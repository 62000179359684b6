"""The benchmark's yardstick: the window loop, traffic generator, profiler
readers, roofline arithmetic and the comparison that decides ``correct``.
Copied here from the program where the program had them, so that later
changes to the program cannot move it."""
