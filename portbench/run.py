#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m portbench.run ...``) from the root of a checkout. The
cell, its configuration, traffic mix, limits and metric readers are found
by name from ``BENCHMARK.json`` (``portbench/README.md``). Exits non-zero
and prints no result without enough CUDA devices.
"""
import os
import sys
import time

T0 = time.time()   # set-up is timed from here

if __name__ == '__main__':
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path and os.path.abspath(sys.path[0] or '.') == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = root
    elif root not in sys.path:
        sys.path.insert(0, root)
    from portbench.lib.driver import main
    sys.exit(main(sys.argv[1:], T0))
