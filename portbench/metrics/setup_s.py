"""setup_s (s): from process start to the window's first tick: loading,
the scene and engine build, the kernel build on a checkout's first run, and
the warm-up of every shape the window uses."""


def read(rec):
    return rec['setup_s']
