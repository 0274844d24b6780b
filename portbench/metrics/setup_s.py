"""setup_s: seconds from the process's start to the window's start
(loading, the inputs, the warm-up; the first run in a checkout also builds
the kernels)."""


def read(run):
    return run.setup_s
