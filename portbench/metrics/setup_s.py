"""setup_s: process start to the first timed call (host clock): loading,
building or loading the kernels, the inputs, the warm-up calls."""


def read(run):
    return run.setup_s
