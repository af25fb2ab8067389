"""Seconds from the process's start to the window's: imports, the CUDA
context, loading or building the kernels, the tables made on the device,
the traffic's own set-up and the warm-up calls."""


def read(run):
    return run.setup_s
