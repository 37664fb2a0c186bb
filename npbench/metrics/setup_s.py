"""Seconds from the process's start to the end of the warm job: imports,
CUDA init, input generation, the kernels' load (and, in a checkout's
first run, their build) and the warm job."""


def read(ctx):
    return ctx["setup_s"]
