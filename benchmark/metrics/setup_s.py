"""setup_s: process start to the first timed dispatch (import, CUDA
context, kernel library, weights, scenes, warm pairs), host clock."""


def read(run):
    return run.setup_s
