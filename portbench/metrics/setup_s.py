"""Process start to the first timed step (host clock): imports, CUDA
context, the problem made from the seed, the kernels loaded or built, one
warm-up step at the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
