"""Set-up seconds: from the process's start to the first timed call
(the CUDA context, the kernels loaded or built, the pool made, one warm
call of every batch)."""

UNIT = "s"
LAYER = "end to end"
MOVES = None


def read(ctx):
    return ctx["setup_s"]
