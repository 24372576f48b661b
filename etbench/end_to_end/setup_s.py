"""Set-up: from the process's start to the first timed call, the build of
the kernels, loading, the generated inputs and the warm-up included."""


def read(ctx):
    return ctx.setup_s
