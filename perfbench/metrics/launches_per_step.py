"""Device kernels a training step launches: the kernel events of
the traced sub-window over its steps (the program's kernels and
PyTorch's alike)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.kernel_count() / ctx.trace.units
