"""Device kernels a batch launches in the embed cell: the kernel events of
the traced sub-window over its batches (the program's kernels and
PyTorch's alike)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.kernel_count() / ctx.trace.units
