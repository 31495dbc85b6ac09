"""Device kernels a request launches in the decode cell: the kernel events of
the traced sub-window over its requests (the program's kernels and
PyTorch's alike)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.kernel_count() / ctx.trace.units
