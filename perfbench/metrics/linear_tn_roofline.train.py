"""Share of its roofline that ``linear_tn`` (each weight gradient with its
bias gradient) reaches in a training cell: the least time of a step's
calls (``work.linear_tn_calls``) over the traced steps, over the device
time of the kernel."""

from perfbench import work

KERNELS = ("linear_tn_wgmma_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernel_seconds(KERNELS):
        return None
    calls = work.linear_tn_calls(ctx.cfg, ctx.traffic["batch"],
                                 ctx.traffic["seq_len"])
    least = sum(work.least_s(*work.linear_tn_call(*c)) for c in calls)
    return 100.0 * least * len(ctx.traced) / t.kernel_seconds(KERNELS)
