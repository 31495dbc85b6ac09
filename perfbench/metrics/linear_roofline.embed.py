"""Share of its roofline that the encoder stack's ``linear`` kernel
reaches in the embed cell: the least time of the traced batches' products
(``work.encoder_linear_calls``, each call's larger bound) over the device
time of the kernels that did them."""

from perfbench import work

KERNELS = ("linear_wgmma_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernel_seconds(KERNELS):
        return None
    M = ctx.traffic["batch"] * ctx.traffic["seq_len"]
    least = work.linear_least_s(work.encoder_linear_calls(ctx.cfg, M))
    return 100.0 * least * len(ctx.traced) / t.kernel_seconds(KERNELS)
