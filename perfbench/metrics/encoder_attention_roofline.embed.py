"""Share of its roofline that the encoder stack's attention reaches in the
embed cell: the least time of every layer's ``encoder_attention`` over the
traced batches (``work.encoder_attention_call``, keys limited to each
row's valid ones) over the device time of the kernels that ran it (the
bf16 tensor-core forward, or the FMA kernel where a width declines)."""

from perfbench import work

KERNELS = ("attention_fwd_mma_kernel", "encoder_attention_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernel_seconds(KERNELS):
        return None
    T, L = ctx.traffic["seq_len"], ctx.cfg["num_layers"]
    least = sum(L * work.least_s(*work.encoder_attention_call(
        ctx.cfg, T, u["keys"])) for u in ctx.traced)
    return 100.0 * least / t.kernel_seconds(KERNELS)
