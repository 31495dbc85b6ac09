"""Share of its roofline that the decode chunk kernel reaches in the
decode cell: the least time of every 16-step chunk of the traced requests
(``work.decode_chunk_call``: weights, head and cross keys and values once
a chunk, the cache rows once a step) over the device time of the chunk
kernel."""

from perfbench import work

KERNELS = ("decode_cluster_kernel", "decode_chunk_kernel")
CHUNK = 16


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernel_seconds(KERNELS):
        return None
    B, T = ctx.traffic["batch"], ctx.traffic["decode_len"]
    per_request = sum(work.least_s(*work.decode_chunk_call(
        ctx.cfg, B, t0, min(CHUNK, T - t0))) for t0 in range(0, T, CHUNK))
    return 100.0 * per_request * len(ctx.traced) / t.kernel_seconds(KERNELS)
