"""The host's turnaround between two chunks of a decode request: the
median, over consecutive chunk-kernel pairs that start inside the same
``sk.decode.request`` span of the program, of the later kernel's start
less the earlier's end (the early-exit read, then the next launch)."""

from perfbench import spans

# the chunk kernels, as ``decode_chunk_roofline.decode.py`` names them
KERNELS = ("decode_cluster_kernel", "decode_chunk_kernel")


def read(ctx):
    return spans.turnaround_ms(ctx.trace, "sk.decode.request", KERNELS)
