"""Host milliseconds a batch of the embed cell spends in its host copies:
the union of the program's ``sk.embed.pin`` spans (each input array's
pinned copy and the pinned z buffer of ``embed_dataset``) over the traced
batches."""

from perfbench import spans

NAMES = ("sk.embed.pin",)


def read(ctx):
    return spans.ms_per_unit(ctx.trace, NAMES)
