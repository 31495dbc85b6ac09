"""Host milliseconds a batch of the embed cell spends waiting for the
device in ``embed_dataset``'s drain: the union of the program's
``sk.embed.drain`` spans (the wait for the z two batches behind) over the
traced batches. It is the time the host has run ahead of the device; a
program with no such span reads nothing."""

from perfbench import spans

NAMES = ("sk.embed.drain",)


def read(ctx):
    return spans.ms_per_unit(ctx.trace, NAMES)
