"""Milliseconds a batch of the embed cell in which the device idles while
the host is in its pinned host copies: the traced window's idle time (no
device operation) inside the union of the program's ``sk.embed.pin``
spans, over the traced batches."""

from perfbench import spans

NAMES = ("sk.embed.pin",)


def read(ctx):
    return spans.idle_ms_per_unit(ctx.trace, NAMES)
