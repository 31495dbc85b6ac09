"""Milliseconds a training step in which the device idles while the host
is in the non-finite guard or the update after it: the traced window's
idle time inside the union of the program's ``sk.train.guard`` (the
gradient norm and the host's read of whether it is finite) and
``sk.train.update`` (the clipped Adam update) spans, over the traced
steps."""

from perfbench import spans

NAMES = ("sk.train.guard", "sk.train.update")


def read(ctx):
    return spans.idle_ms_per_unit(ctx.trace, NAMES)
