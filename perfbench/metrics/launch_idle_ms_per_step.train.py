"""Milliseconds a training step in which the device idles while the host
launches the forward and backward passes: the traced window's idle time
inside the union of the program's ``sk.train.forward`` and
``sk.train.backward`` spans, over the traced steps."""

from perfbench import spans

NAMES = ("sk.train.forward", "sk.train.backward")


def read(ctx):
    return spans.idle_ms_per_unit(ctx.trace, NAMES)
