"""Milliseconds a decode request in which the device idles while the host
is in the request's prologue: the traced window's idle time inside the
union of the program's ``sk.decode.prologue`` spans (the encoder, the
cross keys and values, the zeroed caches and the position table), over
the traced requests."""

from perfbench import spans

NAMES = ("sk.decode.prologue",)


def read(ctx):
    return spans.idle_ms_per_unit(ctx.trace, NAMES)
