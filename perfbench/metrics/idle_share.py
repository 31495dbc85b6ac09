"""Share of the traced window in which the device ran no operation (no
kernel and no copy), from the profiler's device events."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * t.idle_share()
