"""The host's own milliseconds a training step: the traced sub-window's
host time less the spans in which the host's main thread waited on the
device (a host read of a device value, such as the step's read of its
gradient norm, or a synchronise), over its steps. Read from the
profiler's trace of host events, so it includes the profiler's own cost
per operation."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    return 1e3 * (t.window_s - t.waiting_s()) / t.units
