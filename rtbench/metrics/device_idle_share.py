"""device_idle_share.fwd, device_idle_share.jac: the device's idle share
over the traced calls (forward calls, Jacobians), 1 - (union of the device
intervals) / (wall of the calls), from the profiler's trace of the
device's activity."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
