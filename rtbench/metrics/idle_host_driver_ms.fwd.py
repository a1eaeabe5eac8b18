"""idle_host_driver_ms.fwd: milliseconds a traced forward call in which the
device ran nothing while the program's driver ran: inside the ``rt_run``
spans, outside their ``fourier step`` and ``postprocessing (device
fetch)`` subtrees (rtbench.spans: exact intervals against the profiler's
device intervals). Nothing to read where the program records no spans."""
from rtbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None or t.kind != "rt_run":
        return None
    return t.idle_ms(("rt_run",), (spans.FOURIER, spans.FETCH))
