"""host_driver_ms.fwd: host milliseconds a traced forward call spent in the
program's driver: its ``rt_run`` spans less their ``fourier step`` and
``postprocessing (device fetch)`` subtrees (band mixing, schedules, copies
to the device, Z moments, synthesis), from the program's span list on the
host's clock. Nothing to read where the program records no spans."""
from rtbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None or t.kind != "rt_run":
        return None
    return t.host_ms(("rt_run",), (spans.FOURIER, spans.FETCH))
