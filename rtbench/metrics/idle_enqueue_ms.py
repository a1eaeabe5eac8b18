"""idle_enqueue_ms.fwd, idle_enqueue_ms.jac: milliseconds a traced call
(forward call, Jacobian) in which the device ran nothing while the host
enqueued a Fourier moment's layer scan and surface: inside the
``fourier step`` spans, and for a Jacobian (root ``radiance``) outside its
``tangent`` spans, which idle_tangent_ms.jac reads (rtbench.spans: exact
intervals against the profiler's device intervals). Nothing to read where
the program records no spans."""
from rtbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None:
        return None
    return t.idle_ms((spans.FOURIER,),
                     (spans.TANGENT,) if t.kind == "radiance" else ())
