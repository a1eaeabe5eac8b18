"""idle_tangent_ms.jac: milliseconds a traced Jacobian in which the device
ran nothing while the host dispatched the fused layer steps' tangents (the
plain versions' jvp under torch.func): inside the ``tangent`` spans
(rtbench.spans: exact intervals against the profiler's device intervals).
Nothing to read where the program records no spans."""
from rtbench import spans


def read(ctx):
    t = spans.traced(ctx)
    if t is None or t.kind != "radiance":
        return None
    return t.idle_ms((spans.TANGENT,))
