"""The program's own spans beside the profiler's device intervals.

The program records a span list while a profiler runs
(``vsmartmom_torch.util.timing.spans``): tuples (name, start_ns, end_ns,
id, parent, call) on the clock of ``time.time_ns``, on which the profiler
stamps its events too. A call's root span (``rt_run`` for a forward call,
``radiance`` for a Jacobian) has no parent; every span of the call carries
its root's id. A program that records no such list leaves every reader
here with nothing to read.

All arithmetic is on exact intervals in microseconds: a set of spans is
the union of their intervals, and the device's idle time inside it is
that union minus the union of the device intervals, with no minimum gap.
Per-call figures divide by the traced calls' roots.
"""
from __future__ import annotations

#: names of the spans the metrics read
ROOTS = ("rt_run", "radiance")
FOURIER = "fourier step (layer scan + surface)"
FETCH = "postprocessing (device fetch)"
TANGENT = "tangent"


def recorded() -> list:
    """The program's span list; empty where the program keeps none."""
    try:
        from vsmartmom_torch.util import timing
    except ImportError:
        return []
    read = getattr(timing, "spans", None)
    return list(read()) if callable(read) else []


def union(intervals) -> list:
    """Disjoint sorted (start, end) pairs covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        elif e > s:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def subtract(a, b) -> list:
    """The parts of the disjoint sorted intervals ``a`` outside the
    disjoint sorted intervals ``b``."""
    out, k = [], 0
    for s, e in a:
        while k < len(b) and b[k][1] <= s:
            k += 1
        j = k
        while j < len(b) and b[j][0] < e:
            if b[j][0] > s:
                out.append((s, b[j][0]))
            s = max(s, b[j][1])
            j += 1
        if s < e:
            out.append((s, e))
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


class Traced:
    """The spans of the traced calls: those whose root overlaps the
    trace's events (a profiler run earlier in the process leaves spans
    outside them), by name, in microseconds."""

    def __init__(self, trace, spans):
        events = list(trace.device) + list(trace.host)
        lo = min(s for _, s, _ in events)
        hi = max(e for _, _, e in events)
        self.roots = [sp for sp in spans if sp[4] is None and sp[0] in ROOTS
                      and sp[1] / 1e3 < hi and sp[2] / 1e3 > lo]
        calls = {sp[3] for sp in self.roots}
        self.by_name = {}
        for name, s, e, _, _, call in spans:
            if call in calls:
                self.by_name.setdefault(name, []).append((s / 1e3, e / 1e3))
        self.device = union((s, e) for _, s, e in trace.device)

    @property
    def kind(self) -> str:
        """The roots' name: ``rt_run`` or ``radiance``."""
        return self.roots[0][0]

    def covered(self, inside, outside=()) -> list:
        """The union of the spans named ``inside`` less that of the spans
        named ``outside``."""
        def of(names):
            return union(iv for n in names for iv in self.by_name.get(n, ()))
        return subtract(of(inside), of(outside))

    def host_ms(self, inside, outside=()) -> float:
        """Milliseconds a call of ``covered(inside, outside)``."""
        return length(self.covered(inside, outside)) / 1e3 / len(self.roots)

    def idle_ms(self, inside, outside=()) -> float:
        """Milliseconds a call in which the device ran nothing, inside
        ``covered(inside, outside)``."""
        return (length(subtract(self.covered(inside, outside), self.device))
                / 1e3 / len(self.roots))


def traced(ctx, spans=None):
    """The traced calls' spans (``spans``, by default the program's), or
    None without a trace, a device event or a root span."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    t = Traced(ctx.trace, recorded() if spans is None else spans)
    return t if t.roots else None
