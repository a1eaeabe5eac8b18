"""Stage spans: the port's one span recorder (the reference instruments
every stage with TimerOutputs @timeit and prints a report after rt_run;
ref: src/CoreRT/rt_run.jl:87-220, tools/gpu_batched.jl:39-41).

Usage:
    with timeit("doubling"):
        ...

A span never synchronises the device: its times are the host's, on the
clock of ``time.time_ns`` (the epoch clock on which torch.profiler stamps
its events), so a span holds the launches made inside it and a profiler's
device intervals can be matched to it. Two read modes, each off by
default:

- ``enable_timer()``: the flat per-stage report of TimerOutputs
  (``timer_report``, ``print_timer``), sums over every span of a name;
- a running ``torch.profiler`` (as ``record_function`` records only
  then): the span list (``spans``), one ``Span`` per span with its id, its
  parent's id (the innermost open span, None at a root) and its call's id
  (its root's).

``reset_timer()`` clears both. With neither on, a span costs a flag test
and the profiler probe, and stores nothing.
"""
from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import NamedTuple, Optional

from torch.autograd import _profiler_enabled

_ENABLED = False
_STATS: "OrderedDict[str, list]" = OrderedDict()
_SPANS: list = []
#: (id, call id) of each open span, innermost last
_OPEN: list = []
_IDS = itertools.count(1)


class Span(NamedTuple):
    """One recorded span: start and end in ``time.time_ns`` nanoseconds."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int


def enable_timer(on: bool = True):
    """Turn the flat report's aggregates on (or off)."""
    global _ENABLED
    _ENABLED = on


@contextmanager
def timeit(name: str):
    """Record the block as a span ``name``, under the innermost open
    span."""
    aggregate = _ENABLED
    keep = _profiler_enabled()
    if not (aggregate or keep):
        yield
        return
    sid = next(_IDS)
    parent, call = _OPEN[-1] if _OPEN else (None, sid)
    _OPEN.append((sid, call))
    t0 = time.time_ns()
    try:
        yield
    finally:
        t1 = time.time_ns()
        _OPEN.pop()
        if keep:
            _SPANS.append(Span(name, t0, t1, sid, parent, call))
        if aggregate:
            dt = 1e-9 * (t1 - t0)
            ent = _STATS.setdefault(name, [0, 0.0, 0.0])
            ent[0] += 1
            ent[1] += dt
            ent[2] = max(ent[2], dt)


def spans() -> list:
    """The spans recorded while a profiler ran, in the order they
    closed (a child before its parent)."""
    return list(_SPANS)


def reset_timer():
    _STATS.clear()
    _SPANS.clear()


def timer_report() -> str:
    if not _STATS:
        return "(no timing data)"
    width = max((len(k) for k in _STATS), default=4) + 2
    lines = [f"{'stage':<{width}}{'calls':>7}{'total[s]':>11}"
             f"{'mean[ms]':>11}{'max[ms]':>10}"]
    for k, (n, tot, mx) in _STATS.items():
        lines.append(f"{k:<{width}}{n:>7}{tot:>11.3f}"
                     f"{1e3 * tot / n:>11.2f}{1e3 * mx:>10.2f}")
    return "\n".join(lines)


def print_timer():
    print(timer_report())
