"""Stage timing reports (the reference instruments every stage with
TimerOutputs @timeit and prints a report after rt_run;
ref: src/CoreRT/rt_run.jl:87-220, tools/gpu_batched.jl:39-41).

Usage:
    enable_timer()
    with timeit("doubling", device):
        ...
    print_timer()      # flat report
    reset_timer()

Off by default: a disabled ``timeit`` costs one flag test. Enabled, a span
on a CUDA ``device`` synchronises that device at its start and its end,
so the span holds the device work launched inside it.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager

import torch

_ENABLED = False
_STATS: "OrderedDict[str, list]" = OrderedDict()


def enable_timer(on: bool = True):
    """Turn the spans of ``timeit`` on (or off)."""
    global _ENABLED
    _ENABLED = on


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def timeit(name: str, device=None):
    """Add the wall time of the block to the stage ``name``."""
    if not _ENABLED:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        ent = _STATS.setdefault(name, [0, 0.0, 0.0])
        ent[0] += 1
        ent[1] += dt
        ent[2] = max(ent[2], dt)


def reset_timer():
    _STATS.clear()


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
