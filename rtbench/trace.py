"""Reading the profiler's trace of whole calls.

The device's busy time is the union of the intervals of every device event
(kernels, copies, sets) the profiler recorded; its idle share is one minus
that over the wall of the calls. The arithmetic of ``union_us`` is a copy
of the port's ``profile_flagship.py``.

"The port's kernels" are the ``__global__`` functions declared under the
program's ``csrc/``, read from the sources at run time, so a kernel that a
later change adds joins without an edit here. ``LAYER_EXCLUDE`` takes the
Voigt kernels of the model build out of the layer kernels.
"""
from __future__ import annotations

import collections
import os
import re

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: prefixes of the port's kernels that are not layer kernels (the model
#: build's line-by-line Voigt kernels)
LAYER_EXCLUDE = ("voigt",)
#: device idle gaps shorter than this (microseconds) are launch spacing
MIN_GAP_US = 5.0
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def start():
    """Start the profiler on the device's activity alone (kernels, copies
    and the CUDA runtime calls that launch them): recording every torch op
    on the host as well more than doubled a Jacobian's wall."""
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def port_kernels() -> set:
    """Names of the ``__global__`` functions under the program's csrc/."""
    import importlib.util
    spec = importlib.util.find_spec("vsmartmom_torch")
    csrc = os.path.join(list(spec.submodule_search_locations)[0], "csrc")
    names = set()
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fn)) as f:
                names.update(_GLOBAL.findall(f.read()))
    return names


def kernel_of(name: str, kernels) -> str | None:
    """The port kernel a device event's (demangled) name launches, if
    any: the kernel's name followed by its template or argument list."""
    for k in kernels:
        if re.search(r"(?<!\w)" + k + r"(?=[<(]|$)", name):
            return k
    return None


def events(prof):
    """(device intervals, host intervals) of the trace, each a list of
    (name, start_us, end_us), from the profiler's raw events (building its
    FunctionEvents costs minutes and GiB on a Jacobian's events)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            device.append(iv)
        elif e.device_type() == DeviceType.CPU:
            host.append(iv)
    return device, host


def union_us(intervals):
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


class TraceData:
    """The traced calls: device events, host events, wall and work."""

    def __init__(self, device, host, wall_s, n_calls, work, kernels):
        self.device = device
        self.host = host
        self.wall_s = wall_s
        self.n_calls = n_calls
        self.work = work
        self.kernels = kernels
        self.busy_s = union_us(device) / 1e6
        self.kernel_of = {}
        for name, _, _ in device:
            if name not in self.kernel_of:
                self.kernel_of[name] = kernel_of(name, kernels)

    def idle_share(self):
        """1 - device busy / wall of the traced calls; None where no
        device event was recorded."""
        if self.busy_s <= 0 or self.wall_s <= 0:
            return None
        return 1.0 - self.busy_s / self.wall_s

    def outside_port_kernels_ms(self) -> float:
        """Device milliseconds a traced call of every device event outside
        the port's kernels (torch ops, copies, sets)."""
        return 1e3 * self.device_time_s(lambda k: k is None) / self.n_calls

    def device_time_s(self, select) -> float:
        """Summed seconds of the device events whose port kernel (None for
        any other event) ``select`` accepts."""
        return sum(e - s for name, s, e in self.device
                   if select(self.kernel_of[name])) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        host activities under which the device sat idle longest: each gap
        between device events is put to the innermost CUDA runtime call
        running at its middle, or to the host code between such calls."""
        per = collections.Counter()
        for name, s, e in self.device:
            per[name[:NAME_CHARS]] += (e - s) / 1e6
        spans, end = [], None
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if end is not None and s - end > MIN_GAP_US:
                spans.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host, key=lambda h: h[1])
        gaps, active, k = collections.Counter(), [], 0
        for lo, hi in spans:
            mid = 0.5 * (lo + hi)
            while k < len(host) and host[k][1] <= mid:
                active.append(host[k])
                k += 1
            active = [h for h in active if h[2] >= mid]
            name = min(active, key=lambda h: h[2] - h[1])[0] if active \
                else "host code between CUDA calls"
            gaps[name] += (hi - lo) / 1e6
        return {"device_ops": [[n, v] for n, v in per.most_common(10)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}


def outside_port_kernels_ms(ctx):
    """A metric reader: device milliseconds a traced call outside the
    port's kernels; nothing without a trace."""
    return None if ctx.trace is None else ctx.trace.outside_port_kernels_ms()


def read(prof, wall_s: float, n_calls: int, work) -> TraceData:
    device, host = events(prof)
    return TraceData(device, host, wall_s, n_calls, work, port_kernels())
