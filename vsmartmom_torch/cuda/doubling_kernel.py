"""Doubling recursion alone — CUDA kernel and plain version.

Replaces the TPU kernel ``vsmartmom/pallas/doubling_kernel.py:
_doubling_kernel``, reached from ``fused_doubling``: all scheduled
Newton-Schulz doubling steps of a flipped elemental layer (r, t, jp, jm)
with the state resident, returning the doubled (r, t, jp, jm).

What bounds it on Hopper: per spectral point a chain of dependent N x N
products (fp32 FMA) against (4 N^2 + 4 N + 1) floats of device memory:
arithmetic. Design: ``doubling_kernel`` in csrc/layer_step.cu runs phase 1
of the fused layer step (the same team device function of
csrc/rt_device.cuh, a team of whole warps per point) on a smaller
shared-memory arena of about 6 N ld + 4 N^2 floats per point (state, NS
iterates, packed operands; ld the padded row stride) and writes the state
back. Ragged S is masked in the kernel. ``precision`` is the JAX kernel's
``precision_name`` (core/precision.py): every product of the doubling, the
source-vector columns included, in full fp32, three bf16 passes ("high")
or one ("default"); the kernel is a template on the mode.

The plain version runs cuda/layer_step_kernel.py:doubling_body. The wrapper
takes it only for CPU tensors; for CUDA tensors it launches the kernel or
raises. Forward only.
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core.precision import MATMUL_MODES, batch_mm, check_mode
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda.layer_step_kernel import (doubling_body,
                                                    on_tensor_cores)

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0


def arena_floats(n: int, ld: int) -> int:
    """Shared-memory floats one spectral point uses at row stride ld (must
    match ``doubling_arena_floats`` in csrc/rt_device.cuh)."""
    return build.doubling_arena_floats(n, ld)


def launch_config(n: int) -> build.TeamLaunch:
    """Teams per block, dynamic shared-memory bytes, row stride and team
    threads at stream count n."""
    return build.team_launch_config(n, arena_floats)


def entry_point(precision: str, n: int) -> str:
    """The launch entry at ``precision`` and width n: ``vsm_doubling_tc``
    (the tensor-core body) where the layer step's "high" runs on the tensor
    cores (layer_step_kernel.on_tensor_cores: the same classes, for the
    same reason), ``vsm_doubling`` (the body on the CUDA cores)
    otherwise."""
    return ("vsm_doubling_tc" if on_tensor_cores(precision, n)
            else "vsm_doubling")


def product_widths(n: int) -> tuple:
    """The column counts k of the doubling's (n x n) @ (n x k) products."""
    return (n, 2 * n + 2)


def tc_plan(n: int) -> build.TensorCorePlan:
    """The tensor-core body's plan at stream count n (a width of
    layer_step_kernel.TC_CLASSES)."""
    return build.tensor_core_plan(n, launch_config(n), product_widths(n),
                                  diag=True)


def doubling_bytes(n: int) -> int:
    """Device-memory bytes of one point: (r, t, jp, jm, ek) read once, the
    doubled (r, t, jp, jm) written once."""
    return 4 * ((2 * n * n + 2 * n + 1) + (2 * n * n + 2 * n))


def fused_doubling_plain(r, t, jp, jm, ek, *, ns_schedule,
                         precision: str = "highest"):
    """Plain torch version of the kernel (doubling_body at ``precision``),
    with the wrapper's arguments."""
    return doubling_body(r, t, jp, jm, ek[:, None], tuple(ns_schedule),
                         batch_mm(check_mode(precision)))


def fused_doubling(r, t, jp, jm, ek, *, ns_schedule,
                   precision: str = "highest"):
    """All doubling steps of ``ns_schedule`` (NS iterations per step) on
    r, t: (S, N, N); jp, jm: (S, N); ek: (S,), every product in
    ``precision`` (one of core.precision.MATMUL_MODES). Returns the doubled
    (r, t, jp, jm).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, no autograd) or raise; under a torch.func
    transform they raise NotImplementedError (no forward rule).
    """
    ns_schedule = tuple(int(i) for i in ns_schedule)
    check_mode(precision, MATMUL_MODES)
    if r.device.type == "cpu":
        return fused_doubling_plain(r, t, jp, jm, ek,
                                    ns_schedule=ns_schedule,
                                    precision=precision)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    s, n, _ = r.shape
    ins = [r, t, jp, jm, ek]
    build.check_operands("fused_doubling", ins, r.device)
    if t.shape != (s, n, n) or jp.shape != (s, n) or jm.shape != (s, n) \
            or ek.shape != (s,):
        raise ValueError("fused_doubling: inconsistent shapes")
    sched = build.schedule_array(ns_schedule)
    pts, smem, ld, _ = launch_config(n)
    if smem > build.MAX_SHARED_BYTES:
        raise ValueError(f"N = {n} needs {smem} bytes of shared memory per "
                         f"block, more than {build.MAX_SHARED_BYTES}")
    outs = [torch.empty_like(r), torch.empty_like(t), torch.empty_like(jp),
            torch.empty_like(jm)]
    if s == 0:
        return tuple(outs)
    err = getattr(build.lib(), entry_point(precision, n))(
        *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
        s, n, ld, sched, len(ns_schedule), build.mode_code(precision), pts,
        smem, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "doubling launch")
    global launches
    launches += 1
    return tuple(outs)
