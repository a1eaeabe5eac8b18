"""Split-form RT layer step (doubling + adding) — CUDA kernel and plain
version.

Replaces the TPU kernel ``vsmartmom/pallas/layer_step_kernel.py:
_layer_step_kernel_dev``, reached from ``_fused_layer_step_dev_prim``. One
call does one layer in direct/diffuse split form (T = diag(g) + E, see
core.rt.LayerRTDev): the Y-form Newton-Schulz scheduled doubling of the
pre-split flipped elemental layer (r_f, e_el, g_el, jp, jm_f, ek), the
D-unflip, and ``interaction_dev`` under the 7-field composite (r_mp, r_pm,
e_pp, e_mm, g, j_p, j_m) with one NS solve through the push-through
identity. The algebra is core.rt.doubling_dev / interaction_dev.

What bounds it on Hopper: as the plain layer step
(cuda/layer_step_kernel.py), a chain of small dependent N x N products per
spectral point, fp32 FMA on the CUDA cores fed from shared memory; device
memory traffic (7 composite + 5 elemental fields in, 7 out) is small
against the O(N^3) work. Design: one block of 256 threads handles P points,
each with a shared-memory arena of 10 N^2 + 8 N + 1 floats (state, the Y
iterate, NS scratch, and the packed operands of width up to 3N + 2), for
the whole step. At N = 15 a block holds 5 points (47 KB); at N = 44 one
point (79 KB); the largest N is 75 (227 KB). Matrix products are full fp32
(the counterpart of the JAX kernel's "highest" mode). The ragged last
block is masked in the kernel, so no vacuum padding is needed.

The plain version (``fused_layer_step_dev_plain``) is the JAX package's
``_xla_twin_step_dev`` on the port's torch functions. The wrapper takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Forward only.
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core.rt import LayerRTDev, doubling_dev, interaction_dev
from vsmartmom_torch.cuda import build

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0


def arena_floats(n: int) -> int:
    """Shared-memory floats one spectral point uses (must match
    ``dev_arena_floats`` in csrc/layer_step_dev.cu): r, e (2 n^2), g, jp,
    jm (3n), ek (1), Y (n^2) and the interaction's packed operands
    (7 n^2 + 5n), which also hold the NS and doubling scratch."""
    return 10 * n * n + 8 * n + 1


def launch_config(n: int):
    """(points per block, dynamic shared-memory bytes) at stream count n
    (the block shares the D diagonal, n floats)."""
    return build.launch_config(arena_floats(n), n)


def max_n() -> int:
    """Largest stream count N whose one-point block fits Hopper's 227 KB."""
    n = 1
    while 4 * (n + 1 + arena_floats(n + 1)) <= build.MAX_SHARED_BYTES:
        n += 1
    return n


def step_flops(n: int, ns_schedule, ni: int) -> int:
    """Matrix-product FLOPs of one point's split-form layer step (2 n^2 k
    per (n x n) @ (n x k) product; elementwise work left out)."""
    dbl = sum(2 * n * n * (n + 2 * n * it + (n + 2) + 2 * (2 * n + 2))
              for it in ns_schedule)
    inter = 2 * n * n * (n + 2 * n * ni + 3 * (n + 1) + (3 * n + 2)
                         + 3 * (2 * n + 1))
    return dbl + inter


def step_bytes(n: int) -> int:
    """Device-memory bytes of one point's step: the composite (4 n^2 + 3n)
    and the elemental layer (2 n^2 + 3n + 1) read once, the new composite
    written once."""
    return 4 * ((4 * n * n + 3 * n) + (2 * n * n + 3 * n + 1)
                + (4 * n * n + 3 * n))


def fused_layer_step_dev_plain(comp: LayerRTDev, r_f, g_el, e_el, jp, jm_f,
                               ek, d_vec, *, ns_schedule,
                               ni: int) -> LayerRTDev:
    """Plain torch version of the kernel: split-form doubling, unflip and
    interaction_dev, one batched matmul at a time."""
    r_f2, g2, e2, jp2, jm_f2 = doubling_dev(
        r_f, g_el, e_el, jp, jm_f, ek, ns_schedule=tuple(ns_schedule),
        ndoubl=len(ns_schedule))
    r_mp = d_vec[None, :, None] * r_f2
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    added = LayerRTDev(r_mp=r_mp, r_pm=sgn * r_mp, e_pp=e2, e_mm=sgn * e2,
                       g=g2, j_p=jp2, j_m=d_vec[None, :] * jm_f2)
    return interaction_dev(comp, added, ni=int(ni))


def fused_layer_step_dev(comp: LayerRTDev, r_f, g_el, e_el, jp, jm_f, ek,
                         d_vec, *, ns_schedule, ni: int) -> LayerRTDev:
    """One split-form RT layer step. comp: LayerRTDev of (S, N, N) x 4 and
    (S, N) x 3; r_f, e_el: (S, N, N); g_el, jp, jm_f: (S, N); ek: (S,);
    d_vec: (N,). ``ns_schedule``: per-doubling-step NS iteration counts;
    ``ni``: NS iterations of the interaction solve. Returns the new
    composite.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, no autograd, N <= max_n()) or raise.
    """
    ns_schedule = tuple(int(i) for i in ns_schedule)
    if r_f.device.type == "cpu":
        return fused_layer_step_dev_plain(comp, r_f, g_el, e_el, jp, jm_f,
                                          ek, d_vec,
                                          ns_schedule=ns_schedule,
                                          ni=int(ni))
    if r_f.device.type != "cuda":
        raise ValueError(f"unsupported device {r_f.device}")
    s, n, _ = r_f.shape
    mats = [comp.r_mp, comp.r_pm, comp.e_pp, comp.e_mm, r_f, e_el]
    vecs = [comp.g, comp.j_p, comp.j_m, g_el, jp, jm_f]
    ins = [*mats[:4], *vecs[:3], r_f, g_el, e_el, jp, jm_f, ek, d_vec]
    build.check_operands("fused_layer_step_dev", ins, r_f.device)
    if any(m.shape != (s, n, n) for m in mats) \
            or any(v.shape != (s, n) for v in vecs) \
            or ek.shape != (s,) or d_vec.shape != (n,):
        raise ValueError("fused_layer_step_dev: inconsistent shapes")
    sched = build.schedule_array(ns_schedule)
    pts, smem = launch_config(n)
    if smem > build.MAX_SHARED_BYTES:
        raise ValueError(f"N = {n} needs {smem} bytes of shared memory per "
                         f"block, more than {build.MAX_SHARED_BYTES}: the "
                         f"split-form kernel takes N <= {max_n()}")
    outs = [torch.empty_like(comp.r_mp) for _ in range(4)] \
        + [torch.empty_like(comp.j_p) for _ in range(3)]
    if s == 0:
        return LayerRTDev(*outs)
    err = build.lib().vsm_layer_step_dev(
        *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
        s, n, sched, len(ns_schedule), int(ni), pts, smem,
        torch.cuda.current_stream(r_f.device).cuda_stream)
    build.check(err, "layer_step_dev launch")
    global launches
    launches += 1
    return LayerRTDev(*outs)
