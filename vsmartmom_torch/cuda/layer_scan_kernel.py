"""Fused RT layer scan over one schedule bucket — CUDA kernel and plain
version.

Replaces the TPU kernel ``vsmartmom/pallas/layer_scan_kernel.py:_kernel``,
reached from ``fused_layer_scan``. One call runs a run of consecutive layers
that share one static (ndoubl, NS schedule, ni) entry: per layer the Z
mixing sum_k zw_k Z_k, the elemental layer (core.rt.elemental_flipped), the
scheduled Newton-Schulz doubling and the two-solve interaction
(core.rt.interaction with a schulz right-solve of ``inter_iters``
iterations), the composite carried from layer to layer. The TPU kernel's
6-term Taylor ``_expm1`` (Mosaic has no expm1) becomes ``expm1f`` in the
kernel and ``torch.expm1`` in the plain version.

What bounds it on Hopper: as the layer step, a chain of small dependent
N x N fp32 products per spectral point, fed from shared memory. The TPU
kernel kept the composite in VMEM scratch across a sequential layer grid
axis; Hopper's blocks run in no order, so a team of whole warps owns one
point (one warp at N <= 16; 2, 6, 8 warps for the width classes 32, 48,
64) and loops over the bucket's layers itself, the point's composite and
working state resident in a shared-memory arena of about 10 N ld + 4 N^2
floats for the whole bucket (ld the padded row stride; csrc/layer_scan.cu
on the team helpers of csrc/rt_device.cuh: register-tiled products with
the elementwise passes fused into their stores). Device memory sees the
composite once in and once out, plus the per-layer scalars. The arena takes
N <= 64 (``max_n``), the headline N = 44 included (one 108 KB point per
block).

The plain version (``fused_layer_scan_plain``) loops over the layers with
torch ops in the kernel's operation order. The wrapper takes it only for CPU
tensors; for CUDA tensors it launches the kernel or raises. Forward only.
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core import precision
from vsmartmom_torch.core.rt import (LayerRT, elemental_flipped, interaction,
                                     make_rsolve)
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda.layer_step_kernel import doubling_body, \
    doubling_flops

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0


def arena_floats(n: int, ld: int) -> int:
    """Shared-memory floats one spectral point uses at row stride ld (must
    match ``scan_arena_floats`` in csrc/layer_scan.cu): the doubling arena
    and the composite (4 n ld + 2 round4(n))."""
    return (build.doubling_arena_floats(n, ld) + 4 * n * ld
            + 2 * build.round4(n))


def launch_config(n: int) -> build.TeamLaunch:
    """Teams per block, dynamic shared-memory bytes, row stride and team
    threads at stream count n."""
    return build.team_launch_config(n, arena_floats)


def max_n() -> int:
    """Largest stream count N whose one-point block fits Hopper's 227 KB
    (at the unpadded row stride ld = N)."""
    n = 1
    while 4 * arena_floats(n + 1, n + 1) <= build.MAX_SHARED_BYTES:
        n += 1
    return n


def scan_flops(n: int, sched, ni: int, k: int) -> int:
    """Matrix-product FLOPs of one point and one layer: Z mixing (2 k n^2
    per matrix), the Z i0 products, the doubling, and the two-solve
    interaction (two NS solves, t01 / t21, and four packed products)."""
    mix = 2 * (2 * k * n * n) + 2 * (2 * n * n)
    inter = 2 * (2 * n ** 3 * (2 * ni + 1) + 2 * 2 * n * n * (2 * n + 1))
    return mix + doubling_flops(n, sched) + inter


def scan_bytes(n: int, nz: int, k: int) -> int:
    """Device-memory bytes of one point over a bucket of nz layers: tau,
    omega, tau_sum and k mixing weights per layer, the composite in and out
    (the Z components and node vectors are shared by every point)."""
    return 4 * (nz * (3 + k) + 2 * (4 * n * n + 2 * n))


def fused_layer_scan_plain(comp_in: LayerRT, tau, omega, zw, tau_sum,
                           z_pp_c, z_mp_c, qp, wct2, i0_vec, d_vec, mu0,
                           mu0_node, wct02, *, ns_schedule, i_mu0_n: int,
                           n_stokes: int, inter_iters: int) -> LayerRT:
    """Plain torch version of the kernel: the bucket's layers one at a time
    (Z mixing in component order, elemental_flipped, doubling_body, the
    D-unflip and the schulz two-solve interaction), in the tensors' dtype,
    every product in full precision whatever the enclosing
    core.precision block, as the kernel (and the JAX kernel, pinned to
    HIGHEST) computes them."""
    with precision.scoped("matmul", "highest"):
        return _scan_plain(comp_in, tau, omega, zw, tau_sum, z_pp_c, z_mp_c,
                           qp, wct2, i0_vec, d_vec, mu0, mu0_node, wct02,
                           ns_schedule, i_mu0_n, n_stokes, inter_iters)


def _scan_plain(comp_in, tau, omega, zw, tau_sum, z_pp_c, z_mp_c, qp, wct2,
                i0_vec, d_vec, mu0, mu0_node, wct02, ns_schedule, i_mu0_n,
                n_stokes, inter_iters):
    ns_schedule = tuple(int(i) for i in ns_schedule)
    dtype, device = tau.dtype, tau.device
    n = qp.shape[0]
    eye = torch.eye(n, dtype=dtype, device=device)
    mu0 = torch.as_tensor(mu0, dtype=dtype, device=device)
    mu0_node = torch.as_tensor(mu0_node, dtype=dtype, device=device)
    irs = make_rsolve("schulz", int(inter_iters))
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    comp = comp_in
    for z in range(tau.shape[0]):
        z_pp = torch.zeros((tau.shape[1], n, n), dtype=dtype, device=device)
        z_mp = torch.zeros_like(z_pp)
        for k in range(zw.shape[1]):
            w = zw[z, k][:, None, None]
            z_pp = z_pp + w * z_pp_c[k]
            z_mp = z_mp + w * z_mp_c[k]
        r_f, t, jp, jm_f, ek, _ = elemental_flipped(
            tau[z], omega[z], z_pp, z_mp, tau_sum[z], qp, wct2, wct02,
            i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec, None,
            ndoubl_static=len(ns_schedule))
        r_f, t, jp, jm_f = doubling_body(r_f, t, jp, jm_f, ek[:, None],
                                         ns_schedule)
        r_mp = d_vec[None, :, None] * r_f
        added = LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t, t_mm=sgn * t,
                        j_p=jp, j_m=d_vec[None, :] * jm_f)
        comp = interaction(comp, added, eye, rsolve=irs)
    return comp


def fused_layer_scan(comp_in: LayerRT, tau, omega, zw, tau_sum, z_pp_c,
                     z_mp_c, qp, wct2, i0_vec, d_vec, mu0, mu0_node, wct02,
                     *, ns_schedule, i_mu0_n: int, n_stokes: int,
                     inter_iters: int) -> LayerRT:
    """One schedule bucket of layers in one call. comp_in: the composite
    above these layers (LayerRT of (S, N, N) x 4 and (S, N) x 2; a vacuum
    layer for the top bucket); tau/omega/tau_sum: (nZ, S); zw: (nZ, K, S);
    z_pp_c/z_mp_c: (K, N, N); qp/wct2/i0_vec/d_vec: (N,); mu0, mu0_node,
    wct02: scalars (floats or 0-dim tensors). ``ns_schedule``: NS
    iterations of each doubling step (its length is the doubling count);
    ``inter_iters``: NS iterations of the interaction solves. Returns the
    composite through these layers.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, no autograd, N <= max_n()) or raise; under a
    torch.func transform they raise NotImplementedError (no forward rule).
    """
    ns_schedule = tuple(int(i) for i in ns_schedule)
    if tau.device.type == "cpu":
        return fused_layer_scan_plain(
            comp_in, tau, omega, zw, tau_sum, z_pp_c, z_mp_c, qp, wct2,
            i0_vec, d_vec, mu0, mu0_node, wct02, ns_schedule=ns_schedule,
            i_mu0_n=i_mu0_n, n_stokes=n_stokes, inter_iters=inter_iters)
    if tau.device.type != "cuda":
        raise ValueError(f"unsupported device {tau.device}")
    nz, s = tau.shape
    k = zw.shape[1]
    n = qp.shape[0]
    ins = [tau, omega, tau_sum, zw, z_pp_c, z_mp_c, qp, wct2, i0_vec, d_vec,
           *comp_in]
    build.check_operands("fused_layer_scan", ins, tau.device)
    if omega.shape != (nz, s) or tau_sum.shape != (nz, s) \
            or zw.shape != (nz, k, s) \
            or z_pp_c.shape != (k, n, n) or z_mp_c.shape != (k, n, n) \
            or any(v.shape != (n,) for v in (wct2, i0_vec, d_vec)) \
            or any(m.shape != (s, n, n) for m in comp_in[:4]) \
            or any(v.shape != (s, n) for v in comp_in[4:]):
        raise ValueError("fused_layer_scan: inconsistent shapes")
    sched = build.schedule_array(ns_schedule)
    if n > max_n():
        raise ValueError(f"N = {n} exceeds Hopper's shared memory: the "
                         f"layer-scan kernel takes N <= {max_n()}")
    pts, smem, ld, _ = launch_config(n)
    if smem > build.MAX_SHARED_BYTES:
        raise ValueError(f"N = {n} needs {smem} bytes of shared memory per "
                         f"block, more than {build.MAX_SHARED_BYTES}: the "
                         f"layer-scan kernel takes N <= {max_n()}")
    outs = [torch.empty_like(comp_in.r_mp) for _ in range(4)] \
        + [torch.empty_like(comp_in.j_p) for _ in range(2)]
    if s == 0:
        return LayerRT(*outs)
    err = build.lib().vsm_layer_scan(
        *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
        s, n, ld, nz, k, sched, len(ns_schedule), int(inter_iters),
        int(i_mu0_n), int(n_stokes), float(mu0), float(mu0_node), float(wct02), pts, smem,
        torch.cuda.current_stream(tau.device).cuda_stream)
    build.check(err, "layer_scan launch")
    global launches
    launches += 1
    return LayerRT(*outs)
