"""Fused RT layer step (doubling + adding) — CUDA kernel and plain version.

Replaces the TPU kernel ``vsmartmom/pallas/layer_step_kernel.py:
_layer_step_kernel`` (with ``doubling_body`` of
``vsmartmom/pallas/doubling_kernel.py``), reached from
``_fused_layer_step_prim``. One call does one layer: Newton-Schulz
scheduled doubling of the flipped elemental layer, the D-unflip, and the
adding under the composite with ONE NS solve through the push-through
identity (I - c_rpm r2)^-1 = I + c_rpm (I - r2 c_rpm)^-1 r2.

What bounds it on Hopper: each spectral point is a chain of ~20-80 small
dependent N x N products (N = 1..63) on the point's own data. Per point the
kernel reads 4 composite + 2 elemental matrices and writes 4, so device
memory traffic is small against the O(N^3) work per product; the work is
fp32 FMA on the CUDA cores (no TF32, no tensor cores), fed from shared
memory. ``precision`` takes the JAX kernel's ``precision_name`` modes
(core/precision.py): "highest" (full fp32), "high" (three bf16 passes) or
"default" (one bf16 pass); the kernel is a template on the mode, and each
pass is one fmaf chain of exact bf16 products. Design (csrc/layer_step.cu
on the team helpers of csrc/rt_device.cuh): a team of whole warps per point
(one warp at N <= 16; 2, 6, 8 warps for the width classes 32, 48, 64) owns
the point's arena (elemental layer, NS iterates, packed operands, the
composite's c_rpm and c_tmm) for the whole step and synchronises only
itself; products are register-tiled with the elementwise passes fused into
their stores. A block holds as many teams as half an SM's shared memory
takes (N = 15: 7 points of 15 KB; N = 44 and N = 63: one point, 108 KB
and 221 KB). Every arena
slot starts on 16 bytes and square slots have a row stride ld = 4 mod 8
where it fits, so products read float4 rows without bank conflicts. The
ragged last block is masked in the kernel.

The plain version (``fused_layer_step_plain``) computes the same algebra
with torch batched matmuls. The wrapper takes it only for CPU tensors; for
CUDA tensors it launches the kernel or raises. Forward mode only
(the JAX package's custom_jvp); no backward. Under torch.func.jvp/jacfwd
the kernel computes the primal, and the tangent kernel
(csrc/layer_step_tangent.cu) the tangent of every jacfwd column in one
launch: the plain version's iteration linearised term by term, its plain
twin ``layer_step_tangent_body`` on CPU tensors. Widths whose tangent arena
does not fit a block (tangent_on_kernel) take torch.func.jvp of the plain
version.
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core.precision import (MATMUL_MODES, batch_mm,
                                            batch_mm_tangent, check_mode)
from vsmartmom_torch.core.rt import LayerRT
from vsmartmom_torch.cuda import build
from vsmartmom_torch.util.timing import timeit

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0
#: tangent-kernel launches since the count was last reset: one a layer
#: step's tangent, whatever its number of columns (set it to 0 to reset)
tangent_launches = 0
#: layer-step tangents taken as torch.func.jvp of the plain version, at the
#: widths the tangent kernel does not take (tangent_on_kernel)
plain_tangents = 0


def arena_floats(n: int, ld: int) -> int:
    """Shared-memory floats one spectral point uses at row stride ld (must
    match ``step_arena_floats`` in csrc/rt_device.cuh): the doubling arena
    up to its packed operands, then the larger of the doubling's W1, W2 and
    the interaction's X, X2 (3 n round4(2n + 1)), then the composite's
    c_rpm and c_tmm (2 n ld)."""
    w = max(2 * n * build.round4(2 * n + 2), 3 * n * build.round4(2 * n + 1))
    return 6 * n * ld + 2 * build.round4(n) + w + 2 * n * ld


def launch_config(n: int) -> build.TeamLaunch:
    """Teams per block, dynamic shared-memory bytes, row stride and team
    threads at stream count n (the block shares the D diagonal,
    round4(n) floats)."""
    return build.team_launch_config(n, arena_floats, build.round4(n))


def tangent_arena_floats(n: int, ld: int) -> int:
    """Shared-memory floats one (point, column) team of the tangent kernel
    uses: the step's arena twice, the primal's and its tangent's (csrc/
    layer_step_tangent.cu)."""
    return 2 * arena_floats(n, ld)


def tangent_launch_config(n: int) -> build.TeamLaunch:
    """The tangent kernel's launch at stream count n: teams (a point and a
    column each) per block, shared bytes, row stride, team threads."""
    return build.team_launch_config(n, tangent_arena_floats, build.round4(n))


#: the widest tile class (padded width NP) the tangent kernel is built for
#: (kMaxTangentNP in csrc/layer_step_tangent.cu)
TANGENT_MAX_NP = 48


def tangent_on_kernel(n: int) -> bool:
    """Whether the layer step's tangent at width n runs on the tangent
    kernel: its tile class is built and one team's arena fits a block's
    shared memory (N <= 44). Every other width takes torch.func.jvp of
    the plain version (build.tangent_of_plain)."""
    return (1 <= n <= TANGENT_MAX_NP and tangent_launch_config(n).smem_bytes
            <= build.MAX_SHARED_BYTES)


#: the tile classes (padded width NP) whose "high" runs on the tensor cores
#: (the classes that have a tensor-core body, ``has_tc_body`` in
#: csrc/layer_step.cu, take it); the wider classes keep the CUDA-core body at
#: "high" (on_tensor_cores)
TC_CLASSES = (16,)


def on_tensor_cores(precision: str, n: int) -> bool:
    """Whether the kernel at ``precision`` and width n runs its products on
    the tensor cores: "high" in a class of TC_CLASSES. The plain form at
    "high" moves by about as much when its sums change order as it lies
    from "highest" (vsmartmom_torch/order_sensitivity.py --form plain): on
    the CPU the wider classes' emulated orders moved by up to 1.4 times
    that distance, so they keep the CUDA-core body, bit-equal to the plain
    version."""
    check_mode(precision, MATMUL_MODES)
    return precision == "high" and build.tile_class(n)[0] in TC_CLASSES


def entry_point(precision: str, n: int) -> str:
    """The launch entry at ``precision`` and width n:
    ``vsm_layer_step_tc`` (the tensor-core body) where on_tensor_cores,
    ``vsm_layer_step`` (the body on the CUDA cores) otherwise."""
    return ("vsm_layer_step_tc" if on_tensor_cores(precision, n)
            else "vsm_layer_step")


def x2_stride(n: int) -> int:
    """Row stride of the interaction's X2 (``x2_stride`` in
    csrc/rt_device.cuh); X's is twice it."""
    return build.round4(2 * n + 1)


def product_widths(n: int) -> tuple:
    """The column counts k of the step's (n x n) @ (n x k) products: the
    doubling's n and 2n + 2, the interaction's n, 2n + 1 and the in-place
    M [x1 | r2mp x2] of x2_stride(n) + 2n + 1."""
    return (n, 2 * n + 1, 2 * n + 2, x2_stride(n) + 2 * n + 1)


def tc_plan(n: int) -> build.TensorCorePlan:
    """The tensor-core body's plan at stream count n (a width of
    TC_CLASSES)."""
    return build.tensor_core_plan(n, launch_config(n), product_widths(n),
                                  diag=True)


def step_flops(n: int, ns_schedule, ni: int) -> int:
    """Matrix-product FLOPs of one point's layer step (2 n^2 k per
    (n x n) @ (n x k) product; the O(n^2) elementwise work is left out)."""
    return doubling_flops(n, ns_schedule) + 2 * n * n * (
        n + 1 + n + 1 + (2 * n + 1) + n + 2 * n * ni + (4 * n + 2)
        + 3 * (2 * n + 1))


def doubling_flops(n: int, ns_schedule) -> int:
    """Matrix-product FLOPs of one point's doubling over the schedule:
    r r, 2 products per NS iteration, r [t|jp|j1m], M W, t (M W)."""
    return sum(2 * n * n * (n + 2 * n * it + (n + 2) + 2 * (2 * n + 2))
               for it in ns_schedule)


def step_bytes(n: int) -> int:
    """Device-memory bytes of one point's layer step: the composite and
    the elemental layer read once, the new composite written once."""
    return 4 * ((4 * n * n + 2 * n) + (2 * n * n + 2 * n + 1)
                + (4 * n * n + 2 * n))


def ns_m(a, iters: int, mm):
    """Newton-Schulz approximate inverse M of A = I - B, rho(B) < 1, with
    the product ``mm``."""
    n = a.shape[-1]
    eye2 = 2.0 * torch.eye(n, dtype=a.dtype, device=a.device)
    m = eye2 - a
    for _ in range(iters):
        m = mm(m, eye2 - mm(a, m))
    return m


def doubling_body(r, t, jp, jm, ek, ns_schedule, mm=torch.matmul):
    """Doubling recursion over a static NS schedule (flipped space) with
    the product ``mm`` (a core.precision.batch_mm); ek: (S, 1)."""
    n = r.shape[-1]
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    for it in ns_schedule:
        a = eye - mm(r, r)
        m = 2.0 * eye - a               # = I + r r
        for _ in range(it):
            m = mm(m, 2.0 * eye - mm(a, m))
        j1p = jp * ek
        j1m = jm * ek
        rp = mm(r, torch.cat([t, jp[..., None], j1m[..., None]], dim=-1))
        v1 = j1m + rp[..., n]           # j1m + r jp
        v2 = jp + rp[..., n + 1]        # jp  + r j1m
        pack2 = torch.cat([rp[..., :n], t, v1[..., None], v2[..., None]],
                          dim=-1)
        tp = mm(t, mm(m, pack2))        # t M [r t | t | v1 | v2]
        jm = jm + tp[..., 2 * n]
        jp = j1p + tp[..., 2 * n + 1]
        r = r + tp[..., :n]
        t = tp[..., n:2 * n]
        ek = ek * ek
    return r, t, jp, jm


def fused_layer_step_plain(comp: LayerRT, r_f, t, jp, jm_f, ek, d_vec, *,
                           ns_schedule, ni: int,
                           precision: str = "highest") -> LayerRT:
    """Plain torch version of the kernel: the same doubling, unflip and
    push-through adding, one batched matmul at a time, each in
    ``precision``."""
    return layer_step_body(comp, r_f, t, jp, jm_f, ek, d_vec, ns_schedule,
                           ni, batch_mm(check_mode(precision)))


def layer_step_body(comp: LayerRT, r_f, t, jp, jm_f, ek, d_vec, ns_schedule,
                    ni: int, mm) -> LayerRT:
    """fused_layer_step_plain's algebra with the product ``mm``."""
    r_f2, t2, jp2, jm_f2 = doubling_body(r_f, t, jp, jm_f, ek[:, None],
                                         ns_schedule, mm)
    d = d_vec[None, :]
    r2mp = d[:, :, None] * r_f2             # un-flip rows
    j2m = d * jm_f2
    sgn = d[:, :, None] * d[:, None, :]
    r2pm = sgn * r2mp
    t2mm = sgn * t2
    n = r2mp.shape[-1]
    eye = torch.eye(n, dtype=r2mp.dtype, device=r2mp.device)

    a1 = eye - mm(r2mp, comp.r_pm)
    w1 = mm(r2mp, torch.cat([comp.t_pp, comp.j_p[..., None]], dim=-1))
    v1 = w1[..., n] + j2m
    x1 = torch.cat([w1[..., :n], t2mm, v1[..., None]], dim=-1)
    w2 = mm(comp.r_pm, torch.cat([t2mm, j2m[..., None]], dim=-1))
    v2 = comp.j_p + w2[..., n]
    x2 = torch.cat([comp.t_pp, w2[..., :n], v2[..., None]], dim=-1)
    # one NS solve; the second interaction solve by push-through
    y = mm(ns_m(a1, ni, mm), torch.cat([x1, mm(r2mp, x2)], dim=-1))
    o1 = mm(comp.t_mm, y[..., :2 * n + 1])
    o2 = mm(t2, x2 + mm(comp.r_pm, y[..., 2 * n + 1:]))
    return LayerRT(r_mp=comp.r_mp + o1[..., :n],
                   r_pm=r2pm + o2[..., n:2 * n],
                   t_pp=o2[..., :n],
                   t_mm=o1[..., n:2 * n],
                   j_p=jp2 + o2[..., 2 * n],
                   j_m=comp.j_m + o1[..., 2 * n])


def ns_m_tangent(a, da, iters: int, mm, dmm):
    """ns_m and its tangent: M <- M (2I - A M) from M = 2I - A, and
    dM <- dM S + M dS with dS = -(dA M + A dM), ``dmm`` the tangent of
    ``mm``."""
    eye2 = 2.0 * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    m, dm = eye2 - a, -da
    for _ in range(iters):
        s, ds = eye2 - mm(a, m), -dmm(a, da, m, dm)
        m, dm = mm(m, s), dmm(m, dm, s, ds)
    return m, dm


def doubling_tangent_body(r, t, jp, jm, ek, dr, dt, djp, djm, dek,
                          ns_schedule, mm, dmm):
    """doubling_body and its tangent, term by term (the tangent kernel's
    algebra, csrc/layer_step_tangent.cu): the primals (S, ...), the
    tangents (K, S, ...) of K columns, ek and dek with a trailing axis of
    1; ``dmm`` the tangent of the product ``mm``
    (core.precision.batch_mm_tangent). Returns the doubled (r, t, jp, jm)
    and their tangents."""
    n = r.shape[-1]
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    for it in ns_schedule:
        m, dm = ns_m_tangent(eye - mm(r, r), -dmm(r, dr, r, dr), it, mm,
                             dmm)
        j1p, dj1p = jp * ek, djp * ek + jp * dek
        j1m, dj1m = jm * ek, djm * ek + jm * dek
        b = torch.cat([t, jp[..., None], j1m[..., None]], dim=-1)
        db = torch.cat([dt, djp[..., None], dj1m[..., None]], dim=-1)
        rp, drp = mm(r, b), dmm(r, dr, b, db)
        v1, dv1 = j1m + rp[..., n], dj1m + drp[..., n]
        v2, dv2 = jp + rp[..., n + 1], djp + drp[..., n + 1]
        pack2 = torch.cat([rp[..., :n], t, v1[..., None], v2[..., None]],
                          dim=-1)
        dpack2 = torch.cat([drp[..., :n], dt, dv1[..., None],
                            dv2[..., None]], dim=-1)
        w, dw = mm(m, pack2), dmm(m, dm, pack2, dpack2)
        tp, dtp = mm(t, w), dmm(t, dt, w, dw)
        jm, djm = jm + tp[..., 2 * n], djm + dtp[..., 2 * n]
        jp, djp = j1p + tp[..., 2 * n + 1], dj1p + dtp[..., 2 * n + 1]
        r, dr = r + tp[..., :n], dr + dtp[..., :n]
        t, dt = tp[..., n:2 * n], dtp[..., n:2 * n]
        ek, dek = ek * ek, dek * ek + ek * dek
    return r, t, jp, jm, dr, dt, djp, djm


def layer_step_tangent_body(comp: LayerRT, dcomp: LayerRT, r_f, t, jp, jm_f,
                            ek, d_vec, dr_f, dt, djp, djm_f, dek, dd,
                            ns_schedule, ni: int, mm, dmm) -> LayerRT:
    """The tangent of layer_step_body for K columns at once: the plain
    torch twin of the tangent kernel. Primals as layer_step_body takes
    them; their tangents stacked over K leading columns (dcomp's fields
    and dr_f, dt (K, S, N, N), djp, djm_f (K, S, N), dek (K, S), dd
    (K, N)). Every product A B of the primal becomes dA B + A dB by
    ``dmm`` (core.precision.batch_mm_tangent of the mode of ``mm``), every
    elementwise pass its derivative, the Newton-Schulz iterates' included:
    torch.func.jvp of the plain version, to rounding. Returns the output
    tangents (K, S, ...)."""
    r_f2, t2, jp2, jm_f2, dr_f2, dt2, djp2, djm_f2 = doubling_tangent_body(
        r_f, t, jp, jm_f, ek[..., None], dr_f, dt, djp, djm_f,
        dek[..., None], ns_schedule, mm, dmm)
    d, dd = d_vec[None, :], dd[..., None, :]
    r2mp = d[..., None] * r_f2
    dr2mp = dd[..., None] * r_f2 + d[..., None] * dr_f2
    j2m, dj2m = d * jm_f2, dd * jm_f2 + d * djm_f2
    sgn = d[..., :, None] * d[..., None, :]
    dsgn = (dd[..., :, None] * d[..., None, :]
            + d[..., :, None] * dd[..., None, :])
    dr2pm = dsgn * r2mp + sgn * dr2mp
    t2mm, dt2mm = sgn * t2, dsgn * t2 + sgn * dt2
    n = r2mp.shape[-1]
    eye = torch.eye(n, dtype=r2mp.dtype, device=r2mp.device)

    def cat(*xs):
        return torch.cat(xs, dim=-1)

    m, dm = ns_m_tangent(eye - mm(r2mp, comp.r_pm),
                         -dmm(r2mp, dr2mp, comp.r_pm, dcomp.r_pm), ni, mm,
                         dmm)
    b1 = cat(comp.t_pp, comp.j_p[..., None])
    db1 = cat(dcomp.t_pp, dcomp.j_p[..., None])
    w1, dw1 = mm(r2mp, b1), dmm(r2mp, dr2mp, b1, db1)
    v1, dv1 = w1[..., n] + j2m, dw1[..., n] + dj2m
    x1 = cat(w1[..., :n], t2mm, v1[..., None])
    dx1 = cat(dw1[..., :n], dt2mm, dv1[..., None])
    b2, db2 = cat(t2mm, j2m[..., None]), cat(dt2mm, dj2m[..., None])
    w2, dw2 = mm(comp.r_pm, b2), dmm(comp.r_pm, dcomp.r_pm, b2, db2)
    v2, dv2 = comp.j_p + w2[..., n], dcomp.j_p + dw2[..., n]
    x2 = cat(comp.t_pp, w2[..., :n], v2[..., None])
    dx2 = cat(dcomp.t_pp, dw2[..., :n], dv2[..., None])
    b3 = cat(x1, mm(r2mp, x2))
    db3 = cat(dx1, dmm(r2mp, dr2mp, x2, dx2))
    y, dy = mm(m, b3), dmm(m, dm, b3, db3)
    k = 2 * n + 1
    do1 = dmm(comp.t_mm, dcomp.t_mm, y[..., :k], dy[..., :k])
    x2b = x2 + mm(comp.r_pm, y[..., k:])
    dx2b = dx2 + dmm(comp.r_pm, dcomp.r_pm, y[..., k:], dy[..., k:])
    do2 = dmm(t2, dt2, x2b, dx2b)
    return LayerRT(r_mp=dcomp.r_mp + do1[..., :n],
                   r_pm=dr2pm + do2[..., n:2 * n],
                   t_pp=do2[..., :n],
                   t_mm=do1[..., n:2 * n],
                   j_p=djp2 + do2[..., 2 * n],
                   j_m=dcomp.j_m + do1[..., 2 * n])


def _plain_flat(r_mp, r_pm, t_pp, t_mm, j_p, j_m, r_f, t, jp, jm_f, ek,
                d_vec, ns_schedule, ni, precision):
    """fused_layer_step_plain on flat tensor arguments, as a tuple."""
    return tuple(fused_layer_step_plain(
        LayerRT(r_mp, r_pm, t_pp, t_mm, j_p, j_m), r_f, t, jp, jm_f, ek,
        d_vec, ns_schedule=ns_schedule, ni=ni, precision=precision))


class _FusedLayerStep(torch.autograd.Function):
    """The layer step with a forward-mode rule, as the JAX package's
    custom_jvp: the primal is the kernel (the plain version on CPU
    tensors); the tangent, at the same primals and precision mode, is
    _StepTangent (the tangent kernel, its twin on CPU tensors) inside the
    ``tangent`` span where tangent_on_kernel(N), else torch.func.jvp of the
    plain version (counted in ``plain_tangents``). Forward mode through
    torch.func (jvp, jacfwd). The vmap rule is generated, so the primal
    must be unbatched (jacfwd batches only the tangents, which _StepTangent's
    own vmap rule stacks into its K columns); vmapping over states reaches
    the launch with wrapped tensors and raises. No backward: reverse mode
    is not ported."""
    generate_vmap_rule = True

    @staticmethod
    def forward(*args):
        if args[6].device.type == "cpu":
            return _plain_flat(*args)
        return _launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:12])
        ctx.statics = inputs[12:]

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        if not tangent_on_kernel(primals[6].shape[-1]):
            global plain_tangents
            plain_tangents += 1
            return build.tangent_of_plain(_plain_flat, ctx, tangents[:12])
        with timeit("tangent"):
            tangents = [torch.zeros_like(p) if x is None else x
                        for p, x in zip(primals, tangents)]
            outs = _StepTangent.apply(*primals,
                                      *(x.unsqueeze(0) for x in tangents),
                                      *ctx.statics)
            return tuple(o.squeeze(0) for o in outs)


class _StepTangent(torch.autograd.Function):
    """The layer step's tangent for K columns: the 12 primals, their
    tangents with a leading axis of K columns, the statics; the six output
    tangents (K, S, ...). CUDA tensors launch the tangent kernel once for
    every column, CPU tensors take its plain torch twin
    (layer_step_tangent_body). Its vmap rule stacks jacfwd's batch of
    columns into K, so that a Jacobian launches once a layer step; a
    batched primal (a vmap over states) takes one call per state. No
    forward rule of its own: no second derivatives."""

    @staticmethod
    def forward(*args):
        prim, tan, statics = args[:12], args[12:24], args[24:]
        if prim[6].device.type == "cpu":
            ns_schedule, ni, precision = statics
            return tuple(layer_step_tangent_body(
                LayerRT(*prim[:6]), LayerRT(*tan[:6]), *prim[6:], *tan[6:],
                ns_schedule, ni, batch_mm(precision),
                batch_mm_tangent(precision)))
        return _launch_tangent(prim, tan, *statics)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        b = info.batch_size
        prim, tan, statics = args[:12], args[12:24], args[24:]

        def front(x, dim):
            return (x.expand(b, *x.shape) if dim is None
                    else x.movedim(dim, 0))
        tan = [front(x, dim) for x, dim in zip(tan, in_dims[12:24])]
        if all(dim is None for dim in in_dims[:12]):
            k = tan[0].shape[1]
            outs = _StepTangent.apply(
                *prim, *(x.reshape(b * k, *x.shape[2:]) for x in tan),
                *statics)
            return tuple(o.reshape(b, k, *o.shape[1:]) for o in outs), \
                (0,) * 6
        prim = [front(x, dim) for x, dim in zip(prim, in_dims[:12])]
        outs = [_StepTangent.apply(*(x[i] for x in prim),
                                   *(x[i] for x in tan), *statics)
                for i in range(b)]
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * 6


def _launch(r_mp, r_pm, t_pp, t_mm, j_p, j_m, r_f, t, jp, jm_f, ek, d_vec,
            ns_schedule, ni, precision):
    """One launch of the kernel on CUDA tensors; the new composite as a
    tuple of its six fields."""
    if r_f.device.type != "cuda":
        raise ValueError(f"unsupported device {r_f.device}")
    s, n, _ = r_f.shape
    mats = [r_mp, r_pm, t_pp, t_mm, r_f, t]
    vecs = [j_p, j_m, jp, jm_f]
    ins = [*mats[:4], *vecs[:2], r_f, t, jp, jm_f, ek, d_vec]
    build.check_operands("fused_layer_step", ins, r_f.device)
    if any(m.shape != (s, n, n) for m in mats) \
            or any(v.shape != (s, n) for v in vecs) \
            or ek.shape != (s,) or d_vec.shape != (n,):
        raise ValueError("fused_layer_step: inconsistent shapes")
    sched = build.schedule_array(ns_schedule)
    pts, smem, ld, _ = launch_config(n)
    if smem > build.MAX_SHARED_BYTES:
        raise ValueError(f"N = {n} needs {smem} bytes of shared memory per "
                         f"block, more than {build.MAX_SHARED_BYTES}")
    outs = [torch.empty_like(r_mp) for _ in range(4)] \
        + [torch.empty_like(j_p) for _ in range(2)]
    if s == 0:
        return tuple(outs)
    err = getattr(build.lib(), entry_point(precision, n))(
        *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
        s, n, ld, sched, len(ns_schedule), int(ni),
        build.mode_code(precision), pts, smem,
        torch.cuda.current_stream(r_f.device).cuda_stream)
    build.check(err, "layer_step launch")
    global launches
    launches += 1
    return tuple(outs)


def _launch_tangent(prim, tan, ns_schedule, ni, precision):
    """One launch of the tangent kernel on CUDA tensors for the K columns
    of ``tan`` (the 12 primals' tangents, each with a leading axis of K);
    the six output tangents (K, S, ...)."""
    r_f = prim[6]
    s, n, _ = r_f.shape
    k = tan[6].shape[0]
    tan = [x.contiguous() for x in tan]
    shapes = [(s, n, n)] * 4 + [(s, n)] * 2 + [(s, n, n)] * 2 \
        + [(s, n)] * 2 + [(s,), (n,)]
    build.check_operands("fused_layer_step", [*prim, *tan], r_f.device)
    if any(x.shape != sh for x, sh in zip(prim, shapes)) \
            or any(x.shape != (k, *sh) for x, sh in zip(tan, shapes)):
        raise ValueError("fused_layer_step tangent: inconsistent shapes")
    if not tangent_on_kernel(n):
        raise ValueError(f"N = {n}: the tangent kernel takes N <= 44")
    pts, smem, ld, _ = tangent_launch_config(n)
    outs = [torch.empty_like(x) for x in tan[:6]]
    if s == 0 or k == 0:
        return tuple(outs)
    err = build.lib().vsm_layer_step_tangent(
        *(x.data_ptr() for x in [*prim, *tan, *outs]), s, k, n, ld,
        build.schedule_array(ns_schedule), len(ns_schedule), int(ni),
        build.mode_code(precision), pts, smem,
        torch.cuda.current_stream(r_f.device).cuda_stream)
    build.check(err, "layer_step tangent launch")
    global tangent_launches
    tangent_launches += 1
    return tuple(outs)


def fused_layer_step(comp: LayerRT, r_f, t, jp, jm_f, ek, d_vec, *,
                     ns_schedule, ni: int,
                     precision: str = "highest") -> LayerRT:
    """One RT layer step: double the elemental (flipped-space) layer and
    compose it under the composite. comp: LayerRT of (S, N, N) x 4 and
    (S, N) x 2; r_f, t: (S, N, N); jp, jm_f: (S, N); ek: (S,); d_vec: (N,).
    ``ns_schedule``: per-doubling-step NS iteration counts; ``ni``: NS
    iterations of the interaction solve. ``precision``: the product mode,
    one of core.precision.MATMUL_MODES (the JAX kernel's
    ``precision_name``). Returns the new composite.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, no autograd) or raise. Differentiable in forward
    mode under torch.func.jvp/jacfwd (kernel primal, tangent kernel; see
    _FusedLayerStep); ``launches`` counts primal launches only,
    ``tangent_launches`` the tangent kernel's.
    """
    ns_schedule = tuple(int(i) for i in ns_schedule)
    check_mode(precision, MATMUL_MODES)
    return LayerRT(*_FusedLayerStep.apply(*comp, r_f, t, jp, jm_f, ek,
                                          d_vec, ns_schedule, int(ni),
                                          precision))
