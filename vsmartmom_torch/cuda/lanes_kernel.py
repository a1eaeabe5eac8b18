"""Lanes-layout RT layer step (doubling + adding) — CUDA kernel and plain
version.

Replaces the TPU kernel ``vsmartmom/pallas/lanes_kernel.py:_lanes_kernel``
(body ``lanes_layer_step_math``), reached from ``fused_layer_step_lanes``.
The composite and the elemental layer are in lanes layout, matrices
(N, N, S) and vectors (N, S), the spectral points on the contiguous axis;
the composite stays in this layout across the whole layer scan (convert
once with ``to_lanes_m`` / ``from_lanes_m``). Algebra: the scheduled
Newton-Schulz doubling and the two-solve interaction with ``tt`` never
materialized, as the TPU body associates them.

What bounds it on Hopper: per point a chain of small dependent N x N fp32
products, O(N^3) FMAs against O(N^2) bytes of device memory. The TPU kernel
put the points on the 128-lane axis so that a product became N broadcast
FMAs (there Mosaic scalarized them). Here the layout stays at the kernel's
boundary only, and the width picks one of two paths (csrc/lanes.cu):
- N <= TEAM_MAX_N (63): the team kernel, the layer step's design
  (``layer_step_kernel``) on the team helpers of csrc/rt_device.cuh. A team
  of whole warps per point owns the point's shared-memory arena (the
  doubling arena, whose packed operands the interaction reuses, then c_rpm
  and c_tmm) and runs register-tiled fp32 products with fused stores; the
  loads and stores address the lanes layout directly, the teams of a block
  on consecutive points sharing its sectors. No device-memory workspace.
- 64 <= N <= WIDE_MAX_N (136): the wide path. A point's team arena no
  longer fits a block, so the step runs on six n x n slots (c_rpm and
  c_tpp read again from device memory where a solve needs their slots)
  held by a cluster of 1 or 2 CTAs (``wide_launch_config``): each CTA
  owns a row slab of every slot and reads the other CTAs' rows of a
  product's right operand through distributed shared memory. Products are
  the team kernels' float4 register tiles of fp32 FMA (4 x 4; 8 x 4 in a
  cluster of 2). No device-memory workspace; wider N raises ValueError.
Both paths raise on a failed launch and count in ``launches``.

The plain version (``lanes_layer_step_plain``) is the port of
``lanes_layer_step_math``, taking the wrapper's arguments. The wrapper
takes it only for CPU tensors; for CUDA tensors it launches the kernel or
raises. Forward only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vsmartmom_torch.core.rt import LayerRT
from vsmartmom_torch.cuda import build, layer_step_kernel

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0


def to_lanes_m(x):
    """(S, N, N) -> (N, N, S), contiguous"""
    return x.permute(1, 2, 0).contiguous()


def from_lanes_m(x):
    """(N, N, S) -> (S, N, N), contiguous"""
    return x.permute(2, 0, 1).contiguous()


def to_lanes_v(v):
    """(S, N) -> (N, S), contiguous"""
    return v.t().contiguous()


def from_lanes_v(v):
    """(N, S) -> (S, N), contiguous"""
    return v.t().contiguous()


def to_lanes(comp: LayerRT) -> LayerRT:
    """A composite in lanes layout."""
    return LayerRT(*(to_lanes_m(m) for m in comp[:4]),
                   *(to_lanes_v(v) for v in comp[4:]))


def from_lanes(comp_l: LayerRT) -> LayerRT:
    """A lanes-layout composite back in (S, N, N) / (S, N) layout."""
    return LayerRT(*(from_lanes_m(m) for m in comp_l[:4]),
                   *(from_lanes_v(v) for v in comp_l[4:]))


#: widest N the team kernel takes (the layer step's range,
#: ``core.rt_run.KERNEL_MAX_N``); wider N takes the wide path
TEAM_MAX_N = 63


def team_path(n: int) -> bool:
    """Whether width n launches the team kernel (else the wide path)."""
    return n <= TEAM_MAX_N


def arena_floats(n: int, ld: int) -> int:
    """Shared-memory floats one point of the team kernel uses at row stride
    ld (must match ``lanes_arena_floats`` in csrc/lanes.cu): the doubling
    arena, whose W1, W2 hold the interaction's X, X2 (2 n round4(2n + 1)
    floats), then c_rpm and c_tmm (2 n ld)."""
    return build.doubling_arena_floats(n, ld) + 2 * n * ld


def launch_config(n: int) -> build.TeamLaunch:
    """The team kernel's teams per block, dynamic shared-memory bytes, row
    stride and team threads at width n (the block shares the D diagonal,
    round4(n) floats)."""
    return build.team_launch_config(n, arena_floats, build.round4(n))


#: cluster sizes of the wide path, smallest first (csrc/lanes.cu
#: instantiates lanes_wide_kernel<1> and <2>)
WIDE_CLUSTERS = (1, 2)
#: whole vectors in a wide CTA's arena (kWideVecs in csrc/lanes.cu)
WIDE_VECTORS = 8
#: by cluster size (WIDE_CLUSTERS): rows of a thread's register tile and
#: threads a CTA may have (WideTile<CS> in csrc/lanes.cu)
WIDE_TILE_ROWS = (4, 8)
WIDE_MAX_THREADS = (576, 320)
#: widest N the wide path takes (the arena of a cluster of 2 at N = 137 no
#: longer fits a block)
WIDE_MAX_N = 136


class WideLaunch(NamedTuple):
    """The wide path's launch: CTAs a point (one cluster), rows each CTA
    owns, the slots' row stride, threads a CTA and dynamic shared-memory
    bytes a CTA."""
    cluster: int
    rows: int
    ld: int
    threads: int
    smem_bytes: int


def wide_arena_floats(n: int, rows: int, ld: int) -> int:
    """Shared-memory floats of one wide CTA (must match
    ``wide_arena_floats`` in csrc/lanes.cu): six slots of ``rows`` rows at
    row stride ld, then WIDE_VECTORS whole vectors of round4(n)."""
    return 6 * rows * ld + WIDE_VECTORS * build.round4(n)


def wide_launch_config(n: int) -> WideLaunch:
    """The wide path's launch at width n: the smallest cluster of
    WIDE_CLUSTERS whose CTAs' arenas fit a block, each CTA owning rows
    (n for one CTA, else a multiple of 4 with every CTA owning some), the
    row stride ld = 4 mod 8 where that fits (float4 rows on distinct banks)
    else round4(n), and one thread per output tile of the CTA's rows
    (WIDE_TILE_ROWS x 4), in whole warps. Raises ValueError beyond
    WIDE_MAX_N."""
    for cs, tm, most in zip(WIDE_CLUSTERS, WIDE_TILE_ROWS,
                            WIDE_MAX_THREADS):
        rows = n if cs == 1 else build.round4(-(-n // cs))
        if (cs - 1) * rows >= n:
            continue
        for ld in (n + (4 - n) % 8, build.round4(n)):
            smem = 4 * wide_arena_floats(n, rows, ld)
            if smem <= build.MAX_SHARED_BYTES:
                tiles = -(-rows // tm) * -(-n // 4)
                return WideLaunch(cs, rows, ld,
                                  min(most, 32 * -(-tiles // 32)), smem)
    raise ValueError(f"N = {n}: the lanes step's wide path takes N <= "
                     f"{WIDE_MAX_N}")


#: device-memory bytes of one point's step: the layer step's operands in
#: another layout (composite and elemental in, composite out)
step_bytes = layer_step_kernel.step_bytes


def step_flops(n: int, ns_schedule, ni: int) -> int:
    """Matrix-product FLOPs of one point's lanes layer step (2 n^2 k per
    (n x n) @ (n x k) product): per doubling step r r, the NS iterations,
    r t, M (r t), t (.), M t, t (.) and six matrix-vector products; the
    interaction's two solves and their products."""
    dbl = sum(2 * n ** 3 * (6 + 2 * it) + 12 * n * n for it in ns_schedule)
    return dbl + 2 * n ** 3 * (12 + 4 * ni) + 12 * n * n


def _mm(a, b):
    """(N, N, S) @ (N, N, S) pointwise over the points."""
    return torch.einsum("iks,kjs->ijs", a, b)


def _mv(a, v):
    """(N, N, S) @ (N, S) -> (N, S)"""
    return torch.einsum("iks,ks->is", a, v)


def _ns_m(a, eye, iters: int):
    """Newton-Schulz inverse of A = I - B (rho(B) < 1)."""
    eye2 = 2.0 * eye
    m = eye2 - a
    for _ in range(iters):
        m = _mm(m, eye2 - _mm(a, m))
    return m


def lanes_layer_step_plain(comp_l: LayerRT, r, t, jp, jm, ek, d_vec, *,
                           ns_schedule, ni: int) -> LayerRT:
    """Plain torch version of the kernel (the TPU body
    lanes_layer_step_math, same association), on the wrapper's arguments:
    comp_l in lanes layout, r, t: (N, N, S); jp, jm: (N, S); ek: (S,);
    d_vec: (N,)."""
    n = r.shape[0]
    eye = torch.eye(n, dtype=r.dtype, device=r.device)[:, :, None]
    ek = ek[None, :]
    d = d_vec[:, None]
    c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm = comp_l

    # --- 1. doubling (flipped space) ---
    for it in ns_schedule:
        a = eye - _mm(r, r)
        m = _ns_m(a, eye, int(it))
        j1p = jp * ek
        j1m = jm * ek
        v1 = j1m + _mv(r, jp)
        v2 = jp + _mv(r, j1m)
        # tt @ X = t @ (M @ X), tt never materialized
        rt_ = _mm(r, t)
        r = r + _mm(t, _mm(m, rt_))
        jm = jm + _mv(t, _mv(m, v1))
        jp = j1p + _mv(t, _mv(m, v2))
        t = _mm(t, _mm(m, t))
        ek = ek * ek

    r2mp = d[:, :, None] * r             # un-flip rows
    j2m = d * jm
    sgn = d[:, None, :] * d[None, :, :]
    r2pm = sgn * r2mp
    t2mm = sgn * t

    # --- 2. interaction ---
    a1 = eye - _mm(r2mp, c_rpm)
    m1 = _ns_m(a1, eye, int(ni))
    o_jm = c_jm + _mv(c_tmm, _mv(m1, _mv(r2mp, c_jp) + j2m))
    o_rmp = c_rmp + _mm(c_tmm, _mm(m1, _mm(r2mp, c_tpp)))
    o_tmm = _mm(c_tmm, _mm(m1, t2mm))

    a2 = eye - _mm(c_rpm, r2mp)
    m2 = _ns_m(a2, eye, int(ni))
    o_jp = jp + _mv(t, _mv(m2, c_jp + _mv(c_rpm, j2m)))
    o_tpp = _mm(t, _mm(m2, c_tpp))
    o_rpm = r2pm + _mm(t, _mm(m2, _mm(c_rpm, t2mm)))
    return LayerRT(o_rmp, o_rpm, o_tpp, o_tmm, o_jp, o_jm)


def fused_layer_step_lanes(comp_l: LayerRT, r_f, t, jp, jm_f, ek, d_vec, *,
                           ns_schedule, ni: int) -> LayerRT:
    """One RT layer step in lanes layout. comp_l: LayerRT of (N, N, S) x 4
    and (N, S) x 2; r_f, t: (N, N, S); jp, jm_f: (N, S); ek: (S,);
    d_vec: (N,). ``ns_schedule``: per-doubling-step NS iteration counts;
    ``ni``: NS iterations of the interaction solves. Returns the new
    composite in lanes layout.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, no autograd) or raise; under a torch.func
    transform they raise NotImplementedError (no forward rule).
    """
    ns_schedule = tuple(int(i) for i in ns_schedule)
    if r_f.device.type == "cpu":
        return lanes_layer_step_plain(comp_l, r_f, t, jp, jm_f, ek, d_vec,
                                      ns_schedule=ns_schedule, ni=int(ni))
    if r_f.device.type != "cuda":
        raise ValueError(f"unsupported device {r_f.device}")
    n, _, s = r_f.shape
    mats = [*comp_l[:4], r_f, t]
    vecs = [*comp_l[4:], jp, jm_f]
    ins = [*comp_l, r_f, t, jp, jm_f, ek, d_vec]
    build.check_operands("fused_layer_step_lanes", ins, r_f.device)
    if any(m.shape != (n, n, s) for m in mats) \
            or any(v.shape != (n, s) for v in vecs) \
            or ek.shape != (s,) or d_vec.shape != (n,):
        raise ValueError("fused_layer_step_lanes: inconsistent shapes")
    outs = [torch.empty_like(r_f) for _ in range(4)] \
        + [torch.empty_like(jp) for _ in range(2)]
    if s == 0:
        return LayerRT(*outs)
    build.check(_launch(ins, outs, ns_schedule, int(ni),
                        torch.cuda.current_stream(r_f.device).cuda_stream),
                "lanes launch")
    global launches
    launches += 1
    return LayerRT(*outs)


def _launch(ins, outs, ns_schedule, ni: int, stream) -> int:
    """Launch the team kernel (N <= TEAM_MAX_N) or the wide path on the
    checked operands; returns the launch's cudaError_t."""
    n, _, s = ins[6].shape
    ptrs = [x.data_ptr() for x in (*ins, *outs)]
    sched = build.schedule_array(ns_schedule)
    if team_path(n):
        pts, smem, ld, _ = launch_config(n)
        return build.lib().vsm_lanes(*ptrs, s, n, ld, sched,
                                     len(ns_schedule), ni, pts, smem, stream)
    cs, rows, ld, threads, smem = wide_launch_config(n)
    return build.lib().vsm_lanes_wide(*ptrs, s, n, cs, rows, ld, threads,
                                      sched, len(ns_schedule), ni, smem,
                                      stream)
