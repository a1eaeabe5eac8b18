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
against the O(N^3) work. Design (csrc/layer_step_dev.cu on the team helpers
of csrc/rt_device.cuh, the layer step's design): a team of whole warps per
point owns the point's arena (state, the Y-form NS iterates, packed
operands, the composite's c_rpm, [c_epp | c_jp] and c_emm) for the whole
step and synchronises only itself; products are register-tiled with the
elementwise passes fused into their stores, and the new composite is stored
straight from the last products. The tile classes are the layer step's four
for N <= 64 and a fifth, NP = 80, for N = 65 .. 75. Every arena slot is a
square of row stride ld >= N + 2 (E's slot carries jp and j1m as two more
columns); the composite's squares are staged into slots the doubling
frees. A block holds as many teams as half an SM's shared memory takes
(N = 15: 10 points of 11 KB; N = 44: one point of 81 KB; N = 75: one of
223 KB). ``precision`` is the JAX kernel's ``precision_name``
(core/precision.py): "bf16x3" (three bf16 passes, the default here as in
JAX: no operand carries the ~1.0 direct diagonal), "highest" (full fp32)
or "default" (one bf16 pass). "bf16x3" launches the body with every
product on the tensor cores (``layer_step_dev_tc_kernel``: mma.sync
m16n8k16 bf16, fp32 accumulation; ``tc_plan``), whose sums follow the
tensor cores' order, not the fmaf chain. "highest" and "default" launch
the body on the CUDA cores (``layer_step_dev_kernel``: the plain version's
fmaf chains bit for bit, "default" with each loaded operand rounded to
bf16): "default" keeps no low part, so a sum in another order flips some
of its later bf16 roundings by 2^-8 and moved its outputs by up to 3e-4
of max on an H100 (``entry_point``). Every sum outside a product rounds as the plain
version's torch ops. The ragged last block is masked in the kernel.

The plain version (``fused_layer_step_dev_plain``) is the JAX package's
``_xla_twin_step_dev`` on the port's torch functions. The wrapper takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Forward mode only: under torch.func.jvp/jacfwd the kernel computes the
primal and the plain version's jvp the tangent (the JAX package's
custom_jvp); no backward.
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core.precision import DD_MODES, batch_mm, check_mode
from vsmartmom_torch.core.rt import LayerRTDev, doubling_dev, interaction_dev
from vsmartmom_torch.cuda import build

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0


def arena_floats(n: int, ld: int) -> int:
    """Shared-memory floats one spectral point uses at row stride ld (must
    match ``DevArena`` in csrc/layer_step_dev.cu): R and two E slots, g, jp,
    jm and c_g (round4(n) each), then six scratch squares, which also take
    the composite's c_rpm, [c_epp | c_jp] and c_emm once the doubling is
    done."""
    return 9 * n * ld + 4 * build.round4(n)


def launch_config(n: int) -> build.TeamLaunch:
    """Teams per block, dynamic shared-memory bytes, row stride (>= n + 2)
    and team threads at stream count n (the block shares the D diagonal,
    round4(n) floats)."""
    if not 1 <= n <= max_n():
        raise ValueError(f"N = {n}: the split-form kernel takes "
                         f"1 <= N <= {max_n()}")
    return build.team_launch_config(n, arena_floats, build.round4(n),
                                    min_ld=n + 2,
                                    classes=build.DEV_TILE_CLASSES)


def entry_point(precision: str) -> str:
    """The launch entry of a product mode: ``vsm_layer_step_dev_tc`` (the
    tensor-core body) for "bf16x3", ``vsm_layer_step_dev`` (the body on the
    CUDA cores) for "highest" and "default"."""
    check_mode(precision, DD_MODES)
    return ("vsm_layer_step_dev_tc" if precision == "bf16x3"
            else "vsm_layer_step_dev")


def product_widths(n: int) -> tuple:
    """The column counts k of the step's (n x n) @ (n x k) products."""
    return (n, n + 1, n + 2, 2 * n + 1, 2 * n + 2)


#: the tensor-core kernel's block bound by padded width NP
#: (``tc_block_bound`` in csrc/layer_step_dev.cu): a launch of more threads
#: fails
TC_BLOCK_BOUND = {16: 512, 32: 512, 48: 384, 64: 256, 80: 320}


def tc_plan(n: int) -> build.TensorCorePlan:
    """The tensor-core body's plan at stream count n (1 <= n <= max_n();
    build.tensor_core_plan over launch_config and product_widths)."""
    return build.tensor_core_plan(n, launch_config(n), product_widths(n),
                                  build.DEV_TILE_CLASSES)


def max_n() -> int:
    """Largest stream count N the kernel takes. The fifth tile class
    (NP = 80) and the arena would reach N = 78; chip_smoke.py checks the
    kernel up to 75."""
    return 75


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
                               ek, d_vec, *, ns_schedule, ni: int,
                               precision: str = "bf16x3") -> LayerRTDev:
    """Plain torch version of the kernel: split-form doubling, unflip and
    interaction_dev, one batched matmul at a time, each in ``precision``."""
    mm = batch_mm(check_mode(precision, DD_MODES))
    r_f2, g2, e2, jp2, jm_f2 = doubling_dev(
        r_f, g_el, e_el, jp, jm_f, ek, ns_schedule=tuple(ns_schedule),
        ndoubl=len(ns_schedule), mm=mm)
    r_mp = d_vec[None, :, None] * r_f2
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    added = LayerRTDev(r_mp=r_mp, r_pm=sgn * r_mp, e_pp=e2, e_mm=sgn * e2,
                       g=g2, j_p=jp2, j_m=d_vec[None, :] * jm_f2)
    return interaction_dev(comp, added, ni=int(ni), mm=mm)


def _plain_flat(r_mp, r_pm, e_pp, e_mm, g, j_p, j_m, r_f, g_el, e_el, jp,
                jm_f, ek, d_vec, ns_schedule, ni, precision):
    """fused_layer_step_dev_plain on flat tensor arguments, as a tuple."""
    return tuple(fused_layer_step_dev_plain(
        LayerRTDev(r_mp, r_pm, e_pp, e_mm, g, j_p, j_m), r_f, g_el, e_el,
        jp, jm_f, ek, d_vec, ns_schedule=ns_schedule, ni=ni,
        precision=precision))


class _FusedLayerStepDev(torch.autograd.Function):
    """The split-form layer step with a forward-mode rule, as the JAX
    package's custom_jvp: kernel primal (the plain version on CPU
    tensors), tangent torch.func.jvp of the plain version at the same
    primals. torch.func only, unbatched primals, no backward: see
    layer_step_kernel._FusedLayerStep."""
    generate_vmap_rule = True

    @staticmethod
    def forward(*args):
        if args[7].device.type == "cpu":
            return _plain_flat(*args)
        return _launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:14])
        ctx.statics = inputs[14:]

    @staticmethod
    def jvp(ctx, *tangents):
        return build.tangent_of_plain(_plain_flat, ctx, tangents[:14])


def _launch(r_mp, r_pm, e_pp, e_mm, g, j_p, j_m, r_f, g_el, e_el, jp, jm_f,
            ek, d_vec, ns_schedule, ni, precision):
    """One launch of the kernel on CUDA tensors; the new composite as a
    tuple of its seven fields."""
    if r_f.device.type != "cuda":
        raise ValueError(f"unsupported device {r_f.device}")
    s, n, _ = r_f.shape
    mats = [r_mp, r_pm, e_pp, e_mm, r_f, e_el]
    vecs = [g, j_p, j_m, g_el, jp, jm_f]
    ins = [*mats[:4], *vecs[:3], r_f, g_el, e_el, jp, jm_f, ek, d_vec]
    build.check_operands("fused_layer_step_dev", ins, r_f.device)
    if any(m.shape != (s, n, n) for m in mats) \
            or any(v.shape != (s, n) for v in vecs) \
            or ek.shape != (s,) or d_vec.shape != (n,):
        raise ValueError("fused_layer_step_dev: inconsistent shapes")
    sched = build.schedule_array(ns_schedule)
    pts, smem, ld, _ = launch_config(n)
    outs = [torch.empty_like(r_mp) for _ in range(4)] \
        + [torch.empty_like(j_p) for _ in range(3)]
    if s == 0:
        return tuple(outs)
    err = getattr(build.lib(), entry_point(precision))(
        *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
        s, n, ld, sched, len(ns_schedule), int(ni),
        build.mode_code(precision), pts, smem,
        torch.cuda.current_stream(r_f.device).cuda_stream)
    build.check(err, "layer_step_dev launch")
    global launches
    launches += 1
    return tuple(outs)


def fused_layer_step_dev(comp: LayerRTDev, r_f, g_el, e_el, jp, jm_f, ek,
                         d_vec, *, ns_schedule, ni: int,
                         precision: str = "bf16x3") -> LayerRTDev:
    """One split-form RT layer step. comp: LayerRTDev of (S, N, N) x 4 and
    (S, N) x 3; r_f, e_el: (S, N, N); g_el, jp, jm_f: (S, N); ek: (S,);
    d_vec: (N,). ``ns_schedule``: per-doubling-step NS iteration counts;
    ``ni``: NS iterations of the interaction solve. ``precision``: the
    product mode, one of core.precision.DD_MODES, "bf16x3" by default as
    the JAX kernel's ``precision_name`` (rt_run_band passes "highest" unless
    asked otherwise). Returns the new composite.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, contiguous, no autograd, N <= max_n()) or raise.
    Differentiable in forward mode under torch.func.jvp/jacfwd (kernel
    primal, plain-version tangent); ``launches`` counts primal launches
    only.
    """
    ns_schedule = tuple(int(i) for i in ns_schedule)
    check_mode(precision, DD_MODES)
    return LayerRTDev(*_FusedLayerStepDev.apply(
        *comp, r_f, g_el, e_el, jp, jm_f, ek, d_vec, ns_schedule, int(ni),
        precision))
