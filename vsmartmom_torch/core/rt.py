"""Doubling-adding RT core (elemental / doubling / interaction) in torch.

Port of the plain (not split) form of ``vsmartmom/core/rt.py``
(ref: src/CoreRT/CoreKernel/{elemental,doubling,interaction}.jl). Arrays are
batch-leading ``(nSpec, N, N)`` so every product is one batched matmul over
the spectral axis; explicit inverses are replaced by batched LU solves or
Newton-Schulz iterations. The D-matrix symmetry (sign flips of the U/V
Stokes components) uses the exact D = diag(1, 1, -1, -1).

Layer state convention: R/T are (nSpec, N, N); source vectors J are (nSpec, N).
Step counts are host integers: torch runs eagerly, so a data-dependent
doubling count is read back once per layer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LayerRT(NamedTuple):
    """Reflection/transmission operator of a (composite or added) slab.

    r_mp = R^-+ (illuminated from top, reflected up), r_pm = R^+-,
    t_pp = T^++ (downward transmission), t_mm = T^--,
    j_p = J0^+ (downwelling source), j_m = J0^- (upwelling source).
    ref: src/CoreRT/types.jl:108-141 (AddedLayer / CompositeLayer)
    """
    r_mp: torch.Tensor
    r_pm: torch.Tensor
    t_pp: torch.Tensor
    t_mm: torch.Tensor
    j_p: torch.Tensor
    j_m: torch.Tensor


def vacuum_layer(n_spec: int, n: int, dtype, device) -> LayerRT:
    """Identity (empty-space) slab: interaction with it is a no-op copy.
    Every field is its own contiguous tensor (the layer-step kernel takes
    contiguous operands only)."""
    def eye():
        return torch.eye(n, dtype=dtype, device=device).repeat(n_spec, 1, 1)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LayerRT(zeros(n_spec, n, n), zeros(n_spec, n, n), eye(), eye(),
                   zeros(n_spec, n), zeros(n_spec, n))


# --- batched linear algebra helpers -----------------------------------------

def bmm(a, b):
    """Batched matrix product over the leading spectral axis."""
    return torch.matmul(a, b)


def bmv(a, v):
    """Batched matrix-vector product."""
    return torch.matmul(a, v.unsqueeze(-1)).squeeze(-1)


def rsolve_lu(x, a):
    """Compute X @ A^{-1} via batched LU solve (never form the inverse)."""
    return torch.linalg.solve(a.transpose(-1, -2),
                              x.transpose(-1, -2)).transpose(-1, -2)


def _lu_apply(left, a, x):
    return bmm(rsolve_lu(left, a), x)


# (left @ A^{-1}) @ x with solver-chosen association: callers concatenate
# several right-hand operands into one x.
rsolve_lu.apply = _lu_apply


def make_rsolve(solver: str = "lu", schulz_iters: int = 4):
    """Right-solve factory: X @ A^{-1} for A = I - B with spectral radius
    rho(B) < 1 (guaranteed for passive media: B is a product of reflection
    operators).

    'lu'     — batched LU solve.
    'schulz' — Newton-Schulz iteration, pure batched matmuls.
               M_0 = 2I - A (= I + B); residual after k iterations is
               B^(2^(k+1)): 4 iterations leave B^32.
    """
    if solver == "lu":
        return rsolve_lu
    if solver != "schulz":
        raise ValueError(f"unknown solver {solver!r}")

    def _schulz_m(a):
        n = a.shape[-1]
        eye2 = 2.0 * torch.eye(n, dtype=a.dtype, device=a.device)
        m = eye2 - a                        # I + B
        for _ in range(schulz_iters):
            m = bmm(m, eye2 - bmm(a, m))
        return m

    def rsolve_schulz(x, a):
        return bmm(x, _schulz_m(a))

    def _schulz_apply(left, a, x):
        # left @ (M @ x): the wide packed operand x rides both passes
        # instead of materializing the n-wide left @ M
        return bmm(left, bmm(_schulz_m(a), x))

    rsolve_schulz.apply = _schulz_apply
    return rsolve_schulz


def ns_iters_for_bound(b: float, tol: float = 1e-8, cap: int = 4) -> int:
    """Newton-Schulz iterations needed to solve (I - B)^-1 with
    rho(B) <= b: residual after i iterations is B^(2^(i+1))."""
    if b <= 0:
        return 0
    if b >= 1:
        return cap
    need = np.log(tol) / np.log(b)          # want 2^(i+1) >= need
    return min(cap, max(0, int(np.ceil(np.log2(max(need, 1.0)))) - 1))


def ns_doubling_schedule(tau_scat_bound: float, min_qp_mu: float,
                         ndoubl: int, tol: float = 1e-8,
                         cap: int = 4) -> tuple:
    """Per-doubling-step Newton-Schulz iteration counts.

    At step k the slab has scattering depth tau_k = bound / 2^(nd-k); its
    reflection operator is bounded by the worst-node plane albedo
    ||r|| <= 1 - exp(-2 tau_k / mu_min), so rho(r r) <= that squared.
    Early (thin) steps need 0-1 iterations; only the last few need the
    full count (residual kept below f32 rounding).
    """
    sched = []
    for k in range(ndoubl):
        tau_k = tau_scat_bound / 2.0 ** (ndoubl - k)
        r_bound = -np.expm1(-2.0 * tau_k / min_qp_mu)
        sched.append(ns_iters_for_bound(r_bound * r_bound, tol, cap))
    return tuple(sched)


def ns_interaction_iters(tau_scat, min_qp_mu: float, tol: float = 1e-8,
                         cap: int = 4) -> tuple:
    """Per-layer Newton-Schulz iteration counts for the interaction solve.

    The layer scan runs TOA -> BOA: composing the composite (all layers
    above z) with added layer z solves (I - r_z R_comp)^{-1}. Its spectral
    radius is bounded by the product of the two plane albedos,
      ||r_z||     <= 1 - exp(-2 tau_z / mu_min)          (added slab)
      ||R_comp||  <= 1 - exp(-2 sum_{z'<z} tau_z' / mu_min)  (stack above).
    The layer with a VACUUM composite needs 0 exactly (A = I).

    ``tau_scat``: per-layer scattering optical depth bounds, TOA first
    (host numpy). Returns a tuple of Python ints.
    """
    tau_scat = np.maximum(np.asarray(tau_scat, dtype=float), 0.0)
    tau_above = np.concatenate([[0.0], np.cumsum(tau_scat)[:-1]])
    r_add = -np.expm1(-2.0 * tau_scat / min_qp_mu)
    r_comp = -np.expm1(-2.0 * tau_above / min_qp_mu)
    return tuple(ns_iters_for_bound(float(ra * rc), tol, cap)
                 for ra, rc in zip(r_add, r_comp))


# --- doubling count (ref: src/CoreRT/tools/rt_helper_functions.jl:31-57) ----

def doubling_number(dtau_max, tau_end) -> int:
    """Number of doublings to grow an elemental layer of <= dtau_max to
    tau_end (0-dim tensors), as a host integer."""
    eps = torch.finfo(tau_end.dtype).eps
    tlimit = torch.log2(tau_end / dtau_max)
    nlimit = torch.floor(tlimit)
    ndoubl = torch.where(tlimit - nlimit < eps, nlimit, nlimit + 1.0)
    ndoubl = torch.where(tau_end <= dtau_max, torch.zeros_like(ndoubl),
                         ndoubl)
    return int(torch.clamp_min(ndoubl, 0.0).item())


# --- elemental single-scattering layer --------------------------------------

def exp_small(x):
    """e^x for the tiny per-step arguments of the elemental layer:
    1 + expm1(x) is correctly rounded near zero and algebraically
    identical, so the doubling recursion does not compound exp's rounding.
    Large-argument exponentials (tau_sum attenuation) keep plain exp."""
    return 1.0 + torch.expm1(x)


def elemental(dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
              i0_vec, i_mu0_n, n_stokes, mu0_node):
    """Single-scattering initialization of an elemental layer.

    ref: src/CoreRT/CoreKernel/elemental.jl:164-253 (get_elem_rt!/..._SFI!).

    dtau, omega, tau_sum: (nSpec,); z_pp/z_mp: (nSpec|1, N, N);
    qp, wct2: (N,); i0_vec: (N,) incident Stokes vector embedded at the solar
    node block; mu0_node: 0-dim tensor, qp[i_mu0_n].
    Returns r_mp, t_pp (nSpec, N, N) and j_p, j_m (nSpec, N).
    """
    n = qp.shape[0]
    n_sp = dtau.shape[0]
    dt = dtau[:, None, None]
    om = omega[:, None, None]
    mu_i = qp[:, None]
    mu_j = qp[None, :]
    same_mu = mu_i == mu_j
    eye = torch.eye(n, dtype=torch.bool, device=qp.device)
    col_mask = wct2 > 1e-8

    exp_i = exp_small(-dtau[:, None, None] / mu_i)     # (nSpec, N, 1)

    # R^-+(mu_i, mu_j) =
    #   w Z^-+ (mu_j/(mu_i+mu_j)) w_j (1 - e^{-dt(1/mu_i+1/mu_j)})
    # expm1 keeps full precision for the tiny dtau of elemental layers.
    r_mp = (om * z_mp * (mu_j / (mu_i + mu_j)) * wct2[None, None, :]
            * (-torch.expm1(-dt * (1.0 / mu_i + 1.0 / mu_j))))
    r_mp = torch.where(col_mask[None, None, :], r_mp, 0.0)

    # T^++ diagonal: e^{-dt/mu_i}(1 + w Z^++_ii (dt/mu_i) w_i)
    e_diag = exp_i * (om * z_pp * (dt / mu_i) * wct2[None, None, :])
    t_diag = exp_i + e_diag
    # T^++ off-diagonal (mu_i != mu_j):
    # e^{-dt/mu_i} - e^{-dt/mu_j} = e^{-dt/mu_j} expm1(dt/mu_j - dt/mu_i),
    # the expm1 argument as ONE subtraction of exact node values.
    denom = torch.where(same_mu, 1.0, mu_i - mu_j)
    exp_diff = (exp_small(-dt / mu_j)
                * torch.expm1(dt * (mu_i - mu_j) / (mu_i * mu_j)))
    t_off = om * z_pp * (mu_j / denom) * wct2[None, None, :] * exp_diff
    t_pp = torch.where(same_mu[None, :, :],
                       torch.where(eye[None, :, :], t_diag, 0.0),
                       t_off)
    # Zero-weight (camera-only) columns transmit the attenuated beam only
    t_pp = torch.where(col_mask[None, None, :], t_pp,
                       torch.where(eye[None, :, :],
                                   exp_i * torch.ones_like(t_pp), 0.0))

    # --- SFI solar source vectors (Fell eqs. 1.52-1.54) ---
    z_pp_i0 = bmv(z_pp.expand(n_sp, n, n), i0_vec.expand(n_sp, n))
    z_mp_i0 = bmv(z_mp.expand(n_sp, n, n), i0_vec.expand(n_sp, n))

    idx = torch.arange(n, device=qp.device)
    in_block = (idx >= i_mu0_n) & (idx < i_mu0_n + n_stokes)

    mu_iv = qp[None, :]
    dt_v = dtau[:, None]
    exp_iv = exp_small(-dt_v / mu_iv)
    # degenerate limit for the solar block AND any node whose mu coincides
    # with mu0 (the mu_i - mu0 division would produce inf * 0 = NaN)
    same0 = in_block[None, :] | (mu_iv == mu0_node)
    denom0 = torch.where(same0, 1.0, mu_iv - mu0_node)
    exp_diff0 = (exp_small(-dt_v / mu0_node)
                 * torch.expm1(dt_v * (mu_iv - mu0_node)
                               / (mu_iv * mu0_node)))
    j_p = torch.where(same0, (dt_v / mu_iv) * exp_iv,
                      (mu0_node / denom0) * exp_diff0)
    j_p = wct02 * omega[:, None] * z_pp_i0 * j_p
    j_m = (wct02 * omega[:, None] * z_mp_i0 * (mu0_node / (mu_iv + mu0_node))
           * (-torch.expm1(-dt_v * (1.0 / mu_iv + 1.0 / mu0_node))))

    atten = torch.exp(-tau_sum / mu0_node)[:, None]
    return r_mp, t_pp, j_p * atten, j_m * atten


# --- doubling (ref: src/CoreRT/CoreKernel/doubling.jl:13-91) ----------------

def doubling(r_mp_f, t_pp, j_p, j_m_f, expk, ndoubl: int, eye,
             rsolve=rsolve_lu, ns_schedule=None):
    """Grow an elemental layer to the full homogeneous slab by doubling.

    Operates on the row-flipped quantities r~ = D r^-+ and J~^- = D J^- so
    the recursion needs only one reflection operator (D-symmetry trick,
    ref: doubling.jl:43-68). ``ns_schedule``: per-step Newton-Schulz
    iteration counts from ns_doubling_schedule (len == ndoubl), overriding
    ``rsolve`` step by step.
    """
    def body(state, step_rsolve):
        # every right-hand operand sharing a left matrix rides one product:
        # r @ [t | jp | j1m], then tt @ [r t | t | v1 | v2] with
        # tt = t (I - r r)^{-1} never materialized
        r, t, jp, jm, ek = state
        n = r.shape[-1]
        j1p = jp * ek[:, None]
        j1m = jm * ek[:, None]
        pack1 = torch.cat([t, jp[..., None], j1m[..., None]], dim=-1)
        rp = bmm(r, pack1)                     # [r t | r jp | r j1m]
        v1 = j1m + rp[..., n]
        v2 = jp + rp[..., n + 1]
        pack2 = torch.cat(
            [rp[..., :n], t, v1[..., None], v2[..., None]], dim=-1)
        a = eye - bmm(r, r)
        tp = step_rsolve.apply(t, a, pack2)    # tt @ [r t | t | v1 | v2]
        jm_new = jm + tp[..., 2 * n]
        jp_new = j1p + tp[..., 2 * n + 1]
        r_new = r + tp[..., :n]
        t_new = tp[..., n:2 * n]
        return (r_new, t_new, jp_new, jm_new, ek * ek)

    state = (r_mp_f, t_pp, j_p, j_m_f, expk)
    if ns_schedule is not None:
        if len(ns_schedule) != ndoubl:
            raise ValueError(f"ns_schedule has {len(ns_schedule)} steps, "
                             f"ndoubl is {ndoubl}")
        for it in ns_schedule:
            state = body(state, make_rsolve("schulz", int(it)))
    else:
        for _ in range(int(ndoubl)):
            state = body(state, rsolve)
    return state[:4]


def elemental_flipped(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                      i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                      min_qp_mu, ndoubl_static=None):
    """Elemental single-scattering layer in flipped (D-symmetry) space,
    plus the doubling inputs (expk, ndoubl). Shared by make_added_layer and
    the fused layer-step kernel path (cuda/layer_step_kernel.py).
    ref: src/CoreRT/CoreKernel/rt_kernel.jl:238-275 (init_layer)
    """
    if ndoubl_static is not None:
        ndoubl = int(ndoubl_static)
    else:
        tau_scat_max = torch.max(tau * omega)
        # elemental step 0.004*min(mu): single-scatter error O((dtau/mu)^2)
        # stays < ~3e-5 of radiance (f64)
        dtau_max = torch.minimum(tau_scat_max, 0.004 * min_qp_mu)
        ndoubl = doubling_number(dtau_max, tau_scat_max)
    dtau = tau / 2.0 ** ndoubl
    expk = exp_small(-dtau / mu0)

    r_mp, t_pp, j_p, j_m = elemental(
        dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node)

    r_f = d_vec[None, :, None] * r_mp
    jm_f = d_vec[None, :] * j_m
    return r_f, t_pp, j_p, jm_f, expk, ndoubl


def make_added_layer(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                     i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                     min_qp_mu, eye, rsolve=rsolve_lu,
                     ndoubl_static=None, ns_schedule=None) -> LayerRT:
    """Elemental + doubling for one atmospheric layer -> full added layer.

    tau/omega: (nSpec,) per-wavelength optical depth & single-scatter albedo.
    ``ndoubl_static``: host doubling count, or None to derive it from the
    layer's optical depth.
    ref: src/CoreRT/CoreKernel/rt_kernel.jl:238-275 (init_layer + dispatch)
    """
    r_f, t_pp, j_p, jm_f, expk, ndoubl = elemental_flipped(
        tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02, i0_vec, i_mu0_n,
        n_stokes, mu0_node, mu0, d_vec, min_qp_mu,
        ndoubl_static=ndoubl_static)
    r_f, t_pp, j_p, jm_f = doubling(r_f, t_pp, j_p, jm_f, expk, ndoubl,
                                    eye, rsolve=rsolve,
                                    ns_schedule=ns_schedule)
    r_mp = d_vec[None, :, None] * r_f
    j_m = d_vec[None, :] * jm_f

    # mirror operators from D-matrix symmetry: R^+- = D R^-+ D etc.
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    return LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t_pp, t_mm=sgn * t_pp,
                   j_p=j_p, j_m=j_m)


# --- interaction / adding (ref: src/CoreRT/CoreKernel/interaction.jl) -------

def interaction(comp: LayerRT, added: LayerRT, eye,
                rsolve=rsolve_lu) -> LayerRT:
    """Compose composite(top) with added(bottom) slab (full 11-path adding).

    With a vacuum composite this reduces exactly to a copy of ``added``, so
    no special-casing of the first layer is needed.
    ref: src/CoreRT/CoreKernel/interaction.jl:69-117
    """
    a1 = eye - bmm(added.r_mp, comp.r_pm)
    t01 = rsolve(comp.t_mm, a1)               # T^--_comp (I - r R)^{-1}
    j_m = comp.j_m + bmv(t01, bmv(added.r_mp, comp.j_p) + added.j_m)
    r_mp = comp.r_mp + bmm(t01, bmm(added.r_mp, comp.t_pp))
    t_mm = bmm(t01, added.t_mm)

    a2 = eye - bmm(comp.r_pm, added.r_mp)
    t21 = rsolve(added.t_pp, a2)
    j_p = added.j_p + bmv(t21, comp.j_p + bmv(comp.r_pm, added.j_m))
    t_pp = bmm(t21, comp.t_pp)
    r_pm = added.r_pm + bmm(t21, bmm(comp.r_pm, added.t_mm))

    return LayerRT(r_mp=r_mp, r_pm=r_pm, t_pp=t_pp, t_mm=t_mm,
                   j_p=j_p, j_m=j_m)
