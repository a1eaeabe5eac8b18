"""Doubling-adding RT core (elemental / doubling / interaction) in torch.

Port of ``vsmartmom/core/rt.py``, plain form and direct/diffuse split form
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

from vsmartmom_torch.core import precision


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


class LayerRTDev(NamedTuple):
    """Slab operator in direct/diffuse split ("deviation") form.

    The transmission operators are carried as T = diag(g) + E with g the
    direct-beam diagonal (exp(-tau/mu), shared by T^++ and T^--: the direct
    beam is reciprocal) and E the diffuse deviation. Every matrix product of
    doubling and interaction then acts on diffuse-scale operands only: the
    ~1.0 direct diagonal never rides a product, which lowers the float32
    floor of the doubling recursion (no repeated near-identity
    cancellations).
    """
    r_mp: torch.Tensor
    r_pm: torch.Tensor
    e_pp: torch.Tensor   # T^++ = diag(g) + e_pp
    e_mm: torch.Tensor   # T^-- = diag(g) + e_mm
    g: torch.Tensor      # (nSpec, N) direct transmission diagonal
    j_p: torch.Tensor
    j_m: torch.Tensor


def vacuum_layer_dev(n_spec: int, n: int, dtype, device) -> LayerRTDev:
    """Empty-space slab in split form (g = 1, everything else 0); every
    field is its own contiguous tensor."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LayerRTDev(zeros(n_spec, n, n), zeros(n_spec, n, n),
                      zeros(n_spec, n, n), zeros(n_spec, n, n),
                      torch.ones((n_spec, n), dtype=dtype, device=device),
                      zeros(n_spec, n), zeros(n_spec, n))


def dev_to_full(dev: LayerRTDev) -> LayerRT:
    """Reassemble the full operators T = diag(g) + E."""
    n = dev.g.shape[-1]
    gd = dev.g[:, :, None] * torch.eye(n, dtype=dev.g.dtype,
                                       device=dev.g.device)[None]
    return LayerRT(r_mp=dev.r_mp, r_pm=dev.r_pm,
                   t_pp=gd + dev.e_pp, t_mm=gd + dev.e_mm,
                   j_p=dev.j_p, j_m=dev.j_m)


# --- batched linear algebra helpers -----------------------------------------

def bmm(a, b):
    """Batched matrix product over the leading spectral axis, in the mode
    of the enclosing ``precision.matmul_precision`` block (float32 operands
    only; "highest", full float32, outside any block)."""
    return precision.mm(a, b)


def bmv(a, v):
    """Batched matrix-vector product, in the active mode as ``bmm``."""
    return precision.mm(a, v.unsqueeze(-1)).squeeze(-1)


def mix_z(zw, z_c):
    """One layer's phase matrices sum_k zw[k, s] z_c[k]: (K, nSpec)
    weights and (K, N, N) components -> (nSpec, N, N), in the active mode
    as ``bmm`` (JAX runs this einsum under the default precision too)."""
    mode = precision.active()
    if mode == "highest" or z_c.dtype != torch.float32:
        return torch.einsum("kn,kij->nij", zw, z_c)
    k, n = z_c.shape[0], z_c.shape[-1]
    return precision.product(zw.T, z_c.reshape(k, n * n),
                             mode).reshape(-1, n, n)


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
               B^(2^(k+1)): 4 iterations leave B^32. Its
               ``materialize_m(a)`` returns M ~= A^{-1} itself.
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
    # the approximate inverse M(A) is pointwise in the spectral batch, so a
    # caller that needs the same solve at gathered spectral indices (the
    # Raman shift rows, core/rt_raman.py) builds M once and gathers it:
    # M(gather(A)) == gather(M(A)) exactly
    rsolve_schulz.materialize_m = _schulz_m
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


#: expm1 argument above which exp_difference drops its subtracted term
#: (below e^-80 of the other): float32 expm1 overflows beyond 88.7
EXP_DIFF_CUT = 80.0


def exp_difference(e_b, e_a, arg):
    """e^-b - e^-a from e_b = e^-b, e_a = e^-a and arg = a - b (one
    subtraction of exact node values): e_a expm1(arg), or e_b where arg >
    EXP_DIFF_CUT. There e_a is negligible, and in float32 the product
    would be 0 * inf (e^-a underflows where expm1(arg) overflows): an
    optically thick elemental slab seen at a grazing stream, e.g. an O2
    A-band line core (dtau 3.4) at mu = 0.0199."""
    return torch.where(arg > EXP_DIFF_CUT, e_b, e_a * torch.expm1(arg))


def merged_nodes(same_mu, n_stokes):
    """(N, N) mask of entries that join two distinct quadrature nodes at
    one mu (entries i, j of node i // n_stokes and j // n_stokes)."""
    node = torch.arange(same_mu.shape[0], device=same_mu.device) // n_stokes
    return same_mu & (node[:, None] != node[None, :])


def elemental(dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
              i0_vec, i_mu0_n, n_stokes, mu0_node, split=False):
    """Single-scattering initialization of an elemental layer.

    ref: src/CoreRT/CoreKernel/elemental.jl:164-253 (get_elem_rt!/..._SFI!).

    dtau, omega, tau_sum: (nSpec,); z_pp/z_mp: (nSpec|1, N, N);
    qp, wct2: (N,); i0_vec: (N,) incident Stokes vector embedded at the solar
    node block; mu0_node: 0-dim tensor, qp[i_mu0_n].
    Returns r_mp, t_pp (nSpec, N, N) and j_p, j_m (nSpec, N).

    ``split=True``: returns (r_mp, g, e_pp, j_p, j_m) with T^++ in
    direct/diffuse form diag(g) + e_pp (see LayerRTDev). The diffuse
    diagonal is built directly from the single-scatter term, never by
    subtracting exp(-dtau/mu) from the assembled diagonal.
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
    exp_diff = exp_difference(exp_i, exp_small(-dt / mu_j),
                              dt * (mu_i - mu_j) / (mu_i * mu_j))
    t_off = om * z_pp * (mu_j / denom) * wct2[None, None, :] * exp_diff
    # Two distinct nodes at one mu take the diagonal's scattered part, the
    # limit of t_off: after the host's exact deduplication that happens
    # only in float32, where a view 1 ulp from a quadrature node (vza =
    # 60 deg on the Gauss node 0.5) merges with it. The Stokes components
    # of one node keep no off-diagonal term.
    merged = merged_nodes(same_mu, n_stokes)
    if split:
        # diffuse deviation only: the selects of t_pp below, minus diag(g)
        e_pp = torch.where(same_mu[None, :, :],
                           torch.where((eye | merged)[None, :, :], e_diag,
                                       0.0),
                           t_off)
        e_pp = torch.where(col_mask[None, None, :], e_pp, 0.0)
    else:
        t_pp = torch.where(same_mu[None, :, :],
                           torch.where(eye[None, :, :], t_diag,
                                       torch.where(merged[None, :, :],
                                                   e_diag, 0.0)),
                           t_off)
        # Zero-weight (camera-only) columns transmit the attenuated beam
        # only
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
    exp_diff0 = exp_difference(exp_iv, exp_small(-dt_v / mu0_node),
                               dt_v * (mu_iv - mu0_node)
                               / (mu_iv * mu0_node))
    j_p = torch.where(same0, (dt_v / mu_iv) * exp_iv,
                      (mu0_node / denom0) * exp_diff0)
    j_p = wct02 * omega[:, None] * z_pp_i0 * j_p
    j_m = (wct02 * omega[:, None] * z_mp_i0 * (mu0_node / (mu_iv + mu0_node))
           * (-torch.expm1(-dt_v * (1.0 / mu_iv + 1.0 / mu0_node))))

    atten = torch.exp(-tau_sum / mu0_node)[:, None]
    if split:
        g = exp_small(-dtau[:, None] / qp[None, :])
        return r_mp, g, e_pp, j_p * atten, j_m * atten
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
                      min_qp_mu, ndoubl_static=None, tau_scat_max=None):
    """Elemental single-scattering layer in flipped (D-symmetry) space,
    plus the doubling inputs (expk, ndoubl). Shared by make_added_layer and
    the fused layer-step kernel path (cuda/layer_step_kernel.py).
    ``tau_scat_max``: the layer's maximum of tau * omega over the whole
    band (a host float), or None to take it over the points given; it sets
    the doubling count when ``ndoubl_static`` is None.
    ref: src/CoreRT/CoreKernel/rt_kernel.jl:238-275 (init_layer)
    """
    if ndoubl_static is not None:
        ndoubl = int(ndoubl_static)
    else:
        tau_scat_max = (torch.max(tau * omega) if tau_scat_max is None
                        else torch.as_tensor(tau_scat_max, dtype=tau.dtype,
                                             device=tau.device))
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
                     ndoubl_static=None, ns_schedule=None,
                     doubling_engine="torch", tau_scat_max=None,
                     matmul_precision: str = "highest") -> LayerRT:
    """Elemental + doubling for one atmospheric layer -> full added layer.

    tau/omega: (nSpec,) per-wavelength optical depth & single-scatter albedo.
    ``ndoubl_static``: host doubling count, or None to derive it from the
    layer's optical depth. ``doubling_engine``: "torch" (batched ops) or
    "kernel" (the doubling-only kernel, cuda/doubling_kernel.py; needs the
    static NS schedule). ``tau_scat_max`` as in elemental_flipped.
    ``matmul_precision``: the doubling kernel's product mode
    (core/precision.py); the torch ops take the enclosing block's, as the
    JAX package's make_added_layer passes its argument to the kernel alone.
    ref: src/CoreRT/CoreKernel/rt_kernel.jl:238-275 (init_layer + dispatch)
    """
    if doubling_engine not in ("torch", "kernel"):
        raise ValueError(f"unknown doubling engine {doubling_engine!r}")
    if doubling_engine == "kernel" and ns_schedule is None:
        raise ValueError("the doubling kernel needs the schulz solver's "
                         "static Newton-Schulz schedule")
    r_f, t_pp, j_p, jm_f, expk, ndoubl = elemental_flipped(
        tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02, i0_vec, i_mu0_n,
        n_stokes, mu0_node, mu0, d_vec, min_qp_mu,
        ndoubl_static=ndoubl_static, tau_scat_max=tau_scat_max)
    if doubling_engine == "kernel":
        if len(ns_schedule) != ndoubl:
            raise ValueError(f"ns_schedule has {len(ns_schedule)} steps, "
                             f"ndoubl is {ndoubl}")
        from vsmartmom_torch.cuda.doubling_kernel import fused_doubling
        r_f, t_pp, j_p, jm_f = fused_doubling(
            r_f, t_pp, j_p, jm_f, expk, ns_schedule=ns_schedule,
            precision=matmul_precision)
    else:
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


# --- direct/diffuse split ("deviation form") engine -------------------------
#
# The same doubling-adding algebra as above, with every transmission operator
# carried as diag(g) + E (see LayerRTDev). The Newton-Schulz solve runs in
# Y-form: (I - B)^{-1} = I + Y with Y_0 = B, Y <- W + Y(W - Y), W = B + B Y
# (the plain iteration with the identity handled exactly). The matrix product
# is injected (``mm``) so the split-form kernel's plain version reuses these
# functions verbatim.

def ns_y(rr, iters: int, mm=bmm):
    """Y-form Newton-Schulz: Y ~= (I - B)^{-1} - I for B = rr, rho(B) < 1.
    Iteration for iteration the residual B^(2^(k+1)) of the plain form."""
    y = rr
    for _ in range(iters):
        w = rr + mm(rr, y)
        y = w + mm(y, w - y)
    return y


def y_exact_lu(rr, eye):
    """Exact Y = (I - B)^{-1} - I = B (I - B)^{-1} (polynomials in B
    commute) by batched LU: the exact twin of ns_y."""
    return rsolve_lu(rr, eye - rr)


def doubling_dev(r_f, g, e_pp, j_p, j_m_f, expk, ns_schedule=None,
                 exact_eye=None, ndoubl=None, mm=bmm):
    """Doubling recursion in direct/diffuse split form (flipped space).

    State: r (flipped reflection), T^++ = diag(g) + e_pp, sources, expk.
    ``ns_schedule``: per-step NS iteration counts (schulz); ``exact_eye``:
    batched identity for the exact-LU Y, with ``ndoubl`` steps.
    Algebra: t' = t M t, r' = r + t M r t, sources as in doubling(), each
    product expanded over diag(g) + E so only diffuse-scale operands ride
    products.
    """
    r, ge, e = r_f, g, e_pp
    jp, jm, ek = j_p, j_m_f, expk
    if ek.ndim == 1:
        ek = ek[:, None]
    steps = (ns_schedule if ns_schedule is not None
             else [None] * int(ndoubl))
    n = r.shape[-1]
    for it in steps:
        rr = mm(r, r)
        y = (y_exact_lu(rr, exact_eye) if it is None
             else ns_y(rr, int(it), mm))
        j1p = jp * ek
        j1m = jm * ek
        pack1 = torch.cat([e, jp[..., None], j1m[..., None]], dim=-1)
        rp = mm(r, pack1)                  # [r E | r jp | r j1m]
        rt = r * ge[:, None, :] + rp[..., :n]
        v1 = j1m + rp[..., n]
        v2 = jp + rp[..., n + 1]
        packy = torch.cat([rt, e, v1[..., None], v2[..., None]], dim=-1)
        yp = mm(y, packy)                  # [Y rt | Y E | Y v1 | Y v2]
        mrt = rt + yp[..., :n]
        d_mt = e + y * ge[:, None, :] + yp[..., n:2 * n]
        mv1 = v1 + yp[..., 2 * n]
        mv2 = v2 + yp[..., 2 * n + 1]
        packe = torch.cat([mrt, d_mt, mv1[..., None], mv2[..., None]],
                          dim=-1)
        ep = mm(e, packe)
        r = r + ge[:, :, None] * mrt + ep[..., :n]
        e = ge[:, :, None] * d_mt + e * ge[:, None, :] + ep[..., n:2 * n]
        jm = jm + ge * mv1 + ep[..., 2 * n]
        jp = j1p + ge * mv2 + ep[..., 2 * n + 1]
        ge = ge * ge
        ek = ek * ek
    return r, ge, e, jp, jm


def elemental_flipped_dev(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                          i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                          ndoubl_static):
    """Split-form elemental layer in flipped (D-symmetry) space plus the
    doubling input expk: the split twin of elemental_flipped, feeding
    cuda/layer_step_dev_kernel.py:fused_layer_step_dev."""
    ndoubl = int(ndoubl_static)
    dtau = tau / 2.0 ** ndoubl
    expk = exp_small(-dtau / mu0)
    r_mp, g, e_pp, j_p, j_m = elemental(
        dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node, split=True)
    r_f = d_vec[None, :, None] * r_mp
    jm_f = d_vec[None, :] * j_m
    return r_f, g, e_pp, j_p, jm_f, expk


def make_added_layer_dev(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                         i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                         min_qp_mu, ndoubl_static, ns_schedule=None,
                         exact_eye=None, mm=bmm) -> LayerRTDev:
    """Elemental + doubling in split form -> D-symmetric added layer: the
    split twin of make_added_layer. g is shared by T^++ and T^-- (the sign
    diagonal is +1), e_mm = sgn * e_pp."""
    ndoubl = int(ndoubl_static)
    r_f, g, e_pp, j_p, jm_f, expk = elemental_flipped_dev(
        tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02, i0_vec, i_mu0_n,
        n_stokes, mu0_node, mu0, d_vec, ndoubl)
    r_f, g, e_pp, j_p, jm_f = doubling_dev(
        r_f, g, e_pp, j_p, jm_f, expk, ns_schedule=ns_schedule,
        exact_eye=exact_eye, ndoubl=ndoubl, mm=mm)
    r_mp = d_vec[None, :, None] * r_f
    j_m = d_vec[None, :] * jm_f
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    return LayerRTDev(r_mp=r_mp, r_pm=sgn * r_mp, e_pp=e_pp,
                      e_mm=sgn * e_pp, g=g, j_p=j_p, j_m=j_m)


def interaction_dev(comp: LayerRTDev, added: LayerRTDev, ni=None,
                    exact_eye=None, mm=bmm) -> LayerRTDev:
    """Adding in split form: the push-through single-solve interaction.

    ``ni``: Newton-Schulz iterations for (I - r2 R)^{-1}, or None with
    ``exact_eye`` for the exact-LU twin. The composite direct diagonal
    multiplies: g' = g_comp * g_added for both transmissions.
    """
    n = comp.r_mp.shape[-1]
    gc, g2 = comp.g, added.g
    r2mp, e2, e2mm = added.r_mp, added.e_pp, added.e_mm
    b1 = mm(r2mp, comp.r_pm)
    y1 = (y_exact_lu(b1, exact_eye) if ni is None
          else ns_y(b1, int(ni), mm))

    # r2mp @ [c_tpp | c_jp] and c_rpm @ [t2mm | j2m] (split operands)
    p1 = mm(r2mp, torch.cat([comp.e_pp, comp.j_p[..., None]], dim=-1))
    rc_tpp = r2mp * gc[:, None, :] + p1[..., :n]
    v1 = p1[..., n] + added.j_m
    p2 = mm(comp.r_pm, torch.cat([e2mm, added.j_m[..., None]], dim=-1))
    crpm_t2mm = comp.r_pm * g2[:, None, :] + p2[..., :n]
    v2 = comp.j_p + p2[..., n]

    # push-through: y = M1 @ [x1 | r2mp @ x2] with
    # x1 = [rc_tpp | t2mm | v1], x2 = [c_tpp | crpm_t2mm | v2]; the head of
    # r2mp @ x2 is rc_tpp again, so it rides the solve once (y_b1 = y_a)
    p3 = mm(r2mp, torch.cat([crpm_t2mm, v2[..., None]], dim=-1))
    z_small = torch.cat([rc_tpp, e2mm, v1[..., None], p3], dim=-1)
    yz = mm(y1, z_small)
    y_a = rc_tpp + yz[..., :n]                      # M1 @ rc_tpp
    d2 = e2mm + y1 * g2[:, None, :] + yz[..., n:2 * n]   # M1 t2mm = G2 + d2
    y_v1 = v1 + yz[..., 2 * n]
    y_b1 = y_a
    y_b2 = p3[..., :n] + yz[..., 2 * n + 1:3 * n + 1]
    y_bv = p3[..., n] + yz[..., 3 * n + 1]

    # o1 = c_tmm @ (M1 @ x1):  c_tmm = diag(gc) + cE_m
    p4 = mm(comp.e_mm, torch.cat([y_a, d2, y_v1[..., None]], dim=-1))
    r_mp = comp.r_mp + gc[:, :, None] * y_a + p4[..., :n]
    e_mm = (gc[:, :, None] * d2 + comp.e_mm * g2[:, None, :]
            + p4[..., n:2 * n])
    j_m = comp.j_m + gc * y_v1 + p4[..., 2 * n]

    # o2 = t2 @ (x2 + c_rpm @ y2):  t2 = diag(g2) + e2
    p5 = mm(comp.r_pm, torch.cat([y_b1, y_b2, y_bv[..., None]], dim=-1))
    i1 = comp.e_pp + p5[..., :n]                # x2 head deviation
    i2 = crpm_t2mm + p5[..., n:2 * n]
    iv = v2 + p5[..., 2 * n]
    p6 = mm(e2, torch.cat([i1, i2, iv[..., None]], dim=-1))
    e_pp = g2[:, :, None] * i1 + e2 * gc[:, None, :] + p6[..., :n]
    r_pm = added.r_pm + g2[:, :, None] * i2 + p6[..., n:2 * n]
    j_p = added.j_p + g2 * iv + p6[..., 2 * n]

    return LayerRTDev(r_mp=r_mp, r_pm=r_pm, e_pp=e_pp, e_mm=e_mm,
                      g=gc * g2, j_p=j_p, j_m=j_m)
