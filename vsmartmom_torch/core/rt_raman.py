"""Inelastic (Raman) doubling-adding RT core in torch.

Port of ``vsmartmom/core/rt_raman.py`` (ref: src/CoreRT/CoreKernel/
{elemental,doubling,interaction}_inelastic.jl and the concatenated-band
variants *_inelastic_plus.jl). The ``ie*`` arrays are first-order
perturbations, and every update rule is the elastic adding algebra applied
to upper-triangular 2x2 block operators

    O = [[E(n1), ie(n1, dn)], [0, E(n0)]],  n0 = src(dn, n1)

whose diagonal blocks are the elastic operators at the output (n1) and
source (n0) wavelengths and whose off-diagonal block is the Raman coupling:

    (X Y)_ie      = X_1 Y_ie + X_ie Y_0
    ((I-M)^-1)_ie = (I-M_1)^-1 M_ie (I-M_0)^-1

The "n0" operands are the elastic arrays gathered along the spectral axis;
the tests hold the factored algebra against brute-force composition of the
full (2N x 2N) block matrices.

Coupling representation (RRS / RRS_plus / VS_plus / RVRS alike): each Raman
shift row dn carries a per-output source-index map src[dn, n1], a validity
mask and a per-output weight w[dn, n1] (build_coupling).

Shapes: elastic arrays (nSpec, N, N) / (nSpec, N); ie arrays carry a
leading Raman-shift axis (nR, nSpec, N, N) / (nR, nSpec, N). Where the JAX
package maps one function over the shift rows, the port broadcasts every
elastic operand over that axis. The drivers take the shift rows in chunks
(ie_chunk_rows) to bound device memory: rows are independent, so the
result does not depend on the chunk size beyond rounding of the sum over
rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vsmartmom_torch.core import precision
from vsmartmom_torch.core.rt import (EXP_DIFF_CUT, LayerRT, bmm, bmv,
                                     doubling_number, elemental,
                                     make_rsolve, mix_z,
                                     ns_doubling_schedule, vacuum_layer)
from vsmartmom_torch.core.rt_run import (Geometry, Synthesis, default_solver,
                                         geometry, surface_layer)
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device


def bmm_ie(a, b):
    """Batched matmul of the first-order (ie) operands, broadcast over the
    shift axis, in the run's ``ie_precision`` (core/precision.py;
    float32 operands only). The ie operators are perturbation-scale (no
    ~1.0 transmission diagonal rides these products), so a bf16 mode's
    absolute floor is small relative to the ie result. The JAX package
    reads the mode from the environment (VSM_RAMAN_IE_PRECISION, default
    "high"); the port takes it as a keyword, default "highest"."""
    return precision.product(a, b, precision.active("ie"))


class IELayer(NamedTuple):
    """First-order Raman coupling operators, leading axis = Raman shift."""
    r_mp: torch.Tensor
    r_pm: torch.Tensor
    t_pp: torch.Tensor
    t_mm: torch.Tensor
    j_p: torch.Tensor
    j_m: torch.Tensor


def zero_ie(n_r: int, n_spec: int, n: int, dtype, device) -> IELayer:
    zm = torch.zeros((n_r, n_spec, n, n), dtype=dtype, device=device)
    zv = torch.zeros((n_r, n_spec, n), dtype=dtype, device=device)
    return IELayer(zm, zm, zm, zm, zv, zv)


# --- source-index coupling maps ---------------------------------------------

def coupling_rows_from_shifts(shifts, n_spec: int, device=None):
    """Banded rolls: src[dn, n1] = n1 + shifts[dn] (clipped), plus mask."""
    idx = torch.arange(n_spec, device=device)
    src = idx[None, :] + torch.as_tensor(shifts, device=device)[:, None]
    valid = (src >= 0) & (src < n_spec)
    return src.clamp(0, n_spec - 1), valid


def _as_rows(shift, n_spec: int, device=None):
    """Scalar/1-D int shift(s) -> (src, valid) rows; (src, valid) tuples
    pass through (indices clipped onto the grid, validity from the mask).
    A scalar gives one (nSpec,) row, anything else (nR, nSpec) rows."""
    if isinstance(shift, tuple):
        src, valid = shift
        src = torch.as_tensor(src, device=device).long()
        return (src.clamp(0, n_spec - 1),
                torch.as_tensor(valid, device=device).bool())
    s = torch.as_tensor(shift, device=device)
    if s.dtype.is_floating_point or s.dtype == torch.bool or s.ndim > 1:
        raise TypeError("shift must be int scalar/vector or (src, valid) "
                        "tuple")
    if s.ndim == 0:
        src, valid = coupling_rows_from_shifts(s[None], n_spec, device)
        return src[0], valid[0]
    return coupling_rows_from_shifts(s, n_spec, device)


def _take_padded(x, pad, src, valid):
    """x gathered at src, ``pad`` (one more row of x) where not valid: one
    gather from x with the pad row appended."""
    return torch.cat([x, pad])[torch.where(valid, src, x.shape[0])]


def take0(x, src, valid):
    """x evaluated at the source index map (zero outside the grid):
    (nSpec, ...) gathered by (..., nSpec) rows -> (..., nSpec, ...)."""
    return _take_padded(x, x.new_zeros((1,) + x.shape[1:]), src, valid)


def take0_id(a, src, valid, eye):
    """Like take0 for (I - B)-type matrices: identity outside the grid,
    keeping the batched solves nonsingular (the ie operands there are zero
    anyway, so the result is unaffected). ``eye``: (nSpec|1, N, N)."""
    return _take_padded(a, eye[:1], src, valid)


def _roll_valid(n: int, s: int, device):
    idx = torch.arange(n, device=device)
    return (idx + s >= 0) & (idx + s < n)


def roll0(x, s: int):
    """x evaluated at source index n + s (zero outside the grid)."""
    valid = _roll_valid(x.shape[0], s, x.device)
    mask = valid.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(mask, torch.roll(x, -s, 0), 0.0)


def roll0_id(a, s: int, eye):
    """Identity-outside variant of roll0 (see take0_id)."""
    valid = _roll_valid(a.shape[0], s, a.device)
    return torch.where(valid[:, None, None], torch.roll(a, -s, 0), eye)


# --- inelastic elemental (single scattering) --------------------------------

def _exp_quotient(a0, a1, x):
    """(e^-a1 - e^-a0) / x for x = a0 - a1, without cancellation:
    e^-a0 expm1(x) / x, with the limit e^-a0 (1 + x/2) near x = 0. Beyond
    x = EXP_DIFF_CUT it is taken as written: there e^-a0 expm1(x) is
    0 * inf in float32 (a source in a line core feeding an output in the
    continuum at a grazing stream). ``x`` comes from the node values
    (one subtraction), not from a0 - a1."""
    big = torch.abs(x) > 1e-10
    xs = torch.where(big, x, 1.0)
    e0 = torch.exp(-a0)
    return torch.where(x > EXP_DIFF_CUT, (torch.exp(-a1) - e0) / xs,
                       e0 * torch.where(big, torch.expm1(x) / xs,
                                        1.0 + x / 2.0))


def ie_elemental(shift, w_shift, dtau, f_rayl, tau_sum, z_pp_r, z_mp_r,
                 qp, wct2, wct02, i0_vec, i_mu0_n, n_stokes, mu0_node):
    """Raman-coupled single-scattering operators for shift rows.

    ``shift`` is an int offset (one row) or int offsets / an (src, valid)
    index map of nR rows; ``w_shift`` a scalar, per-row (nR,) or per-output
    (nSpec,) / (nR, nSpec) coupling weight; ``z_pp_r``/``z_mp_r`` one
    (N, N) Raman phase matrix or one per row (nR, N, N). Two-wavelength
    generalization of the elastic elemental expressions: incident light
    attenuates with dtau0 (source wavelength), scattered light with dtau1
    (ref: elemental_inelastic.jl:93-162, 320-383; smooth equal-dtau limits
    with expm1 instead of branch thresholds). Every difference of two
    exponentials is formed as e^-a expm1(a - b), the T^++ diagonal's form
    in the JAX package, which subtracts the exponentials elsewhere.
    Returns (ier_mp, iet_pp, iej_p, iej_m) for output wavelengths n1, with
    a leading row axis unless ``shift`` is one row.
    """
    n_spec = dtau.shape[0]
    n = qp.shape[0]
    src, valid = _as_rows(shift, n_spec, dtau.device)
    single = src.ndim == 1
    if single:
        src, valid = src[None], valid[None]
    n_r = src.shape[0]
    w = torch.as_tensor(w_shift, dtype=dtau.dtype, device=dtau.device)
    if w.ndim == 1 and not single:
        w = w[:, None]                        # per-row scalars
    if z_pp_r.ndim == 2:
        z_pp_r = z_pp_r.expand(n_r, n, n)
        z_mp_r = z_mp_r.expand(n_r, n, n)

    dt1 = dtau[:, None, None]                 # (nSpec, 1, 1)
    dt0_s = take0(dtau, src, valid)           # (nR, nSpec)
    # coupling strength: w(output) * Rayleigh-scatter fraction at source
    f0 = w * take0(f_rayl, src, valid)
    dt0 = dt0_s[..., None, None]
    cpl = f0[..., None, None]
    zpp, zmp = z_pp_r[:, None], z_mp_r[:, None]   # (nR, 1, N, N)
    mu_i = qp[:, None]
    mu_j = qp[None, :]
    col_mask = wct2 > 1e-8

    # R^-+: cpl Z^-+ (mu_j dt0 / (mu_i dt0 + mu_j dt1))
    #       (1 - e^{-dt1/mu_i - dt0/mu_j}) w_j
    denom_r = mu_i * dt0 + mu_j * dt1
    r_ie = (cpl * zmp * (mu_j * dt0 / torch.where(denom_r == 0, 1.0,
                                                  denom_r))
            * (-torch.expm1(-(dt1 / mu_i + dt0 / mu_j))) * wct2)
    r_ie = torch.where(col_mask, r_ie, 0.0)

    # T^++: cpl Z^++ mu_j dt0 (e^{-dt1/mu_i} - e^{-dt0/mu_j})
    #       / (mu_i dt0 - mu_j dt1) w_j
    #     = cpl Z^++ (dt0/mu_i) e^{-dt0/mu_j} expm1(x)/x w_j,
    # x = dt0/mu_j - dt1/mu_i: one form for every pair of nodes, its
    # equal-mu, equal-dtau limit included (JAX subtracts the exponentials
    # off the diagonal, which cancels to nothing between two nodes 1 ulp
    # apart at equal dtau). The Stokes components of one node couple on
    # the diagonal only.
    x = (mu_i * dt0 - mu_j * dt1) / (mu_i * mu_j)
    t_ie = (cpl * zpp * (dt0 / mu_i)
            * _exp_quotient(dt0 / mu_j, dt1 / mu_i, x) * wct2)
    node = torch.arange(n, device=qp.device) // n_stokes
    one_node = node[:, None] == node[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=qp.device)
    t_ie = torch.where(col_mask & ~(one_node & ~eye), t_ie, 0.0)

    # --- SFI sources ---
    z_pp_i0 = torch.matmul(z_pp_r, i0_vec)[:, None, :]   # (nR, 1, N)
    z_mp_i0 = torch.matmul(z_mp_r, i0_vec)[:, None, :]

    mu_iv = qp[None, :]
    dt1v = dtau[:, None]
    dt0v = dt0_s[..., None]
    cplv = f0[..., None]

    # mu0 dt0 (e^{-dt1/mu_i} - e^{-dt0/mu0}) / (mu_i dt0 - mu0 dt1)
    # = (dt0/mu_i) e^{-dt0/mu0} expm1(x)/x, the solar block's limit
    # (dt0/mu0) e^{-dt0/mu0} expm1(dd)/dd included
    xv = (mu_iv * dt0v - mu0_node * dt1v) / (mu_iv * mu0_node)
    iej_p = (wct02 * cplv * z_pp_i0 * (dt0v / mu_iv)
             * _exp_quotient(dt0v / mu0_node, dt1v / mu_iv, xv))

    denom_m = mu_iv * dt0v + mu0_node * dt1v
    iej_m = (wct02 * cplv * z_mp_i0
             * (mu0_node * dt0v / torch.where(denom_m == 0, 1.0, denom_m))
             * (-torch.expm1(-(dt1v / mu_iv + dt0v / mu0_node))))

    atten = torch.exp(-take0(tau_sum, src, valid) / mu0_node)[..., None]
    out = (r_ie, t_ie, iej_p * atten, iej_m * atten)
    return tuple(f[0] for f in out) if single else out


# --- Raman-coupled doubling -------------------------------------------------

def raman_doubling(r, t, jp, jm, ek, ier, iet, iejp, iejm, shifts, ndoubl,
                   eye, rsolve, ns_schedule=None):
    """Joint elastic + first-order-Raman doubling (flipped space).

    Elastic recursion identical to rt.doubling; ie updates are the
    off-diagonal blocks of the same algebra (see module docstring).
    ``shifts``: int (nR,) banded offsets or a ((nR, nSpec) src,
    (nR, nSpec) valid) tuple. ``ns_schedule``: optional static per-step
    Newton-Schulz iteration counts (ns_doubling_schedule) in place of
    ``ndoubl`` steps of ``rsolve``.
    Returns (r, t, jp, jm, ek, ier, iet, iejp, iejm).
    """
    srcs, valids = _as_rows(shifts, r.shape[0], r.device)

    def tk(x):
        return take0(x, srcs, valids)

    def body(state, rsolve):
        r, t, jp, jm, ek, ier, iet, iejp, iejm = state
        a = eye - bmm(r, r)
        # schulz exposes materialize_m: build the pointwise inverse field
        # once per step and gather it per shift (M(gather(A)) ==
        # gather(M(A))); LU keeps the per-shift solve
        m_fn = getattr(rsolve, "materialize_m", None)
        if m_fn is None:
            m = None
            tt = rsolve(t, a)
        else:
            m = m_fn(a)
            tt = bmm(t, m)
        j1p = jp * ek[:, None]
        j1m = jm * ek[:, None]
        u1 = jp + bmv(r, j1m)
        u2 = j1m + bmv(r, jp)
        # r t serves the elastic update and, gathered, every shift row
        rt = bmm(r, t)

        t0 = tk(t)
        x = bmm_ie(tt, bmm_ie(r, ier) + bmm_ie(ier, tk(r))) + iet
        if m is None:
            tt_off = rsolve(x, take0_id(a, srcs, valids, eye))
        else:
            tt_off = bmm_ie(x, take0_id(m, srcs, valids, eye))
        del x
        ier_n = (ier + bmm_ie(tt, bmm_ie(r, iet) + bmm_ie(ier, t0))
                 + bmm_ie(tt_off, tk(rt)))
        iet_n = bmm_ie(tt, iet) + bmm_ie(tt_off, t0)
        del t0

        iej1p = iejp * ek[:, None]
        iej1m = iejm * ek[:, None]
        u1_off = iejp + bmv(r, iej1m) + bmv(ier, tk(j1m))
        u2_off = iej1m + bmv(r, iejp) + bmv(ier, tk(jp))
        iejp_n = iej1p + bmv(tt, u1_off) + bmv(tt_off, tk(u1))
        iejm_n = iejm + bmv(tt, u2_off) + bmv(tt_off, tk(u2))

        jm = jm + bmv(tt, u2)
        jp = j1p + bmv(tt, u1)
        r = r + bmm(tt, rt)
        t = bmm(tt, t)
        return (r, t, jp, jm, ek * ek, ier_n, iet_n, iejp_n, iejm_n)

    state = (r, t, jp, jm, ek, ier, iet, iejp, iejm)
    if ns_schedule is not None:
        for it in ns_schedule:
            state = body(state, make_rsolve("schulz", int(it)))
    else:
        for _ in range(int(ndoubl)):
            state = body(state, rsolve)
    return state


def raman_make_added_layer(tau, omega, z_pp, z_mp, z_pp_r, z_mp_r, tau_sum,
                           f_rayl, shifts, w_shifts, gids, qp, wct2, wct02,
                           i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                           min_qp_mu, eye, rsolve, ndoubl_static=None,
                           ns_schedule=None, tau_scat_max=None):
    """One atmospheric layer: elastic + Raman elemental, joint doubling.

    ref: rt_kernel.jl:278-343 (RRS path). Returns (LayerRT, IELayer).
    ``shifts`` banded ints or (src, valid) rows; ``w_shifts`` (nR,) scalars
    or (nR, nSpec) per-output weights; ``gids`` (nR,) index each row's
    Raman phase matrix in the (G, N, N) stacks ``z_pp_r``/``z_mp_r``.
    ``ndoubl_static``/``ns_schedule``: host static doubling count and
    per-step NS iteration counts, or None to derive the count from the
    layer's optical depth: its maximum of tau * omega over the points
    given, or ``tau_scat_max`` (a host float: the maximum over a whole
    band of which these points are a shard).
    """
    n_spec = tau.shape[0]
    srcs, valids = _as_rows(shifts, n_spec, tau.device)
    if ndoubl_static is not None:
        ndoubl = int(ndoubl_static)
    else:
        tau_scat_max = (torch.max(tau * omega) if tau_scat_max is None
                        else torch.as_tensor(tau_scat_max, dtype=tau.dtype,
                                             device=tau.device))
        # elemental step 0.004*min(mu), as the elastic engines
        dtau_max = torch.minimum(tau_scat_max, torch.as_tensor(
            0.004 * min_qp_mu, dtype=tau.dtype, device=tau.device))
        ndoubl = doubling_number(dtau_max, tau_scat_max)
    dtau = tau / 2.0 ** ndoubl
    expk = torch.exp(-dtau / mu0)

    r_mp, t_pp, j_p, j_m = elemental(
        dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node)
    gids = torch.as_tensor(gids, device=tau.device).long()
    ier, iet, iejp, iejm = ie_elemental(
        (srcs, valids), w_shifts, dtau, f_rayl, tau_sum, z_pp_r[gids],
        z_mp_r[gids], qp, wct2, wct02, i0_vec, i_mu0_n, n_stokes, mu0_node)

    # D-flip, joint doubling, unflip (rows live on the output side)
    dv = d_vec[:, None]
    r_f, t_pp, j_p, jm_f, _, ier_f, iet, iejp, iejm_f = raman_doubling(
        dv * r_mp, t_pp, j_p, d_vec * j_m, expk, dv * ier, iet, iejp,
        d_vec * iejm, (srcs, valids), ndoubl, eye, rsolve,
        ns_schedule=ns_schedule)
    r_mp = dv * r_f
    j_m = d_vec * jm_f
    ier = dv * ier_f
    iejm = d_vec * iejm_f

    sgn = d_vec[:, None] * d_vec[None, :]
    elastic = LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t_pp,
                      t_mm=sgn * t_pp, j_p=j_p, j_m=j_m)
    ie = IELayer(r_mp=ier, r_pm=sgn * ier, t_pp=iet, t_mm=sgn * iet,
                 j_p=iejp, j_m=iejm)
    return elastic, ie


# --- Raman-coupled interaction (adding) -------------------------------------

def raman_interaction(comp, comp_ie, added, added_ie, shifts, eye, rsolve):
    """Compose composite (top) with added (bottom), elastic + first order.

    Off-diagonal block algebra of rt.interaction
    (ref: interaction_inelastic.jl:230-342).
    """
    srcs, valids = _as_rows(shifts, comp.r_mp.shape[0], comp.r_mp.device)
    m_fn = getattr(rsolve, "materialize_m", None)   # see raman_doubling

    def tk(x):
        return take0(x, srcs, valids)

    def solve_off(x, a, m):
        if m is None:
            return rsolve(x, take0_id(a, srcs, valids, eye))
        return bmm_ie(x, take0_id(m, srcs, valids, eye))

    a1 = eye - bmm(added.r_mp, comp.r_pm)
    if m_fn is None:
        m1 = None
        t01 = rsolve(comp.t_mm, a1)
    else:
        m1 = m_fn(a1)
        t01 = bmm(comp.t_mm, m1)
    v1 = bmv(added.r_mp, comp.j_p) + added.j_m
    w1 = bmm(added.r_mp, comp.t_pp)

    a2 = eye - bmm(comp.r_pm, added.r_mp)
    if m_fn is None:
        m2 = None
        t21 = rsolve(added.t_pp, a2)
    else:
        m2 = m_fn(a2)
        t21 = bmm(added.t_pp, m2)
    v2 = comp.j_p + bmv(comp.r_pm, added.j_m)
    w2 = bmm(comp.r_pm, added.t_mm)

    c_ie, a_ie = comp_ie, added_ie
    x1 = bmm_ie(t01, bmm_ie(a_ie.r_mp, tk(comp.r_pm))
                + bmm_ie(added.r_mp, c_ie.r_pm)) + c_ie.t_mm
    t01_off = solve_off(x1, a1, m1)
    del x1
    v1_off = (bmv(a_ie.r_mp, tk(comp.j_p)) + bmv(added.r_mp, c_ie.j_p)
              + a_ie.j_m)
    iejm = c_ie.j_m + bmv(t01, v1_off) + bmv(t01_off, tk(v1))
    w1_off = (bmm_ie(a_ie.r_mp, tk(comp.t_pp))
              + bmm_ie(added.r_mp, c_ie.t_pp))
    ier_mp = c_ie.r_mp + bmm_ie(t01, w1_off) + bmm_ie(t01_off, tk(w1))
    del w1_off
    iet_mm = bmm_ie(t01, a_ie.t_mm) + bmm_ie(t01_off, tk(added.t_mm))
    del t01_off

    x2 = bmm_ie(t21, bmm_ie(c_ie.r_pm, tk(added.r_mp))
                + bmm_ie(comp.r_pm, a_ie.r_mp)) + a_ie.t_pp
    t21_off = solve_off(x2, a2, m2)
    del x2
    v2_off = (c_ie.j_p + bmv(c_ie.r_pm, tk(added.j_m))
              + bmv(comp.r_pm, a_ie.j_m))
    iejp = a_ie.j_p + bmv(t21, v2_off) + bmv(t21_off, tk(v2))
    iet_pp = bmm_ie(t21, c_ie.t_pp) + bmm_ie(t21_off, tk(comp.t_pp))
    w2_off = (bmm_ie(c_ie.r_pm, tk(added.t_mm))
              + bmm_ie(comp.r_pm, a_ie.t_mm))
    ier_pm = a_ie.r_pm + bmm_ie(t21, w2_off) + bmm_ie(t21_off, tk(w2))
    ie_new = IELayer(ier_mp, ier_pm, iet_pp, iet_mm, iejp, iejm)

    elastic_new = LayerRT(
        r_mp=comp.r_mp + bmm(t01, w1),
        r_pm=added.r_pm + bmm(t21, w2),
        t_pp=bmm(t21, comp.t_pp),
        t_mm=bmm(t01, added.t_mm),
        j_p=added.j_p + bmv(t21, v2),
        j_m=comp.j_m + bmv(t01, v1))
    return elastic_new, ie_new


# --- full RRS forward driver ------------------------------------------------

class _MomentInputs(NamedTuple):
    """Device inputs of one Fourier moment shared by the layer scans."""
    tau: torch.Tensor
    omega: torch.Tensor
    zw: torch.Tensor
    z_pp_c: torch.Tensor
    z_mp_c: torch.Tensor
    z_pp_r: torch.Tensor
    z_mp_r: torch.Tensor
    f_rayl: torch.Tensor
    geom: Geometry
    albedo: torch.Tensor
    m: int
    solver: str
    #: (nZ,) host maxima of tau * omega over the whole band, or None
    tau_scat_max: Optional[np.ndarray] = None


def _layer_fn(mi: _MomentInputs, srcs, valids, w_shifts, gids):
    """One layer's (LayerRT, IELayer) for the shift rows given, with
    optional per-layer static (ndoubl, NS schedule)."""
    rsolve = make_rsolve(mi.solver)
    n_spec = mi.tau.shape[1]
    n = mi.geom.qp.shape[0]
    dtype, device = mi.tau.dtype, mi.tau.device
    eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
    streams = mi.geom.layer_args(mi.m)
    tau_sum_all = torch.cat([torch.zeros((1, n_spec), dtype=dtype,
                                         device=device),
                             torch.cumsum(mi.tau, dim=0)], dim=0)

    def layer(iz, nd=None, sched=None):
        w_z = w_shifts[iz] if w_shifts.ndim == 3 else w_shifts
        z_pp = mix_z(mi.zw[iz], mi.z_pp_c)
        z_mp = mix_z(mi.zw[iz], mi.z_mp_c)
        return raman_make_added_layer(
            mi.tau[iz], mi.omega[iz], z_pp, z_mp, mi.z_pp_r, mi.z_mp_r,
            tau_sum_all[iz], mi.f_rayl[iz], (srcs, valids), w_z, gids,
            *streams, mi.geom.min_qp_mu_h, eye, rsolve,
            ndoubl_static=nd, ns_schedule=sched,
            tau_scat_max=(None if mi.tau_scat_max is None
                          else float(mi.tau_scat_max[iz])))

    surf = surface_layer(mi.geom, mi.m, tau_sum_all[-1], mi.albedo)
    return layer, surf, eye, rsolve


def _fourier_step_rrs(mi: _MomentInputs, srcs, valids, w_shifts, gids,
                      layer_schedules=None):
    """One Fourier moment of the Raman-coupled RT for the shift rows given:
    joint elastic+ie layer scan TOA -> BOA, Lambertian surface (no Raman at
    the surface). ref: rt_run.jl RRS path + rt_kernel.jl:278-343.

    ``layer_schedules``: per-layer static (ndoubl, NS schedule, ni) from
    _raman_layer_schedules, or None for each layer's own doubling count
    with the moment's solver.
    Returns (composite LayerRT, ie j_p and j_m summed over the rows).
    """
    layer, surf, eye, rsolve = _layer_fn(mi, srcs, valids, w_shifts, gids)
    n_spec, n = mi.tau.shape[1], mi.geom.qp.shape[0]
    comp = vacuum_layer(n_spec, n, mi.tau.dtype, mi.tau.device)
    comp_ie = zero_ie(srcs.shape[0], n_spec, n, mi.tau.dtype, mi.tau.device)
    for iz in range(mi.tau.shape[0]):
        entry = layer_schedules[iz][:2] if layer_schedules else (None, None)
        added, added_ie = layer(iz, *entry)
        comp, comp_ie = raman_interaction(comp, comp_ie, added, added_ie,
                                          (srcs, valids), eye, rsolve)
        del added, added_ie
    surf_ie = zero_ie(srcs.shape[0], n_spec, n, mi.tau.dtype, mi.tau.device)
    comp, comp_ie = raman_interaction(comp, comp_ie, surf, surf_ie,
                                      (srcs, valids), eye, rsolve)
    return comp, comp_ie.j_p.sum(dim=0), comp_ie.j_m.sum(dim=0)


def build_coupling(specs, n_spec: int):
    """Normalize inelastic coupling specs into dense per-output rows.

    Each spec is an ``inelastic.rrs.RRS`` (banded: i_shift/w_shift, with an
    optional band_range restricting outputs+sources to a sub-grid of the
    concatenated axis) or an ``inelastic.plus.AbsoluteRaman`` (absolute
    i_out/i_src/w rows). Returns numpy (srcs, valids, ws, gids) with
    shapes (nR, nSpec) x3 + (nR,); ws is (nZ, nR, nSpec) for per-layer
    weights. Raises ValueError when the specs hold no row (a grid narrower
    than every shift: make_vs on one band that does not span the
    vibrationally shifted range).
    """
    srcs, valids, ws, gids = [], [], [], []
    idx = np.arange(n_spec)
    for g, s in enumerate(specs):
        if hasattr(s, "i_out"):                 # absolute coupling rows
            src = np.full(n_spec, int(s.i_src), np.int32)
            w = np.zeros(n_spec)
            np.add.at(w, np.asarray(s.i_out, np.int64), np.asarray(s.w))
            srcs.append(src)
            valids.append(np.ones(n_spec, bool))
            ws.append(w)
            gids.append(g)
            continue
        lo, hi = (0, n_spec)
        if getattr(s, "band_range", None) is not None:
            lo, hi = s.band_range
        in_band = (idx >= lo) & (idx < hi)
        for shift, w_s in zip(s.i_shift, np.asarray(s.w_shift).T):
            # w_s: scalar (global) or (nZ,) per-layer weights for this shift
            src = idx + int(shift)
            valid = in_band & (src >= lo) & (src < hi)
            srcs.append(np.clip(src, 0, n_spec - 1).astype(np.int32))
            valids.append(valid)
            if np.ndim(w_s) == 0:
                ws.append(np.where(valid, w_s, 0.0))
            else:
                ws.append(np.where(valid[None, :], w_s[:, None], 0.0))
            gids.append(g)
    if not srcs:
        raise ValueError(
            "no Raman shift row couples two points of this spectral grid: "
            "it is narrower than every shift of the coupling specs (for "
            "vibrational Raman use a grid spanning the incident and the "
            "shifted ranges, or the concatenated-band make_vs_plus)")
    ws = np.stack(ws)
    if ws.ndim == 3:                       # (nR, nZ, nSpec) -> (nZ, nR, nSpec)
        ws = ws.transpose(1, 0, 2)
    return (np.stack(srcs), np.stack(valids), ws,
            np.asarray(gids, np.int32))


def _raman_layer_schedules(tau, omega, min_qp_mu, tau_scat_max=None):
    """Exact (unquantized) per-layer static doubling schedules for the
    Raman scan: nd matches the data-derived doubling count per layer, with
    the per-step NS iteration schedule of ns_doubling_schedule. Returns a
    tuple of (nd, sched, ni=4) 3-tuples, or None where a layer's
    scattering depth is not finite or no layer scatters.
    ``tau_scat_max``: (nZ,) maxima of tau * omega over a whole band, in
    place of those over ``tau``."""
    tau_scat = (np.max(np.asarray(tau) * np.asarray(omega), axis=1)
                if tau_scat_max is None
                else np.asarray(tau_scat_max, np.float64))
    if not np.all(np.isfinite(tau_scat)) or not np.any(tau_scat > 0):
        return None
    dm = np.minimum(np.maximum(tau_scat, 1e-30), 0.004 * min_qp_mu)
    nd = np.maximum(np.ceil(np.log2(np.maximum(tau_scat / dm, 1.0))),
                    0).astype(int)
    return tuple(
        (int(k), ns_doubling_schedule(float(ts), min_qp_mu, int(k)), 4)
        for k, ts in zip(nd, tau_scat))


#: bytes of one ie matrix field (rows x nSpec x N x N) per chunk of shift
#: rows, by device type: about 25 such fields are live at once inside
#: raman_interaction. The card takes large batches; on the CPU, chunks
#: that stay near the caches run faster than one chunk of all rows.
IE_CHUNK_BYTES = {"cuda": 1 << 30, "cpu": 1 << 24}


def ie_chunk_rows(n_r: int, n_spec: int, n: int, dtype, device) -> int:
    """Shift rows per chunk: as many as keep one ie matrix field within
    IE_CHUNK_BYTES of ``device``'s type (at least one, at most n_r)."""
    per_row = n_spec * n * n * torch.finfo(dtype).bits // 8
    budget = IE_CHUNK_BYTES[torch.device(device).type]
    return max(1, min(n_r, budget // per_row))


class _RamanRun(NamedTuple):
    """Host set-up shared by rt_run_band_rrs and rt_run_band_rrs_ms."""
    srcs: torch.Tensor
    valids: torch.Tensor
    w_shifts: torch.Tensor
    gids: torch.Tensor
    chunk: int
    moment: callable          # m -> _MomentInputs
    geom: Geometry


def _setup_raman(pol, quad, band, rrs, f_rayl, surface, dtype, device,
                 solver, tau_scat_max=None, coupling=None):
    """Validate a Raman run's surface and build its coupling rows (or take
    ``coupling``, prebuilt rows of build_coupling's form) and per-moment
    device inputs."""
    if surface["type"] != "LambertianSurfaceScalar":
        raise ValueError(
            f"Raman runs take a LambertianSurfaceScalar surface (as the "
            f"reference), not {surface['type']!r}")
    specs = list(rrs) if isinstance(rrs, (list, tuple)) else [rrs]
    n_spec = band.tau.shape[1]
    geom = geometry(pol, quad, dtype, device)
    to_dev = geom.to_dev

    srcs_np, valids_np, ws_np, gids_np = (
        build_coupling(specs, n_spec) if coupling is None else coupling)
    srcs = torch.as_tensor(srcs_np, device=device).long()
    valids = torch.as_tensor(valids_np, device=device)
    shared = dict(
        tau=to_dev(band.tau), omega=to_dev(band.omega), zw=to_dev(band.zw),
        f_rayl=to_dev(f_rayl), geom=geom,
        albedo=to_dev(float(surface["albedo"])), solver=solver,
        tau_scat_max=tau_scat_max)

    def moment(m):
        z_pp_c, z_mp_c = geom.z_moments(band.greeks, m)
        z_pp_r, z_mp_r = geom.z_moments([s.greek_raman for s in specs], m)
        return _MomentInputs(z_pp_c=z_pp_c, z_mp_c=z_mp_c, z_pp_r=z_pp_r,
                             z_mp_r=z_mp_r, m=m, **shared)

    return _RamanRun(srcs, valids, to_dev(ws_np),
                     torch.as_tensor(gids_np, device=device).long(),
                     ie_chunk_rows(len(srcs_np), n_spec,
                                   len(quad.qp_mu_n), dtype, device),
                     moment, geom)


def _chunks(run: _RamanRun):
    """(srcs, valids, w_shifts, gids) of each chunk of shift rows."""
    n_r = run.srcs.shape[0]
    for lo in range(0, n_r, run.chunk):
        sl = slice(lo, min(n_r, lo + run.chunk))
        w = run.w_shifts[:, sl] if run.w_shifts.ndim == 3 \
            else run.w_shifts[sl]
        yield run.srcs[sl], run.valids[sl], w, run.gids[sl]


def rt_run_band_rrs(pol, quad, band, rrs, f_rayl, vza, vaz, max_m: int,
                    surface, dtype=torch.float64, solver: Optional[str] = None,
                    device=DEFAULT_DEVICE, static_schedules: bool = False,
                    tau_scat_max=None, coupling=None,
                    ie_precision: str = "highest"):
    """Forward run with Raman coupling (RRS / VS / RVRS / ``_plus`` groups)
    for one band or a concatenated multi-band spectral axis.

    rrs: a single inelastic coupling spec (inelastic.rrs.RRS, the specs
    from make_vs, or inelastic.plus.AbsoluteRaman) or a list of them; each
    contributes its own source-index rows and Raman phase matrix.
    f_rayl: (nZ, nSpec) Rayleigh-scattering fraction tau_rayl/tau_total per
    layer. Returns (R, T, ieR, ieT), each (n_vza, n_stokes, nSpec): elastic
    (Cabannes) radiances and the first-order Raman corrections
    (ref: rt_run.jl:219-226 return R_SFI.., ieR_SFI..).
    ``device``: "cuda" (default) or "cpu". ``solver``: "lu" (default on
    the CPU) or "schulz" (default on CUDA). ``static_schedules``: under
    schulz, each layer doubles on its static per-step NS schedule
    (_raman_layer_schedules) instead of the solver's fixed count; off by
    default. Surfaces other than LambertianSurfaceScalar raise ValueError.
    The elastic products run in full float32 (TF32 off) or float64, as the
    JAX package pins them; ``ie_precision`` ("highest", "high" or
    "default", core/precision.py) is the mode of the float32 ie products
    (bmm_ie).
    A spectral shard of a band (parallel/sharding.py) passes the whole
    band's ``tau_scat_max`` ((nZ,) maxima of tau * omega: the doubling
    counts) and ``coupling`` (the (srcs, valids, ws, gids) rows of
    build_coupling remapped onto its points, in place of rows built from
    ``rrs`` on its own grid); None (default) derives both from ``band``.
    """
    device = resolve_device(device)
    solver = default_solver(device, solver)
    n_spec = band.tau.shape[1]
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    layer_schedules = None
    if static_schedules:
        if solver != "schulz":
            raise ValueError("static_schedules needs the schulz solver")
        layer_schedules = _raman_layer_schedules(
            band.tau, band.omega, float(np.min(quad.qp_mu)), tau_scat_max)
        if layer_schedules is None:
            raise ValueError("no static schedule for this profile: a "
                             "layer's scattering depth is not finite, or "
                             "no layer scatters")

    run = _setup_raman(pol, quad, band, rrs, f_rayl, surface, dtype, device,
                       solver, tau_scat_max, coupling)
    syn = Synthesis(run.geom, vza, vaz, n_spec, 4)
    with precision.matmul_precision("highest"), \
            precision.scoped("ie", ie_precision):
        for m in range(max_m):
            mi = run.moment(m)
            ie_p = ie_m = comp = None
            for rows in _chunks(run):
                comp_c, iejp, iejm = _fourier_step_rrs(
                    mi, *rows, layer_schedules=layer_schedules)
                comp = comp_c if comp is None else comp
                ie_p = iejp if ie_p is None else ie_p + iejp
                ie_m = iejm if ie_m is None else ie_m + iejm
            j_m, j_p = comp.j_m.cpu().numpy(), comp.j_p.cpu().numpy()
            ie_m, ie_p = ie_m.cpu().numpy(), ie_p.cpu().numpy()
            syn.add(m, j_m, j_p, ie_m, ie_p)
    return tuple(syn.outs)


# --- inelastic multi-sensor (interior-level radiances with Raman) -----------

def ie_interlayer_flux(top, top_ie, bot, bot_ie, shifts, eye, rsolve):
    """Up/downwelling radiance at the interface between a top and bottom
    composite, elastic + first-order Raman.

    Elastic coupling (ref: CoreKernel/interlayer_flux.jl:7-25):
        dwJ = (I - R_top^{+-} R_bot^{-+})^{-1} (J_top^+ + R_top^{+-} J_bot^-)
        uwJ = (I - R_bot^{-+} R_top^{+-})^{-1} (J_bot^- + R_bot^{-+} J_top^+)
    The ie terms are the off-diagonal blocks of the same algebra applied to
    the 2x2 block operators (module docstring).
    Returns (uw, dw, ie_uw, ie_dw); ie_* carry the Raman-shift axis.
    """
    srcs, valids = _as_rows(shifts, top.r_mp.shape[0], top.r_mp.device)

    def tk(x):
        return take0(x, srcs, valids)

    def lsolve(a, v):
        return rsolve(v[..., None, :], a.transpose(-1, -2))[..., 0, :]

    a_dw = eye - bmm(top.r_pm, bot.r_mp)
    dw = lsolve(a_dw, top.j_p + bmv(top.r_pm, bot.j_m))
    a_uw = eye - bmm(bot.r_mp, top.r_pm)
    uw = lsolve(a_uw, bot.j_m + bmv(bot.r_mp, top.j_p))

    m_ie_dw = bmm_ie(top_ie.r_pm, tk(bot.r_mp)) + bmm_ie(top.r_pm,
                                                         bot_ie.r_mp)
    ie_u_dw = (top_ie.j_p + bmv(top_ie.r_pm, tk(bot.j_m))
               + bmv(top.r_pm, bot_ie.j_m))
    ie_dw = lsolve(a_dw, ie_u_dw + bmv(m_ie_dw, tk(dw)))
    del m_ie_dw
    m_ie_uw = bmm_ie(bot_ie.r_mp, tk(top.r_pm)) + bmm_ie(bot.r_mp,
                                                         top_ie.r_pm)
    ie_u_uw = (bot_ie.j_m + bmv(bot_ie.r_mp, tk(top.j_p))
               + bmv(bot.r_mp, top_ie.j_p))
    ie_uw = lsolve(a_uw, ie_u_uw + bmv(m_ie_uw, tk(uw)))
    return uw, dw, ie_uw, ie_dw


def _fourier_step_rrs_ms(mi: _MomentInputs, srcs, valids, w_shifts, gids,
                         sensor_levels):
    """One Fourier moment of the Raman-coupled multi-sensor RT for the
    shift rows given: a forward scan carrying the (elastic, ie) composite
    above each sensor level and a reverse scan carrying the one below it
    (surface included), then the ie-aware interlayer-flux coupling per
    sensor. ref: rt_run_multisensor.jl + interaction_multisensor.jl RS
    paths. Returns (uw, dw, ie_uw, ie_dw), each (nSensor, nSpec, N), the
    ie ones summed over the rows."""
    layer, surf, eye, rsolve = _layer_fn(mi, srcs, valids, w_shifts, gids)
    n_z, n_spec = mi.tau.shape
    n = mi.geom.qp.shape[0]
    dtype, device = mi.tau.dtype, mi.tau.device
    rows = (srcs, valids)

    tops = {}
    carry = (vacuum_layer(n_spec, n, dtype, device),
             zero_ie(srcs.shape[0], n_spec, n, dtype, device))
    prev = 0
    for s in sorted(sensor_levels):
        for iz in range(prev, s):
            lay, lay_ie = layer(iz)
            carry = raman_interaction(*carry, lay, lay_ie, rows, eye, rsolve)
        prev = max(prev, s)
        tops[s] = carry

    bots = {}
    acc = (surf, zero_ie(srcs.shape[0], n_spec, n, dtype, device))
    prev = n_z
    for s in sorted(sensor_levels, reverse=True):
        for iz in range(prev - 1, s - 1, -1):
            lay, lay_ie = layer(iz)
            acc = raman_interaction(lay, lay_ie, *acc, rows, eye, rsolve)
        prev = min(prev, s)
        bots[s] = acc

    uw, dw, ie_uw, ie_dw = [], [], [], []
    for s in sensor_levels:
        u, d, iu, idw = ie_interlayer_flux(*tops[s], *bots[s], rows, eye,
                                           rsolve)
        uw.append(u)
        dw.append(d)
        ie_uw.append(iu.sum(dim=0))
        ie_dw.append(idw.sum(dim=0))
    return (torch.stack(uw), torch.stack(dw), torch.stack(ie_uw),
            torch.stack(ie_dw))


def rt_run_band_rrs_ms(pol, quad, band, rrs, f_rayl, vza, vaz, max_m: int,
                       surface, sensor_levels, dtype=torch.float64,
                       solver: Optional[str] = None, device=DEFAULT_DEVICE,
                       ie_precision: str = "highest"):
    """Multi-sensor forward run with Raman coupling.

    sensor_levels: layer-interface indices, 0 = TOA .. nZ = BOA.
    Returns (uwJ, dwJ, ie_uwJ, ie_dwJ), each
    (nSensor, n_vza, n_stokes, nSpec).
    ref: rt_run_multisensor.jl rt_run_test_ms with RS types +
    postprocessing_vza_ms.jl ieJ accumulation. ``device``, ``solver``,
    ``ie_precision`` and the surface as in rt_run_band_rrs.
    """
    device = resolve_device(device)
    solver = default_solver(device, solver)
    n_spec = band.tau.shape[1]
    n_z = band.tau.shape[0]
    sensor_levels = tuple(int(s) for s in sensor_levels)
    if not all(0 <= s <= n_z for s in sensor_levels):
        raise ValueError(f"sensor levels {sensor_levels} outside 0..{n_z}")
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    run = _setup_raman(pol, quad, band, rrs, f_rayl, surface, dtype, device,
                       solver)
    syn = Synthesis(run.geom, vza, vaz, n_spec, 4,
                    n_sensor=len(sensor_levels))
    with precision.matmul_precision("highest"), \
            precision.scoped("ie", ie_precision):
        for m in range(max_m):
            mi = run.moment(m)
            acc = None
            for rows in _chunks(run):
                res = _fourier_step_rrs_ms(mi, *rows, sensor_levels)
                # the elastic fields are the same for every chunk
                acc = list(res) if acc is None else \
                    acc[:2] + [acc[2] + res[2], acc[3] + res[3]]
            syn.add(m, *(a.cpu().numpy() for a in acc))
    return tuple(syn.outs)
