"""Plain doubling-adding RT in float64: the reference's radiances.

Every Fourier moment: per layer an elemental single-scattering slab grown
by doubling to the layer's depth, added under the composite of the layers
above, then the Lambertian surface; every inverse (I - B)^-1 is an exact
batched solve. The products and solves go through a ``Products``: exact
(``EXACT``), or with every operand rounded to bfloat16 (``BF16``), the
reference one precision below the configuration's float32, which is the
comparison's control. The doubling count of each layer follows the band's largest
scattering depth by the rule the program states (``doubling_counts``), so
both sides run one discretization. The azimuthal synthesis sums the
moments at each view.

ref: src/CoreRT/CoreKernel/{elemental,doubling,interaction}.jl,
     src/CoreRT/Surfaces/lambertian_surface.jl,
     src/CoreRT/tools/postprocessing_vza.jl
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.phase import compute_Z_moments
from rtbench.reference.quadrature import nearest_point

#: elemental slab: at most this share of the smallest stream cosine
DTAU_SHARE = 0.004
#: quantum of the per-layer doubling counts of a spread profile
ND_QUANT = 4
#: distinct per-layer schedules past which one count serves every layer
MAX_BUCKETS = 6


def _ns_iters(b: float, tol: float = 1e-8, cap: int = 4) -> int:
    if b <= 0:
        return 0
    if b >= 1:
        return cap
    need = np.log(tol) / np.log(b)
    return min(cap, max(0, int(np.ceil(np.log2(max(need, 1.0)))) - 1))


def _ns_schedule(bound: float, min_mu: float, nd: int) -> tuple:
    out = []
    for k in range(nd):
        r = -np.expm1(-2.0 * bound / 2.0 ** (nd - k) / min_mu)
        out.append(_ns_iters(r * r))
    return tuple(out)


def doubling_counts(tau_scat_max, min_mu: float):
    """Per-layer doubling counts from each layer's largest scattering depth
    (nZ,) over the run's spectral axis: the smallest count that brings the
    elemental slab to DTAU_SHARE * min_mu or below; one count for every
    layer where they spread by 2 or less, else each layer's count raised to
    a multiple of ND_QUANT, and the largest for every layer where the
    layers' schedules take more than MAX_BUCKETS distinct values even with
    the adding's iterations dropped. The schedules' iteration counts only
    decide that last case: the reference solves exactly."""
    ts = np.asarray(tau_scat_max, np.float64)
    n_z = len(ts)
    pos = ts > 0
    if not pos.any():
        return [0] * n_z
    dmax = np.minimum(ts[pos], DTAU_SHARE * min_mu)
    nd = np.ceil(np.log2(np.maximum(ts[pos] / dmax, 1.0)))
    if nd.max() - nd.min() <= 2:
        return [int(nd.max())] * n_z
    nd_all = np.zeros(n_z, dtype=int)
    nd_all[pos] = nd.astype(int)
    nd_all = ND_QUANT * np.ceil(np.maximum(nd_all, 1) / ND_QUANT).astype(int)
    dm = DTAU_SHARE * min_mu
    sched = [(int(k), _ns_schedule(dm * 2.0 ** int(k), min_mu, int(k)))
             for k in nd_all]
    if len(set(sched)) > MAX_BUCKETS:
        return [int(nd_all.max())] * n_z
    return [int(k) for k in nd_all]


class Products:
    """The RT's products and solves. With ``bf16`` every operand is rounded
    to bfloat16 first (``round``) and each product summed in float32, as a
    bfloat16 computation would; the solves stay exact (in float64, on the
    rounded operands)."""

    def __init__(self, bf16: bool = False):
        self.bf16 = bf16

    def round(self, x):
        """``x`` in bfloat16. A square matrix keeps the whole part of its
        diagonal exact and rounds the rest: a transmission's unit diagonal
        rounded to bfloat16 would double its error with every doubling,
        and the radiances diverge."""
        if not self.bf16:
            return x
        if x.ndim >= 2 and x.shape[-1] == x.shape[-2]:
            d = torch.diag_embed(torch.round(torch.diagonal(
                x, dim1=-2, dim2=-1)))
            return d + (x - d).to(torch.bfloat16).to(x.dtype)
        return x.to(torch.bfloat16).to(x.dtype)

    def mm(self, a, b):
        if not self.bf16:
            return a @ b
        return (self.round(a).float() @ self.round(b).float()).to(a.dtype)

    def mv(self, a, v):
        return self.mm(a, v[..., None])[..., 0]

    def rsolve(self, x, a):
        """x @ a^-1 by a batched solve."""
        x, a = self.round(x), self.round(a)
        return torch.linalg.solve(a.transpose(-1, -2),
                                  x.transpose(-1, -2)).transpose(-1, -2)


EXACT = Products()
BF16 = Products(bf16=True)


def _exp_diff(e_b, e_a, arg):
    """e^-b - e^-a from e^-b, e^-a and a - b."""
    return torch.where(arg > 80.0, e_b, e_a * torch.expm1(arg))


def elemental(dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum, i0, i_mu0_n,
              n_stokes, mu0, P=EXACT):
    """Single-scattering slab of depth dtau (S,): r_mp, t_pp (S, N, N) and
    the solar sources j_p, j_m (S, N), attenuated by the depth above."""
    n = qp.shape[0]
    dt = dtau[:, None, None]
    om = omega[:, None, None]
    mu_i, mu_j = qp[:, None], qp[None, :]
    same_mu = mu_i == mu_j
    eye = torch.eye(n, dtype=torch.bool, device=qp.device)
    node = torch.arange(n, device=qp.device) // n_stokes
    merged = same_mu & (node[:, None] != node[None, :])
    col = wct2 > 1e-8
    exp_i = 1.0 + torch.expm1(-dt / mu_i)
    r_mp = (om * z_mp * (mu_j / (mu_i + mu_j)) * wct2
            * (-torch.expm1(-dt * (1.0 / mu_i + 1.0 / mu_j))))
    r_mp = torch.where(col, r_mp, 0.0)
    e_diag = exp_i * (om * z_pp * (dt / mu_i) * wct2)
    denom = torch.where(same_mu, 1.0, mu_i - mu_j)
    t_off = (om * z_pp * (mu_j / denom) * wct2
             * _exp_diff(exp_i, 1.0 + torch.expm1(-dt / mu_j),
                         dt * (mu_i - mu_j) / (mu_i * mu_j)))
    t_pp = torch.where(same_mu, torch.where(eye, exp_i + e_diag,
                                            torch.where(merged, e_diag, 0.0)),
                       t_off)
    t_pp = torch.where(col, t_pp, torch.where(eye, exp_i, 0.0))

    idx = torch.arange(n, device=qp.device)
    in_block = (idx >= i_mu0_n) & (idx < i_mu0_n + n_stokes)
    z_pp_i0 = P.mv(z_pp, i0)
    z_mp_i0 = P.mv(z_mp, i0)
    dt_v = dtau[:, None]
    exp_v = 1.0 + torch.expm1(-dt_v / qp)
    same0 = in_block | (qp == mu0)
    denom0 = torch.where(same0, 1.0, qp - mu0)
    j_p = torch.where(same0, (dt_v / qp) * exp_v,
                      (mu0 / denom0)
                      * _exp_diff(exp_v, 1.0 + torch.expm1(-dt_v / mu0),
                                  dt_v * (qp - mu0) / (qp * mu0)))
    j_p = wct02 * omega[:, None] * z_pp_i0 * j_p
    j_m = (wct02 * omega[:, None] * z_mp_i0 * (mu0 / (qp + mu0))
           * (-torch.expm1(-dt_v * (1.0 / qp + 1.0 / mu0))))
    atten = torch.exp(-tau_sum / mu0)[:, None]
    return r_mp, t_pp, j_p * atten, j_m * atten


def added_layer(tau, omega, z_pp, z_mp, tau_sum, nd, geo, mu0_beam, P=EXACT):
    """Elemental slab of tau / 2^nd doubled nd times, in the D-flipped space
    where one reflection operator serves both directions; returns
    (r_mp, r_pm, t_pp, t_mm, j_p, j_m)."""
    qp, wct2, wct02, i0, i_mu0_n, n_stokes, mu0, d = geo
    dtau = tau / 2.0 ** nd
    r, t, jp, jm = elemental(dtau, omega, z_pp, z_mp, qp, wct2, wct02,
                             tau_sum, i0, i_mu0_n, n_stokes, mu0, P)
    r = d[:, None] * r
    jm = d * jm
    ek = 1.0 + torch.expm1(-dtau / mu0_beam)
    n = r.shape[-1]
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    for _ in range(nd):
        j1p = jp * ek[:, None]
        j1m = jm * ek[:, None]
        tt = P.rsolve(t, eye - P.mm(r, r))         # t (I - r r)^-1
        v1 = j1m + P.mv(r, jp)
        v2 = jp + P.mv(r, j1m)
        jm = jm + P.mv(tt, v1)
        jp = j1p + P.mv(tt, v2)
        r = r + P.mm(tt, P.mm(r, t))
        t = P.mm(tt, t)
        ek = ek * ek
    r_mp = d[:, None] * r
    jm = d * jm
    sgn = d[:, None] * d[None, :]
    return r_mp, sgn * r_mp, t, sgn * t, jp, jm


def interaction(comp, added, P=EXACT):
    """Adding of ``added`` under ``comp``: the full 11 paths."""
    c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm = comp
    a_rmp, a_rpm, a_tpp, a_tmm, a_jp, a_jm = added
    n = c_rmp.shape[-1]
    eye = torch.eye(n, dtype=c_rmp.dtype, device=c_rmp.device)
    mm, mv = P.mm, P.mv
    t01 = P.rsolve(c_tmm, eye - mm(a_rmp, c_rpm))
    j_m = c_jm + mv(t01, mv(a_rmp, c_jp) + a_jm)
    r_mp = c_rmp + mm(t01, mm(a_rmp, c_tpp))
    t_mm = mm(t01, a_tmm)
    t21 = P.rsolve(a_tpp, eye - mm(c_rpm, a_rmp))
    j_p = a_jp + mv(t21, c_jp + mv(c_rpm, a_jm))
    t_pp = mm(t21, c_tpp)
    r_pm = a_rpm + mm(t21, mm(c_rpm, a_tmm))
    return r_mp, r_pm, t_pp, t_mm, j_p, j_m


def lambertian(albedo, s, n_stokes, qp, wt, i0, tau_sum, mu0, is_m0):
    """Lambertian surface of ``albedo`` (a scalar tensor) as an added
    layer; only moment 0 reflects, and only the intensity."""
    n = qp.shape[0]
    dtype, device = qp.dtype, qp.device
    eye = torch.eye(n, dtype=dtype, device=device).expand(s, n, n)
    zm = torch.zeros((s, n, n), dtype=dtype, device=device)
    zv = torch.zeros((s, n), dtype=dtype, device=device)
    if not is_m0:
        return zm, zm, eye, eye, zv, zv
    is_i = ((torch.arange(n, device=device) % n_stokes) == 0).to(dtype)
    rho = 2.0 * albedo * torch.outer(is_i, is_i)
    atten = torch.exp(-tau_sum / mu0)[:, None]
    j_p = i0.expand(s, n) * atten
    j_m = mu0 * (rho @ i0)[None, :] * atten
    r_mp = (rho * (qp * wt)[None, :]).expand(s, n, n)
    return r_mp, zm, eye, eye, j_p, j_m


def synthesis_weights(quad, vza, vaz, m, n_stokes):
    """(stream slice, Stokes weights) of each view at moment m."""
    weight = 0.5 if m == 0 else 1.0
    out = []
    for za, az in zip(vza, vaz):
        i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(za)))
        cm, sm = np.cos(np.deg2rad(m * az)), np.sin(np.deg2rad(m * az))
        out.append((slice(n_stokes * i_mu, n_stokes * (i_mu + 1)),
                    weight * np.array([cm, cm, sm, sm][:n_stokes])))
    return out


def radiance(scene, greeks, tau, omega, zw, albedo, nds, device, P=EXACT):
    """Reflected and transmitted Stokes vectors (n_vza, n_stokes, S) at
    every view for tau, omega (nZ, S), zw (nZ, K, S) float64 tensors, a
    scalar tensor ``albedo`` and the per-layer doubling counts ``nds``,
    with the products and solves ``P``. Differentiable in tau, omega, zw
    and albedo (torch.func)."""
    p, pol, quad = scene.params, scene.pol, scene.quad
    dtype = torch.float64

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    n_z, s = tau.shape
    n = len(quad.qp_mu_n)
    ns = pol.n
    qp, wt = t(quad.qp_mu_n), t(quad.wt_mu_n)
    i0_np = np.zeros(n)
    i0_np[quad.i_mu0_n:quad.i_mu0_n + ns] = pol.i0
    i0, d = t(i0_np), t(np.tile(pol.d, quad.n_quad))
    mu0 = t(quad.qp_mu_n[quad.i_mu0_n])
    mu0_beam = t(quad.mu0)
    tau_sum = torch.cat([torch.zeros((1, s), dtype=dtype, device=device),
                         torch.cumsum(tau, dim=0)])
    R = torch.zeros((len(p.vza), ns, s), dtype=dtype, device=device)
    T = torch.zeros_like(R)
    for m in range(p.max_m):
        zs = [compute_Z_moments(pol, quad.qp_mu, gc, m) for gc in greeks]
        z_pp_c, z_mp_c = t(np.stack([z[0] for z in zs])), \
            t(np.stack([z[1] for z in zs]))
        is_m0 = m == 0
        geo = (qp, wt / 2.0 if is_m0 else wt / 4.0, 0.5 if is_m0 else 0.25,
               i0, quad.i_mu0_n, ns, mu0, d)
        eye = torch.eye(n, dtype=dtype, device=device).expand(s, n, n)
        zero_m = torch.zeros((s, n, n), dtype=dtype, device=device)
        zero_v = torch.zeros((s, n), dtype=dtype, device=device)
        comp = (zero_m, zero_m, eye, eye, zero_v, zero_v)
        for iz in range(n_z):
            z_pp = torch.einsum("ks,kij->sij", P.round(zw[iz]),
                                P.round(z_pp_c))
            z_mp = torch.einsum("ks,kij->sij", P.round(zw[iz]),
                                P.round(z_mp_c))
            comp = interaction(comp, added_layer(
                tau[iz], omega[iz], z_pp, z_mp, tau_sum[iz], nds[iz], geo,
                mu0_beam, P), P)
        comp = interaction(comp, lambertian(albedo, s, ns, qp, wt, i0,
                                            tau_sum[-1], mu0_beam, is_m0), P)
        j_p, j_m = comp[4], comp[5]
        for i, (sl, w) in enumerate(synthesis_weights(quad, p.vza, p.vaz, m,
                                                      ns)):
            R[i] = R[i] + t(w)[:, None] * j_m[:, sl].T
            T[i] = T[i] + t(w)[:, None] * j_p[:, sl].T
    return R, T
