"""Differentiable Mie -> NAI2 -> Greek-coefficient chain (aerosol
microphysics autodiff).

Port of ``vsmartmom/scattering/mie_ad.py``: the numpy setup path of mie.py /
nai2.py in torch, so that ``torch.func.jacfwd`` yields
d(AerosolOptics)/d(mu, sigma, n_r, n_i), the seam the reference exposes
through ForwardDiff (ref: src/Scattering/phase_function_autodiff.jl:41-94)
and uses for aerosol-state retrievals (test/prototyping/AD_OCO2_test.jl).

  * Everything radius-dependent but parameter-independent (radius
    quadrature, size parameters x, Riccati-Bessel psi/chi recursions,
    pi/tau angular functions, Legendre projection tables) is built once in
    numpy float64 (make_setup); only the parameter-dependent math runs in
    torch, on the device of the parameters.
  * The D_n logarithmic-derivative downward recurrence is a Python loop
    over n on an (nr,) complex tensor, sequential by nature.
  * Complex tensors carry the tangents: every complex op used (complex
    construction, division, abs, conj, real, imag, matmul) has a forward
    formula in torch.
  * The numpy path (nai2.compute_aerosol_optical_properties) remains the
    float64 cross-check; the tests pin both to each other and to JAX.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vsmartmom_torch.scattering.legendre import (compute_legendre_poly,
                                                 compute_mie_pi_tau)
from vsmartmom_torch.scattering.mie import get_n_max
from vsmartmom_torch.scattering.nai2 import AerosolOptics
from vsmartmom_torch.scattering.phase import GreekCoefs
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device
from vsmartmom_torch.util.quadrature import gauleg, gauss_legendre


@dataclasses.dataclass(frozen=True)
class MieSetup:
    """Static (parameter-independent) tables for one (lambda, r grid)."""
    lam: float
    r: np.ndarray          # (nr,) radius quadrature nodes
    w_r: np.ndarray        # (nr,) normalized quadrature weights
    x: np.ndarray          # (nr,) size parameters
    n_max: int
    nmx: int               # start order of the downward D recurrence
    psi: np.ndarray        # (nr, n_max) Riccati-Bessel psi_n(x)
    psi_m1: np.ndarray     # psi_{n-1}
    xi: np.ndarray         # (nr, n_max) complex psi - i chi
    xi_m1: np.ndarray
    trunc: np.ndarray      # (nr, n_max) per-radius order mask
    mu: np.ndarray         # (n_mu,) angular quadrature
    w_mu: np.ndarray
    leg_pi: np.ndarray     # (n_mu, n_max)
    leg_tau: np.ndarray
    proj: dict             # Legendre projection tables


def make_setup(lam: float, r_max: float, nquad_radius: int) -> MieSetup:
    """The parameter-independent tables of greek_stack (numpy float64)."""
    r, w_r = gauleg(nquad_radius, 0.0, r_max)
    w_r = w_r / w_r.sum()
    k = 2.0 * np.pi / lam
    x = k * r
    n_max = get_n_max(x.max())
    n_max_i = np.array([get_n_max(xi) for xi in x])

    # Riccati-Bessel psi/chi upward recurrences (x only), frozen per radius
    # beyond n_max(x_i) exactly as mie.py
    nr = len(x)
    psi = np.zeros((nr, n_max))
    psi_m1 = np.zeros((nr, n_max))
    chi = np.zeros((nr, n_max))
    chi_m1 = np.zeros((nr, n_max))
    p0, p1 = np.cos(x), np.sin(x)
    c0, c1 = -np.sin(x), np.cos(x)
    for n in range(1, n_max + 1):
        active = n <= n_max_i
        pn = np.where(active, (2 * n - 1) * p1 / x - p0, p1)
        cn = np.where(active, (2 * n - 1) * c1 / x - c0, c1)
        psi[:, n - 1] = pn
        psi_m1[:, n - 1] = p1
        chi[:, n - 1] = cn
        chi_m1[:, n - 1] = c1
        p0, p1 = np.where(active, p1, p0), pn
        c0, c1 = np.where(active, c1, c0), cn

    n_mu = 2 * n_max - 1
    mu, w_mu = gauss_legendre(n_mu)
    leg_pi, leg_tau = compute_mie_pi_tau(mu, n_max)
    P, P2, R2, T2 = compute_legendre_poly(mu, n_mu)
    ls = np.arange(n_mu)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = (2 * ls + 1) / 2.0 * np.sqrt(
            1.0 / ((ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0)))
    fac[:2] = 0.0
    proj = dict(P=P, P2=P2, R2=R2, T2=T2, fac=fac,
                coef=(2 * ls + 1) / 2.0)
    trunc = (np.arange(1, n_max + 1)[None, :] <= n_max_i[:, None])
    nmx = int(np.ceil(max(n_max, x.max() * 1.7) + 51))
    return MieSetup(lam=lam, r=r, w_r=w_r, x=x, n_max=n_max, nmx=nmx,
                    psi=psi, psi_m1=psi_m1,
                    xi=psi - 1j * chi, xi_m1=psi_m1 - 1j * chi_m1,
                    trunc=trunc, mu=mu, w_mu=w_mu,
                    leg_pi=leg_pi, leg_tau=leg_tau, proj=proj)


def _mie_ab(setup: MieSetup, m, device):
    """a_n, b_n (nr, n_max) as functions of the complex refractive index m
    (a 0-dim complex tensor): the downward D_n recurrence, then BH eq.
    4.88."""
    def c(v):
        return torch.as_tensor(v, dtype=torch.complex128, device=device)
    x = torch.as_tensor(setup.x, dtype=torch.float64, device=device)
    y = x * m                               # (nr,) complex
    # D of order n from D of order n + 1, n = nmx - 1 .. 1; orders
    # 1 .. n_max kept (mie.compute_mie_ab_batch's d[k] holds order k + 1)
    d = torch.zeros_like(y)
    kept = []
    for n in range(setup.nmx - 1, 0, -1):
        np1_y = (n + 1.0) / y
        d = np1_y - 1.0 / (d + np1_y)
        if n <= setup.n_max:
            kept.append(d)
    d = torch.stack(kept[::-1], dim=1)      # (nr, n_max): orders 1..n_max

    n_x = (torch.arange(1, setup.n_max + 1, dtype=torch.float64,
                        device=device)[None, :] / x[:, None])
    t_a = d / m + n_x
    t_b = d * m + n_x
    psi, psi1, xi, xi1 = (c(v) for v in (setup.psi, setup.psi_m1, setup.xi,
                                          setup.xi_m1))
    an = (t_a * psi - psi1) / (t_a * xi - xi1)
    bn = (t_b * psi - psi1) / (t_b * xi - xi1)
    mask = c(setup.trunc)
    return an * mask, bn * mask


def greek_stack(setup: MieSetup, theta):
    """theta = (mu_g, sigma_g, n_r, n_i), a (4,) float64 tensor -> (greeks
    (6, n_mu), ssa, k_ext) on theta's device: the NAI2 pipeline of
    nai2.compute_aerosol_optical_properties in torch."""
    device = theta.device

    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    def c128(v):
        return torch.as_tensor(v, dtype=torch.complex128, device=device)

    mu_g, sigma_g, n_r, n_i = theta
    m = torch.complex(n_r, torch.abs(n_i))
    r, x = f64(setup.r), f64(setup.x)
    k = 2.0 * math.pi / setup.lam

    # log-normal quadrature weights (differentiable in mu_g, sigma_g)
    mu_ln, sig_ln = torch.log(mu_g), torch.log(sigma_g)
    pdf = (torch.exp(-0.5 * ((torch.log(r) - mu_ln) / sig_ln) ** 2)
           / (r * sig_ln * math.sqrt(2.0 * math.pi)))
    wx = pdf * f64(setup.w_r)
    wx = wx / wx.sum()

    an, bn = _mie_ab(setup, m, device)

    n_arr = torch.arange(1, setup.n_max + 1, dtype=torch.float64,
                         device=device)
    w2n1 = 2 * n_arr + 1
    c_sca = 2 * math.pi / k ** 2 * ((torch.abs(an) ** 2
                                     + torch.abs(bn) ** 2) @ w2n1)
    c_ext = 2 * math.pi / k ** 2 * (torch.real(an + bn) @ w2n1)
    bulk_c_sca = torch.sum(wx * c_sca)
    bulk_c_ext = torch.sum(wx * c_ext)

    coef_n = (w2n1 / (n_arr * (n_arr + 1))).to(torch.complex128)
    ca, cb = coef_n * an, coef_n * bn
    leg_pi, leg_tau = c128(setup.leg_pi), c128(setup.leg_tau)
    s1 = leg_tau @ ca.T + leg_pi @ cb.T      # (n_mu, nr)
    s2 = leg_pi @ ca.T + leg_tau @ cb.T

    inv_x2 = 0.5 / x[None, :] ** 2
    f11 = inv_x2 * (torch.abs(s1) ** 2 + torch.abs(s2) ** 2)
    f33 = inv_x2 * 2.0 * torch.real(s1 * torch.conj(s2))
    f12 = -inv_x2 * (torch.abs(s1) ** 2 - torch.abs(s2) ** 2)
    f34 = -inv_x2 * torch.imag(s1 * torch.conj(s2) - s2 * torch.conj(s1))

    wr = 4.0 * math.pi * r ** 2 * wx
    bf11 = (f11 @ wr) / bulk_c_sca
    bf33 = (f33 @ wr) / bulk_c_sca
    bf12 = (f12 @ wr) / bulk_c_sca
    bf34 = (f34 @ wr) / bulk_c_sca

    pr = setup.proj
    w_mu = f64(setup.w_mu)[:, None]
    wP, wP2, wR2, wT2 = (w_mu * f64(pr[key])
                         for key in ("P", "P2", "R2", "T2"))
    fac, coef = f64(pr["fac"]), f64(pr["coef"])
    delta = coef * (bf33 @ wP)
    beta = coef * (bf11 @ wP)
    gamma = fac * (bf12 @ wP2)
    eps = fac * (bf34 @ wP2)
    zeta = fac * (bf33 @ wR2 + bf11 @ wT2)
    alpha = fac * (bf11 @ wR2 + bf33 @ wT2)

    greeks = torch.stack([alpha, beta, gamma, delta, eps, zeta])
    return greeks, bulk_c_sca / bulk_c_ext, bulk_c_ext


def aerosol_optics_with_derivs(mu_g, sigma_g, n_r, n_i, lam, r_max,
                               nquad_radius, device=DEFAULT_DEVICE):
    """AerosolOptics + forward-mode derivatives w.r.t. (mu, sigma, nr, ni),
    computed in float64 on ``device``.

    Returns (AerosolOptics, derivs) where derivs is a dict of host arrays:
    d_greeks (4, 6, L), d_ssa (4,), d_k (4,), the reference's
    AerosolOptics.derivs seam (phase_function_autodiff.jl:41-94).
    """
    device = resolve_device(device)
    setup = make_setup(lam, r_max, nquad_radius)
    theta = torch.tensor([mu_g, sigma_g, n_r, n_i], dtype=torch.float64,
                         device=device)

    def value_and_aux(th):
        out = greek_stack(setup, th)
        return out, out

    (jg, jssa, jk), (greeks, ssa, k) = torch.func.jacfwd(
        value_and_aux, has_aux=True)(theta)
    greeks = greeks.cpu().numpy()
    gc = GreekCoefs(*[greeks[i] for i in range(6)])
    optics = AerosolOptics(greek_coefs=gc, ssa=float(ssa), k=float(k),
                           f_t=1.0)
    derivs = dict(d_greeks=np.moveaxis(jg.cpu().numpy(), -1, 0),
                  d_ssa=jssa.cpu().numpy(), d_k=jk.cpu().numpy())
    return optics, derivs
