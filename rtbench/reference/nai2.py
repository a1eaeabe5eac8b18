"""NAI2 (Siewert) aerosol optical-property decomposition.

Quadrature over the size distribution -> bulk scattering matrix elements ->
Greek coefficients via generalized-spherical-function projection
(Sanghavi 2014 eq. 17). Vectorized numpy (the reference loops radii:
ref src/Scattering/compute_NAI2.jl:16-260).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.reference.legendre import (compute_legendre_poly,
                                           compute_mie_pi_tau)
from rtbench.reference.mie import (Aerosol, compute_mie_S1S2,
                                      compute_mie_ab_batch, cross_sections,
                                      get_n_max, size_distribution_weights)
from rtbench.reference.phase import GreekCoefs
from rtbench.reference.quadrature import gauleg, gauss_legendre


@dataclasses.dataclass
class AerosolOptics:
    """Greek coefficients + bulk optical parameters of one aerosol type.

    ref: Scattering/types.jl:246-257 (AerosolOptics)
    """
    greek_coefs: GreekCoefs
    ssa: float          # single-scattering albedo (omega-tilde)
    k: float            # bulk extinction cross-section
    f_t: float          # delta-BGE truncation factor (1 = untruncated)


def _aerosol_from_spec(spec) -> Aerosol:
    """Accept a mie.Aerosol / BimodalAerosol (anything with .pdf) or a
    config AerosolSpec."""
    if hasattr(spec, "pdf"):
        return spec
    if getattr(spec, "bimodal", None) is not None:
        return spec.bimodal
    return Aerosol(mu=spec.mu, sigma=spec.sigma, n_r=spec.n_r, n_i=spec.n_i)


def _bulk_mie(aerosol: Aerosol, lam: float, n_ref: complex, r_max: float,
              nquad_radius: int, with_matrix: bool = True):
    assert aerosol.n_i >= 0, "Imaginary refractive index must be >= 0"
    r, w_r = gauleg(nquad_radius, 0.0, r_max)
    w_r = w_r / w_r.sum()
    k = 2.0 * np.pi / lam
    x = k * r
    n_max = get_n_max(x.max())
    m = n_ref if n_ref is not None else complex(aerosol.n_r, aerosol.n_i)
    # HITRAN-convention m = n_r - i n_i maps to BH m = n_r + i n_i here
    m = complex(m.real, abs(m.imag))
    an, bn = compute_mie_ab_batch(x, m, n_max)
    c_sca, c_ext = cross_sections(an, bn, k)
    wx = size_distribution_weights(aerosol, w_r, r)
    out = {"r": r, "x": x, "k": k, "n_max": n_max, "an": an, "bn": bn,
           "c_sca": c_sca, "c_ext": c_ext, "wx": wx,
           "bulk_c_sca": np.sum(wx * c_sca), "bulk_c_ext": np.sum(wx * c_ext)}
    return out


def compute_ref_aerosol_extinction(spec, lam: float, n_ref: complex,
                                   r_max: float, nquad_radius: int) -> float:
    """Bulk extinction cross-section at the reference wavelength.

    ref: compute_NAI2.jl:184-260
    """
    aero = _aerosol_from_spec(spec)
    b = _bulk_mie(aero, lam, n_ref, r_max, nquad_radius, with_matrix=False)
    return float(b["bulk_c_ext"])


def compute_aerosol_optical_properties(spec, lam: float, r_max: float,
                                       nquad_radius: int, pol=None,
                                       n_ref: complex = None) -> AerosolOptics:
    """Full NAI2 pipeline: S1/S2 -> f-matrix -> Greek coefficients.

    ref: compute_NAI2.jl:16-182
    """
    aero = _aerosol_from_spec(spec)
    b = _bulk_mie(aero, lam, n_ref, r_max, nquad_radius)
    n_max, x, r, wx = b["n_max"], b["x"], b["r"], b["wx"]

    n_mu = 2 * n_max - 1
    mu, w_mu = gauss_legendre(n_mu)
    leg_pi, leg_tau = compute_mie_pi_tau(mu, n_max)
    s1, s2 = compute_mie_S1S2(b["an"], b["bn"], leg_pi, leg_tau)  # (n_mu, nr)

    inv_x2 = 0.5 / x[None, :] ** 2
    f11 = inv_x2 * (np.abs(s1) ** 2 + np.abs(s2) ** 2)
    f33 = inv_x2 * 2.0 * np.real(s1 * np.conj(s2))
    f12 = -inv_x2 * (np.abs(s1) ** 2 - np.abs(s2) ** 2)
    f34 = -inv_x2 * np.imag(s1 * np.conj(s2) - s2 * np.conj(s1))

    wr = 4.0 * np.pi * r**2 * wx
    bulk_c_sca, bulk_c_ext = b["bulk_c_sca"], b["bulk_c_ext"]
    bf11 = (f11 @ wr) / bulk_c_sca
    bf33 = (f33 @ wr) / bulk_c_sca
    bf12 = (f12 @ wr) / bulk_c_sca
    bf34 = (f34 @ wr) / bulk_c_sca

    # Greek projection (Sanghavi 2014 eq. 17), vectorized over l
    l_max = n_mu
    P, P2, R2, T2 = compute_legendre_poly(mu, l_max)
    ls = np.arange(l_max)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = (2 * ls + 1) / 2.0 * np.sqrt(
            1.0 / ((ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0)))
    fac[:2] = 0.0

    wP = w_mu[:, None] * P
    wP2 = w_mu[:, None] * P2
    wR2 = w_mu[:, None] * R2
    wT2 = w_mu[:, None] * T2
    coef = (2 * ls + 1) / 2.0
    delta = coef * (bf33 @ wP)
    beta = coef * (bf11 @ wP)
    gamma = fac * (bf12 @ wP2)
    eps = fac * (bf34 @ wP2)
    zeta = fac * (bf33 @ wR2 + bf11 @ wT2)
    alpha = fac * (bf11 @ wR2 + bf33 @ wT2)

    gc = GreekCoefs(alpha, beta, gamma, delta, eps, zeta)
    return AerosolOptics(greek_coefs=gc, ssa=float(bulk_c_sca / bulk_c_ext),
                         k=float(bulk_c_ext), f_t=1.0)
