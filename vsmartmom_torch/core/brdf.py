"""BRDF surface reflectance models + azimuthal Fourier decomposition.

Port of ``vsmartmom/core/brdf.py``: setup-time numpy (the (N, N) Fourier
matrices are tiny and spectrally constant; rt_run_band copies each to the
device once per moment).

ref: src/CoreRT/Surfaces/rpv_surface.jl (RPV + generic Fourier machinery),
     src/CoreRT/Surfaces/rossli_surface.jl (RossThick-LiSparse kernels).

All kernels act on the intensity (first Stokes) component only, matching
the reference (`reflectance(brdf, n, ...) = 0 for n > 1`).
"""
from __future__ import annotations

import numpy as np

from vsmartmom_torch.util.quadrature import gauleg


def rpv_reflectance(mu_i, mu_r, dphi, rho0, rho_c, k, theta):
    """Rahman-Pinty-Verstraete BRDF f(mu_i, mu_r, dphi).

    mu_i, mu_r broadcastable arrays; dphi scalar or array (relative azimuth).
    Sign conventions follow the reference's RAMI-compatible form
    (rpv_surface.jl:71-97): cos g = -mu_i mu_r + sin sin cos(dphi),
    G with +2 tan tan cos(dphi), and the asymmetry parameter negated.
    """
    mu_i = np.asarray(mu_i, dtype=np.float64)
    mu_r = np.asarray(mu_r, dtype=np.float64)
    sin_i = np.sqrt(np.maximum(1.0 - mu_i**2, 0.0))
    sin_r = np.sqrt(np.maximum(1.0 - mu_r**2, 0.0))
    tan_i = sin_i / mu_i
    tan_r = sin_r / mu_r
    cosg = -mu_i * mu_r + sin_i * sin_r * np.cos(dphi)
    G = np.sqrt(np.maximum(
        tan_i**2 + tan_r**2 + 2.0 * tan_i * tan_r * np.cos(dphi), 0.0))
    th = -theta
    M = (mu_i * mu_r) ** (k - 1.0) / (mu_i + mu_r) ** (1.0 - k)
    F = (1.0 - th**2) / (1.0 + th**2 + 2.0 * th * cosg) ** 1.5
    H = 1.0 + (1.0 - rho_c) / (1.0 + G)
    return rho0 * M * F * H


def rossli_reflectance(mu_i, mu_r, dphi, fiso, fvol, fgeo,
                       h_by_b=2.0, b_by_r=1.0):
    """Ross-Li (RossThick + LiSparse) kernel BRDF.

    ref: rossli_surface.jl:1-56; the azimuth is flipped (pi - dphi) to the
    RAMI convention, and the LiSparse crown parameters default to the RAMI
    values h/b = 2, b/r = 1.
    """
    mu_i = np.asarray(mu_i, dtype=np.float64)
    mu_r = np.asarray(mu_r, dtype=np.float64)
    dphi = np.pi - dphi
    sin_i = np.sqrt(np.maximum(1.0 - mu_i**2, 0.0))
    sin_r = np.sqrt(np.maximum(1.0 - mu_r**2, 0.0))
    cosd = np.cos(dphi)

    # RossThick volumetric kernel
    xi = np.arccos(np.clip(mu_i * mu_r + sin_i * sin_r * cosd, -1.0, 1.0))
    k_vol = (((np.pi / 2.0 - xi) * np.cos(xi) + np.sin(xi))
             / (mu_i + mu_r)) - np.pi / 4.0

    # LiSparse geometric kernel
    tan_ip = (sin_i / mu_i) * b_by_r
    tan_rp = (sin_r / mu_r) * b_by_r
    cos_ip = 1.0 / np.sqrt(1.0 + tan_ip**2)
    cos_rp = 1.0 / np.sqrt(1.0 + tan_rp**2)
    sin_ip = tan_ip * cos_ip
    sin_rp = tan_rp * cos_rp
    xi_p = np.arccos(np.clip(cos_ip * cos_rp + sin_ip * sin_rp * cosd,
                             -1.0, 1.0))
    d2 = tan_ip**2 + tan_rp**2 - 2.0 * tan_ip * tan_rp * cosd
    sec_sum = 1.0 / cos_ip + 1.0 / cos_rp
    ct = (h_by_b * np.sqrt(np.maximum(
        d2 + (tan_ip * tan_rp * np.sin(dphi)) ** 2, 0.0)) / sec_sum)
    t = np.arccos(np.clip(ct, -1.0, 1.0))
    overlap = (1.0 / np.pi) * (t - np.sin(t) * np.cos(t)) * sec_sum
    k_geo = (overlap - sec_sum
             + 0.5 * (1.0 + np.cos(xi_p)) / (cos_ip * cos_rp))

    return fiso + fvol * k_vol + fgeo * k_geo


_BRDF_KERNELS = {
    "rpvSurfaceScalar": (rpv_reflectance, ("rho0", "rho_c", "k", "theta")),
    "RossLiSurfaceScalar": (rossli_reflectance, ("fiso", "fvol", "fgeo")),
}


def brdf_fourier_matrix(surface: dict, qp_mu, m: int, n_stokes: int,
                        n_quad_phi: int = 100) -> np.ndarray:
    """Fourier moment m of a BRDF on the quadrature grid.

    rho_m(mu_i, mu_j) = (2/pi) int_0^pi f(mu_i, mu_j, phi) cos(m phi) dphi,
    expanded to the Stokes-replicated (N, N) block (intensity rows/cols
    only). This matches the reference's normalization: its
    `reflectance(brdf, pol, mu, m)` applies 1/pi and a factor 2 for m > 0,
    and `create_surface_layer!` doubles the m = 0 term
    (rpv_surface.jl:100-127, :36-41).
    """
    kind = surface["type"]
    fn, keys = _BRDF_KERNELS[kind]
    params = [float(surface[k]) for k in keys]

    qp_mu = np.asarray(qp_mu, dtype=np.float64)
    phi, w_phi = gauleg(n_quad_phi, 0.0, np.pi)
    f = fn(qp_mu[:, None, None], qp_mu[None, :, None], phi[None, None, :],
           *params)
    rho_m = (2.0 / np.pi) * np.einsum("ijq,q->ij", f,
                                      w_phi * np.cos(m * phi))

    n_mu = len(qp_mu)
    out = np.zeros((n_mu * n_stokes, n_mu * n_stokes))
    out[::n_stokes, ::n_stokes] = rho_m
    return out


def legendre_spectral_albedo(legendre_coeff, n_spec: int) -> np.ndarray:
    """Per-wavelength albedo from a Legendre expansion over the band
    (x spans [-1, 1] across the spectral grid).
    ref: lambertian_surface.jl:77-100 (LambertianSurfaceLegendre)."""
    coeff = np.asarray(legendre_coeff, dtype=np.float64)
    x = np.linspace(-1.0, 1.0, n_spec)
    return np.polynomial.legendre.legvander(x, len(coeff) - 1) @ coeff
