"""Mie theory: a_n/b_n coefficients, amplitude functions, cross-sections.

Host-side setup math, vectorized over the radius quadrature in numpy f64
(the reference loops radius-by-radius: compute_NAI2.jl:80-112). Setup cost
only — results feed the RT core as constants.

ref: src/Scattering/mie_helper_functions.jl (compute_mie_ab!, get_n_max,
compute_mie_S1S2!, compute_avg_C_scatt_ext, compute_w_x)
"""
from __future__ import annotations

import dataclasses

import numpy as np


def get_n_max(size_parameter: float) -> int:
    """Required series length for a size parameter (Sanghavi 2014 eq. 6 /
    de Rooij & Stap 1984 A17)."""
    return int(round(size_parameter + 4.05 * size_parameter ** (1.0 / 3.0)
                     + 10.0))


@dataclasses.dataclass
class Aerosol:
    """Log-normal aerosol: LogNormal(log(mu_r), log(sigma_g)) + refractive
    index (ref: Scattering/types.jl Aerosol; parameters_from_yaml.jl:60)."""
    mu: float          # geometric mean radius [um]
    sigma: float       # geometric std dev (>= 1)
    n_r: float
    n_i: float

    def pdf(self, r):
        r = np.asarray(r, dtype=np.float64)
        mu_ln, sig_ln = np.log(self.mu), np.log(self.sigma)
        out = np.zeros_like(r)
        pos = r > 0
        out[pos] = (np.exp(-0.5 * ((np.log(r[pos]) - mu_ln) / sig_ln) ** 2)
                    / (r[pos] * sig_ln * np.sqrt(2.0 * np.pi)))
        return out


def compute_mie_ab_batch(x: np.ndarray, m: complex, n_max_total: int,
                         truncate: bool = True):
    """Mie a_n, b_n for a batch of size parameters (BH eq. 4.88).

    x: (nr,) size parameters; m: complex refractive index (n_r + i n_i).
    Returns an, bn of shape (nr, n_max_total) with entries for
    n > get_n_max(x_i) zeroed (per-radius truncation, as the reference).
    """
    x = np.asarray(x, dtype=np.float64)
    nr = len(x)
    y = x * m
    n_max_i = np.array([get_n_max(xi) for xi in x])
    nmx = int(np.ceil(max(n_max_total, np.abs(y).max()) + 51))

    # Downward recurrence for the logarithmic derivative D_n (BH 4.89),
    # vectorized over the radius batch.
    d = np.zeros((nmx, nr), dtype=np.complex128)
    for n in range(nmx - 1, 0, -1):
        np1_y = (n + 1) / y
        d[n - 1] = np1_y - 1.0 / (d[n] + np1_y)

    an = np.zeros((nr, n_max_total), dtype=np.complex128)
    bn = np.zeros((nr, n_max_total), dtype=np.complex128)

    # Upward recurrence for Riccati-Bessel psi, chi and a_n, b_n.
    # The recursion is frozen per-radius beyond n_max(x_i): chi_n blows up
    # as (2n-1)!!/x^n for n >> x (the reference never recurses past
    # n_max(x_i) — its per-radius loops stop there).
    limit = n_max_i if truncate else np.full(nr, n_max_total)
    psi0, psi1 = np.cos(x), np.sin(x)
    chi0, chi1 = -np.sin(x), np.cos(x)
    xi1 = psi1 - 1j * chi1
    for n in range(1, n_max_total + 1):
        active = n <= limit
        psi = np.where(active, (2 * n - 1) * psi1 / x - psi0, psi1)
        chi = np.where(active, (2 * n - 1) * chi1 / x - chi0, chi1)
        xi = psi - 1j * chi
        t_a = d[n - 1] / m + n / x
        t_b = d[n - 1] * m + n / x
        with np.errstate(invalid="ignore"):
            an[:, n - 1] = np.where(active,
                                    (t_a * psi - psi1) / (t_a * xi - xi1), 0.0)
            bn[:, n - 1] = np.where(active,
                                    (t_b * psi - psi1) / (t_b * xi - xi1), 0.0)
        psi0, psi1 = np.where(active, psi1, psi0), psi
        chi0, chi1 = np.where(active, chi1, chi0), chi
        xi1 = psi1 - 1j * chi1

    if not truncate:
        return an, bn
    # Per-radius truncation at n_max(x_i)
    mask = np.arange(1, n_max_total + 1)[None, :] <= n_max_i[:, None]
    return an * mask, bn * mask


def compute_mie_S1S2(an: np.ndarray, bn: np.ndarray, leg_pi: np.ndarray,
                     leg_tau: np.ndarray):
    """Amplitude functions S1, S2 for a batch of radii.

    an, bn: (nr, nmax); leg_pi/leg_tau: (n_mu, nmax).
    Returns S1, S2 of shape (n_mu, nr).
    """
    n = np.arange(1, an.shape[1] + 1)
    coef = (2 * n + 1) / (n * (n + 1))
    ca, cb = coef * an, coef * bn            # (nr, nmax)
    s1 = leg_tau @ ca.T + leg_pi @ cb.T
    s2 = leg_pi @ ca.T + leg_tau @ cb.T
    return s1, s2


def cross_sections(an: np.ndarray, bn: np.ndarray, k: float):
    """Per-radius scattering/extinction cross sections (BH eq. 4.61/4.62)."""
    n = np.arange(1, an.shape[1] + 1)
    w = 2 * n + 1
    c_sca = 2 * np.pi / k**2 * ((np.abs(an) ** 2 + np.abs(bn) ** 2) @ w)
    c_ext = 2 * np.pi / k**2 * (np.real(an + bn) @ w)
    return c_sca, c_ext


def size_distribution_weights(aerosol: Aerosol, w_r, r):
    """Normalized probability weights over the radius quadrature
    (ref: mie_helper_functions.jl:266 compute_w_x)."""
    wx = aerosol.pdf(r) * w_r
    return wx / wx.sum()


@dataclasses.dataclass
class BimodalAerosol:
    """Two-mode log-normal mixture (fine + coarse) sharing one refractive
    index — the RAMI4ATM desert/continental aerosol shape
    (ref: test/rami/rami_tools.jl:52-117 MixtureModel of LogNormals)."""
    mu_fine: float
    sigma_fine: float
    mu_coarse: float
    sigma_coarse: float
    frac_coarse: float   # number fraction of the coarse mode
    n_r: float
    n_i: float

    def pdf(self, r):
        fine = Aerosol(self.mu_fine, self.sigma_fine, self.n_r, self.n_i)
        coarse = Aerosol(self.mu_coarse, self.sigma_coarse, self.n_r,
                         self.n_i)
        return ((1.0 - self.frac_coarse) * fine.pdf(r)
                + self.frac_coarse * coarse.pdf(r))
