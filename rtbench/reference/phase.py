"""Phase-matrix machinery: Greek coefficients, B/Pi matrices, Z Fourier moments.

Host-side setup math (numpy, float64). The Z matrices are small
(N_stokes*N_quad squared), computed once per (band, Fourier moment), then used
by the RT core as constants; compute_Z_moments_torch is their differentiable
torch twin on a Greek-coefficient tensor (the Mie-AD seam).

ref: src/Scattering/compute_Z_matrices.jl:5-84 (compute_Z_moments)
     src/Scattering/mie_helper_functions.jl:237-251 (get_greek_rayleigh)
     src/Scattering/mie_helper_functions.jl:287-350 (Pi / B construction)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.reference.legendre import compute_associated_legendre_PRT


@dataclasses.dataclass(frozen=True)
class GreekCoefs:
    """Greek coefficients of a phase-matrix expansion (Sanghavi 2014 eq. 16).

    Arrays indexed by Legendre order l = 0..l_max-1.
    ref: src/Scattering/types.jl:198-211
    """
    alpha: np.ndarray
    beta: np.ndarray
    gamma: np.ndarray
    delta: np.ndarray
    epsilon: np.ndarray
    zeta: np.ndarray

    @property
    def l_max(self) -> int:
        return len(self.beta)


# --- Polarization types (ref: src/Scattering/types.jl:82-123) ---------------

@dataclasses.dataclass(frozen=True)
class Polarization:
    """Stokes-vector configuration.

    n: number of Stokes components (1: I, 3: IQU, 4: IQUV)
    d: D-matrix diagonal (symmetry signs for U/V under azimuth reversal)
    i0: incident (unpolarized) Stokes vector
    """
    n: int
    d: np.ndarray
    i0: np.ndarray
    name: str

    @staticmethod
    def from_name(name: str) -> "Polarization":
        key = name.replace("()", "").strip()
        if key in ("Stokes_I", "I"):
            return Polarization(1, np.array([1.0]), np.array([1.0]), "Stokes_I")
        if key in ("Stokes_IQU", "IQU"):
            return Polarization(3, np.array([1.0, 1.0, -1.0]),
                                np.array([1.0, 0.0, 0.0]), "Stokes_IQU")
        if key in ("Stokes_IQUV", "IQUV"):
            return Polarization(4, np.array([1.0, 1.0, -1.0, -1.0]),
                                np.array([1.0, 0.0, 0.0, 0.0]), "Stokes_IQUV")
        raise ValueError(f"Unknown polarization type {name!r}")


def get_greek_rayleigh(depol: float = 0.0) -> GreekCoefs:
    """Greek coefficients of the Rayleigh phase matrix for given depolarization.

    ref: src/Scattering/mie_helper_functions.jl:237-251
    """
    dpl_p = (1.0 - depol) / (1.0 + depol / 2.0)
    dpl_r = (1.0 - 2.0 * depol) / (1.0 - depol)
    alpha = np.array([0.0, 0.0, 3.0 * dpl_p])
    beta = np.array([1.0, 0.0, 0.5 * dpl_p])
    gamma = np.array([0.0, 0.0, dpl_p * np.sqrt(1.5)])
    delta = np.array([0.0, dpl_p * dpl_r * 1.5, 0.0])
    eps = np.zeros(3)
    zeta = np.zeros(3)
    return GreekCoefs(alpha, beta, gamma, delta, eps, zeta)


def _b_matrices(pol: Polarization, gc: GreekCoefs) -> np.ndarray:
    """Stack of B_l matrices, shape (l_max, n, n). Sanghavi 2014 eq. 16."""
    lm = gc.l_max
    n = pol.n
    B = np.zeros((lm, n, n))
    B[:, 0, 0] = gc.beta
    if n >= 3:
        B[:, 0, 1] = gc.gamma
        B[:, 1, 0] = gc.gamma
        B[:, 1, 1] = gc.alpha
        B[:, 2, 2] = gc.zeta
    if n == 4:
        B[:, 2, 3] = gc.epsilon
        B[:, 3, 2] = -gc.epsilon
        B[:, 3, 3] = gc.delta
    return B


def _pi_matrices(pol: Polarization, P, R, T, m0: int) -> np.ndarray:
    """Stack of Pi_l(mu_i) matrices for Fourier moment m0 (0-based).

    Shapes: P/R/T are (n_mu, l_max, l_max); returns (l_max, n_mu, n, n).
    Sanghavi 2014 eq. 15.
    """
    n_mu, lm, _ = P.shape
    n = pol.n
    Pi = np.zeros((lm, n_mu, n, n))
    p = P[:, :, m0].T  # (l_max, n_mu)
    Pi[:, :, 0, 0] = p
    if n >= 3:
        r = R[:, :, m0].T
        t = T[:, :, m0].T
        Pi[:, :, 1, 1] = r
        Pi[:, :, 1, 2] = -t
        Pi[:, :, 2, 1] = -t
        Pi[:, :, 2, 2] = r
    if n == 4:
        Pi[:, :, 3, 3] = p
    return Pi


def compute_Z_moments(pol: Polarization, mu: np.ndarray, gc: GreekCoefs,
                      m: int) -> tuple[np.ndarray, np.ndarray]:
    """Fourier moments Z++ and Z-+ of the phase matrix.

    ref: src/Scattering/compute_Z_matrices.jl:5-84. Returns two arrays of
    shape (n*n_mu, n*n_mu) with the Stokes dimension innermost, matching the
    stokes-expanded quadrature layout of the RT core.

    m is the 0-based Fourier moment. A moment at or beyond the expansion's
    length (m >= gc.l_max: Rayleigh's 3 terms at m >= 3) has no term, and
    both matrices are zero (the JAX package raises IndexError there).
    """
    mu = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    assert np.all((mu > 0) & (mu <= 1.0)), "mu must be in (0, 1]"
    l_max = gc.l_max
    n_mu = len(mu)
    n = pol.n
    if m >= l_max:
        zero = np.zeros((n_mu * n, n_mu * n))
        return zero, zero.copy()

    fact = 0.5 if m == 0 else 1.0

    P, R, T = compute_associated_legendre_PRT(mu, l_max)
    Pm, Rm, Tm = compute_associated_legendre_PRT(-mu, l_max)

    B = _b_matrices(pol, gc)                  # (L, n, n)
    Pi = _pi_matrices(pol, P, R, T, m)        # (L, n_mu, n, n)
    Pim = _pi_matrices(pol, Pm, Rm, Tm, m)    # (L, n_mu, n, n)

    ls = slice(m, l_max)
    # A±[i,j,a,b] = sum_l Pi_l(mu_i) B_l Pi_l(±mu_j)
    App = np.einsum("liab,lbc,ljcd->ijad", Pi[ls], B[ls], Pi[ls],
                    optimize=True)
    Amp = np.einsum("liab,lbc,ljcd->ijad", Pi[ls], B[ls], Pim[ls],
                    optimize=True)

    # Sign map for Z-+: -1 where exactly one of (row, col) Stokes comps is U/V
    upper = np.arange(n) >= 2
    sign = np.where(upper[:, None] ^ upper[None, :], -1.0, 1.0)

    Zpp = 2.0 * fact * App
    Zmp = 2.0 * fact * Amp * sign[None, None, :, :]

    # Reshape (i, j, a, b) -> (i*a, j*b) block layout
    Zpp = Zpp.transpose(0, 2, 1, 3).reshape(n_mu * n, n_mu * n)
    Zmp = Zmp.transpose(0, 2, 1, 3).reshape(n_mu * n, n_mu * n)
    return Zpp, Zmp


