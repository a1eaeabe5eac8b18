"""delta-BGE phase-function truncation (Sanghavi & Stephens 2015).

Truncates the Greek-coefficient series to l_max by a weighted least-squares
fit of the reconstructed phase matrix excluding the forward peak, and
renormalizes via the truncation factor f_t.

ref: src/Scattering/truncate_phase.jl:95-220 and
     mie_helper_functions.jl:198-229 (reconstruct_phase)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.reference.legendre import compute_legendre_poly
from rtbench.reference.nai2 import AerosolOptics
from rtbench.reference.phase import GreekCoefs
from rtbench.reference.quadrature import gauss_legendre


@dataclasses.dataclass
class ScatteringMatrix:
    """Reconstructed phase-matrix elements (ref: Scattering/types.jl)."""
    f11: np.ndarray
    f12: np.ndarray
    f22: np.ndarray
    f33: np.ndarray
    f34: np.ndarray
    f44: np.ndarray


def reconstruct_phase(gc: GreekCoefs, mu, return_leg: bool = False):
    """Phase matrix elements from Greek coefficients.

    ref: mie_helper_functions.jl:198-229
    """
    mu = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    l_max = gc.l_max
    P, P2, R2, T2 = compute_legendre_poly(mu, l_max)
    ls = np.arange(l_max)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = np.sqrt(1.0 / ((ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0)))
    fac[:2] = 0.0

    sm = ScatteringMatrix(
        f11=P @ gc.beta,
        f44=P @ gc.delta,
        f12=P2 @ (fac * gc.gamma),
        f34=P2 @ (fac * gc.epsilon),
        f22=R2 @ (fac * gc.alpha) + T2 @ (fac * gc.zeta),
        f33=R2 @ (fac * gc.zeta) + T2 @ (fac * gc.alpha))
    if return_leg:
        return sm, P, P2
    return sm


def _wls_fit(basis, y, w, start=0):
    """Weighted LSQ of 1/y against the basis columns (the reference's
    A x = b system with weights w/y^2)."""
    A = (basis.T * (w / y**2)) @ basis
    b = (basis.T) @ (w / y)
    out = np.zeros(basis.shape[1])
    out[start:] = np.linalg.solve(A[start:, start:], b[start:])
    return out


def truncate_phase(aero: AerosolOptics, l_max: int,
                   delta_angle: float) -> AerosolOptics:
    """delta-BGE truncation of AerosolOptics to l_max terms.

    ref: truncate_phase.jl:95-220
    """
    gc = aero.greek_coefs
    l_tr = l_max
    n_mu = gc.l_max
    mu, w_mu = gauss_legendre(n_mu)

    sm, P, P2 = reconstruct_phase(gc, mu, return_leg=True)

    # NOTE: the reference computes the forward-peak exclusion set (Delta
    # angle) but its fit sums actually run over ALL mu
    # (truncate_phase.jl:133-140 uses full w_mu/f11); we match that behavior.
    w = w_mu

    ls = np.arange(l_tr)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = np.sqrt(1.0 / ((ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0)))
    fac[:2] = 0.0

    # beta fit against P basis (all l)
    cl = _wls_fit(P[:, :l_tr], sm.f11, w, start=0)
    # gamma / epsilon fits against fac*P2 basis (l >= 2)
    basis2 = P2[:, :l_tr] * fac[None, :]
    gamma_t = _wls_fit(basis2, sm.f12, w, start=2)
    eps_t = _wls_fit(basis2, sm.f34, w, start=2)

    c0 = cl[0]
    beta_t = cl / c0
    delta_t = (gc.delta[:l_tr] - (gc.beta[:l_tr] - cl)) / c0
    alpha_t = (gc.alpha[:l_tr] - (gc.beta[:l_tr] - cl)) / c0
    zeta_t = (gc.zeta[:l_tr] - (gc.beta[:l_tr] - cl)) / c0

    gc_t = GreekCoefs(alpha_t, beta_t, gamma_t, delta_t, eps_t, zeta_t)
    return AerosolOptics(greek_coefs=gc_t, ssa=aero.ssa, k=aero.k,
                         f_t=1.0 - c0)
