"""Molecular constants for rotational/vibrational Raman scattering
(port of ``vsmartmom/inelastic/constants.py``).

N2 / O2 / H2 polarizability tensors, Dunham Y-matrices, and nuclear-spin
degeneracies (ref: src/Inelastic/src/molecular_constructors.jl:1-212; values
are standard spectroscopic constants — Buldakov et al. 1996, Asawaroengchai
& Rosenblatt 1980).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# physical constants (CGS-flavored, matching the reference's units)
H_PLANCK = 6.62607015e-27      # erg s
C_LIGHT = 2.99792458e10        # cm/s
K_BOLTZ = 1.380649e-16         # erg/K
HC_BY_K = 1.4387769            # cm K (second radiation constant)


@dataclasses.dataclass
class PolarizationTensor:
    alpha_00: float       # mean polarizability [cm^3]
    alpha_00_prime: float  # derivative, to be scaled by sqrt(Be/we)
    omega_0: float        # electronic resonance frequency [1/s]
    alpha_b: float        # T-dependence linear coeff
    alpha_c: float        # T-dependence quadratic coeff
    gamma_00: float       # anisotropy [cm^3]
    gamma_00_prime: float  # anisotropy derivative [cm^3]


@dataclasses.dataclass
class MolecularConstants:
    name: str
    vmr: float
    pol: PolarizationTensor
    Y: np.ndarray          # (5, 5) Dunham matrix [cm^-1]
    g_s: tuple             # nuclear-spin degeneracy (odd J, even J)


def molecular_constants(species: str, vmr: float) -> MolecularConstants:
    """Construct constants for 'N2', 'O2' or 'H2'.

    ref: molecular_constructors.jl getMolecularConstants (N2 :2-71,
    O2 :74-143, H2 :146-212).
    """
    if not 0.0 <= vmr <= 1.0:
        raise ValueError(f"vmr {vmr} outside [0, 1]")
    Y = np.zeros((5, 5))
    if species == "N2":
        pol = PolarizationTensor(1.7406e-24, 1.86e-24, 2.6049e16,
                                 1.8e-6, 0.0, 0.71e-24, 2.23e-24)
        Y[0, 1], Y[0, 2] = 1.99824, -5.76e-6
        Y[1, 0], Y[1, 1] = 2358.57, -0.017318
        Y[2, 0], Y[3, 0] = -14.324, -2.26e-3
        g_s = (3, 6)
    elif species == "O2":
        pol = PolarizationTensor(1.5658e-24, 1.76e-24, 2.1801e16,
                                 -2.369e-6, 8.687e-9, 1.080e-24, 3.19e-24)
        Y[0, 1], Y[0, 2] = 1.4376766, -4.839e-6
        Y[1, 0], Y[1, 1] = 1580.19, -0.01590
        Y[2, 0], Y[3, 0] = -11.98, 0.0
        g_s = (1, 0)
    elif species == "H2":
        pol = PolarizationTensor(0.8032e-24, 0.90e-24, 2.1399e16,
                                 5.870e-6, 7.544e-9, 0.288e-24, 1.02e-24)
        Y[0, 1], Y[0, 2] = 60.853, -0.0471
        Y[1, 0], Y[1, 1] = 4401.21, -3.062
        Y[2, 0], Y[3, 0] = -121.33, 0.0
        g_s = (3, 1)
    else:
        raise ValueError(f"Unknown Raman species {species!r}")
    return MolecularConstants(species, vmr, pol, Y, g_s)


def energy_levels(mol: MolecularConstants, v_max: int = 2,
                  j_max: int = 30) -> np.ndarray:
    """Rovibrational term values E(v, J) [cm^-1] from the Dunham expansion
    E = sum_kl Y[k, l] (v + 1/2)^k [J(J+1)]^l.
    ref: inelastic_cross_section.jl compute_energy_levels! (:253-271)."""
    v = np.arange(v_max + 1)[:, None]
    j = np.arange(j_max + 1)[None, :]
    E = np.zeros((v_max + 1, j_max + 1))
    for k in range(5):
        for l in range(5):
            if mol.Y[k, l] != 0.0:
                E += mol.Y[k, l] * (v + 0.5) ** k * (j * (j + 1.0)) ** l
    return E


def g_nuclear(mol: MolecularConstants, j: np.ndarray) -> np.ndarray:
    """Nuclear-spin statistical weight per rotational level."""
    j = np.asarray(j)
    return np.where(j % 2 == 1, mol.g_s[0], mol.g_s[1]).astype(np.float64)
