"""RRS (rotational Raman) single-scattering properties on a spectral grid
(port of ``vsmartmom/inelastic/rrs.py``).

Maps the N2/O2 rotational Raman lines onto the simulation's uniform
wavenumber grid: integer grid-index shifts ``i_shift`` (source = output
index + shift) with coupling weights ``w_shift`` = sigma_RRS / sigma_Rayl,
plus the Cabannes fraction and the Raman Greek coefficients / Z matrices.

ref: src/Inelastic/raman_atmo_prop.jl getRamanSSProp! (:57-74),
     src/Inelastic/inelastic_helper.jl apply_gridlines! (:146-218),
     get_greek_raman (:410-428).

Design notes vs the reference:
  * each line deposits half its (nu^4-weighted) strength on the two grid
    points bracketing its shift (same box deposition as apply_gridlines!);
  * the receiver-picture index shift is the *negated* deposit offset — the
    reference instead reverses the offset list, which is equivalent only
    because the +/- line positions are symmetric; we negate exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from vsmartmom_torch.inelastic.constants import molecular_constants
from vsmartmom_torch.inelastic.xsec import (cabannes_fraction,
                                            rayleigh_depol,
                                            rotational_raman_lines,
                                            vibrational_raman_lines)
from vsmartmom_torch.scattering.phase import GreekCoefs


@dataclasses.dataclass
class RRS:
    """Rotational-Raman coupling spec for one band."""
    i_shift: np.ndarray        # (n_Raman,) int source-index offsets
    w_shift: np.ndarray        # (n_Raman,) coupling weights sigma/sigma_Rayl
    omega_cabannes: float      # elastic Cabannes fraction
    greek_raman: GreekCoefs    # Greek coefs of the Raman phase matrix
    depol_rayl: float          # Rayleigh depolarization (for elastic Z)
    # optional [lo, hi) output/source window on a concatenated spectral
    # axis (the _plus concatenated-band mode, ref: Inelastic/types.jl
    # RRS_plus bandSpecLim); None = the whole axis
    band_range: Optional[tuple] = None

    @property
    def n_raman(self) -> int:
        return len(self.i_shift)


def greek_raman_coefs(rho_depol_rot: float) -> GreekCoefs:
    """Raman phase-matrix Greek coefficients (depol 6/7 structure).
    ref: inelastic_helper.jl get_greek_raman:410-428."""
    d = rho_depol_rot
    dpl_p = (1.0 - d) / (1.0 + d / 2.0)
    dpl_r = (1.0 - 2.0 * d) / (1.0 - d)
    return GreekCoefs(
        alpha=np.array([0.0, 0.0, 3.0 * dpl_p]),
        beta=np.array([1.0, 0.0, 0.5 * dpl_p]),
        gamma=np.array([0.0, 0.0, dpl_p * np.sqrt(1.5)]),
        delta=np.array([0.0, dpl_p * dpl_r * 1.5, 0.0]),
        epsilon=np.array([0.0, 0.0, 0.0]),
        zeta=np.array([0.0, 0.0, 0.0]))


def make_rrs(grid: np.ndarray, T: float = 250.0, vmr_n2: float = 0.79,
             vmr_o2: float = 0.21, j_max: int = 30) -> RRS:
    """Build the RRS coupling for a uniform wavenumber grid [cm^-1].

    The reference uses vmr_n2 = 0.8, vmr_o2 = 0.2
    (inelastic_helper.jl:23-40); we default to the standard atmosphere.
    """
    grid = np.asarray(grid, dtype=np.float64)
    nu0 = 0.5 * (grid[0] + grid[-1])
    dnu = grid[1] - grid[0]
    n_spec = len(grid)

    mols = [molecular_constants("N2", vmr_n2),
            molecular_constants("O2", vmr_o2)]
    lines = [rotational_raman_lines(m, nu0, T, j_max) for m in mols]
    vmrs = [vmr_n2, vmr_o2]

    sigma_rayl = sum(v * ln.sigma_rayl_coeff
                     for ln, v in zip(lines, vmrs)) * nu0**4

    # Deposit each line's strength onto the two bracketing grid offsets.
    # Offsets are relative grid indices (can exceed the band edge for very
    # narrow bands — those lines are dropped, as in the reference where
    # grid_min < shift < grid_max is required).
    # offsets up to the full grid width are usable (per-output-index
    # validity is enforced by the RT core's roll masking)
    half = n_spec - 1
    acc = {}
    for ln, v in zip(lines, vmrs):
        for shift, coeff in zip(ln.shifts, ln.coeffs):
            x = shift / dnu                      # fractional index offset
            if abs(x) >= half:
                continue
            s = v * coeff * (nu0 + shift) ** 4
            lo = int(np.floor(x))
            for off in (lo, lo + 1):
                acc[off] = acc.get(off, 0.0) + 0.5 * s

    offsets = np.array(sorted(acc.keys()), dtype=np.int64)
    weights = np.array([acc[o] for o in offsets]) / sigma_rayl
    # drop zero-strength deposits (e.g. O2 even-J lines with g_N = 0)
    nz = weights > 0
    offsets, weights = offsets[nz], weights[nz]
    # receiver picture: output at n1 receives from source n0 = n1 + i_shift
    # with i_shift = -deposit_offset
    i_shift = -offsets[::-1]
    w_shift = weights[::-1]

    omega_cab = cabannes_fraction(lines, vmrs, nu0)
    rho_rot = lines[0].rho_depol_rot_raman
    return RRS(i_shift=i_shift, w_shift=w_shift,
               omega_cabannes=omega_cab,
               greek_raman=greek_raman_coefs(rho_rot),
               depol_rayl=rayleigh_depol(lines, vmrs))


def make_rrs_profile(grid: np.ndarray, T_layers, vmr_n2: float = 0.79,
                     vmr_o2: float = 0.21, j_max: int = 30) -> RRS:
    """Per-layer-temperature RRS coupling: one RRS spec whose ``w_shift``
    is (nZ, n_Raman) and ``omega_cabannes`` (nZ,), built from each layer's
    temperature. The rotational line *positions* (hence i_shift rows) are
    T-independent; only the population-driven weights and the Cabannes
    fraction vary — the reference computes exactly these per layer
    (ref: raman_atmo_prop.jl:14-160 getRamanSSProp! per-layer T use).
    """
    T_layers = np.atleast_1d(np.asarray(T_layers, np.float64))
    per = [make_rrs(grid, T=float(t), vmr_n2=vmr_n2, vmr_o2=vmr_o2,
                    j_max=j_max) for t in T_layers]
    i_shift = per[0].i_shift
    for p in per[1:]:
        if not np.array_equal(p.i_shift, i_shift):
            raise ValueError("RRS shift set must be T-independent")
    w = np.stack([p.w_shift for p in per])           # (nZ, nR)
    cab = np.array([p.omega_cabannes for p in per])  # (nZ,)
    return RRS(i_shift=i_shift, w_shift=w, omega_cabannes=cab,
               greek_raman=per[0].greek_raman,
               depol_rayl=per[0].depol_rayl)


def _deposit_lines(pairs, grid, sigma_rayl):
    """Deposit (vmr, shifts, coeffs) line sets onto grid-index offsets.
    Returns (i_shift, w_shift) in the receiver picture."""
    grid = np.asarray(grid, dtype=np.float64)
    nu0 = 0.5 * (grid[0] + grid[-1])
    dnu = grid[1] - grid[0]
    half = len(grid) - 1
    acc = {}
    for vmr, shifts, coeffs in pairs:
        for shift, coeff in zip(shifts, coeffs):
            x = shift / dnu
            if abs(x) >= half:
                continue
            s = vmr * coeff * (nu0 + shift) ** 4
            lo = int(np.floor(x))
            for off in (lo, lo + 1):
                acc[off] = acc.get(off, 0.0) + 0.5 * s
    offsets = np.array(sorted(acc.keys()), dtype=np.int64)
    weights = np.array([acc[o] for o in offsets]) / sigma_rayl
    nz = weights > 0
    offsets, weights = offsets[nz], weights[nz]
    return -offsets[::-1], weights[::-1]


def make_vs(grid: np.ndarray, T: float = 250.0, direction: str = "0to1",
            vmr_n2: float = 0.79, vmr_o2: float = 0.21,
            j_max: int = 30):
    """Vibrational Raman (VS 0->1 Stokes or 1->0 anti-Stokes) coupling
    specs for a wavenumber grid spanning both the incident and the
    ~1556/2331 cm^-1-shifted scattered ranges.

    Returns a list of RRS-like specs (one per phase-matrix group):
    [rovibrational O/S branches (N2 + O2, depol 6/7),
     Q branch N2, Q branch O2 (per-molecule vibrational depol)] —
    feed the list directly to core.rt_raman.rt_run_band_rrs. A grid
    narrower than every shift gives an empty list.
    ref: raman_atmo_prop.jl getRamanSSProp!(VS_*) and
    inelastic_helper.jl get_greek_raman_VS (:430-449).
    """
    grid = np.asarray(grid, dtype=np.float64)
    nu0 = 0.5 * (grid[0] + grid[-1])
    mols = [molecular_constants("N2", vmr_n2),
            molecular_constants("O2", vmr_o2)]
    rrs_lines = [rotational_raman_lines(m, nu0, T, j_max) for m in mols]
    vmrs = [vmr_n2, vmr_o2]
    sigma_rayl = sum(v * ln.sigma_rayl_coeff
                     for ln, v in zip(rrs_lines, vmrs)) * nu0**4
    depol = rayleigh_depol(rrs_lines, vmrs)

    specs = []
    vib = [vibrational_raman_lines(m, nu0, T, direction, j_max)
           for m in mols]
    n_q = j_max + 1      # the first j_max+1 lines of each set = Q branch

    # group 1: O/S rovibrational branches of both molecules (depol 6/7)
    pairs = [(v, sh[n_q:], co[n_q:]) for v, (sh, co, _) in zip(vmrs, vib)]
    i_sh, w_sh = _deposit_lines(pairs, grid, sigma_rayl)
    rho_rot = rrs_lines[0].rho_depol_rot_raman
    if len(i_sh):
        specs.append(RRS(i_shift=i_sh, w_shift=w_sh, omega_cabannes=1.0,
                         greek_raman=greek_raman_coefs(rho_rot),
                         depol_rayl=depol))
    # groups 2/3: Q branches per molecule with vibrational depol
    for v, (sh, co, rho_vib) in zip(vmrs, vib):
        i_sh, w_sh = _deposit_lines([(v, sh[:n_q], co[:n_q])], grid,
                                    sigma_rayl)
        if len(i_sh):
            specs.append(RRS(i_shift=i_sh, w_shift=w_sh,
                             omega_cabannes=1.0,
                             greek_raman=greek_raman_coefs(rho_vib),
                             depol_rayl=depol))
    return specs
