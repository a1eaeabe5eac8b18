"""Concatenated-band ("_plus") Raman coupling specs (port of
``vsmartmom/inelastic/plus.py``).

The reference's ``RRS_plus`` / ``VS_0to1_plus`` / ``VS_1to0_plus`` modes run
RT on a *concatenated* spectral axis made of several bands and couple them
inelastically (ref: src/Inelastic/types.jl:134-261,
src/Inelastic/raman_atmo_prop.jl getRamanSSProp!(RRS_plus):75-117,
getRamanSSProp!(VS_0to1_plus):119-252):

* RRS_plus — each band keeps its own within-band rotational-Raman shift
  structure (banded coupling, per-band index window);
* VS_*_plus — a monochromatic incident point (band 1) sources vibrational /
  rovibrational Raman into far-shifted scattered windows (bands 2..), i.e.
  absolute-index coupling from one source column into per-output weights.

Representation: both reduce to per-output (source-index, weight)
rows consumed by core.rt_raman.build_coupling — banded rows for RRS_plus
(``RRS.band_range``), single gather-from-i_ref rows for VS_plus
(``AbsoluteRaman``), so the RT core is identical for all modes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from vsmartmom_torch.inelastic.constants import molecular_constants
from vsmartmom_torch.inelastic.rrs import RRS, greek_raman_coefs, make_rrs
from vsmartmom_torch.inelastic.xsec import (cabannes_fraction,
                                            rayleigh_depol,
                                            rotational_raman_lines,
                                            vibrational_raman_lines)
from vsmartmom_torch.scattering.phase import GreekCoefs


@dataclasses.dataclass
class AbsoluteRaman:
    """Absolute-index Raman coupling rows on a concatenated spectral axis:
    output i_out[k] receives w[k] x (elastic field at column i_src).
    ref: Inelastic/types.jl VS_*_plus i_lambda1lambda0_all / i_ref."""
    i_out: np.ndarray          # (n,) absolute output indices
    i_src: int                 # absolute source index (monochromatic)
    w: np.ndarray              # (n,) coupling weights sigma/sigma_Rayl
    greek_raman: GreekCoefs    # phase matrix of this coupling group

    @property
    def n_raman(self) -> int:
        return 1               # one gather row (matches reference n_Raman=1)


@dataclasses.dataclass
class ConcatBands:
    """Concatenated-band run description shared by all _plus modes."""
    grids: List[np.ndarray]            # per-band wavenumber grids [cm^-1]
    band_spec_lim: List[Tuple[int, int]]  # absolute [lo, hi) per band
    specs: list                        # RRS / AbsoluteRaman coupling specs
    omega_cabannes: np.ndarray         # per-band elastic Cabannes fraction
    depol_rayl: float
    i_ref: int = 0                     # incident column (VS/RVRS modes)

    @property
    def grid(self) -> np.ndarray:
        return np.concatenate(self.grids)

    @property
    def n_spec(self) -> int:
        return self.band_spec_lim[-1][1]


def _band_spec_lim(grids: Sequence[np.ndarray]) -> List[Tuple[int, int]]:
    lims, n = [], 0
    for g in grids:
        lims.append((n, n + len(g)))
        n += len(g)
    return lims


def make_rrs_plus(grids: Sequence[np.ndarray], T: float = 250.0,
                  vmr_n2: float = 0.79, vmr_o2: float = 0.21,
                  j_max: int = 30) -> ConcatBands:
    """Rotational-Raman coupling for several concatenated bands: each band
    gets its own shift set / Cabannes fraction, restricted to its index
    window. ref: raman_atmo_prop.jl getRamanSSProp!(RRS_plus):75-117."""
    grids = [np.asarray(g, np.float64) for g in grids]
    lims = _band_spec_lim(grids)
    specs, cab = [], []
    for g, (lo, hi) in zip(grids, lims):
        s = make_rrs(g, T=T, vmr_n2=vmr_n2, vmr_o2=vmr_o2, j_max=j_max)
        s.band_range = (lo, hi)
        specs.append(s)
        cab.append(s.omega_cabannes)
    return ConcatBands(grids=list(grids), band_spec_lim=lims, specs=specs,
                       omega_cabannes=np.asarray(cab),
                       depol_rayl=specs[0].depol_rayl)


def _deposit_absolute(shifts, coeffs, vmr, nu_inc, grids, lims, sigma_rayl):
    """Deposit lines at nu_inc+shift onto the bracketing points of whichever
    band window contains them; returns absolute (i_out, w) arrays."""
    acc = {}
    for shift, coeff in zip(shifts, coeffs):
        nu_s = nu_inc + shift
        for g, (lo, _hi) in zip(grids, lims):
            if len(g) < 2 or not (g[0] <= nu_s <= g[-1]):
                continue
            dnu = g[1] - g[0]
            x = (nu_s - g[0]) / dnu
            i = min(int(np.floor(x)), len(g) - 2)
            s = vmr * coeff * nu_s**4
            acc[lo + i] = acc.get(lo + i, 0.0) + 0.5 * s
            acc[lo + i + 1] = acc.get(lo + i + 1, 0.0) + 0.5 * s
            break
    if not acc:
        return np.zeros(0, np.int64), np.zeros(0)
    i_out = np.array(sorted(acc.keys()), np.int64)
    w = np.array([acc[i] for i in i_out]) / sigma_rayl
    nz = w > 0
    return i_out[nz], w[nz]


def make_vs_plus(nu_inc: float, T: float = 250.0, direction: str = "0to1",
                 dnu: float = 0.05, margin: float = 2.0,
                 vmr_n2: float = 0.79, vmr_o2: float = 0.21,
                 j_max: int = 30,
                 include_rrs_band: bool = False,
                 rrs_dnu: float = 0.5) -> ConcatBands:
    """Vibrational-Raman concatenated-band spec: monochromatic incident
    point at nu_inc (band 1) scattering into the N2- and O2-shifted windows
    (bands 2, 3; ~0.05 cm^-1 spacing, +/- margin).

    ``include_rrs_band=True`` additionally adds a rotational-Raman window
    around nu_inc (the combined ro-vibrational "RVRS" mode, ref:
    Inelastic/types.jl RVRS:95-114, whose upstream builder is unfinished —
    raman_atmo_prop.jl:39-46 commented out).
    ref: raman_atmo_prop.jl getRamanSSProp!(VS_0to1_plus):119-252.
    """
    if direction not in ("0to1", "1to0"):
        raise ValueError(f"unknown direction {direction!r}")
    mols = [molecular_constants("N2", vmr_n2),
            molecular_constants("O2", vmr_o2)]
    vmrs = [vmr_n2, vmr_o2]
    rot = [rotational_raman_lines(m, nu_inc, T, j_max) for m in mols]
    sigma_rayl = sum(v * ln.sigma_rayl_coeff
                     for ln, v in zip(rot, vmrs)) * nu_inc**4

    grids = [np.array([nu_inc])]
    vib = [vibrational_raman_lines(m, nu_inc, T, direction, j_max)
           for m in mols]
    for sh, _co, _rho in vib:
        nz = sh[sh != 0.0]
        lo = nu_inc + nz.min() - margin
        hi = nu_inc + nz.max() + margin
        grids.append(np.arange(lo, hi + dnu / 2, dnu))
    if include_rrs_band:
        rot_sh = np.concatenate([ln.shifts for ln in rot])
        lo = nu_inc + rot_sh.min() - margin
        hi = nu_inc + rot_sh.max() + margin
        grids.append(np.arange(lo, hi + rrs_dnu / 2, rrs_dnu))
    lims = _band_spec_lim(grids)

    specs = []
    n_q = j_max + 1                    # Q branch = first j_max+1 lines
    rho_rot = rot[0].rho_depol_rot_raman

    # group 1: O/S rovibrational branches of both molecules (depol 6/7)
    i_out, w = np.zeros(0, np.int64), np.zeros(0)
    for v, (sh, co, _rho) in zip(vmrs, vib):
        io, wo = _deposit_absolute(sh[n_q:], co[n_q:], v, nu_inc,
                                   grids, lims, sigma_rayl)
        i_out, w = np.concatenate([i_out, io]), np.concatenate([w, wo])
    if len(i_out):
        specs.append(AbsoluteRaman(i_out=i_out, i_src=0, w=w,
                                   greek_raman=greek_raman_coefs(rho_rot)))
    # groups 2/3: Q branches per molecule with vibrational depol
    for v, (sh, co, rho_vib) in zip(vmrs, vib):
        io, wo = _deposit_absolute(sh[:n_q], co[:n_q], v, nu_inc,
                                   grids, lims, sigma_rayl)
        if len(io):
            specs.append(AbsoluteRaman(
                i_out=io, i_src=0, w=wo,
                greek_raman=greek_raman_coefs(rho_vib)))
    if include_rrs_band:
        i_out, w = np.zeros(0, np.int64), np.zeros(0)
        for v, ln in zip(vmrs, rot):
            io, wo = _deposit_absolute(ln.shifts, ln.coeffs, v, nu_inc,
                                       grids, lims, sigma_rayl)
            i_out, w = np.concatenate([i_out, io]), np.concatenate([w, wo])
        if len(i_out):
            specs.append(AbsoluteRaman(
                i_out=i_out, i_src=0, w=w,
                greek_raman=greek_raman_coefs(rho_rot)))

    cab = np.ones(len(grids))
    cab[0] = cabannes_fraction(rot, vmrs, nu_inc)
    return ConcatBands(grids=grids, band_spec_lim=lims, specs=specs,
                       omega_cabannes=cab,
                       depol_rayl=rayleigh_depol(rot, vmrs), i_ref=0)


def make_rvrs_plus(nu_inc: float, **kw) -> ConcatBands:
    """Combined rotational + vibrational Raman from a monochromatic source
    (the reference's RVRS intent, Inelastic/types.jl:95-114)."""
    return make_vs_plus(nu_inc, include_rrs_band=True, **kw)
