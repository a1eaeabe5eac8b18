"""Pretty-printing of parameters and derived models.

Port of ``vsmartmom/util/show.py`` (ref: src/CoreRT/tools/show_utils.jl,
the Base.show overloads for vSmartMOM_Parameters / vSmartMOM_Model). The
same sectioned reports, rendered by describe_parameters / describe_model
and wired into the __repr__ of RTParameters and RTModel.
"""
from __future__ import annotations

import numpy as np


def _band_line(band):
    b = np.asarray(band)
    return (f"{len(b)}-point grid from {b.min():.2f} to {b.max():.2f} "
            f"cm^-1 ({1e7 / b.max():.1f}-{1e7 / b.min():.1f} nm)")


def describe_parameters(p) -> str:
    """Sectioned summary of RTParameters (ref: show_utils.jl:7-76)."""
    out = []
    out.append("------------------")
    out.append("Radiative Transfer")
    out.append("------------------")
    out.append("  Spectral bands:")
    for band in p.spec_bands:
        out.append(f"    - {_band_line(band)}")
    out.append("  Surfaces:")
    for s in p.surfaces:
        out.append(f"    - {s}")
    out.append(f"  Quadrature type: {p.quadrature_type}")
    out.append(f"  Polarization type: {p.polarization_type}")
    out.append(f"  max_m: {p.max_m}   l_trunc: {p.l_trunc}   "
               f"depol: {p.depol}")
    out.append(f"  Float type: {p.float_type}")
    out.append("")
    out.append("--------")
    out.append("Geometry")
    out.append("--------")
    out.append(f"  SZA (deg): {p.sza}")
    out.append(f"  VZA (deg): {np.asarray(p.vza).tolist()}")
    out.append(f"  VAZ (deg): {np.asarray(p.vaz).tolist()}")
    out.append(f"  Observation altitude: {p.obs_alt}")
    out.append("")
    out.append("-------------------")
    out.append("Atmospheric Profile")
    out.append("-------------------")
    nz = len(np.asarray(p.T))
    out.append(f"  T/p/q: {nz}-level arrays "
               f"(p {np.asarray(p.p).min():.1f}-"
               f"{np.asarray(p.p).max():.1f} hPa)")
    red = getattr(p, "profile_reduction", -1)
    out.append("  Profile reduction: "
               + ("none" if red in (-1, None) else f"{red} layers"))
    out.append("")
    out.append("----------")
    out.append("Absorption")
    out.append("----------")
    ap = p.absorption_params
    if ap is None:
        out.append("  (none)")
    else:
        for mols in ap.molecules:
            out.append(f"  Molecules: {mols}")
        out.append(f"  Broadening: {ap.broadening}   CEF: {ap.cef}   "
                   f"wing cutoff: {ap.wing_cutoff} cm^-1")
    out.append("")
    out.append("----------")
    out.append("Scattering")
    out.append("----------")
    sp = p.scattering_params
    if sp is None or not getattr(sp, "rt_aerosols", None):
        out.append("  (Rayleigh only)")
    else:
        for i, aer in enumerate(sp.rt_aerosols):
            out.append(f"  aerosol[{i}]: {aer}")
    return "\n".join(out)


def describe_model(m) -> str:
    """Sectioned summary of a derived RTModel (ref: show_utils.jl:79-...)."""
    out = []
    out.append("------------------------")
    out.append("Derived RT model")
    out.append("------------------------")
    nz = m.profile.n_layers
    out.append(f"  Layers: {nz}   quadrature N = {len(m.quad_points.qp_mu_n)}"
               f" ({m.pol.name}, n_stokes={m.pol.n})")
    for ib, band in enumerate(m.params.spec_bands):
        ta = m.tau_abs[ib]
        tr = m.tau_rayl[ib]
        col_a = float(ta.sum(axis=1).max()) if ta.size else 0.0
        col_r = float(tr.sum(axis=1).max()) if tr.size else 0.0
        out.append(f"  band[{ib}]: {_band_line(band)}")
        out.append(f"    max column tau_abs = {col_a:.3g}, "
                   f"tau_rayl = {col_r:.3g}")
        for ia in range(len(m.tau_aer[ib])):
            out.append(f"    aerosol[{ia}] column AOD = "
                       f"{float(m.tau_aer[ib][ia].sum()):.4f}")
    return "\n".join(out)
