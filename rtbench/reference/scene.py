"""The reference's model build: a scene's optics from its parameter file.

What the program derives in its set-up (profile, Rayleigh and aerosol
optical depths, delta-BGE-truncated NAI2 aerosol optics, line-by-line gas
absorption) is worked out here again from the same parameter file and line
lists, in float64. Gas absorption is computed only at the spectral points
asked for, since each point's cross-section depends on that point alone;
everything else covers each band's whole grid, since the doubling counts
follow the band's largest scattering depth.

ref: src/CoreRT/tools/model_from_parameters.jl:12-194,
     src/CoreRT/LayerOpticalProperties/compEffectiveLayerProperties.jl
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from rtbench.reference import HITRAN_DIR
from rtbench.reference.atmosphere import (aerosol_layer_tau_gaussian,
                                          compute_atmos_profile_fields,
                                          rayleigh_layer_tau, reduce_profile)
from rtbench.reference.hitran import HitranEmptyError, read_hitran, \
    read_linelist_npz
from rtbench.reference.nai2 import (compute_aerosol_optical_properties,
                                    compute_ref_aerosol_extinction)
from rtbench.reference.params import RTParameters, parameters_from_yaml
from rtbench.reference.phase import Polarization, get_greek_rayleigh
from rtbench.reference.quadrature import rt_set_streams
from rtbench.reference.truncation import truncate_phase
from rtbench.reference.voigt import (compute_absorption_cross_section,
                                     make_hitran_model)

#: HITRAN molecule numbers of the line lists kept in binary form
MOL_IDS = {"H2O": 1, "CO2": 2, "O3": 3, "N2O": 4, "CO": 5, "CH4": 6,
           "O2": 7}


@dataclasses.dataclass
class BandOptics:
    """One band: its grid (cm^-1), Rayleigh depths (nSpec, nZ), and per
    aerosol the truncated optics and the layer depths (nZ,)."""
    grid: np.ndarray
    tau_rayl: np.ndarray
    aerosols: list
    albedo: float


@dataclasses.dataclass
class Scene:
    params: RTParameters
    pol: Polarization
    quad: object
    profile: object
    greek_rayleigh: object
    bands: List[BandOptics]


def build_scene(path: str) -> Scene:
    """Everything of the scene but gas absorption, from the parameter file
    at ``path``."""
    p = parameters_from_yaml(path)
    pol = Polarization.from_name(p.polarization_type)
    quad = rt_set_streams(p.quadrature_type, p.l_trunc, p.sza, p.vza, pol.n)
    vmr = {} if p.absorption_params is None else p.absorption_params.vmr
    profile = compute_atmos_profile_fields(p.T, p.p, p.q, vmr)
    if p.profile_reduction != -1:
        profile = reduce_profile(p.profile_reduction, profile)
    bands = []
    sp = p.scattering_params
    for ib, grid in enumerate(p.spec_bands):
        lam_um = 1e4 / grid
        tau_rayl = rayleigh_layer_tau(float(profile.p_half[-1]), lam_um,
                                      p.depol, profile.vcd_dry)
        aerosols = []
        for aero in (sp.rt_aerosols if sp is not None else []):
            k_ref = compute_ref_aerosol_extinction(
                aero, sp.lambda_ref, sp.n_ref, sp.r_max, sp.nquad_radius)
            lam_c = 0.5 * (lam_um.max() + lam_um.min())
            optics = truncate_phase(
                compute_aerosol_optical_properties(aero, lam_c, sp.r_max,
                                                   sp.nquad_radius, pol),
                p.l_trunc, p.delta_angle)
            vert = aerosol_layer_tau_gaussian(1.0, aero.p0, aero.sigma_p,
                                              profile)
            aerosols.append((optics, aero.tau_ref * (optics.k / k_ref)
                             * vert))
        surface = p.surfaces[min(ib, len(p.surfaces) - 1)]
        if surface["type"] != "LambertianSurfaceScalar":
            raise ValueError(f"the reference takes Lambertian scalar "
                             f"surfaces, not {surface['type']}")
        bands.append(BandOptics(grid=grid, tau_rayl=tau_rayl,
                                aerosols=aerosols,
                                albedo=float(surface["albedo"])))
    return Scene(params=p, pol=pol, quad=quad, profile=profile,
                 greek_rayleigh=get_greek_rayleigh(p.depol), bands=bands)


def _line_list(molecule: str, lo: float, hi: float):
    for name in (f"{molecule}.par", f"{molecule}.npz"):
        path = os.path.join(HITRAN_DIR, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".par"):
            return read_hitran(path, nu_min=lo, nu_max=hi)
        ht = read_linelist_npz(path, MOL_IDS[molecule])
        sel = (ht.nu > lo) & (ht.nu < hi)
        if not sel.any():
            raise HitranEmptyError(path)
        return dataclasses.replace(ht, **{
            f.name: (getattr(ht, f.name)[sel]
                     if isinstance(getattr(ht, f.name), np.ndarray)
                     else [x for x, k in zip(getattr(ht, f.name), sel) if k])
            for f in dataclasses.fields(ht)})
    raise FileNotFoundError(f"no line list for {molecule} in {HITRAN_DIR}")


def gas_tau(scene: Scene, i_band: int, idx, device) -> np.ndarray:
    """Gas absorption optical depth (len(idx), nZ) at the points ``idx`` of
    band ``i_band``. The line list is cut to the band's grid widened by the
    wing cutoff, as the program cuts it."""
    ap = scene.params.absorption_params
    grid = scene.bands[i_band].grid
    prof = scene.profile
    n_z = prof.n_layers
    tau = np.zeros((len(idx), n_z))
    if ap is None:
        return tau
    pts = grid[np.asarray(idx)]
    lo = float(grid.min()) - ap.wing_cutoff
    hi = float(grid.max()) + ap.wing_cutoff
    for mol in ap.molecules[i_band]:
        try:
            ht = _line_list(mol, lo, hi)
        except HitranEmptyError:
            continue                     # no line of the list in the band
        model = make_hitran_model(ht, ap.broadening,
                                  wing_cutoff=ap.wing_cutoff, cef=ap.cef,
                                  vmr=0.0)
        vmr = prof.vmr[mol]
        vmr = (np.asarray(vmr) if np.ndim(vmr) > 0
               else np.full(n_z, float(vmr)))
        for iz in range(n_z):
            sigma = compute_absorption_cross_section(
                model, pts, float(prof.p_full[iz]), float(prof.T[iz]),
                device)
            tau[:, iz] += sigma.cpu().numpy() * prof.vcd_dry[iz] * vmr[iz]
    return tau


def scattering_depth(band: BandOptics, aod_scale: float = 1.0):
    """(nSpec, nZ) scattering depth of the band's whole grid: Rayleigh plus
    the truncated aerosols' tau' ssa'."""
    scat = band.tau_rayl.copy()
    for optics, tau_aer in band.aerosols:
        f_t, ssa = optics.f_t, optics.ssa
        scat += (aod_scale * (1.0 - f_t) * ssa * tau_aer)[None, :]
    return scat


def band_inputs(band: BandOptics, idx, tau_gas, aod_scale: float = 1.0,
                gas_scale: float = 1.0):
    """tau, omega (nZ, S) and zw (nZ, K, S) at the points ``idx``, K = 1
    Rayleigh + the band's aerosols, with the aerosol depths scaled by
    ``aod_scale`` and the gas depths by ``gas_scale``; the greeks of the K
    components follow from the band (Rayleigh first)."""
    idx = np.asarray(idx)
    n_z = band.tau_rayl.shape[1]
    scat = [band.tau_rayl[idx].T]
    tau = band.tau_rayl[idx].T + gas_scale * tau_gas.T
    for optics, tau_aer in band.aerosols:
        f_t, ssa = optics.f_t, optics.ssa
        tau_mod = aod_scale * (1.0 - f_t * ssa) * tau_aer
        ssa_mod = (1.0 - f_t) * ssa / (1.0 - f_t * ssa)
        tau = tau + tau_mod[:, None]
        scat.append(np.broadcast_to((tau_mod * ssa_mod)[:, None],
                                    (n_z, len(idx))))
    scat = np.stack(scat, axis=1)                 # (nZ, K, S)
    scat_sum = scat.sum(axis=1)
    omega = scat_sum / tau
    zw = np.where(scat_sum[:, None, :] > 0,
                  scat / np.maximum(scat_sum[:, None, :], 1e-300), 0.0)
    return tau, omega, zw


def greeks(scene: Scene, band: BandOptics):
    return [scene.greek_rayleigh] + [o.greek_coefs for o, _ in band.aerosols]


def to_torch(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)
