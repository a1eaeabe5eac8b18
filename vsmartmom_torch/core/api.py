"""User-facing rt_run on an RTModel (mirrors the reference's entry point).

ref: src/CoreRT/rt_run.jl:19-230 and
     src/CoreRT/LayerOpticalProperties/compEffectiveLayerProperties.jl
"""
from __future__ import annotations

import numpy as np
import torch

from vsmartmom_torch.core.model import RTModel
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.util.device import DEFAULT_DEVICE


def build_band_inputs(model: RTModel, i_band: int,
                      omega_cabannes: float = 1.0) -> BandRTInputs:
    """Mix Rayleigh + aerosols + gas absorption into core layer optical
    properties (tau, omega, component mixing weights).

    ref: compEffectiveLayerProperties.jl:1-85 (constructCoreOpticalProperties
    + createAero). The delta-BGE-truncated aerosols enter with
    tau' = (1 - f_t * ssa) tau and ssa' = (1 - f_t) ssa / (1 - f_t * ssa).
    """
    tau_rayl = model.tau_rayl[i_band]          # (nSpec, nZ)
    tau_abs = model.tau_abs[i_band]            # (nSpec, nZ)
    tau_aer = model.tau_aer[i_band]            # (nAer, nZ)
    n_spec, n_z = tau_rayl.shape
    n_aer = tau_aer.shape[0]

    # scattering components: Rayleigh first, then aerosols
    scat = np.zeros((n_z, 1 + n_aer, n_spec))
    scat[:, 0, :] = (tau_rayl * omega_cabannes).T
    tau_total = tau_rayl.T.copy()              # (nZ, nSpec)
    greeks = [model.greek_rayleigh]
    for i in range(n_aer):
        optics = model.aerosol_optics[i_band][i]
        f_t, ssa = optics.f_t, optics.ssa
        tau_mod = (1.0 - f_t * ssa) * tau_aer[i]        # (nZ,)
        ssa_mod = (1.0 - f_t) * ssa / (1.0 - f_t * ssa)
        tau_total += tau_mod[:, None]
        scat[:, 1 + i, :] = (tau_mod * ssa_mod)[:, None]
        greeks.append(optics.greek_coefs)
    tau_total += tau_abs.T

    scat_sum = scat.sum(axis=1)                          # (nZ, nSpec)
    omega = scat_sum / tau_total
    with np.errstate(invalid="ignore", divide="ignore"):
        zw = np.where(scat_sum[:, None, :] > 0,
                      scat / np.maximum(scat_sum[:, None, :], 1e-300), 0.0)
    return BandRTInputs(tau=tau_total, omega=omega, zw=zw, greeks=greeks)


def rt_run(model: RTModel, i_band: int = 0, dtype=None, rs_type=None,
           device=DEFAULT_DEVICE, engine: str = "auto"):
    """Run the elastic forward RT simulation for band ``i_band`` on
    ``device`` ("cuda" unless the caller asks for "cpu"); returns (R_SFI,
    T_SFI) of shape (n_vza, n_stokes, nSpec).

    ``dtype`` defaults to the parameters' float_type. ``engine`` is passed
    to rt_run_band ("auto" or one of core.rt_run.ENGINES). Band concatenation
    (several bands in one run) and inelastic (Raman) ``rs_type`` are not
    ported yet.
    """
    if rs_type is not None and rs_type != "noRS":
        raise NotImplementedError(
            "Raman coupling is not ported yet (ROADMAP queue 1, item 7)")
    if not isinstance(i_band, int):
        raise NotImplementedError(
            "band concatenation is not ported yet (ROADMAP queue 1, item 5)")
    if dtype is None:
        dtype = (torch.float32 if model.params.float_type == "Float32"
                 else torch.float64)
    surfaces = model.params.surfaces
    # reuse the last surface when fewer are given than bands
    surface = surfaces[min(i_band, len(surfaces) - 1)]
    return rt_run_band(model.pol, model.quad_points,
                       build_band_inputs(model, i_band), model.obs_geom.vza,
                       model.obs_geom.vaz, model.params.max_m, surface,
                       dtype=dtype, device=device, engine=engine)
