"""Per-layer absorption optical-depth profiles + HITRAN data resolution.

ref: src/CoreRT/tools/atmo_prof.jl:427-449 (compute_absorption_profile!)
     src/Artifacts/artifact_helper.jl (HITRAN data lookup)

Line lists are read in place from the repository's ``data/hitran``;
nothing is downloaded.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import warnings
from typing import Optional

import numpy as np
import torch

from vsmartmom_torch._paths import HITRAN_DIR
from vsmartmom_torch.spectroscopy.hitran import (HitranEmptyError,
                                                 read_hitran,
                                                 read_linelist_npz)
from vsmartmom_torch.spectroscopy.voigt import (
    check_kernel_model, compute_absorption_cross_section, kernel_computes,
    line_parameters, make_hitran_model, make_voigt_plan)
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device

#: HITRAN molecule numbers for the name-keyed line-list lookup
MOL_IDS = {"H2O": 1, "CO2": 2, "O3": 3, "N2O": 4, "CO": 5, "CH4": 6,
           "O2": 7, "NO": 8, "SO2": 9, "NO2": 10}


# Physically line-free spectral windows (vibrational polyad gaps), per
# molecule: a zero cross-section there is the correct physical answer, not
# a coverage hole, so no warning is raised. CO2: the O2 A-band region sits
# in the gap between the 5-quanta polyad (ending below ~12790 cm^-1) and the
# 6-quanta polyad (above ~13600 cm^-1); residual CO2 lines there have
# S < 1e-28 cm^-1/(molec cm^-2) and contribute column tau < 1e-6.
DECLARED_EMPTY_WINDOWS = {
    "CO2": ((12790.0, 13600.0),),
}


def hitran_artifact(molecule: str) -> str:
    """Locate the line list for a molecule in the repository's data/hitran:
    HITRAN fixed-width ``.par`` or the full-precision binary ``.npz`` form
    (theta = (n, 6) columns [nu0, ln S296, E'', ln gamma_air, n_air,
    delta_air]). ref: Artifacts/artifact_helper.jl:20-26.
    """
    for name in (f"{molecule}.par", f"{molecule}.npz", f"{molecule}.data",
                 f"hitran_molec_id_{molecule}.par"):
        p = os.path.join(HITRAN_DIR, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"No line list found for {molecule!r}: place '{molecule}.par' (or "
        f"the binary '{molecule}.npz') in {HITRAN_DIR}.")


def read_linelist(path: str, molecule: str, nu_min: float = 0.0,
                  nu_max: float = np.inf):
    """Dispatch the line-list parse by extension (.par fixed width / .npz
    binary), with the same wavenumber filter semantics."""
    if path.endswith(".npz"):
        ht = read_linelist_npz(path, MOL_IDS.get(molecule, -1))
        sel = (ht.nu > nu_min) & (ht.nu < nu_max)
        if not sel.any():
            raise HitranEmptyError(path)
        return dataclasses.replace(
            ht, **{f.name: (getattr(ht, f.name)[sel]
                            if isinstance(getattr(ht, f.name), np.ndarray)
                            else [x for x, k in
                                  zip(getattr(ht, f.name), sel) if k])
                   for f in dataclasses.fields(ht)})
    return read_hitran(path, nu_min=nu_min, nu_max=nu_max)


def select_voigt_engine(engine: str, device: torch.device, model) -> str:
    """Resolve ``engine`` ("auto", "kernel" or "dense") for ``model``.

    "auto" takes the Voigt kernel on CUDA for a model whose line shape it
    computes (the default CEF's Voigt profile, voigt.kernel_computes) and
    the dense engine otherwise, so every CEF computes what it names.
    "kernel" with another CEF or broadening raises ValueError.
    """
    if engine == "auto":
        return ("kernel" if device.type == "cuda" and kernel_computes(model)
                else "dense")
    if engine == "kernel":
        check_kernel_model(model)
    elif engine != "dense":
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def compute_absorption_profile(tau_abs: np.ndarray, molecule: str,
                               absorption_params, grid, vmr, profile,
                               lut_path: Optional[str] = None,
                               engine: str = "auto",
                               device=DEFAULT_DEVICE):
    """Accumulate tau_abs[nu, iz] += sigma(nu; p_iz, T_iz) * vcd_dry * vmr.

    ref: atmo_prof.jl:427-449. Mutates tau_abs (nSpec, nZ) in place.

    ``lut_path``: an InterpolationModel npz (spectroscopy.lut) to
    interpolate sigma from, on the host, in place of the line list.
    engine: 'dense' (f64 sweep — the HAPI-gate numerics, layer by layer),
    'kernel' (the f32 tiled Voigt kernel: every layer in one launch), or
    'auto' (see select_voigt_engine).
    """
    device = resolve_device(device)
    n_z = profile.n_layers
    if tau_abs.shape[1] != n_z:
        raise ValueError("tau_abs must be (nSpec, n_layers)")
    vmr_arr = (np.asarray(vmr) if np.ndim(vmr) > 0
               else np.full(n_z, float(vmr)))
    if np.ndim(vmr) > 0 and len(vmr_arr) != n_z:
        raise ValueError(
            "Length of VMR array has to match profile size or be uniform")
    if lut_path is not None:
        # scipy's interpolators load only for a table
        from vsmartmom_torch.spectroscopy.lut import load_interpolation_model
        lut = load_interpolation_model(lut_path)
        for iz in range(n_z):
            tau_abs[:, iz] += (lut(grid, float(profile.p_full[iz]),
                                   float(profile.T[iz]))
                               * profile.vcd_dry[iz] * vmr_arr[iz])
        return tau_abs

    lo = float(np.min(grid)) - absorption_params.wing_cutoff
    hi = float(np.max(grid)) + absorption_params.wing_cutoff
    try:
        # all isotopologues of the molecule's line list
        ht = read_linelist(hitran_artifact(molecule), molecule,
                           nu_min=lo, nu_max=hi)
    except HitranEmptyError:
        if any(lo >= a and hi <= b
               for a, b in DECLARED_EMPTY_WINDOWS.get(molecule, ())):
            logging.getLogger("vsmartmom_torch").info(
                "%s: [%.1f, %.1f] cm-1 is a declared line-free window"
                " (polyad gap); tau_abs += 0", molecule,
                float(np.min(grid)), float(np.max(grid)))
        else:
            warnings.warn(f"{molecule}: no lines in "
                          f"[{float(np.min(grid)):.1f}, "
                          f"{float(np.max(grid)):.1f}] cm-1; "
                          f"tau_abs += 0 (line-list coverage hole?)")
        return tau_abs
    model = make_hitran_model(ht, absorption_params.broadening,
                              wing_cutoff=absorption_params.wing_cutoff,
                              cef=absorption_params.cef, vmr=0.0)
    engine = select_voigt_engine(engine, device, model)
    if engine == "kernel":
        # every layer in one launch, one copy to the host
        plan = make_voigt_plan(model, grid, device=device)
        sigma = plan.run(*line_parameters(model, profile.p_full,
                                          profile.T)).cpu().numpy()
        tau_abs += sigma.T * profile.vcd_dry * vmr_arr
        return tau_abs
    for iz in range(n_z):
        sigma = compute_absorption_cross_section(
            model, grid, float(profile.p_full[iz]), float(profile.T[iz]),
            device=device, engine=engine)
        tau_abs[:, iz] += (sigma.cpu().numpy() * profile.vcd_dry[iz]
                           * vmr_arr[iz])
    return tau_abs
