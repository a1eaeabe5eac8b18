"""RAMI4ATM benchmark scene runner.

Port of ``vsmartmom/core/rami.py``: host set-up in numpy, the forward run
on ``device`` (core/rt_run.py:rt_run_band).

Maps a RAMI4ATM experiment description (the structure of the benchmark's
``RAMI4ATM_experiments_v1.0.json`` entries) onto RTParameters, runs the
forward model, and produces the benchmark's TOA BRF and surface HDRF/BHR
products, optionally convolved with the Sentinel-2A spectral response.

ref: test/rami/rami.jl (scene runner), test/rami/rami_tools.jl (surface /
aerosol / gas / geometry mapping, Sentinel convolution). Data files (AFGL
profile, aerosol refractive-index tables, Sentinel-2A ILS) are the public
RAMI4ATM/Sentinel ancillaries; point ``data_dir`` at a directory holding
them (the reference vendors them under test/rami/).

Note: the reference's gas scaling swaps the two ratios (rami_tools.jl:
133-134 scales vmr[O3] by the H2O ratio and vmr[H2O] by the O3 ratio);
this implementation applies each gas its own ratio.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from vsmartmom_torch.config.params import (AbsorptionParameters,
                                           AerosolSpec, RTParameters,
                                           ScatteringParameters)
from vsmartmom_torch.scattering.mie import BimodalAerosol
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device

# RAMI4ATM bimodal aerosol shapes (number-fraction coarse mode)
# ref: rami_tools.jl:55-91; RAMI4ATM_aerosols_v1.0 spec
AEROSOL_MODES = {
    "desert": dict(mu_fine=0.0478666, sigma_fine=1.87411,
                   mu_coarse=0.604127, sigma_coarse=1.75172,
                   frac_coarse=0.0033219635),
    "continental": dict(mu_fine=0.0807989, sigma_fine=1.50180,
                        mu_coarse=0.682651, sigma_coarse=2.10400,
                        frac_coarse=0.00046374026257),
}

# Sentinel-2A band -> 0-based column in the ILS file and band edges [nm]
# ref: rami_tools.jl:12-26 (1-based cols 3,4,5,10,13,14)
SENTINEL_ILS_COL = {"2": 2, "3": 3, "4": 4, "8a": 9, "11": 12, "12": 13}
SENTINEL_BAND_NM = {"2": (456.0, 533.0), "3": (538.0, 583.0),
                    "4": (646.0, 684.0), "8a": (848.0, 881.0),
                    "11": (1539.0, 1682.0), "12": (2078.0, 2320.0)}

# RAMI reference column amounts [kg/m^2] for concentration scaling
# ref: rami_tools.jl:127-129
REF_H2O_KG_M2 = 14.274
REF_O3_KG_M2 = 0.746e-2

ATM_NO_RAYLEIGH = ("AtmosphereType.ABSORBING", "AtmosphereType.AEROSOLS",
                   "AtmosphereType.ABSORBING_AEROSOLS")
ATM_NO_ABSORPTION = ("AtmosphereType.RAYLEIGH", "AtmosphereType.AEROSOLS",
                     "AtmosphereType.SCATTERING_AEROSOLS")


@dataclasses.dataclass
class AFGLProfile:
    """AFGL standard-atmosphere levels (surface -> TOA in file order)."""
    z_km: np.ndarray
    p_hpa: np.ndarray
    T: np.ndarray
    n_air: np.ndarray            # [molec/cm^3]
    vmr: Dict[str, np.ndarray]   # per-level VMR (mol/mol)


def read_afgl_profile(path: str) -> AFGLProfile:
    """Parse a RAMI4ATM AFGL ap-file: columns z[km] p[hPa] T[K]
    n_air[cm^-3] then H2O CO2 O3 N2O CO CH4 O2 in ppmv.
    ref: test/rami/RAMI4ATM_AFGLUSstandard_ap_v1.0.txt format."""
    d = np.loadtxt(path)
    gases = ["H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"]
    vmr = {g: d[:, 4 + i] * 1e-6 for i, g in enumerate(gases)}
    return AFGLProfile(z_km=d[:, 0], p_hpa=d[:, 1], T=d[:, 2],
                       n_air=d[:, 3], vmr=vmr)


def write_afgl_profile(path: str, prof: AFGLProfile):
    """Write ``prof`` in the ap-file format read_afgl_profile reads (the
    inverse of that reader: ppmv columns, one level a row)."""
    gases = ["H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"]
    cols = [prof.z_km, prof.p_hpa, prof.T, prof.n_air] + [
        np.asarray(prof.vmr[g]) * 1e6 for g in gases]
    np.savetxt(path, np.column_stack(cols), fmt="%.10e")


def profile_inputs_from_afgl(prof: AFGLProfile):
    """AFGL levels -> (T_layer, p_half, q_layer g/kg, vmr_layer dict) in the
    TOA->surface layer ordering used by compute_atmos_profile_fields."""
    order = np.argsort(prof.p_hpa)          # ascending p = TOA -> surface
    p_half = prof.p_hpa[order]
    T_lev = prof.T[order]
    T = 0.5 * (T_lev[1:] + T_lev[:-1])
    vmr = {g: 0.5 * (v[order][1:] + v[order][:-1])
           for g, v in prof.vmr.items()}
    x = vmr["H2O"]
    q = x * 18.01534 / (x * 18.01534 + (1.0 - x) * 28.9644) * 1000.0
    return T, p_half, q, vmr


def h2o_column_kg_m2(profile) -> float:
    """Water-vapour column [kg/m^2] of a derived AtmosphericProfile."""
    return float(np.sum(profile.vcd_h2o) * 1e4 * 18.01534e-3 / 6.02214076e23)


def o3_column_kg_m2(profile) -> float:
    vmr = profile.vmr["O3"]
    return float(np.sum(profile.vcd_dry * vmr) * 1e4 * 47.9982e-3
                 / 6.02214076e23)


def read_refractive_table(path: str):
    """Aerosol refractive-index table: rows of (wl_nm, n_r, n_i).
    ref: rami_tools.jl:9-10 (desert/continental tables)."""
    d = np.loadtxt(path)
    return d[:, 0], d[:, 1], d[:, 2]


def refractive_at(table, wl_nm: float):
    """Wavelength-interpolated (n_r, n_i) — the reference picks the nearest
    Sentinel row (rami_tools.jl:72-75); interpolation subsumes that."""
    wl, nr, ni = table
    return (float(np.interp(wl_nm, wl, nr)), float(np.interp(wl_nm, wl, ni)))


def read_sentinel_ils(path: str):
    """Sentinel-2A spectral responses: (wl_nm, {band: response})."""
    d = np.loadtxt(path)
    return d[:, 0], {b: d[:, c] for b, c in SENTINEL_ILS_COL.items()}


def convolve_ils(nu_grid, spectrum, wl_ils, resp):
    """Band-average a wavenumber-gridded spectrum with an ILS given on a
    wavelength grid (ref: rami_tools.jl convolve_2_sentinel:139-155).
    spectrum: (..., nSpec). Returns (...,)."""
    wl_in = 1e7 / np.asarray(nu_grid)
    w = np.interp(wl_in, wl_ils, resp, left=0.0, right=0.0)
    s = w.sum()
    if s <= 0:
        raise ValueError("ILS does not overlap the spectral band")
    return np.tensordot(np.asarray(spectrum), w / s, axes=([-1], [0]))


def rami_geometry(vza_start: float = 1.0, vza_end: float = 75.0,
                  vza_step: float = 2.0):
    """The RAMI principal + cross-plane VZA fan
    (ref: rami_tools.jl setGeometry!:228-236)."""
    vzas = np.arange(vza_start, vza_end + vza_step / 2, vza_step)
    vza = np.concatenate([vzas[::-1], vzas, vzas[::-1], vzas])
    vaz = np.concatenate([np.full(len(vzas), 180.0), np.zeros(len(vzas)),
                          np.full(len(vzas), 90.0), np.full(len(vzas), -90.0)])
    return vza, vaz


def _surface_from_scene(surface: dict) -> dict:
    """RAMI surface spec -> rt_run surface dict
    (ref: rami_tools.jl setSurface!:265-283)."""
    name = surface["name"]
    p = surface.get("surface_parameters", {})
    first = lambda v: v[0] if isinstance(v, (list, tuple, np.ndarray)) else v
    if name in ("WHI", "BLA", "LAM"):
        return {"type": "LambertianSurfaceScalar",
                "albedo": float(first(p.get("reflectance", 0.0)))}
    if name == "RPV":
        return {"type": "rpvSurfaceScalar", "rho0": float(first(p["rho_0"])),
                "rho_c": float(first(p["rho_c"])), "k": float(first(p["k"])),
                "theta": float(first(p["theta"]))}
    if name == "RLI":
        return {"type": "RossLiSurfaceScalar",
                "fvol": float(first(p["f_vol"])),
                "fgeo": float(first(p["f_geo"])),
                "fiso": float(first(p["f_iso"]))}
    raise NotImplementedError(f"RAMI surface {name!r} (HOM00 LAM/RPV/RLI)")


def build_rami_parameters(scenario: dict, data_dir: str,
                          dnu: float = 1.0, n_layers: int = 20,
                          l_trunc: int = 40, max_m: int = 20,
                          nquad_radius: int = 200) -> RTParameters:
    """RAMI4ATM experiment dict -> RTParameters.

    scenario keys used (mirroring the benchmark JSON): name,
    measures[0].bands[0], atmosphere{atmosphere_type, aerosols[],
    concentrations{}}, illumination.sza.value, surface{name,
    surface_parameters}. ref: rami.jl:31-120, rami_tools.jl getParams /
    add_aerosols! / scale_gases! / setGeometry! / setSurface!.
    """
    band = scenario["measures"][0]["bands"][0]
    atm = scenario["atmosphere"]
    atm_type = atm["atmosphere_type"]

    wl_lo, wl_hi = SENTINEL_BAND_NM[band]
    nu = np.arange(1e7 / wl_hi, 1e7 / wl_lo, dnu)

    prof = read_afgl_profile(os.path.join(
        data_dir, "RAMI4ATM_AFGLUSstandard_ap_v1.0.txt"))
    T, p_half, q, vmr = profile_inputs_from_afgl(prof)

    # gas concentration scaling (each gas by ITS OWN ratio; see module note)
    conc = atm.get("concentrations") or {}
    if conc:
        from vsmartmom_torch.core.atmosphere import \
            compute_atmos_profile_fields
        base = compute_atmos_profile_fields(T, p_half, q, vmr)
        if "H2O" in conc:
            vmr["H2O"] = vmr["H2O"] * (conc["H2O"]["value"]
                                       / h2o_column_kg_m2(base))
            x = vmr["H2O"]
            q = x * 18.01534 / (x * 18.01534 + (1 - x) * 28.9644) * 1000.0
        if "O3" in conc:
            vmr["O3"] = vmr["O3"] * (conc["O3"]["value"]
                                     / o3_column_kg_m2(base))

    absorption = None
    if atm_type not in ATM_NO_ABSORPTION:
        molecules = {"2": ["O3"], "3": ["O3", "H2O"], "4": ["O3", "H2O"],
                     "8a": ["H2O"], "11": ["H2O", "CO2", "CH4"],
                     "12": ["H2O", "CO2", "CH4", "N2O", "CO"]}[band]
        absorption = AbsorptionParameters(
            molecules=[molecules], vmr=vmr, broadening="Voigt",
            cef="HumlicekWeidemann32SDErrorFunction", wing_cutoff=40.0)

    scattering = None
    aeros = atm.get("aerosols") or []
    if aeros:
        a = aeros[0]
        kind = "desert" if a["name"].startswith("D") else "continental"
        table = read_refractive_table(os.path.join(
            data_dir, f"refractive_aero_{kind}.txt"))
        n_r, n_i = refractive_at(table, 0.5 * (wl_lo + wl_hi))
        n_ref_r, n_ref_i = refractive_at(table, 550.0)
        bim = BimodalAerosol(n_r=n_r, n_i=n_i, **AEROSOL_MODES[kind])
        spec = AerosolSpec(mu=bim.mu_fine, sigma=bim.sigma_fine, n_r=n_r,
                           n_i=n_i, tau_ref=float(a["tau_550"]),
                           p0=795.0, sigma_p=0.0, profile_type="uniform",
                           p_hi=1013.0, bimodal=bim)
        scattering = ScatteringParameters(
            rt_aerosols=[spec], r_max=20.0, nquad_radius=nquad_radius,
            lambda_ref=0.550, n_ref=complex(n_ref_r, -n_ref_i),
            decomp_type="NAI2")

    depol = 0.0
    vza, vaz = rami_geometry()
    rayleigh_off = atm_type in ATM_NO_RAYLEIGH

    return RTParameters(
        spec_bands=[nu], surfaces=[_surface_from_scene(scenario["surface"])],
        quadrature_type="GaussQuadFullSphere",
        polarization_type="Stokes_I", max_m=max_m, delta_angle=2.0,
        l_trunc=l_trunc, depol=(0.0 if rayleigh_off else depol),
        float_type="Float64", architecture="default",
        sza=float(scenario["illumination"]["sza"]["value"]),
        vza=vza, vaz=vaz, obs_alt=0.0, T=T, p=p_half, q=q,
        profile_reduction=n_layers, absorption_params=absorption,
        scattering_params=scattering)


def run_rami_scenario(scenario: dict, data_dir: str,
                      ils_path: Optional[str] = None,
                      device=DEFAULT_DEVICE, **build_kw) -> dict:
    """Run one RAMI4ATM experiment end-to-end on ``device`` ("cuda" unless
    the caller asks for "cpu"; the model build and the RT run both take
    it).

    Returns {"nu", "vza", "vaz", "brf", "hdrf", "bhr"}: TOA bidirectional
    reflectance factors pi*I/(mu0*F0) per view direction, the surface
    hemispherical-directional reflectance factor, and the bi-hemispherical
    reflectance — each ILS-convolved when ``ils_path`` is given.
    ref: rami.jl:90-182 (run + BRF normalization + save).
    """
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.model import model_from_parameters
    from vsmartmom_torch.core.rt_run import rt_run_band

    device = resolve_device(device)
    params = build_rami_parameters(scenario, data_dir, **build_kw)
    atm_type = scenario["atmosphere"]["atmosphere_type"]
    model = model_from_parameters(params, device=device)
    if atm_type in ATM_NO_RAYLEIGH:
        model.tau_rayl = [t * 1e-30 for t in model.tau_rayl]
    band = build_band_inputs(model, 0)
    mu0 = np.cos(np.deg2rad(params.sza))
    dtype = (torch.float32 if params.float_type == "Float32"
             else torch.float64)

    R, _T, hdr, bhr_uw, bhr_dw = rt_run_band(
        model.pol, model.quad_points, band, params.vza, params.vaz,
        params.max_m, params.surfaces[0], dtype=dtype, device=device,
        return_hdr=True)

    # Radiances here are already pi*I/F0 (Lambertian sanity: R = rho*mu0),
    # so BRF = R/mu0; fluxes bhr_* are hemisphere quadrature sums
    # Sum(I mu w) = flux/(2 pi), so HDRF = pi*I_up/E_down = hdr/(2 bhr_dw)
    # (ref: rami.jl BRF output convention; rami_tools.jl:157-178 HDRF/BHR)
    brf = R[:, 0, :] / mu0
    with np.errstate(invalid="ignore", divide="ignore"):
        hdrf = hdr[:, 0, :] / np.maximum(2.0 * bhr_dw[None, :], 1e-300)
    bhr = bhr_uw / np.maximum(bhr_dw, 1e-300)

    out = {"nu": params.spec_bands[0], "vza": params.vza, "vaz": params.vaz,
           "brf": brf, "hdrf": hdrf, "bhr": bhr}
    if ils_path is not None:
        wl, resp = read_sentinel_ils(ils_path)
        b = scenario["measures"][0]["bands"][0]
        out["brf_band"] = convolve_ils(out["nu"], brf, wl, resp[b])
        out["hdrf_band"] = convolve_ils(out["nu"], hdrf, wl, resp[b])
        out["bhr_band"] = float(convolve_ils(out["nu"], bhr, wl, resp[b]))
    return out
