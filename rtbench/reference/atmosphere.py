"""Atmospheric profile math: hydrostatic columns, layer reduction, Rayleigh
and aerosol optical-depth profiles.

Host-side numpy (setup-time). ref: src/CoreRT/tools/atmo_prof.jl.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

NA = 6.02214179e23       # Avogadro
RGAS = 8.3144598         # J/(mol K)
DRY_MASS = 28.9644e-3    # kg/mol (N2/O2 weighted)
WET_MASS = 18.01534e-3   # kg/mol (H2O)


@dataclasses.dataclass
class AtmosphericProfile:
    """Derived per-layer profile fields (ref: CoreRT/types.jl AtmosphericProfile)."""
    T: np.ndarray           # layer-center temperature (K)
    p_full: np.ndarray      # layer-center pressure (hPa)
    q: np.ndarray           # specific humidity (g/kg)
    p_half: np.ndarray      # layer-boundary pressure (hPa)
    vmr_h2o: np.ndarray
    vcd_dry: np.ndarray     # dry column density per layer (molec/cm^2)
    vcd_h2o: np.ndarray
    vmr: Dict               # trace-gas VMRs (scalar or per-layer arrays)
    dz: np.ndarray          # layer thickness (m)

    @property
    def n_layers(self) -> int:
        return len(self.T)


def compute_atmos_profile_fields(T, p_half, q, vmr, g0=9.807) -> AtmosphericProfile:
    """Hydrostatic layer fields from T/p/q. ref: atmo_prof.jl:36-91."""
    T = np.asarray(T, dtype=np.float64)
    p_half = np.asarray(p_half, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64) / 1000.0     # g/kg -> kg/kg
    n = len(T)
    assert len(p_half) == n + 1, "p must have one more level than T"

    p_full = 0.5 * (p_half[1:] + p_half[:-1])
    ratio = DRY_MASS / WET_MASS

    dp = np.diff(p_half)
    vmr_h2o = q / (1.0 - q) * ratio
    vmr_dry = 1.0 - vmr_h2o
    M = vmr_dry * DRY_MASS + vmr_h2o * WET_MASS
    vcd = NA * dp / (M * g0 * 100.0**2) * 100.0       # molec/cm^2
    vcd_dry = vmr_dry * vcd
    vcd_h2o = vmr_h2o * vcd
    dz = (np.log(p_half[1:]) - np.log(p_half[:-1])) / (g0 * M / (RGAS * T))

    new_vmr: Dict = {}
    for k, v in (vmr or {}).items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            if len(v) == n:
                new_vmr[k] = v
            else:
                # interpolate nodal points onto the p_full grid
                pg = np.linspace(p_full.min(), p_full.max(), len(v))
                new_vmr[k] = np.interp(p_full, pg, v)
        else:
            new_vmr[k] = float(v)

    return AtmosphericProfile(T=T, p_full=p_full, q=q * 1000.0, p_half=p_half,
                              vmr_h2o=vmr_h2o, vcd_dry=vcd_dry,
                              vcd_h2o=vcd_h2o, vmr=new_vmr, dz=dz)


def reduce_profile(n: int, profile: AtmosphericProfile) -> AtmosphericProfile:
    """Re-bin the profile to n near-equidistant pressure layers.

    ref: atmo_prof.jl:137-195. Raises ValueError where n is not below the
    layer count or a bin holds no layer (the JAX package asserts both).
    """
    if n >= profile.n_layers:
        raise ValueError("can only reduce the profile")
    a = np.linspace(0.0, profile.p_half.max(), n + 1)

    T = np.zeros(n)
    q = np.zeros(n)
    dz = np.zeros(n)
    p_full = np.zeros(n)
    p_half = a.copy()
    vmr_h2o = np.zeros(n)
    vcd_dry = np.zeros(n)
    vcd_h2o = np.zeros(n)
    indices = []
    for i in range(n):
        ind = np.where((a[i] < profile.p_full) & (profile.p_full <= a[i + 1]))[0]
        if len(ind) == 0:
            raise ValueError(
                f"Profile reduction has an empty layer ({a[i]:.2f}-"
                f"{a[i + 1]:.2f} hPa)")
        indices.append(ind)
        p_full[i] = profile.p_full[ind].mean()
        T[i] = profile.T[ind].mean()
        q[i] = profile.q[ind].mean()
        dz[i] = profile.dz[ind].sum()
        vcd_dry[i] = profile.vcd_dry[ind].sum()
        vcd_h2o[i] = profile.vcd_h2o[ind].sum()
        vmr_h2o[i] = vcd_h2o[i] / vcd_dry[i]

    new_vmr: Dict = {}
    for k, v in profile.vmr.items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            new_vmr[k] = np.array([v[ind].mean() for ind in indices])
        else:
            new_vmr[k] = v
    return AtmosphericProfile(T=T, p_full=p_full, q=q, p_half=p_half,
                              vmr_h2o=vmr_h2o, vcd_dry=vcd_dry,
                              vcd_h2o=vcd_h2o, vmr=new_vmr, dz=dz)


def rayleigh_layer_tau(psurf: float, lam_um: np.ndarray, depol: float,
                       vcd_dry: np.ndarray) -> np.ndarray:
    """Rayleigh scattering optical depth per (wavelength, layer).

    Bodhaine-style lambda^-4 fit for an N2/O2 atmosphere, distributed across
    layers proportionally to dry column. ref: atmo_prof.jl:210-224.
    Returns array of shape (n_lambda, n_layers).
    """
    lam_um = np.atleast_1d(np.asarray(lam_um, dtype=np.float64))
    tau_scat = (0.00864 * (psurf / 1013.25)
                * lam_um ** (-3.916 - 0.074 * lam_um - 0.05 / lam_um))
    tau_scat = tau_scat * (6.0 + 3.0 * depol) / (6.0 - 7.0 * depol)
    k = tau_scat / vcd_dry.sum()
    return k[:, None] * vcd_dry[None, :]


def aerosol_layer_tau_gaussian(total_tau: float, p0: float, sigma_p: float,
                               profile: AtmosphericProfile) -> np.ndarray:
    """Aerosol optical depth per layer: Gaussian density in pressure.

    ref: atmo_prof.jl:255-260 (Normal-distribution profile variant):
    rho = pdf(Normal(p0, sigma_p), p_full) * dz, normalized to total_tau.
    """
    pdf = (np.exp(-0.5 * ((profile.p_full - p0) / sigma_p) ** 2)
           / (sigma_p * np.sqrt(2.0 * np.pi)))
    rho = pdf * profile.dz
    return (total_tau / rho.sum()) * rho
