"""Solar / Planck source spectra.

Setup-time math (numpy): Planck black-body radiance in wavenumber and
wavelength conventions, photon-rate conversion, and the Toon GGG2014 solar
transmission line-list loader with interpolation onto a simulation grid.

Port of ``vsmartmom/solar/model.py`` (ref: src/SolarModel/SolarModel.jl:
16-157; the reference downloads the Toon line list at first use, the port
reads the repository's ``data/solar/solar.out`` in place, see
``solar_linelist_path``).
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from vsmartmom_torch import _paths

# First radiation constant for spectral radiance, mW/m2-sr-cm-1 (c1L = 2hc^2)
_C1_WN = 1.1910427e-5
# Second radiation constant, K cm
_C2_WN = 1.4387752
# Same constants in wavelength units (W/m2-sr-um, K um)
_C1_WL = 1.1910427e8
_C2_WL = 1.4387752e4

_H = 6.62607015e-34   # J s
_C = 299792458.0      # m/s


def planck_spectrum_wn(T: float, nu_grid=None, stride_length: int = 100):
    """Black-body spectral radiance L(nu, T) in mW/m2-sr-cm-1.

    With ``nu_grid`` (cm-1) given, returns the radiance on that grid.
    Without it, auto-extends a unit grid from 1 cm-1 until the spectrum has
    decayed below its first value, returning an (n, 2) [nu, L] array
    (ref: SolarModel.jl:66-89).
    """
    if nu_grid is not None:
        nu = np.asarray(nu_grid, dtype=np.float64)
        return _C1_WN * nu**3 / np.expm1(_C2_WN * nu / T)

    nus = np.array([1.0])
    rad = planck_spectrum_wn(T, nus)
    while rad[-1] >= rad[0]:
        ext = nus[-1] + 1.0 + np.arange(stride_length)
        nus = np.concatenate([nus, ext])
        rad = np.concatenate([rad, planck_spectrum_wn(T, ext)])
    return np.column_stack([nus[:-1], rad[:-1]])


def planck_spectrum_wl(T: float, wl_grid):
    """Black-body spectral radiance L(lambda, T) in W/m2-sr-um
    (lambda in microns). ref: SolarModel.jl:33-43."""
    wl = np.asarray(wl_grid, dtype=np.float64)
    return _C1_WL / (wl**5 * np.expm1(_C2_WL / (wl * T)))


def watts_to_photons(wl_grid, radiance):
    """Convert W/m2-sr-um -> photons/s-m2-sr-um (lambda in microns).
    ref: SolarModel.jl:47-56."""
    wl = np.asarray(wl_grid, dtype=np.float64)
    e_per_photon = _H * _C / (wl * 1e-6)
    return np.asarray(radiance) / e_per_photon


def solar_linelist_path() -> Optional[Path]:
    """The Toon GGG2014 merged solar transmission file of the repository
    (``data/solar/solar.out``), or None where it is absent."""
    path = Path(_paths.SOLAR_FILE)
    return path if path.is_file() else None


def solar_transmission_from_file(file_name, nu_grid=None):
    """Load a two-column (nu, transmission) solar line list; optionally
    linearly interpolate onto ``nu_grid`` with a 10-point margin subset
    (ref: SolarModel.jl:96-126)."""
    solar = np.loadtxt(file_name)
    if nu_grid is None:
        return solar
    return itp_solar_to_nu_grid(solar, nu_grid)


def itp_solar_to_nu_grid(solar, nu_grid):
    """Interpolate an (n, 2) solar table onto nu_grid (cm-1)."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    i0 = max(int(np.argmin(np.abs(solar[:, 0] - nu_grid.min()))) - 10, 0)
    i1 = min(int(np.argmin(np.abs(solar[:, 0] - nu_grid.max()))) + 10,
             solar.shape[0] - 1)
    sub = solar[i0:i1 + 1]
    return np.interp(nu_grid, sub[:, 0], sub[:, 1])


def default_solar_transmission(nu_grid=None):
    """Toon solar transmission on ``nu_grid`` (default: full 600-26316 cm-1
    range at 0.01 cm-1). Returns (n, 2) [nu, transmission].
    Falls back to unit transmission (continuum only) when no line-list file
    is present, so forward runs stay usable offline."""
    if nu_grid is None:
        nu_grid = np.arange(600.0, 26316.0 + 1e-9, 0.01)
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    path = solar_linelist_path()
    if path is None:
        warnings.warn(f"No Toon solar line list at {_paths.SOLAR_FILE}; "
                      f"using unit solar transmission.")
        trans = np.ones_like(nu_grid)
    else:
        trans = solar_transmission_from_file(path, nu_grid)
    return np.column_stack([nu_grid, trans])


def default_solar_spectrum_at_earth(nu_grid=None):
    """Solar spectral photon flux at 1 AU: 5777 K Planck disk irradiance
    scaled by the solid angle of the Sun (2.1629e-5 sr) times pi, converted
    to photons, times the Toon transmission (ref: SolarModel.jl:152-157).
    Returns (n, 2) [nu, photons/s-m2-sr-um-equivalent]."""
    if nu_grid is None:
        nu_grid = np.arange(600.0, 26316.0 + 1e-9, 0.01)
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    wl_grid = 1e4 / nu_grid
    black_body = watts_to_photons(
        wl_grid, planck_spectrum_wl(5777.0, wl_grid) * 2.1629e-5 * np.pi)
    trans = default_solar_transmission(nu_grid)[:, 1]
    return np.column_stack([nu_grid, black_body * trans])
