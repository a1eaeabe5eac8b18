"""ABSCO (NASA Absorption Coefficient) table reader + LUT construction.

Port of ``vsmartmom/spectroscopy/absco.py``. ABSCO v5 tables ship as HDF5
(read with h5py, imported by the reader only: the package does not need
it otherwise); legacy netCDF3 variants are read with scipy.io.netcdf_file.

ref: src/CoreRT/tools/model_from_parameters.jl:366-378 (loadAbsco),
     src/Absorption/types.jl:73-86 (AbscoTable),
     src/Absorption/make_model_helpers.jl:112-229
     (make_interpolation_model from ABSCO).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from vsmartmom_torch.spectroscopy.lut import InterpolationModel


@dataclasses.dataclass
class AbscoTable:
    """Tabulated cross sections sigma(nu, broadener, T, p).

    mol/iso: HITRAN IDs (iso = -1 when not resolved, as the reference);
    nu [cm^-1]; sigma 4-D (n_nu, n_broadener, n_T, n_p); p [hPa];
    T (n_T, n_p): ABSCO tabulates a different temperature set per
    pressure level. ref: Absorption/types.jl:73-86.
    """
    mol: int
    iso: int
    nu: np.ndarray
    sigma: np.ndarray
    p: np.ndarray
    T: np.ndarray


def _read_variables_h5(path):
    import h5py
    f = h5py.File(path, "r")
    return (lambda k: np.asarray(f[k])), f


def _read_variables_nc3(path):
    from scipy.io import netcdf_file
    f = netcdf_file(path, "r", mmap=False)
    return (lambda k: np.asarray(f.variables[k][:])), f


def load_absco(path, scale: float = 1.0) -> AbscoTable:
    """Load an ABSCO file (HDF5 or netCDF3). ref: loadAbsco
    (model_from_parameters.jl:366-378): pressure converted Pa -> hPa,
    cross sections optionally scaled. Without h5py a netCDF3 file still
    loads (the JAX package needs h5py for either)."""
    try:
        get, f = _read_variables_h5(path)
    except (ImportError, OSError):
        # not HDF5, or no h5py installed: netCDF3 needs scipy only
        get, f = _read_variables_nc3(path)
    try:
        gas_index = get("Gas_Index")
        if gas_index.dtype.kind in "SU":
            mol_str = (gas_index.ravel()[0].decode()
                       if gas_index.dtype.kind == "S"
                       else str(gas_index.ravel()[0]))
        else:
            mol_str = str(int(np.ravel(gas_index)[0]))
        sigma = np.float32(scale) * np.asarray(
            get(f"Gas_{mol_str}_Absorption"), np.float32)
        T = np.asarray(get("Temperature"), np.float64)
        p = np.asarray(get("Pressure"), np.float64) / 100.0   # Pa -> hPa
        nu = np.asarray(get("Wavenumber"), np.float64)
    finally:
        f.close()
    # axis order (n_nu, n_b, n_T, n_p): ABSCO v5 stores (p, T, b, nu), the
    # reference's column-major read yields the former
    if sigma.shape[0] != len(nu) and sigma.shape[-1] == len(nu):
        sigma = sigma.transpose(tuple(range(sigma.ndim))[::-1])
    if sigma.ndim == 3:
        sigma = sigma[:, None, :, :]
    if T.ndim == 2 and T.shape[0] == len(p):
        T = T.T
    return AbscoTable(mol=int(mol_str), iso=-1, nu=nu, sigma=sigma, p=p,
                      T=T)


def absco_to_interpolation_model(absco: AbscoTable, nu_grid, p_grid,
                                 t_grid, wavelength_flag: bool = False
                                 ) -> InterpolationModel:
    """Resample the ABSCO table onto regular (nu, p, T) grids as an
    InterpolationModel (what make_interpolation_model makes).
    ref: make_model_helpers.jl:112-174.

    ABSCO's T coordinates vary per pressure level, so for each target
    (p, T): interpolate in T at the bracketing pressure levels, then in p,
    then in nu. ``wavelength_flag``: nu_grid is in nm.
    """
    nu_grid = np.asarray(nu_grid, np.float64)
    if wavelength_flag:
        nu_grid = np.sort(1e7 / nu_grid)
    p_grid = np.asarray(p_grid, np.float64)
    t_grid = np.asarray(t_grid, np.float64)

    xs = absco.sigma[:, 0]                   # (n_nu, n_T, n_p)
    n_t_tab, n_p_tab = xs.shape[1], xs.shape[2]
    cube = np.zeros((len(nu_grid), len(p_grid), len(t_grid)))

    def t_interp(tv, ip):
        ft = np.interp(tv, absco.T[:, ip], np.arange(n_t_tab))
        t_lo, t_hi = int(np.floor(ft)), int(np.ceil(ft))
        b = t_hi - ft if t_hi != t_lo else 0.0
        return (1 - b) * xs[:, t_hi, ip] + b * xs[:, t_lo, ip]

    # fractional pressure index (flat extrapolation)
    fp = np.interp(p_grid, absco.p, np.arange(n_p_tab))
    for i, fpi in enumerate(fp):
        i_lo, i_hi = int(np.floor(fpi)), int(np.ceil(fpi))
        a = i_hi - fpi if i_hi != i_lo else 0.0
        for j, tv in enumerate(t_grid):
            prof = a * t_interp(tv, i_lo) + (1 - a) * t_interp(tv, i_hi)
            cube[:, i, j] = np.interp(nu_grid, absco.nu, prof)

    return InterpolationModel(sigma=cube, nu_grid=nu_grid, p_grid=p_grid,
                              t_grid=t_grid, mol=absco.mol, iso=absco.iso)
