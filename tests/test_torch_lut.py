"""Spectroscopy beyond the default CEF: the complex error functions, the
Voigt engine choice by CEF, cross-section look-up tables and ABSCO
tables, of the port against the JAX package (CPU, f64).

Tolerances: every CEF of the registry at rtol 1e-12 on a seeded complex
grid; the dense cross section under each CEF at rtol 1e-10 (the dense
engine's bound in tests/test_torch_voigt.py); a LUT's cube at rtol 1e-10
and its interpolation at rtol 1e-12 given the same cube (the same scipy
calls); absorption profiles from a LUT at rtol 1e-12; ABSCO tables read
and resampled exactly as JAX does (rtol 1e-12).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core.atmosphere import \
    compute_atmos_profile_fields as jax_profile_fields
from vsmartmom.spectroscopy import absco as jabsco
from vsmartmom.spectroscopy import cef as jcef
from vsmartmom.spectroscopy import lut as jlut
from vsmartmom.spectroscopy import voigt as jvoigt
from vsmartmom.spectroscopy.hitran import read_hitran as jax_read_hitran
from vsmartmom.spectroscopy.profiles import \
    compute_absorption_profile as jax_absorption_profile

import vsmartmom_torch as port
from vsmartmom_torch.core.atmosphere import compute_atmos_profile_fields
from vsmartmom_torch.spectroscopy import absco as tabsco
from vsmartmom_torch.spectroscopy import cef as tcef
from vsmartmom_torch.spectroscopy import lut as tlut
from vsmartmom_torch.spectroscopy import voigt as tvoigt
from vsmartmom_torch.spectroscopy.hitran import read_hitran
from vsmartmom_torch.spectroscopy.profiles import (
    compute_absorption_profile, select_voigt_engine)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
CO2_PAR = os.path.join(DATA, "testCO2.par")
#: 750 points around testCO2.par's strongest line (6317.42 cm^-1)
GRID = np.arange(6316.0, 6319.0, 0.004)
OTHER_CEFS = sorted(set(tcef.CEF_REGISTRY) - {tcef.KERNEL_CEF})


def _models(cef=tcef.KERNEL_CEF, broadening="Voigt"):
    """The same testCO2.par model in the JAX package and the port."""
    return (jvoigt.make_hitran_model(jax_read_hitran(CO2_PAR,
                                                     engine="python"),
                                     broadening, wing_cutoff=40.0, cef=cef),
            tvoigt.make_hitran_model(read_hitran(CO2_PAR), broadening,
                                     wing_cutoff=40.0, cef=cef))


@pytest.mark.parametrize("name", sorted(jcef.CEF_REGISTRY))
def test_cef_matches_jax(name):
    assert set(tcef.CEF_REGISTRY) == set(jcef.CEF_REGISTRY)
    rng = np.random.default_rng(0)
    z = rng.uniform(-30, 30, 2000) + 1j * 10 ** rng.uniform(-4, 1.5, 2000)
    ref = np.asarray(jcef.CEF_REGISTRY[name](jnp.asarray(z)))
    got = tcef.CEF_REGISTRY[name](torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("cef", OTHER_CEFS)
def test_dense_cross_section_per_cef_matches_jax(cef):
    jm, tm = _models(cef)
    ref = np.asarray(jvoigt.compute_absorption_cross_section(
        jm, GRID, 800.0, 250.0))
    assert ref.max() > 0
    got = tvoigt.compute_absorption_cross_section(tm, GRID, 800.0, 250.0,
                                                  device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * ref.max())


def test_voigt_engine_choice_by_cef():
    """auto takes the kernel on CUDA only for the CEF (and Voigt profile)
    it computes; engine='kernel' with any other line shape raises."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    _, sd = _models()
    assert select_voigt_engine("auto", cuda, sd) == "kernel"
    assert select_voigt_engine("auto", cpu, sd) == "dense"
    assert select_voigt_engine("kernel", cpu, sd) == "kernel"
    for cef in OTHER_CEFS:
        _, m = _models(cef)
        assert select_voigt_engine("auto", cuda, m) == "dense"
        assert select_voigt_engine("auto", cpu, m) == "dense"
        assert select_voigt_engine("dense", cuda, m) == "dense"
        with pytest.raises(ValueError, match="Voigt kernel"):
            select_voigt_engine("kernel", cuda, m)
    _, lorentz = _models(broadening="Lorentz")
    assert select_voigt_engine("auto", cuda, lorentz) == "dense"
    with pytest.raises(ValueError):
        select_voigt_engine("pallas", cpu, sd)


@pytest.mark.parametrize("cef", OTHER_CEFS[:2])
def test_kernel_engine_refuses_other_cefs(cef):
    """No entry point runs the kernel (or its plain version) in place of a
    CEF it does not compute."""
    params = port.default_parameters()
    ap = params.absorption_params
    ap.cef = cef
    _, tm = _models(cef)
    with pytest.raises(ValueError, match="Voigt kernel"):
        tvoigt.compute_absorption_cross_section(tm, GRID, 800.0, 250.0,
                                                device="cpu", engine="kernel")
    profile = compute_atmos_profile_fields(params.T, params.p, params.q,
                                           ap.vmr)
    grid = np.arange(13150.0, 13151.0, 0.1)
    with pytest.raises(ValueError, match="Voigt kernel"):
        compute_absorption_profile(np.zeros((len(grid), profile.n_layers)),
                                   "O2", ap, grid, 0.21, profile,
                                   engine="kernel", device="cpu")


@pytest.fixture(scope="module")
def luts():
    """One small LUT built by each package from the same line list."""
    jm, tm = _models()
    grids = (GRID, np.array([200.0, 500.0, 800.0, 1000.0]),
             np.array([200.0, 240.0, 270.0, 300.0]))
    return (jlut.make_interpolation_model(jm, *grids),
            tlut.make_interpolation_model(tm, *grids, device="cpu"))


def test_lut_cube_matches_jax(luts):
    jl, tl = luts
    assert tl.method == jl.method == "cubic"
    np.testing.assert_allclose(tl.sigma, jl.sigma, rtol=1e-10,
                               atol=1e-10 * jl.sigma.max())
    assert (tl.mol, tl.iso) == (jl.mol, jl.iso)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_lut_round_trip_between_packages(luts, tmp_path, method, direction):
    """A LUT saved by one package loads in the other and interpolates the
    same values."""
    jl, _ = luts
    src_lut, dst_lut = ((tlut, jlut) if direction == "port_to_jax"
                        else (jlut, tlut))
    model = src_lut.InterpolationModel(sigma=jl.sigma, nu_grid=jl.nu_grid,
                                       p_grid=jl.p_grid, t_grid=jl.t_grid,
                                       mol=jl.mol, iso=jl.iso, method=method)
    path = str(tmp_path / "lut.npz")
    src_lut.save_interpolation_model(model, path)
    loaded = dst_lut.load_interpolation_model(path)
    assert loaded.method == method and loaded.mol == jl.mol
    grid = np.linspace(6316.5, 6318.5, 37)
    for p, T in ((650.0, 255.0), (900.0, 290.0)):
        np.testing.assert_allclose(loaded(grid, p, T), model(grid, p, T),
                                   rtol=1e-12, atol=0.0)


def test_absorption_profile_from_lut_matches_jax(luts, tmp_path):
    jl, _ = luts
    path = str(tmp_path / "lut.npz")
    jlut.save_interpolation_model(jl, path)
    params = port.default_parameters()
    T, p, q = params.T, params.p, params.q
    grid = np.linspace(6316.5, 6318.5, 51)
    ref = jax_absorption_profile(
        np.zeros((len(grid), len(T))), "CO2", None, grid, 4e-4,
        jax_profile_fields(T, p, q, {}), lut_path=path)
    got = compute_absorption_profile(
        np.zeros((len(grid), len(T))), "CO2", None, grid, 4e-4,
        compute_atmos_profile_fields(T, p, q, {}), lut_path=path,
        device="cpu")
    assert got.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


def _sigma_fn(nu, T, p_hpa):
    return (1e-25 * (1 + 0.01 * (nu - 13000.0))
            * (T / 250.0) * (p_hpa / 500.0))


def _absco_table(mod):
    """The synthetic ABSCO table of tests/test_absco.py."""
    nu = np.linspace(12990.0, 13010.0, 201)
    p_hpa = np.array([100.0, 400.0, 700.0, 1000.0])
    T = np.stack([np.linspace(180.0 + 5 * i, 300.0 + 5 * i, 5)
                  for i in range(len(p_hpa))], axis=1)   # (n_T, n_p)
    sigma = np.zeros((len(nu), 1, T.shape[0], len(p_hpa)), np.float32)
    for ip in range(len(p_hpa)):
        for it in range(T.shape[0]):
            sigma[:, 0, it, ip] = _sigma_fn(nu, T[it, ip], p_hpa[ip])
    return mod.AbscoTable(mol=2, iso=-1, nu=nu, sigma=sigma, p=p_hpa, T=T)


def _write_nc3(path, tab):
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as f:
        n_nu, _, n_t, n_p = tab.sigma.shape
        for name, size in (("nu", n_nu), ("b", 1), ("t", n_t), ("p", n_p),
                           ("one", 1)):
            f.createDimension(name, size)
        f.createVariable("Gas_Index", "i4", ("one",))[:] = [2]
        f.createVariable("Gas_2_Absorption", "f4",
                         ("nu", "b", "t", "p"))[:] = tab.sigma
        f.createVariable("Temperature", "f8", ("t", "p"))[:] = tab.T
        f.createVariable("Pressure", "f8", ("p",))[:] = tab.p * 100.0
        f.createVariable("Wavenumber", "f8", ("nu",))[:] = tab.nu


def _write_h5(path, tab):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        f["Gas_Index"] = np.array([b"02"])
        f["Gas_02_Absorption"] = tab.sigma
        f["Temperature"] = tab.T
        f["Pressure"] = tab.p * 100.0        # stored in Pa
        f["Wavenumber"] = tab.nu


@pytest.mark.parametrize("fmt", ["h5", "nc3"])
def test_load_absco_matches_jax(tmp_path, fmt):
    tab = _absco_table(tabsco)
    path = str(tmp_path / f"absco.{fmt}")
    (_write_h5 if fmt == "h5" else _write_nc3)(path, tab)
    got, ref = tabsco.load_absco(path, scale=2.0), jabsco.load_absco(
        path, scale=2.0)
    assert got.mol == ref.mol == 2 and got.iso == ref.iso == -1
    for f in ("nu", "sigma", "p", "T"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    np.testing.assert_allclose(got.sigma, 2.0 * tab.sigma, rtol=1e-6)


def test_load_absco_netcdf3_without_h5py(tmp_path, monkeypatch):
    """A netCDF3 table loads where h5py is absent (scipy only)."""
    tab = _absco_table(tabsco)
    path = str(tmp_path / "absco.nc")
    _write_nc3(path, tab)
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = tabsco.load_absco(path)
    assert got.mol == 2
    np.testing.assert_array_equal(got.sigma, tab.sigma)


@pytest.mark.parametrize("wavelength_flag", [False, True])
def test_absco_interpolation_model_matches_jax(wavelength_flag):
    nu_grid = np.linspace(12995.0, 13005.0, 51)
    if wavelength_flag:
        nu_grid = 1e7 / nu_grid
    grids = (nu_grid, np.array([200.0, 500.0, 900.0]),
             np.array([220.0, 260.0, 290.0]))
    got = tabsco.absco_to_interpolation_model(
        _absco_table(tabsco), *grids, wavelength_flag=wavelength_flag)
    ref = jabsco.absco_to_interpolation_model(
        _absco_table(jabsco), *grids, wavelength_flag=wavelength_flag)
    np.testing.assert_allclose(got.sigma, ref.sigma, rtol=1e-12, atol=0.0)
    np.testing.assert_array_equal(got.nu_grid, ref.nu_grid)
    for pv, tv in ((250.0, 230.0), (800.0, 280.0)):
        expect = _sigma_fn(got.nu_grid, tv, pv)
        np.testing.assert_allclose(got(got.nu_grid, pv, tv), expect,
                                   rtol=5e-3)
