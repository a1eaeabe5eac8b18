"""Cross-section AD of the port (spectroscopy/voigt.py:
absorption_cross_section(..., autodiff=True)) and the wavelength grid of
compute_absorption_cross_section, against the JAX package.

A small O2 A-band window (data/hitran/O2.par, lines 13 100-13 200 cm^-1,
grid 13 142-13 150 cm^-1 at 0.02) at p = 800 hPa, T = 250 K, float64 on
the CPU: value and d sigma / d(p, T) within 1e-10 of max against JAX's
jax.jacfwd, on the wavenumber and on the wavelength grid.
"""
import numpy as np
import pytest
import torch

from vsmartmom.spectroscopy import voigt as jvoigt
from vsmartmom.spectroscopy.hitran import read_hitran as jax_read_hitran
from vsmartmom.spectroscopy.profiles import hitran_artifact as jax_artifact

from vsmartmom_torch.spectroscopy import voigt as tvoigt
from vsmartmom_torch.spectroscopy.hitran import read_hitran
from vsmartmom_torch.spectroscopy.profiles import hitran_artifact

torch.set_num_threads(2)

GRID = np.arange(13142.0, 13150.0, 0.02)
P, T = 800.0, 250.0
BOUND = 1e-10


@pytest.fixture(scope="module")
def models():
    kw = dict(mol=7, nu_min=13100.0, nu_max=13200.0)
    return (tvoigt.make_hitran_model(read_hitran(hitran_artifact("O2"),
                                                 **kw)),
            jvoigt.make_hitran_model(jax_read_hitran(jax_artifact("O2"),
                                                     engine="python", **kw)))


def _grid(wavelength_flag):
    return 1e7 / GRID[::-1] if wavelength_flag else GRID


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("wavelength_flag", [False, True])
def test_autodiff_matches_jax(models, wavelength_flag):
    tm, jm = models
    grid = _grid(wavelength_flag)
    value, jac = tvoigt.absorption_cross_section(
        tm, grid, P, T, wavelength_flag, autodiff=True, device="cpu")
    jvalue, jjac = jvoigt.absorption_cross_section(
        jm, grid, P, T, wavelength_flag, autodiff=True)
    assert value.shape == (len(grid),) and jac.shape == (len(grid), 2)
    assert value.dtype == jac.dtype == torch.float64
    assert _rel(value.numpy(), jvalue) < BOUND
    for k in range(2):
        assert np.abs(jjac[:, k]).max() > 0
        assert _rel(jac[:, k].numpy(), jjac[:, k]) < BOUND, k
    # without autodiff: the value alone, the same numbers
    plain = tvoigt.absorption_cross_section(tm, grid, P, T, wavelength_flag,
                                            device="cpu")
    assert torch.equal(plain, value)


def test_wavelength_grid_is_the_reversed_wavenumber_grid(models):
    """compute_absorption_cross_section(wavelength_flag=True) on the
    wavelengths of GRID is the wavenumber result reversed (dense engine
    against JAX, the kernel engine's plain version against itself)."""
    tm, jm = models
    wl = _grid(True)
    dense = tvoigt.compute_absorption_cross_section(tm, wl, P, T, True,
                                                    device="cpu")
    ref = np.asarray(jvoigt.compute_absorption_cross_section(jm, wl, P, T,
                                                             True))
    assert _rel(dense.numpy(), ref) < BOUND
    wn = tvoigt.compute_absorption_cross_section(tm, GRID, P, T,
                                                 device="cpu")
    assert _rel(dense.numpy(), wn.numpy()[::-1]) < BOUND
    k_wl, k_wn = (tvoigt.compute_absorption_cross_section(
        tm, g, P, T, flag, device="cpu", engine="kernel")
        for g, flag in ((wl, True), (GRID, False)))
    assert torch.equal(k_wl, k_wn.flip(0))


def test_jacobian_matches_central_differences(models):
    """Steps of 0.1 hPa and 0.01 K: smaller ones meet the rounding of the
    line sum, larger ones its curvature."""
    tm, _ = models
    _, jac = tvoigt.absorption_cross_section(tm, GRID, P, T, autodiff=True,
                                             device="cpu")
    for k, h in ((0, 0.1), (1, 0.01)):
        x = np.array([P, T])
        dx = np.zeros(2)
        dx[k] = h
        fd = (tvoigt.absorption_cross_section(tm, GRID, *(x + dx),
                                              device="cpu")
              - tvoigt.absorption_cross_section(tm, GRID, *(x - dx),
                                                device="cpu")) / (2 * h)
        assert _rel(jac[:, k].numpy(), fd.numpy()) < 1e-6, k


def test_tips_range_check_reads_the_primal(models):
    """The TIPS temperature check (O2: 1-7 500 K) holds under the
    transform too."""
    tm, _ = models
    with pytest.raises(ValueError, match="TIPS2017"):
        tvoigt.absorption_cross_section(tm, GRID, P, 8000.0, autodiff=True,
                                        device="cpu")
