"""Port's Voigt kernel (kernel 2, plain version on the CPU) and dense
cross-section engine against the JAX package.

Tolerances: Re w in float64 to rounding (1e-12); the tiled f32 sum to
2e-5 x max sigma, the bound of tests/test_pallas_voigt.py (the port sums
each tile's lines in another order); the dense f64 engine to rtol 1e-10.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.pallas.voigt_kernel import VoigtPlan as JaxVoigtPlan
from vsmartmom.pallas.voigt_kernel import rew_hw32sd as jax_rew
from vsmartmom.spectroscopy import voigt as jvoigt
from vsmartmom.spectroscopy.hitran import read_hitran as jax_read_hitran

from vsmartmom_torch.cuda.voigt_kernel import VoigtPlan, rew_hw32sd
from vsmartmom_torch.spectroscopy import voigt as tvoigt
from vsmartmom_torch.spectroscopy.cef import w_humlicek_weideman32_sd
from vsmartmom_torch.spectroscopy.hitran import read_hitran

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _rand_problem(n_l=400, n_g=2100, seed=3):
    """The random line problem of tests/test_pallas_voigt.py."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(13000.0, 13080.0, n_g)
    nu = rng.uniform(12995.0, 13085.0, n_l)
    S = 10 ** rng.uniform(-3, 0, n_l)
    gd = rng.uniform(0.01, 0.03, n_l)
    yv = rng.uniform(0.05, 4.0, n_l)
    return grid, nu, S, gd, yv


def test_rew_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-30, 30, 1000)
    y = 10 ** rng.uniform(-4, 1.2, 1000)
    ref = np.asarray(jax_rew(jnp.asarray(x), jnp.asarray(y)))
    got = rew_hw32sd(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_complex_cef_matches_real_form():
    rng = np.random.default_rng(1)
    x = rng.uniform(-30, 30, 500)
    y = 10 ** rng.uniform(-4, 1.2, 500)
    w = w_humlicek_weideman32_sd(torch.complex(torch.as_tensor(x),
                                               torch.as_tensor(y)))
    real = rew_hw32sd(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(w.real.numpy(), real.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("seed,cut", [(3, 10.0), (5, 8.0), (9, 40.0)])
def test_plan_matches_jax_interpret(seed, cut):
    grid, nu, S, gd, yv = _rand_problem(seed=seed)
    ref = np.asarray(JaxVoigtPlan(grid, nu, cut, interpret=True)
                     .run(nu, S, gd, yv))
    plan = VoigtPlan(grid, nu, cut, device="cpu")
    got = plan.run(nu, S, gd, yv)
    assert got.dtype == torch.float32 and got.shape == (len(grid),)
    assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("p,T,broadening", [
    (1000.0, 296.0, "Voigt"), (300.0, 220.0, "Voigt"),
    (1000.0, 296.0, "Lorentz"), (500.0, 250.0, "Doppler")])
def test_dense_engine_matches_jax(p, T, broadening):
    path = os.path.join(DATA, "testCO2.par")
    grid = np.arange(6214.0, 6214.8, 0.002)
    ref = np.asarray(jvoigt.compute_absorption_cross_section(
        jvoigt.make_hitran_model(jax_read_hitran(path, engine="python"),
                                 broadening, wing_cutoff=40.0), grid, p, T))
    got = tvoigt.compute_absorption_cross_section(
        tvoigt.make_hitran_model(read_hitran(path), broadening,
                                 wing_cutoff=40.0), grid, p, T, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * ref.max())


def test_kernel_engine_matches_dense():
    """engine='kernel' (tiled f32 sum, plain version on the CPU) against
    the dense f64 engine, at the bound of tests/test_pallas_voigt.py:80."""
    ht = read_hitran(os.path.join(DATA, "testCO2.par"))
    model = tvoigt.make_hitran_model(ht, wing_cutoff=40.0)
    grid = np.arange(6214.0, 6214.8, 0.002)
    ref = tvoigt.compute_absorption_cross_section(model, grid, 1000.0,
                                                  296.0, device="cpu").numpy()
    got = tvoigt.compute_absorption_cross_section(
        model, grid, 1000.0, 296.0, engine="kernel", device="cpu").numpy()
    assert np.abs(got - ref).max() < 1e-3 * ref.max() + 1e-30


def test_line_parameters_match_jax():
    path = os.path.join(DATA, "testCO2.par")
    jm = jvoigt.make_hitran_model(jax_read_hitran(path, engine="python"))
    tm = tvoigt.make_hitran_model(read_hitran(path))
    for a, b in zip(jvoigt.line_parameters(jm, 800.0, 250.0),
                    tvoigt.line_parameters(tm, 800.0, 250.0)):
        np.testing.assert_allclose(b, a, rtol=1e-14)
