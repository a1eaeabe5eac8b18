"""The port's multi-sensor run against the JAX package (CPU, float64), and
the gates of tests/test_multisensor.py on the port alone.

1. rt_run_band_ms matches JAX within 1e-10 of max per output at that
   file's setups (Stokes IQU with TOA/BOA sensors, Stokes I with an
   interior one, unsorted and duplicate levels), both solvers, and with
   the RPV surface; rt_run_ms(model) on rayleigh_benchmark.yaml, cut,
   with sensors at every interface.
2. The four gates of tests/test_multisensor.py on the port: TOA/BOA
   anchors at rtol 1e-10, interior physics, level order, the BRDF surface.
"""
import os

import numpy as np
import pytest
import torch

from vsmartmom.config.params import parameters_from_yaml as jax_params
from vsmartmom.core.model import model_from_parameters as jax_model
from vsmartmom.core.multisensor import rt_run_band_ms as jax_rt_run_band_ms
from vsmartmom.core.multisensor import rt_run_ms as jax_rt_run_ms
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.config.params import parameters_from_yaml
from vsmartmom_torch.core.model import model_from_parameters
from vsmartmom_torch.core.multisensor import rt_run_band_ms, rt_run_ms
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = 1e-10
VZA = [0.0, 30.0, 60.0]
VAZ = [0.0, 90.0, 180.0]
SURF = {"type": "LambertianSurfaceScalar", "albedo": 0.15}
RPV = {"type": "rpvSurfaceScalar", "rho0": 0.2, "rho_c": 0.6, "k": 0.8,
       "theta": -0.1}


def _close(got, want, tol=TOL, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-300)
        assert err <= tol, (what, i, err)


def _setup(lib="torch", pol_name="Stokes_IQU", n_z=4, n_spec=3):
    """tests/test_multisensor.py's setup for either package."""
    port = lib == "torch"
    pol = (Polarization if port else JaxPol).from_name(pol_name)
    quad = (rt_set_streams if port else jax_streams)(
        "GaussQuadFullSphere", 12, 45.0, VZA, pol.n)
    rng = np.random.default_rng(3)
    tau_scat = np.full((n_z, n_spec), 0.08)
    tau_abs = rng.uniform(0.0, 0.3, (n_z, n_spec))
    tau = tau_scat + tau_abs
    band = (BandRTInputs if port else JaxBand)(
        tau=tau, omega=tau_scat / tau, zw=np.ones((n_z, 1, n_spec)),
        greeks=[(get_greek_rayleigh if port else jax_greek)(0.0)])
    return pol, quad, band


CASES = {
    "iqu_toa_boa": (dict(pol_name="Stokes_IQU"), 3, SURF, [0, 4]),
    "i_interior": (dict(pol_name="Stokes_I"), 3, SURF, [0, 2, 4]),
    "i_unsorted": (dict(pol_name="Stokes_I", n_z=3), 2, SURF, [3, 0, 1, 3]),
}


@pytest.mark.parametrize("solver", ["lu", "schulz"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rt_run_band_ms_matches_jax(case, solver):
    kw, max_m, surf, levels = CASES[case]
    pol, quad, band = _setup("torch", **kw)
    got = rt_run_band_ms(pol, quad, band, VZA, VAZ, max_m, surf, levels,
                         device="cpu", solver=solver)
    pol, quad, band = _setup("jax", **kw)
    want = jax_rt_run_band_ms(pol, quad, band, VZA, VAZ, max_m, surf,
                              levels, solver=solver)
    _close(got, want, what=(case, solver))
    assert got[0].shape == (len(levels), len(VZA), pol.n, 3)


def test_rt_run_band_ms_rpv_matches_jax():
    pol, quad, band = _setup("torch", pol_name="Stokes_I", n_z=3)
    got = rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, RPV, [0, 1, 3],
                         device="cpu")
    pol, quad, band = _setup("jax", pol_name="Stokes_I", n_z=3)
    want = jax_rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, RPV, [0, 1, 3])
    _close(got, want, what="rpv")


def _cut(params):
    """rayleigh_benchmark.yaml with two layers, Stokes IQU, 2 moments."""
    params.polarization_type = "Stokes_IQU"
    params.max_m = 2
    params.l_trunc = 10
    params.T = np.array([231.62, 250.0])
    params.p = np.array([0.14, 0.18, 0.22])
    params.surfaces = [{"type": "LambertianSurfaceScalar", "albedo": 0.1}]
    return params


def test_rt_run_ms_matches_jax():
    path = f"{DATA}/rayleigh_benchmark.yaml"
    model = model_from_parameters(_cut(parameters_from_yaml(path)),
                                  device="cpu")
    jmodel = jax_model(_cut(jax_params(path)))
    got = rt_run_ms(model, [0, 1, 2], device="cpu")
    want = jax_rt_run_ms(jmodel, [0, 1, 2])
    _close(got, want, what="rt_run_ms")
    assert got[0].shape == (3, len(model.params.vza), 3, 2)


# --- the gates of tests/test_multisensor.py on the port ----------------------

def test_toa_boa_match_single_sensor_run():
    pol, quad, band = _setup()
    n_z = band.tau.shape[0]
    R, T = rt_run_band(pol, quad, band, VZA, VAZ, 3, SURF, device="cpu")
    uw, dw = rt_run_band_ms(pol, quad, band, VZA, VAZ, 3, SURF, [0, n_z],
                            device="cpu")
    np.testing.assert_allclose(uw[0], R, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(dw[1], T, rtol=1e-10, atol=1e-14)


def test_interior_sensor_physical():
    pol, quad, band = _setup(pol_name="Stokes_I")
    n_z = band.tau.shape[0]
    uw, dw = rt_run_band_ms(pol, quad, band, VZA, VAZ, 3, SURF,
                            [0, 2, n_z], device="cpu")
    assert np.all(np.isfinite(uw)) and np.all(np.isfinite(dw))
    # downwelling diffuse grows toward the surface in a scattering atmosphere
    assert np.all(dw[1, :, 0, :] >= dw[0, :, 0, :] - 1e-12)
    # upwelling I stays positive everywhere
    assert np.all(uw[:, :, 0, :] > 0)


def test_unsorted_and_duplicate_levels():
    pol, quad, band = _setup(pol_name="Stokes_I", n_z=3)
    uw1, _ = rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, SURF, [3, 0, 1],
                            device="cpu")
    uw2, _ = rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, SURF, [0, 1, 3],
                            device="cpu")
    np.testing.assert_allclose(uw1[1], uw2[0], rtol=1e-12)
    np.testing.assert_allclose(uw1[2], uw2[1], rtol=1e-12)
    np.testing.assert_allclose(uw1[0], uw2[2], rtol=1e-12)
    with pytest.raises(ValueError, match="sensor levels"):
        rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, SURF, [4],
                       device="cpu")


def test_ms_brdf_surface():
    pol, quad, band = _setup(pol_name="Stokes_I", n_z=3)
    uw, dw = rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, RPV, [0, 3],
                            device="cpu")
    assert np.all(np.isfinite(uw)) and np.all(np.isfinite(dw))
    assert np.all(uw[:, :, 0, :] > 0)
    with pytest.raises(NotImplementedError):
        rt_run_band_ms(pol, quad, band, VZA, VAZ, 2, {"type": "Other"},
                       [0], device="cpu")
