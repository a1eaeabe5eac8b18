"""The port's inelastic multi-sensor run and its rt_run Raman dispatch
against the JAX package, and the reference's multi-sensor gates on the port
alone.

1. ie_interlayer_flux and rt_run_band_rrs_ms match JAX within 1e-9 of max
   per field (float64), both solvers.
2. TOA/BOA consistency: sensor level 0 reproduces rt_run_band_rrs's TOA
   (R, ieR); an interior sensor equals the dense (2N x 2N) block solution
   composed layer by layer.
3. rt_run(model, rs_type=...) on rayleigh_benchmark.yaml, cut as in
   tests/test_api.py, keeps that test's physics; its refusals. Its match
   with JAX within 1e-9 is in tests/test_torch_raman_rt_rrs.py (RRS) and
   tests/test_torch_raman_rt_spec.py (a spec used as it is), one file each
   so that the two JAX runs go to different workers.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vsmartmom.core.rt as jrt
import vsmartmom.core.rt_raman as jrr
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.config.params import parameters_from_yaml
from vsmartmom_torch.core.api import rt_run
from vsmartmom_torch.core.model import model_from_parameters
from vsmartmom_torch.core.rt import LayerRT, make_rsolve
from vsmartmom_torch.core.rt_raman import (IELayer, ie_interlayer_flux,
                                           raman_interaction,
                                           raman_make_added_layer,
                                           rt_run_band_rrs,
                                           rt_run_band_rrs_ms, zero_ie)
from vsmartmom_torch.core.rt_run import BandRTInputs
from vsmartmom_torch.core.surface import lambertian_surface_layer
from vsmartmom_torch.scattering.phase import (Polarization,
                                              compute_Z_moments,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = 1e-9
F64 = torch.float64
LAMB = {"type": "LambertianSurfaceScalar", "albedo": 0.15}


def T(x, dtype=F64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, tol=TOL, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-300)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, (what, i, err)


def _band(lib, n_spec=6, n_z=3, seed=0):
    rng = np.random.default_rng(seed)
    tau_r = rng.uniform(0.05, 0.2, (n_z, n_spec))
    tau = tau_r + rng.uniform(0.0, 0.15, (n_z, n_spec))
    band = (JaxBand if lib == "jax" else BandRTInputs)(
        tau=tau, omega=tau_r / tau, zw=np.ones((n_z, 1, n_spec)),
        greeks=[(jax_greek if lib == "jax" else get_greek_rayleigh)(0.03)])
    return band, tau_r / tau


class _Spec:
    """Minimal banded RRS coupling spec (tests/test_raman_ms.py's)."""
    def __init__(self, shifts, ws, greek):
        self.i_shift = shifts
        self.w_shift = ws
        self.greek_raman = greek
        self.band_range = None


def _spec(lib):
    return _Spec([2, -1], [0.02, 0.03],
                 (jax_greek if lib == "jax" else get_greek_rayleigh)(0.4))


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_rt_run_band_rrs_ms_matches(solver):
    streams = ("GaussQuadFullSphere", 6, 35.0, [15.0], 3)
    levels = [0, 1, 3]
    band, f_rayl = _band("torch")
    got = rt_run_band_rrs_ms(Polarization.from_name("Stokes_IQU"),
                             rt_set_streams(*streams), band, _spec("torch"),
                             f_rayl, [15.0], [20.0], 2, LAMB,
                             sensor_levels=levels, device="cpu",
                             solver=solver)
    jband, _ = _band("jax")
    want = jrr.rt_run_band_rrs_ms(JaxPol.from_name("Stokes_IQU"),
                                  jax_streams(*streams), jband,
                                  _spec("jax"), f_rayl, [15.0], [20.0], 2,
                                  LAMB, sensor_levels=levels, solver=solver)
    _close(got, want, what=solver)
    assert got[0].shape == (3, 1, 3, 6)


def _layers(n_spec=7, seed=3):
    """Two Stokes-I layers with one shift row, the surface, and their
    numpy inputs (tests/test_raman_ms.py's interior-sensor setup)."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 40.0, [0.0], pol.n)
    n = len(quad.qp_mu_n)
    band, f_rayl = _band("torch", n_spec=n_spec, n_z=2, seed=seed)
    rsolve = make_rsolve("lu")
    eye = T(np.broadcast_to(np.eye(n), (n_spec, n, n)))
    z_pp, z_mp = compute_Z_moments(pol, quad.qp_mu, band.greeks[0], 0)
    z_pp_r, z_mp_r = compute_Z_moments(pol, quad.qp_mu,
                                       get_greek_rayleigh(0.4), 0)
    i0 = np.zeros(n)
    i0[quad.i_mu0_n] = 1.0
    tau_sum = np.vstack([np.zeros((1, n_spec)),
                         np.cumsum(band.tau, axis=0)])
    layers = [raman_make_added_layer(
        T(band.tau[iz]), T(band.omega[iz]), T(z_pp)[None], T(z_mp)[None],
        T(z_pp_r)[None], T(z_mp_r)[None], T(tau_sum[iz]), T(f_rayl[iz]),
        [2], T([0.04]), [0], T(quad.qp_mu_n), T(quad.wt_mu_n / 2.0),
        T(0.5), T(i0), quad.i_mu0_n, 1, T(quad.qp_mu_n[quad.i_mu0_n]),
        T(quad.mu0), T(np.ones(n)), float(np.min(quad.qp_mu)), eye, rsolve)
        for iz in range(2)]
    surf = lambertian_surface_layer(
        T(0.2), n_spec, 1, T(quad.qp_mu_n), T(quad.wt_mu_n), T(i0),
        T(tau_sum[-1]), T(quad.mu0), True)
    surf_ie = zero_ie(1, n_spec, n, F64, "cpu")
    return n, eye, rsolve, layers, surf, surf_ie


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_ie_interlayer_flux_matches(solver):
    n, eye, _, layers, surf, surf_ie = _layers()
    rsolve = make_rsolve(solver)
    top, top_ie = layers[0]
    bot, bot_ie = raman_interaction(*layers[1], surf, surf_ie, [2], eye,
                                    rsolve)
    got = ie_interlayer_flux(top, top_ie, bot, bot_ie, [2], eye, rsolve)

    def j(x, cls):
        return cls(*(jnp.asarray(np.asarray(f)) for f in x))

    want = jrr.ie_interlayer_flux(
        j(top, jrt.LayerRT), j(top_ie, jrr.IELayer), j(bot, jrt.LayerRT),
        j(bot_ie, jrr.IELayer), jnp.asarray([2]), jnp.asarray(eye.numpy()),
        jrt.make_rsolve(solver))
    _close(got, want, what=solver)


def test_toa_boa_sensors_match_single_sensor_run():
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 35.0, [15.0], pol.n)
    band, f_rayl = _band("torch")
    spec = _spec("torch")
    R, _, ieR, _ = rt_run_band_rrs(pol, quad, band, spec, f_rayl, [15.0],
                                   [20.0], 2, LAMB, device="cpu")
    uw, dw, ie_uw, ie_dw = rt_run_band_rrs_ms(
        pol, quad, band, spec, f_rayl, [15.0], [20.0], 2, LAMB,
        sensor_levels=[0, band.tau.shape[0]], device="cpu")
    np.testing.assert_allclose(uw[0], R, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(ie_uw[0], ieR, rtol=1e-12, atol=1e-300)
    assert np.all(dw[1][:, 0] > 0)
    assert np.abs(ie_dw[1]).max() > 0
    with pytest.raises(ValueError, match="sensor levels"):
        rt_run_band_rrs_ms(pol, quad, band, spec, f_rayl, [15.0], [20.0],
                           1, LAMB, sensor_levels=[4], device="cpu")


def test_interior_sensor_vs_brute_force_blocks():
    """ie interlayer flux == dense 2Nx2N block solve, layer-composed."""
    n, eye, rsolve, layers, surf, surf_ie = _layers()
    n_spec, shift = 7, 2
    top, top_ie = layers[0]
    bot, bot_ie = raman_interaction(*layers[1], surf, surf_ie, [shift], eye,
                                    rsolve)
    uw, dw, ie_uw, ie_dw = (x.numpy() for x in ie_interlayer_flux(
        top, top_ie, bot, bot_ie, [shift], eye, rsolve))

    def as_np(lay, lay_ie):
        return ([f.numpy() for f in lay], [f.numpy()[0] for f in lay_ie])

    def blocks(lay, lay_ie, n1, n0):
        e, ie = as_np(lay, lay_ie)
        Z = np.zeros((n, n))
        mats = [np.block([[e[k][n1], ie[k][n1]], [Z, e[k][n0]]])
                for k in range(4)]
        vecs = [np.concatenate([ie[k][n1], e[k][n0]]) for k in (4, 5)]
        return mats + vecs

    def compose(topb, botb):
        r1, p1, tp1, tm1, jp1, jm1 = topb
        r2, p2, tp2, tm2, jp2, jm2 = botb
        I2 = np.eye(2 * n)
        t01 = tm1 @ np.linalg.inv(I2 - r2 @ p1)
        t21 = tp2 @ np.linalg.inv(I2 - p1 @ r2)
        return (r1 + t01 @ r2 @ tp1, p2 + t21 @ p1 @ tm2, t21 @ tp1,
                t01 @ tm2, jp2 + t21 @ (jp1 + p1 @ jm2),
                jm1 + t01 @ (r2 @ jp1 + jm2))

    for n1 in range(n_spec - shift):
        n0 = n1 + shift
        botb = compose(blocks(*layers[1], n1, n0),
                       blocks(surf, surf_ie, n1, n0))
        topb = blocks(*layers[0], n1, n0)
        I2 = np.eye(2 * n)
        dw_b = np.linalg.solve(I2 - topb[1] @ botb[0],
                               topb[4] + topb[1] @ botb[5])
        uw_b = np.linalg.solve(I2 - botb[0] @ topb[1],
                               botb[5] + botb[0] @ topb[4])
        for got, want in ((ie_dw[0, n1], dw_b[:n]), (ie_uw[0, n1], uw_b[:n]),
                          (dw[n0], dw_b[n:]), (uw[n0], uw_b[n:])):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


# --- rt_run(model, rs_type=...) ----------------------------------------------

def _cut(params):
    """rayleigh_benchmark.yaml cut as tests/test_api.py cuts it: a grid
    spanning the rotational shift range at 8 cm^-1, 2 moments."""
    params.spec_bands = [np.arange(12740.0, 13268.0, 8.0)]
    params.max_m = 2
    params.l_trunc = 10
    params.sza = 45.0
    params.vza = np.array([10.0])
    params.vaz = np.array([0.0])
    params.surfaces = [{"type": "LambertianSurfaceScalar", "albedo": 0.0}]
    return params


@pytest.fixture(scope="module")
def model():
    path = f"{DATA}/rayleigh_benchmark.yaml"
    return model_from_parameters(_cut(parameters_from_yaml(path)),
                                 device="cpu")


def test_rt_run_raman_dispatch_physics(model):
    """tests/test_api.py's gate on the port: elastic + ie radiances, the
    filling-in positive over a Rayleigh atmosphere, Cabannes + ie restoring
    the full-Rayleigh elastic radiance."""
    R, T_, ieR, ieT = rt_run(model, rs_type="RRS", device="cpu")
    R0, _ = rt_run(model, device="cpu")
    c = R.shape[-1] // 2
    assert ieR[0, 0, c] > 0
    assert R[0, 0, c] < R0[0, 0, c]
    assert R[0, 0, c] + ieR[0, 0, c] == pytest.approx(R0[0, 0, c], rel=5e-3)
    # vibrational Raman on one band needs a grid spanning the shifted
    # range: this band is narrower than every shift
    with pytest.raises(ValueError, match="no Raman shift row"):
        rt_run(model, rs_type="VS_0to1", device="cpu")
