"""Multi-band elastic runs of the port against the JAX package (CPU, f64).

- Band bookkeeping (band_spec_lim, concat_band_inputs, _concat_surface) is
  compared exactly on the same model.
- Multi-band rt_run against JAX's at rtol 1e-8 for per-band Lambertian
  albedos and identical RPV surfaces (one run over the concatenated axis)
  and for mixed surfaces (one run per band); with equal doubling counts in
  every band the concatenated run equals the per-band runs at rtol 5e-12.
- The reference's 3-band configuration (tests/data/ref_yaml/
  3BandParameters.yaml, each band cut to its first 40 points at its own
  step, every layer kept, NAI2 with 100 radius nodes in both packages in
  place of the file's 1 000, whose builds took minutes on a loaded CPU):
  tau_abs,
  tau_rayl, tau_aer and the aerosol Greek coefficients at rtol 1e-10, R and
  T at rtol 1e-8. S2BandParameters.yaml the same way (tau_abs at rtol
  1e-10, R/T at 1e-8) without its profile reduction, which neither package
  can build.
"""
import copy
import logging
import os

import numpy as np
import pytest
import torch

import vsmartmom as jax_pkg
from vsmartmom.core import api as japi

import vsmartmom_torch as port
from vsmartmom_torch.core import api as tapi
from vsmartmom_torch.core.model import model_from_arrays

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
REF_YAML = os.path.join(DATA, "ref_yaml")
N_CUT = 40
#: NAI2 radius nodes of both packages' builds (the files say 1 000)
NQUAD_RADIUS = 100

RPV = {"type": "rpvSurfaceScalar", "rho0": 0.2, "rho_c": 1.0, "k": 0.8,
       "theta": -0.1}
LAMB = [{"type": "LambertianSurfaceScalar", "albedo": 0.1},
        {"type": "LambertianSurfaceScalar", "albedo": 0.3}]
SURFACES = {"lambertian": LAMB, "rpv": [RPV, dict(RPV)],
            "mixed": [RPV, LAMB[1]]}


def _cut(params):
    params.spec_bands = [b[:N_CUT] for b in params.spec_bands]
    params.scattering_params.nquad_radius = NQUAD_RADIUS
    return params


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _build_both(name):
    """JAX and port models of a reference YAML cut to N_CUT points a band,
    with the port's warnings recorded."""
    path = os.path.join(REF_YAML, name)
    jm = jax_pkg.model_from_parameters(
        _cut(jax_pkg.parameters_from_yaml(path)))
    rec = _Records()
    logger = logging.getLogger("vsmartmom_torch")
    logger.addHandler(rec)
    try:
        tm = port.model_from_parameters(
            _cut(port.parameters_from_yaml(path)), device="cpu")
    finally:
        logger.removeHandler(rec)
    return jm, tm, rec.records


@pytest.fixture(scope="module")
def three_band():
    jm, tm, warned = _build_both("3BandParameters.yaml")
    bands = [0, 1, 2]
    jR, jT = jax_pkg.rt_run(jm, i_band=bands)
    tR, tT = port.rt_run(tm, i_band=bands, device="cpu")
    return jm, tm, warned, (jR, jT), (tR, tT)


@pytest.mark.parametrize("name", ["tau_abs", "tau_rayl", "tau_aer"])
def test_three_band_optical_depths(three_band, name):
    jm, tm = three_band[:2]
    assert len(getattr(tm, name)) == 3
    for ib in range(3):
        np.testing.assert_allclose(getattr(tm, name)[ib],
                                   getattr(jm, name)[ib], rtol=1e-10,
                                   atol=0.0, err_msg=f"{name}[{ib}]")
    if name == "tau_abs":
        # O2 in band 1, H2O and CO2 in band 2; band 3 has no lines in
        # data/hitran
        assert tm.tau_abs[0].max() > 0 and tm.tau_abs[1].max() > 0
        assert tm.tau_abs[2].max() == 0


def test_three_band_aerosol_optics(three_band):
    jm, tm = three_band[:2]
    for ib in range(3):
        jo, to = jm.aerosol_optics[ib][0], tm.aerosol_optics[ib][0]
        for f in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta"):
            a, b = getattr(jo.greek_coefs, f), getattr(to.greek_coefs, f)
            np.testing.assert_allclose(b, a, rtol=1e-10,
                                       atol=1e-10 * np.abs(a).max(),
                                       err_msg=f"band {ib} {f}")
        for f in ("ssa", "k", "f_t"):
            np.testing.assert_allclose(getattr(to, f), getattr(jo, f),
                                       rtol=1e-10)


def test_three_band_radiances(three_band):
    _, tm, _, (jR, jT), (tR, tT) = three_band
    assert len(tm.quad_points.qp_mu_n) == 30
    assert tR.shape == jR.shape == (1, 3, 3 * N_CUT)
    assert np.isfinite(tR).all() and np.isfinite(tT).all()
    np.testing.assert_allclose(tR, jR, rtol=1e-8, atol=0.0)
    np.testing.assert_allclose(tT, jT, rtol=1e-8, atol=0.0)


def test_three_band_lutfiles_parsed_and_ignored(three_band):
    """LUTfiles build as in the JAX package: parsed, not used, and named in
    one warning."""
    _, tm, warned = three_band[:3]
    luts = tm.params.absorption_params.luts
    assert len(luts) == 3 and luts[0][0].endswith("o2_v52.jld2")
    assert len(warned) == 1
    assert all(f in warned[0].getMessage() for band in luts for f in band)


def test_three_band_bookkeeping_matches_jax(three_band):
    """band_spec_lim, concat_band_inputs (K = 1 Rayleigh + one aerosol row
    per band) and the merged spectral albedo, exactly."""
    jm = three_band[0]
    tm = model_from_arrays(jm)
    bands = [0, 1, 2]
    assert tapi.band_spec_lim(tm, bands) == japi.band_spec_lim(jm, bands)
    tb, jb = tapi.concat_band_inputs(tm, bands), japi.concat_band_inputs(
        jm, bands)
    assert tb.zw.shape == (tm.profile.n_layers, 4, 3 * N_CUT)
    for f in ("tau", "omega", "zw"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert len(tb.greeks) == len(jb.greeks) == 4
    for tg, jg in zip(tb.greeks, jb.greeks):
        np.testing.assert_array_equal(tg.beta, jg.beta)
    ts, js = tapi._concat_surface(tm, bands), japi._concat_surface(jm, bands)
    assert ts["type"] == js["type"] == "LambertianSurfaceSpectrum"
    np.testing.assert_array_equal(ts["albedo"], js["albedo"])


@pytest.mark.parametrize("surfaces", [
    LAMB,
    [{"type": "LambertianSurfaceSpectrum", "albedo": np.linspace(0, 0.2, 5)},
     {"type": "LambertianSurfaceLegendre", "legendre_coeff": [0.2, 0.05]}],
    [RPV, dict(RPV)],
    [RPV, LAMB[0]],
    [RPV, dict(RPV, k=0.7)],
], ids=["scalars", "spectrum_legendre", "same_rpv", "rpv_lambertian",
        "two_rpvs"])
def test_concat_surface_matches_jax(surfaces):
    """The merged surface (or None, the per-band branch) equals JAX's."""
    params = [pkg.parameters_from_yaml(os.path.join(
        DATA, "rayleigh_benchmark.yaml")) for pkg in (jax_pkg, port)]
    got = []
    for p, api in zip(params, (japi, tapi)):
        p.spec_bands = [np.arange(13000.0, 13010.0, 2.0),
                        np.arange(14000.0, 14012.0, 3.0)]
        p.surfaces = copy.deepcopy(surfaces)
        got.append(api._concat_surface(
            type("M", (), {"params": p})(), [0, 1]))
    js, ts = got
    if js is None:
        assert ts is None
    else:
        assert ts.keys() == js.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])


def _two_band_models(surfaces, uniform):
    """A two-band one-layer Rayleigh atmosphere (IQU) in both packages;
    ``uniform`` sets each band's Rayleigh depth to one value so every band
    takes the same doubling counts."""
    models = []
    for pkg, kw in ((jax_pkg, {}), (port, {"device": "cpu"})):
        p = pkg.parameters_from_yaml(os.path.join(
            DATA, "rayleigh_benchmark.yaml"))
        p.spec_bands = [np.arange(13000.0, 13010.0, 2.0),
                        np.arange(14000.0, 14012.0, 3.0)]
        p.surfaces = copy.deepcopy(surfaces)
        p.polarization_type = "Stokes_IQU"
        p.quadrature_type = "GaussQuadFullSphere"
        p.l_trunc = 8
        p.vza, p.vaz = np.array([0.0, 30.0, 60.0]), np.array([0.0, 90.0,
                                                               180.0])
        m = pkg.model_from_parameters(p, **kw)
        if uniform:
            m.tau_rayl[0][:] = 0.25
            m.tau_rayl[1][:] = 0.23
        else:
            m.tau_rayl[0][:] = np.linspace(0.2, 0.3, 5)[:, None]
            m.tau_rayl[1][:] = np.linspace(0.05, 0.1, 4)[:, None]
        models.append(m)
    return models


@pytest.mark.parametrize("kind", list(SURFACES))
def test_rt_run_bands_match_jax(kind):
    jm, tm = _two_band_models(SURFACES[kind], uniform=False)
    jR, jT = jax_pkg.rt_run(jm, i_band=[0, 1])
    tR, tT = port.rt_run(tm, i_band=[0, 1], device="cpu")
    assert tR.shape == jR.shape == (3, 3, 9)
    np.testing.assert_allclose(tR, jR, rtol=1e-8, atol=0.0)
    np.testing.assert_allclose(tT, jT, rtol=1e-8, atol=0.0)


@pytest.mark.parametrize("kind", ["lambertian", "rpv"])
def test_concatenated_run_equals_per_band(kind):
    """With equal doubling counts the concatenated axis is transparent:
    concat == per-band runs to rounding."""
    _, tm = _two_band_models(SURFACES[kind], uniform=True)
    assert tapi._concat_surface(tm, [0, 1]) is not None
    R_cat, T_cat = port.rt_run(tm, i_band=[0, 1], device="cpu")
    for ib, sl in enumerate(tapi.band_spec_lim(tm, [0, 1])):
        R, T = port.rt_run(tm, i_band=ib, device="cpu")
        np.testing.assert_allclose(R_cat[..., sl], R, rtol=5e-12)
        np.testing.assert_allclose(T_cat[..., sl], T, rtol=5e-12)


def test_s2band_matches_jax():
    """S2BandParameters.yaml (O2 A-band and strong CO2). Its
    profile_reduction of 20 leaves the 402-452 hPa bin without a layer, so
    neither package builds it as written (JAX asserts, the port raises
    ValueError); without the reduction (34 layers) it builds and runs with
    i_band as a list."""
    path = os.path.join(REF_YAML, "S2BandParameters.yaml")
    with pytest.raises(AssertionError, match="empty layer"):
        jax_pkg.model_from_parameters(
            _cut(jax_pkg.parameters_from_yaml(path)))
    with pytest.raises(ValueError, match="empty layer"):
        port.model_from_parameters(_cut(port.parameters_from_yaml(path)),
                                   device="cpu")
    models = []
    for pkg, kw in ((jax_pkg, {}), (port, {"device": "cpu"})):
        p = _cut(pkg.parameters_from_yaml(path))
        p.profile_reduction = -1
        models.append(pkg.model_from_parameters(p, **kw))
    jm, tm = models
    assert len(tm.params.spec_bands) == 2 and tm.profile.n_layers == 34
    for ib in range(2):
        np.testing.assert_allclose(tm.tau_abs[ib], jm.tau_abs[ib],
                                   rtol=1e-10, atol=0.0)
    jR, jT = jax_pkg.rt_run(jm, i_band=[0, 1])
    tR, tT = port.rt_run(tm, i_band=[0, 1], device="cpu")
    assert tR.shape == (1, 3, 2 * N_CUT) and np.isfinite(tR).all()
    np.testing.assert_allclose(tR, jR, rtol=1e-8, atol=0.0)
    np.testing.assert_allclose(tT, jT, rtol=1e-8, atol=0.0)


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_float32_thick_layer_at_grazing_stream(solver):
    """An optically thick layer seen at a grazing stream, as an O2 A-band
    line core of 3BandParameters.yaml (layer tau 53.7 under GaussQuad-
    Hemisphere's mu = 0.0199): in float32 e^-a expm1(a - b) would be
    0 * inf (core/rt.py:exp_difference). The run stays finite and within
    1e-4 of float64."""
    from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadHemisphere", 15, 32.4436, [0.072],
                          pol.n)
    assert quad.qp_mu.min() < 0.02
    tau = np.array([[0.02, 0.02], [60.0, 0.3]])
    omega = np.array([[0.99, 0.99], [1e-5, 1e-5]])
    band = BandRTInputs(tau=tau, omega=omega, zw=np.ones((2, 1, 2)),
                        greeks=[get_greek_rayleigh(0.03)])
    out = [rt_run_band(pol, quad, band, [0.072], [0.0], 3,
                       {"type": "LambertianSurfaceScalar", "albedo": 0.2},
                       dtype=dt, device="cpu", solver=solver)[0]
           for dt in (torch.float32, torch.float64)]
    assert np.isfinite(out[0]).all()
    assert np.abs(out[0] - out[1]).max() < 1e-4 * np.abs(out[1]).max()
