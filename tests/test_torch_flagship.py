"""The flagship O2 A-band forward run through the port's public API against
the JAX package's, on a 200-point sub-window of the default band
(default_parameters -> model_from_parameters -> rt_run, CPU, float64).

Tolerances: the model build (absorption, Rayleigh and aerosol optical
depths, aerosol Greek coefficients) at rtol 1e-10; radiances R and T at
rtol 1e-8 (34 layers of doubling and adding in another summation order).
"""
import collections
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vsmartmom as jax_pkg

import vsmartmom_torch as port
from vsmartmom_torch.core.model import model_from_arrays
from vsmartmom_torch.util import timing

torch.set_num_threads(2)

WINDOW = np.arange(13150.0, 13155.0, 0.025)      # 200 points, R branch


def _params(pkg):
    params = copy.deepcopy(pkg.default_parameters())
    params.spec_bands = [WINDOW.copy()]
    return params


@pytest.fixture(scope="module")
def flagship():
    jm = jax_pkg.model_from_parameters(_params(jax_pkg))
    jR, jT = jax_pkg.rt_run(jm)
    tm = port.model_from_parameters(_params(port), device="cpu")
    tR, tT = port.rt_run(tm, device="cpu")
    return jm, (jR, jT), tm, (tR, tT)


def test_optical_depths_match(flagship):
    jm, _, tm, _ = flagship
    assert tm.tau_abs[0].shape == (len(WINDOW), tm.profile.n_layers)
    assert tm.tau_abs[0].max() > 1.0, "strong O2 lines must be present"
    for name in ("tau_abs", "tau_rayl", "tau_aer"):
        np.testing.assert_allclose(getattr(tm, name)[0],
                                   getattr(jm, name)[0], rtol=1e-10,
                                   atol=0.0, err_msg=name)


def test_aerosol_optics_match(flagship):
    jm, _, tm, _ = flagship
    jo, to = jm.aerosol_optics[0][0], tm.aerosol_optics[0][0]
    for f in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta"):
        a, b = getattr(jo.greek_coefs, f), getattr(to.greek_coefs, f)
        np.testing.assert_allclose(b, a, rtol=1e-10,
                                   atol=1e-10 * np.abs(a).max(), err_msg=f)
    for f in ("ssa", "k", "f_t"):
        np.testing.assert_allclose(getattr(to, f), getattr(jo, f),
                                   rtol=1e-10)


def test_radiances_match(flagship):
    _, (jR, jT), _, (tR, tT) = flagship
    assert tR.shape == jR.shape == (9, 1, len(WINDOW))
    assert np.isfinite(tR).all() and np.isfinite(tT).all()
    nadir = tR[4, 0]
    assert np.all(nadir > 0) and np.all(nadir < 1)
    np.testing.assert_allclose(tR, jR, rtol=1e-8, atol=0.0)
    np.testing.assert_allclose(tT, jT, rtol=1e-8, atol=0.0)


def test_port_rt_on_jax_model(flagship):
    """The port's RT on exactly the JAX build (model_from_arrays): any
    difference is the RT's, not the model build's."""
    jm, (jR, _), _, _ = flagship
    R, _ = port.rt_run(model_from_arrays(jm), device="cpu")
    np.testing.assert_allclose(R, jR, rtol=1e-8, atol=0.0)


def test_kernel_engines_on_flagship_window(flagship):
    """The Float32 flagship path on the CPU: the tiled Voigt sum (plain
    version) within 1e-3 of the dense f64 engine, and the fused layer step
    (plain version) within 1e-3 of the float64 torch engine at the same
    Newton-Schulz schedules."""
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile

    _, _, tm, (tR, _) = flagship
    ap = tm.params.absorption_params
    ta = np.zeros_like(tm.tau_abs[0])
    compute_absorption_profile(ta, "O2", ap, WINDOW, 0.21, tm.profile,
                               engine="kernel", device="cpu")
    np.testing.assert_allclose(ta, tm.tau_abs[0], rtol=0,
                               atol=1e-3 * tm.tau_abs[0].max())
    args = (tm.pol, tm.quad_points, build_band_inputs(tm, 0),
            tm.obs_geom.vza, tm.obs_geom.vaz, tm.params.max_m,
            tm.params.surfaces[0])
    # same Newton-Schulz schedules in float64 through the torch engine
    R64, _ = rt_run_band(*args, solver="schulz", engine="torch",
                         device="cpu")
    R32, _ = rt_run_band(*args, dtype=torch.float32, solver="schulz",
                         engine="kernel", device="cpu")
    assert np.abs(R32 - R64).max() / np.abs(R64).max() < 1e-3
    # the schedules' quantized (finer) doubling stays inside the 6SV1 gate
    assert np.abs(R64 - tR).max() / np.abs(tR).max() < 6e-3


def test_rt_run_span_tree(flagship):
    """Under a profiler, a forward call through rt_run (the flagship cut to
    three points) records one call: the root rt_run holds band_inputs,
    schedules, to_device and each moment's Z moments, fourier step, fetch
    and synthesis; each fourier step an elemental and a layer_step span a
    layer, then surface."""
    _, _, tm, _ = flagship
    cut = dataclasses.replace(
        tm, params=dataclasses.replace(tm.params,
                                       spec_bands=[WINDOW[:3].copy()]),
        tau_abs=[tm.tau_abs[0][:3]], tau_rayl=[tm.tau_rayl[0][:3]])
    saved = list(timing._SPANS)
    timing._SPANS.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            R, _ = port.rt_run(cut, device="cpu")
        spans = timing.spans()
    finally:
        timing._SPANS[:] = saved
    assert R.shape == (9, 1, 3)
    children = collections.defaultdict(list)
    for sp in sorted(spans, key=lambda sp: sp.start_ns):
        children[sp.parent].append(sp)
    [root] = children[None]
    assert root.name == "rt_run" and {sp.call for sp in spans} == {root.id}
    max_m, n_z = tm.params.max_m, tm.profile.n_layers
    assert [sp.name for sp in children[root.id]] \
        == ["band_inputs", "schedules", "to_device"] + [
            "Z moments", "fourier step (layer scan + surface)",
            "postprocessing (device fetch)", "synthesis"] * max_m
    for sp in children[root.id][4::4]:
        assert [c.name for c in children[sp.id]] \
            == ["elemental", "layer_step"] * n_z + ["surface"]
