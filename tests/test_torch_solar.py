"""The port's solar model, stage timer and model reports against the JAX
package (CPU, f64).

Tolerances: Planck spectra, photon conversion and the solar transmission
and spectrum at rtol 1e-12 (the same numpy arithmetic on the same
data/solar/solar.out); the timer's and the reports' text equal as strings
where the JAX output is deterministic (no timing data, a report of given
stage statistics, the JAX package's span names among those rt_run_band
records, describe_parameters and describe_model); the port's span tree.
"""
import collections
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vsmartmom as jax_pkg
from vsmartmom import solar as jsolar
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.solar import model as jsolar_model
from vsmartmom.util import show as jshow
from vsmartmom.util import timing as jtiming
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

import vsmartmom_torch as port
from vsmartmom_torch import _paths
from vsmartmom_torch import solar as tsolar
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.solar import model as tsolar_model
from vsmartmom_torch.util import show as tshow
from vsmartmom_torch.util import timing as ttiming
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

#: the Na D doublet and the K I line at 12 985 cm^-1
GRIDS = [np.arange(16950.0, 16990.0, 0.01), np.arange(12980.0, 12990.0, 0.01)]
FOURIER = "fourier step (layer scan + surface)"


@pytest.mark.parametrize("T", [290.0, 1000.0, 3777.0, 5777.0])
def test_planck_matches_jax(T):
    np.testing.assert_allclose(tsolar.planck_spectrum_wn(T),
                               jsolar.planck_spectrum_wn(T), rtol=1e-12)
    nu = np.linspace(500.0, 25000.0, 97)
    np.testing.assert_allclose(tsolar.planck_spectrum_wn(T, nu),
                               jsolar.planck_spectrum_wn(T, nu), rtol=1e-12)
    np.testing.assert_allclose(tsolar.planck_spectrum_wl(T, 1e4 / nu),
                               jsolar.planck_spectrum_wl(T, 1e4 / nu),
                               rtol=1e-12)
    L = tsolar.planck_spectrum_wl(T, 1e4 / nu)
    np.testing.assert_allclose(tsolar.watts_to_photons(1e4 / nu, L),
                               jsolar.watts_to_photons(1e4 / nu, L),
                               rtol=1e-12)


def test_solar_file_is_read_in_place(monkeypatch, tmp_path):
    """The port finds data/solar/solar.out from any working directory, as
    the JAX package does from the repository root."""
    monkeypatch.chdir(tmp_path)
    assert str(tsolar_model.solar_linelist_path()) == _paths.SOLAR_FILE


@pytest.mark.parametrize("grid", GRIDS, ids=["na_d", "k_i"])
def test_solar_transmission_matches_jax(grid):
    ref = jsolar.default_solar_transmission(grid)
    got = tsolar.default_solar_transmission(grid)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert got[:, 1].min() < 0.9      # a Fraunhofer line in the window
    table = np.column_stack([grid[::7], np.linspace(0.5, 1.0,
                                                    len(grid[::7]))])
    np.testing.assert_allclose(
        tsolar_model.itp_solar_to_nu_grid(table, grid[5:-5]),
        jsolar_model.itp_solar_to_nu_grid(table, grid[5:-5]), rtol=1e-12)


@pytest.mark.parametrize("grid", GRIDS, ids=["na_d", "k_i"])
def test_solar_spectrum_at_earth_matches_jax(grid):
    np.testing.assert_allclose(tsolar.default_solar_spectrum_at_earth(grid),
                               jsolar.default_solar_spectrum_at_earth(grid),
                               rtol=1e-12)


def test_solar_transmission_without_file(monkeypatch, tmp_path):
    """No line list: unit transmission with a warning, as in JAX."""
    monkeypatch.setattr(_paths, "SOLAR_FILE", str(tmp_path / "solar.out"))
    grid = np.arange(13000.0, 13001.0, 0.1)
    with pytest.warns(UserWarning):
        out = tsolar.default_solar_transmission(grid)
    assert out.shape == (len(grid), 2)
    np.testing.assert_allclose(out[:, 1], 1.0)


@pytest.fixture
def timers():
    """Both timers emptied, the port's enabled; both restored after."""
    saved = (dict(jtiming._STATS), dict(ttiming._STATS), ttiming._ENABLED,
             list(ttiming._SPANS))
    jtiming.reset_timer()
    ttiming.reset_timer()
    ttiming.enable_timer()
    yield
    ttiming.enable_timer(saved[2])
    for mod, stats in ((jtiming, saved[0]), (ttiming, saved[1])):
        mod.reset_timer()
        mod._STATS.update(stats)
    ttiming._SPANS.extend(saved[3])


def test_timer_reports_match_jax(timers):
    assert ttiming.timer_report() == jtiming.timer_report() \
        == "(no timing data)"
    for mod in (jtiming, ttiming):
        mod._STATS["Z moments"] = [3, 0.0123, 0.0051]
        mod._STATS["fourier step (layer scan + surface)"] = [3, 1.5, 0.75]
    assert ttiming.timer_report() == jtiming.timer_report()
    ttiming.reset_timer()
    assert ttiming.timer_report() == "(no timing data)"


def test_rt_run_band_spans_match_jax(timers):
    """rt_run_band records the JAX package's three stage spans once a
    moment, among the port's own. Under a profiler the port's span tree:
    the driver's stages in order, each moment's fourier step holding an
    elemental and a layer_step span a layer and then its surface span,
    every span inside its parent and of its root's call. Disabled, the
    timer records nothing."""
    n_z, max_m = 2, 3
    band = dict(tau=np.full((n_z, 2), 0.2), omega=np.ones((n_z, 2)),
                zw=np.ones((n_z, 1, 2)))
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    jax_rt_run_band(JaxPol.from_name("Stokes_I"),
                    jax_streams("GaussQuadFullSphere", 8, 30.0, [0.0], 1),
                    JaxBand(**band, greeks=[jax_greek(0.0)]), [0.0], [0.0],
                    max_m, surf)
    with profile(activities=[ProfilerActivity.CPU]):
        rt_run_band(Polarization.from_name("Stokes_I"),
                    rt_set_streams("GaussQuadFullSphere", 8, 30.0, [0.0], 1),
                    BandRTInputs(**band, greeks=[get_greek_rayleigh(0.0)]),
                    [0.0], [0.0], max_m, surf, device="cpu")
    stages = ["Z moments", FOURIER, "postprocessing (device fetch)"]
    assert list(jtiming._STATS) == stages
    assert [ttiming._STATS[k][0] for k in stages] \
        == [jtiming._STATS[k][0] for k in stages] == [max_m] * 3

    spans = ttiming.spans()
    by_id = {sp.id: sp for sp in spans}
    children = collections.defaultdict(list)
    for sp in sorted(spans, key=lambda sp: sp.start_ns):
        children[sp.parent].append(sp)
        if sp.parent is None:
            assert sp.call == sp.id
        else:
            up = by_id[sp.parent]
            assert sp.call == up.call
            assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
    assert [sp.name for sp in children[None]] == ["schedules", "to_device"] \
        + [stages[0], FOURIER, stages[2], "synthesis"] * max_m
    steps = [sp for sp in children[None] if sp.name == FOURIER]
    for sp in steps:
        assert [c.name for c in children[sp.id]] \
            == ["elemental", "layer_step"] * n_z + ["surface"]
    assert {sp.name for sp in spans if children[sp.id]} == {FOURIER}

    ttiming.reset_timer()
    ttiming.enable_timer(False)
    rt_run_band(Polarization.from_name("Stokes_I"),
                rt_set_streams("GaussQuadFullSphere", 8, 30.0, [0.0], 1),
                BandRTInputs(**band, greeks=[get_greek_rayleigh(0.0)]),
                [0.0], [0.0], 1, surf, device="cpu")
    assert ttiming.timer_report() == "(no timing data)"
    assert ttiming.spans() == []


def _params(pkg):
    """Default parameters over 10 points, NAI2 with 100 radius nodes."""
    params = copy.deepcopy(pkg.default_parameters())
    params.spec_bands = [np.arange(13155.0, 13157.0, 0.2)]
    params.scattering_params.nquad_radius = 100
    return params


def test_reports_match_jax():
    """repr(params) and repr(model) render the JAX package's reports."""
    tp, jp = _params(port), _params(jax_pkg)
    assert repr(tp) == repr(jp) == jshow.describe_parameters(jp)
    for section in ("Radiative Transfer", "Geometry", "Atmospheric Profile",
                    "Absorption", "Scattering"):
        assert section in repr(tp)
    tm = port.model_from_parameters(tp, device="cpu")
    jm = jax_pkg.model_from_parameters(jp)
    assert repr(tm) == tshow.describe_model(tm) == repr(jm)
    assert "Derived RT model" in repr(tm) and "band[0]" in repr(tm)
