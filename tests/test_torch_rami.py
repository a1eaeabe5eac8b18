"""The port's RAMI4ATM scene runner against the JAX package (CPU, float64).

The RAMI ancillary files (AFGL profile, aerosol refractive tables,
Sentinel-2A responses) are not in the repository. Every test that needs one
writes a small stand-in of the same format under ``tmp_path`` (a 241-level
synthetic standard atmosphere, two refractive tables, Gaussian band
responses), and both packages read that same file.

1. rami_geometry, convolve_ils and _surface_from_scene match JAX exactly;
   the readers, profile_inputs_from_afgl, the column amounts and
   build_rami_parameters (gas scaling, aerosols) match JAX.
2. run_rami_scenario on a Rayleigh scene over a Lambertian and an RPV
   surface, cut (dnu 20, 3 layers, l_trunc 8, max_m 2) and convolved with
   the stand-in ILS, matches JAX within 1e-10 of max per output.
3. tests/test_rami.py's Rayleigh scene gate on the port at that file's
   cut (BHR = albedo within 1e-2, cross-plane symmetry), and its
   flat-spectrum ILS gate.
"""
import dataclasses

import numpy as np
import pytest

from vsmartmom.core import rami as jr

from vsmartmom_torch.core import rami as tr
from vsmartmom_torch.core.atmosphere import compute_atmos_profile_fields

TOL = 1e-10
CUT = dict(dnu=20.0, n_layers=3, l_trunc=8, max_m=2)
SURFACES = {
    "LAM": {"name": "LAM", "surface_parameters": {"reflectance": [0.2]}},
    "RPV": {"name": "RPV", "surface_parameters":
            {"rho_0": [0.05], "rho_c": [0.05], "k": [0.7],
             "theta": [-0.1]}},
    "RLI": {"name": "RLI", "surface_parameters":
            {"f_vol": [0.2], "f_geo": [0.05], "f_iso": [0.1]}},
    "BLA": {"name": "BLA", "surface_parameters": {"reflectance": [0.0]}},
}


def _scenario(atm_type="AtmosphereType.RAYLEIGH", surface="LAM",
              aerosols=(), conc=None, band="8a", sza=30.0):
    return {
        "name": "HOM00_TEST",
        "measures": [{"bands": [band]}],
        "atmosphere": {"atmosphere_type": atm_type,
                       "aerosols": list(aerosols),
                       "concentrations": conc or {}},
        "illumination": {"sza": {"value": sza}},
        "surface": SURFACES[surface],
    }


def _standin_profile():
    """A 241-level synthetic standard atmosphere, surface first."""
    z = np.linspace(0.0, 60.0, 241)
    p = 1013.0 * np.exp(-z / 7.6)
    T = np.where(z < 11.0, 288.2 - 6.5 * z,
                 np.where(z < 20.0, 216.7, 216.7 + 1.5 * (z - 20.0)))
    n_air = p * 100.0 / (1.380649e-23 * T) * 1e-6
    vmr = {"H2O": 7.75e-3 * np.exp(-z / 2.2) + 4e-6,
           "CO2": np.full_like(z, 330e-6),
           "O3": 7e-6 * np.exp(-0.5 * ((z - 25.0) / 7.0) ** 2) + 3e-8,
           "N2O": np.full_like(z, 0.32e-6),
           "CO": np.full_like(z, 0.15e-6),
           "CH4": np.full_like(z, 1.7e-6),
           "O2": np.full_like(z, 0.209)}
    return tr.AFGLProfile(z_km=z, p_hpa=p, T=T, n_air=n_air, vmr=vmr)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The stand-in ancillary files, written once for the module."""
    d = tmp_path_factory.mktemp("rami")
    tr.write_afgl_profile(str(d / "RAMI4ATM_AFGLUSstandard_ap_v1.0.txt"),
                          _standin_profile())
    wl = np.arange(400.0, 1000.0, 50.0)
    for kind, (nr, ni) in {"desert": (1.53, 0.008),
                           "continental": (1.45, 0.003)}.items():
        np.savetxt(str(d / f"refractive_aero_{kind}.txt"),
                   np.column_stack([wl, nr - 1e-4 * (wl - 550.0) / 50.0,
                                    np.full_like(wl, ni)]))
    wl_ils = np.arange(400.0, 2400.0, 1.0)
    cols = [wl_ils] + [np.zeros_like(wl_ils)] * 13
    for b, c in tr.SENTINEL_ILS_COL.items():
        lo, hi = tr.SENTINEL_BAND_NM[b]
        cols[c] = np.exp(-0.5 * ((wl_ils - 0.5 * (lo + hi))
                                 / (0.25 * (hi - lo))) ** 2)
    np.savetxt(str(d / "ils.txt"), np.column_stack(cols))
    return str(d)


def _same_fields(a, b, path="params"):
    """Dataclasses, dicts, arrays and scalars of the two packages equal."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same_fields(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_fields(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_fields(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    else:
        assert a == b, (path, a, b)


# --- 1. the host pieces -----------------------------------------------------

def test_rami_geometry_fan_matches_jax():
    vza, vaz = tr.rami_geometry()
    assert len(vza) == len(vaz) == 4 * 38
    assert set(np.unique(vaz)) == {-90.0, 0.0, 90.0, 180.0}
    assert vza.min() == 1.0 and vza.max() == 75.0
    for got, want in zip(tr.rami_geometry(), jr.rami_geometry()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tr.rami_geometry(5.0, 45.0, 10.0),
                         jr.rami_geometry(5.0, 45.0, 10.0)):
        np.testing.assert_array_equal(got, want)


def test_convolve_ils_matches_jax():
    """A flat spectrum convolves to itself; any spectrum as JAX does."""
    nu = np.linspace(18000.0, 22000.0, 200)
    wl = np.linspace(400.0, 600.0, 100)
    resp = np.exp(-0.5 * ((wl - 490) / 20.0) ** 2)
    out = tr.convolve_ils(nu, np.full((3, 200), 0.7), wl, resp)
    np.testing.assert_allclose(out, 0.7, rtol=1e-12)
    spec = np.random.default_rng(0).uniform(0.0, 1.0, (4, 200))
    np.testing.assert_array_equal(tr.convolve_ils(nu, spec, wl, resp),
                                  jr.convolve_ils(nu, spec, wl, resp))
    with pytest.raises(ValueError, match="overlap"):
        tr.convolve_ils(nu, spec, wl + 1000.0, resp)


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_surface_from_scene_matches_jax(name):
    assert tr._surface_from_scene(SURFACES[name]) == \
        jr._surface_from_scene(SURFACES[name])


def test_surface_from_scene_refuses_other():
    for mod in (tr, jr):
        with pytest.raises(NotImplementedError):
            mod._surface_from_scene({"name": "HOM26"})


def test_readers_match_jax(data_dir):
    path = f"{data_dir}/RAMI4ATM_AFGLUSstandard_ap_v1.0.txt"
    prof, jprof = tr.read_afgl_profile(path), jr.read_afgl_profile(path)
    _same_fields(prof, jprof)
    np.testing.assert_allclose(prof.p_hpa, _standin_profile().p_hpa,
                               rtol=1e-9)
    for got, want in zip(tr.profile_inputs_from_afgl(prof),
                         jr.profile_inputs_from_afgl(jprof)):
        _same_fields(got, want)
    T, p_half, q, vmr = tr.profile_inputs_from_afgl(prof)
    assert p_half[0] < p_half[-1] and len(T) == len(p_half) - 1
    assert 0 < q[-1] < 10.0
    atm = compute_atmos_profile_fields(T, p_half, q, vmr)
    assert tr.h2o_column_kg_m2(atm) == jr.h2o_column_kg_m2(atm)
    assert tr.o3_column_kg_m2(atm) == jr.o3_column_kg_m2(atm)
    for kind in ("desert", "continental"):
        path = f"{data_dir}/refractive_aero_{kind}.txt"
        tab = tr.read_refractive_table(path)
        _same_fields(tab, jr.read_refractive_table(path))
        assert tr.refractive_at(tab, 860.0) == jr.refractive_at(tab, 860.0)
    wl, resp = tr.read_sentinel_ils(f"{data_dir}/ils.txt")
    jwl, jresp = jr.read_sentinel_ils(f"{data_dir}/ils.txt")
    _same_fields((wl, resp), (jwl, jresp))


@pytest.mark.parametrize("kind", ["rayleigh_lam", "absorbing_conc",
                                  "aerosols_rpv"])
def test_build_rami_parameters_matches_jax(data_dir, kind):
    if kind == "rayleigh_lam":
        sc = _scenario()
    elif kind == "absorbing_conc":
        sc = _scenario("AtmosphereType.ABSORBING", band="2",
                       conc={"H2O": {"value": 7.0}, "O3": {"value": 0.01}})
    else:
        sc = _scenario("AtmosphereType.AEROSOLS", surface="RPV",
                       aerosols=[{"name": "DESERT", "tau_550": 0.2}])
    got = tr.build_rami_parameters(sc, data_dir, **CUT)
    want = jr.build_rami_parameters(sc, data_dir, **CUT)
    _same_fields(got, want)
    if kind == "absorbing_conc":
        # each gas scaled by its own ratio
        atm = compute_atmos_profile_fields(got.T, got.p, got.q,
                                           got.absorption_params.vmr)
        assert tr.h2o_column_kg_m2(atm) == pytest.approx(7.0, rel=2e-2)
        assert tr.o3_column_kg_m2(atm) == pytest.approx(0.01, rel=1e-3)
    if kind == "aerosols_rpv":
        assert got.absorption_params is None
        assert got.scattering_params.rt_aerosols[0].bimodal is not None


# --- 2. the scene runner against JAX ----------------------------------------

@pytest.mark.parametrize("surface", ["LAM", "RPV"])
def test_run_rami_scenario_matches_jax(data_dir, surface):
    sc = _scenario(surface=surface)
    ils = f"{data_dir}/ils.txt"
    got = tr.run_rami_scenario(sc, data_dir, ils_path=ils, device="cpu",
                               **CUT)
    want = jr.run_rami_scenario(sc, data_dir, ils_path=ils, **CUT)
    assert set(got) == set(want)
    for key in sorted(want):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err <= TOL, (surface, key, err)
    # cross-plane symmetry (vaz +/-90); an anisotropic surface's
    # principal-plane fore/aft asymmetry
    assert np.all(np.isfinite(got["brf"]))
    n = len(got["vza"]) // 4
    np.testing.assert_allclose(got["brf"][2 * n:3 * n][::-1],
                               got["brf"][3 * n:], rtol=1e-8)
    if surface == "RPV":
        assert not np.allclose(got["brf"][:n][::-1], got["brf"][n:2 * n],
                               rtol=1e-3)


# --- 3. tests/test_rami.py's Rayleigh gate on the port ------------------------

def test_rami_rayleigh_lambertian_scene(data_dir):
    """Pure-Rayleigh scene at tests/test_rami.py's cut (dnu 60, 8 layers,
    l_trunc 12, max_m 3): BHR == surface albedo, BRF sane and cross-plane
    symmetric."""
    sc = _scenario(band="2")
    sc["surface"] = {"name": "LAM",
                     "surface_parameters": {"reflectance": [0.25]}}
    out = tr.run_rami_scenario(sc, data_dir, device="cpu", dnu=60.0,
                               n_layers=8, l_trunc=12, max_m=3)
    assert np.all(np.isfinite(out["brf"]))
    np.testing.assert_allclose(out["bhr"], 0.25, rtol=1e-2)
    n = len(out["vza"]) // 4
    np.testing.assert_allclose(out["brf"][2 * n:3 * n][::-1],
                               out["brf"][3 * n:], rtol=1e-8)
    assert 0.2 < np.median(out["brf"]) < 0.6


def test_rayleigh_scene_beyond_the_phase_expansion(data_dir):
    """A Rayleigh-only scene at more moments than Rayleigh's 3 Greek terms
    (run_rami_scenario's default is 20): the port's moments m >= 3 have a zero
    phase matrix and add nothing over a Lambertian surface; the JAX
    package raises IndexError in compute_Z_moments there."""
    sc = _scenario()
    kw = dict(CUT, max_m=3)
    three = tr.run_rami_scenario(sc, data_dir, device="cpu", **kw)
    kw["max_m"] = 5
    five = tr.run_rami_scenario(sc, data_dir, device="cpu", **kw)
    for key in ("brf", "hdrf", "bhr"):
        np.testing.assert_allclose(five[key], three[key], rtol=1e-12,
                                   atol=1e-15)
    with pytest.raises(IndexError):
        jr.run_rami_scenario(sc, data_dir, **kw)
