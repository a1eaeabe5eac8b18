"""Port's direct/diffuse split form (the torch_dev engine and the split-form
layer step's plain version) against the JAX package, plus engine selection
and the entry points' default device.

JAX runs as its own tests run it: CPU, x64, Pallas in interpret mode at
"highest" precision. Tolerances: the split-form algebra at float64 to
1e-12 of each field's max (the same products in another summation order);
whole runs to 1e-10 of max R (tests/test_dev_form.py's bound for a 34-layer
run); the layer step at float32 to 1e-5 of each field's max (float32
rounding in two libraries).
"""
import inspect
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core import rt as jrt
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.pallas.layer_step_kernel import \
    _fused_layer_step_dev_prim as jax_step_dev
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core import rt as trt
from vsmartmom_torch.core.rt_run import (BandRTInputs, rt_run_band,
                                         select_engine)
from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

from test_torch_layer_step import _tile_cover

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _layer_args(S=8, n=12, seed=0):
    """The layer model of tests/test_dev_form.py:_layer_args (numpy)."""
    rng = np.random.default_rng(seed)
    qp = np.sort(rng.uniform(0.05, 1.0, n))
    qp[-1] = 0.5
    i_mu0 = n - 1
    wct2 = rng.uniform(0.01, 0.2, n)
    wct2[2] = 0.0                              # a zero-weight camera column
    d_vec = np.ones(n)
    d_vec[5] = -1.0                            # exercise the D-flip signs
    i0_vec = np.zeros(n)
    i0_vec[i_mu0] = 1.0
    return dict(
        tau=rng.uniform(0.05, 0.4, S), omega=rng.uniform(0.3, 0.99, S),
        z_pp=rng.uniform(0.1, 1.0, (1, n, n)),
        z_mp=rng.uniform(0.1, 1.0, (1, n, n)),
        tau_sum=rng.uniform(0, 0.5, S), qp=qp, wct2=wct2, wct02=0.5,
        i0_vec=i0_vec, i_mu0_n=i_mu0, n_stokes=1, mu0_node=float(qp[i_mu0]),
        mu0=float(qp[i_mu0]), d_vec=d_vec, min_qp_mu=float(qp.min()))


_ORDER = ("tau", "omega", "z_pp", "z_mp", "tau_sum", "qp", "wct2", "wct02",
          "i0_vec", "i_mu0_n", "n_stokes", "mu0_node", "mu0", "d_vec",
          "min_qp_mu")


def _common(a, as_array):
    return tuple(as_array(a[k]) if isinstance(a[k], np.ndarray) else a[k]
                 for k in _ORDER)


def _torch_common(a):
    out = list(_common(a, torch.as_tensor))
    for i, k in enumerate(_ORDER):        # 0-dim scalars, as rt_run gives
        if k in ("wct02", "mu0_node", "mu0", "min_qp_mu"):
            out[i] = torch.tensor(a[k], dtype=torch.float64)
    return tuple(out)


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_added_layer_and_interaction_dev_match_jax(solver):
    """make_added_layer_dev and interaction_dev, exact LU and schulz, on
    the layer model of tests/test_dev_form.py:30-83 (float64)."""
    a = _layer_args()
    S, n, nd = 8, 12, 9
    sched = (2, 3, 3, 4, 4, 4, 4, 4, 4)
    eye_j = jnp.broadcast_to(jnp.eye(n), (S, n, n))
    eye_t = torch.eye(n, dtype=torch.float64).expand(S, n, n)
    if solver == "lu":
        kw_j, kw_t = dict(exact_eye=eye_j), dict(exact_eye=eye_t)
        ikw_j, ikw_t = dict(exact_eye=eye_j), dict(exact_eye=eye_t)
    else:
        kw_j = kw_t = dict(ns_schedule=sched)
        ikw_j = ikw_t = dict(ni=3)
    ref = jrt.make_added_layer_dev(*_common(a, jnp.asarray),
                                   ndoubl_static=nd, **kw_j)
    got = trt.make_added_layer_dev(*_torch_common(a), ndoubl_static=nd,
                                   **kw_t)
    for name, x, y in zip(trt.LayerRTDev._fields, got, ref):
        assert _rel(x.numpy(), y) < 1e-12, (name, _rel(x.numpy(), y))
    ref_c = jrt.interaction_dev(ref, ref, **ikw_j)
    got_c = trt.interaction_dev(got, got, **ikw_t)
    for name, x, y in zip(trt.LayerRTDev._fields, got_c, ref_c):
        assert _rel(x.numpy(), y) < 1e-12, (name, _rel(x.numpy(), y))


def test_dev_to_full_matches_plain_form():
    """The port's split form, reassembled, is the port's plain form (f64,
    exact LU: the same algebra)."""
    a = _layer_args()
    S, n, nd = 8, 12, 9
    eye = torch.eye(n, dtype=torch.float64).expand(S, n, n)
    c = _torch_common(a)
    plain = trt.make_added_layer(*c, eye, rsolve=trt.rsolve_lu,
                                 ndoubl_static=nd)
    dev = trt.make_added_layer_dev(*c, ndoubl_static=nd, exact_eye=eye)
    for name, x, y in zip(trt.LayerRT._fields, trt.dev_to_full(dev), plain):
        assert _rel(x.numpy(), y.numpy()) < 1e-12, name
    c_plain = trt.interaction(plain, plain, eye, rsolve=trt.rsolve_lu)
    c_dev = trt.interaction_dev(dev, dev, exact_eye=eye)
    for name, x, y in zip(trt.LayerRT._fields, trt.dev_to_full(c_dev),
                          c_plain):
        assert _rel(x.numpy(), y.numpy()) < 1e-12, name


def _band_fixture():
    """tests/test_dev_form.py:_band_fixture: thin stratosphere above thick
    scatterers (a wide doubling-count spread)."""
    rng = np.random.default_rng(3)
    n_z, n_spec = 12, 24
    tau = np.concatenate([np.full((n_z // 2, n_spec), 0.002),
                          rng.uniform(0.05, 0.3, (n_z - n_z // 2, n_spec))])
    om = rng.uniform(0.4, 0.999, (n_z, n_spec))
    return ("Stokes_IQU", ("GaussQuadFullSphere", 8, 45.0, [10.0, 40.0], 3),
            tau, om, 0.03, 0.2, 3)


def _hetero_34():
    """tests/test_dev_form.py:249: the 34-layer heterogeneous profile."""
    rng = np.random.default_rng(7)
    n_spec = 16
    tau = np.concatenate([np.full((20, n_spec), 0.0005),
                          rng.uniform(0.02, 0.25, (14, n_spec))])
    om = rng.uniform(0.3, 0.99, (34, n_spec))
    return ("Stokes_I", ("GaussQuadFullSphere", 6, 60.0, [30.0], 1), tau, om,
            0.0, 0.1, 2)


def _run_both(fixture, port_kw, jax_kw):
    pol_name, quad, tau, om, depol, albedo, max_m = fixture
    n_z, n_spec = tau.shape
    zw = np.ones((n_z, 1, n_spec))
    surf = {"type": "LambertianSurfaceScalar", "albedo": albedo}
    vza = [quad[3][-1]]
    R, T = rt_run_band(Polarization.from_name(pol_name),
                       rt_set_streams(*quad),
                       BandRTInputs(tau=tau, omega=om, zw=zw,
                                    greeks=[get_greek_rayleigh(depol)]),
                       vza, [0.0], max_m, surf, device="cpu", **port_kw)
    Rj, Tj = jax_rt_run_band(JaxPol.from_name(pol_name), jax_streams(*quad),
                             JaxBand(tau=tau, omega=om, zw=zw,
                                     greeks=[jax_greek(depol)]),
                             vza, [0.0], max_m, surf, **jax_kw)
    return R, T, Rj, Tj


@pytest.mark.parametrize("fixture", [_band_fixture, _hetero_34],
                         ids=["band", "hetero34"])
@pytest.mark.parametrize("solver", ["schulz", "lu"])
def test_rt_run_band_torch_dev_matches_jax_xla_dev(fixture, solver):
    """The torch_dev engine against JAX xla_dev (float64), under schulz
    and under LU (both borrow the schulz builder's buckets and solve each
    exactly)."""
    R, T, Rj, Tj = _run_both(
        fixture(), dict(dtype=torch.float64, solver=solver,
                        engine="torch_dev"),
        dict(dtype=jnp.float64, solver=solver, doubling_engine="xla_dev"))
    assert np.isfinite(R).all()
    assert np.abs(R - Rj).max() < 1e-10 * np.abs(Rj).max()
    assert np.abs(T - Tj).max() < 1e-10 * np.abs(Tj).max()


def test_kernel_dev_engine_matches_jax_pallas_dd_interpret(monkeypatch):
    """The kernel_dev engine (split-form step's plain version on the CPU)
    against JAX pallas_dd_interpret at "highest" precision, float64."""
    monkeypatch.setenv("VSM_DD_PRECISION", "highest")
    R, _, Rj, _ = _run_both(
        _band_fixture()[:6] + (2,),
        dict(dtype=torch.float64, solver="schulz", engine="kernel_dev"),
        dict(dtype=jnp.float64, solver="schulz",
             doubling_engine="pallas_dd_interpret"))
    assert np.abs(R - Rj).max() < 1e-12 * np.abs(Rj).max()


def _dev_slab(S, n, nd, seed, scale=1.0):
    """Passive pre-split elemental slab (r_f, g, e, jp, jm, ek), numpy."""
    rng = np.random.default_rng(seed)
    tau_scat, mqm = 0.2, 0.2
    dtau = tau_scat / 2 ** nd
    r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
    e = rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm)
    g = np.exp(-dtau / np.linspace(mqm, 1.0, n))[None].repeat(S, 0)
    jp = rng.uniform(0, dtau, (S, n))
    jm = rng.uniform(0, dtau, (S, n))
    ek = np.full(S, np.exp(-dtau / 0.7))
    return r, g, e, jp, jm, ek


# (S, N, D pattern, schedule, ni): Stokes_I at the flagship's N = 15, a
# polarized D pattern, ragged S against the JAX kernel's 16-point blocks,
# zero-iteration steps
DEV_CASES = [
    (40, 15, (1.0,), (0, 1, 2, 4, 4), 3),
    (37, 12, (1.0, 1.0, -1.0, -1.0), (0, 0, 1, 2), 0),
    (16, 16, (1.0, 1.0, -1.0), (4, 4, 4), 4),
    # the split-form kernel's width classes and edges (N = 1, the first
    # width of the 32, 48 and fifth classes, the widest N), a D pattern of
    # +-1 each and one zero-iteration step
    (5, 1, (1.0, -1.0), (0, 2, 3), 2),
    (9, 17, (1.0, -1.0), (3, 0, 2), 3),
    (6, 33, (1.0, 1.0, -1.0, -1.0), (2, 0, 3), 2),
    (3, 64, (1.0, -1.0), (0, 3, 3), 3),
    (3, 75, (1.0, 1.0, -1.0, -1.0), (2, 3, 0), 3),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", DEV_CASES,
                         ids=lambda c: f"S{c[0]}N{c[1]}d{len(c[2])}")
def test_fused_layer_step_dev_plain_matches_jax(case, dtype):
    """fused_layer_step_dev's plain version against the JAX split-form
    Pallas kernel in interpret mode at "highest" precision."""
    S, n, dpat, sched, ni = case
    nd = len(sched)
    d = np.tile(dpat, n // len(dpat) + 1)[:n]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bound = 1e-5 if dtype == "float32" else 1e-12

    def jx(x):
        return jnp.asarray(x, jdt)

    def tx(x):
        return torch.as_tensor(np.array(x), dtype=tdt)

    comp = jrt.vacuum_layer_dev(S, n, jdt)
    for k, scale in enumerate((1.0, 0.6)):
        comp = jax_step_dev(comp, *map(jx, _dev_slab(S, n, nd, k, scale)),
                            jx(d), ns_schedule=sched, ni=4, interpret=True,
                            precision_name="highest")
    r, g, e, jp, jm, ek = _dev_slab(S, n, nd, 5, 0.8)
    ref = jax_step_dev(comp, jx(r), jx(g), jx(e), jx(jp), jx(jm), jx(ek),
                       jx(d), ns_schedule=sched, ni=ni, interpret=True,
                       precision_name="highest")
    got = ldk.fused_layer_step_dev(
        trt.LayerRTDev(*(tx(np.asarray(x)) for x in comp)), tx(r), tx(g),
        tx(e), tx(jp), tx(jm), tx(ek), tx(d), ns_schedule=sched, ni=ni,
        precision="highest")
    for name, x, y in zip(trt.LayerRTDev._fields, got, ref):
        assert x.shape == y.shape and x.dtype == tdt
        assert np.isfinite(x.numpy()).all(), name
        assert _rel(x.numpy(), y) < bound, (name, _rel(x.numpy(), y))


_UNIFORM = ((4, (0, 1, 2, 3), 4),) * 2


@pytest.mark.parametrize("engine, dtype, n, schedules, precision, want", [
    ("auto", torch.float32, 148, _UNIFORM, "highest", "torch_dev"),
    ("auto", torch.float32, 136, _UNIFORM, "highest", "torch_dev"),
    ("auto", torch.float32, 136, _UNIFORM, "high", "torch_dev"),
    ("auto", torch.float64, 148, _UNIFORM, "highest", "torch"),
    ("auto", torch.float32, 148, ((4, None, None),) * 2, "highest",
     "torch"),
    ("auto", torch.float32, 44, _UNIFORM, "highest", "kernel_scan"),
    ("auto", torch.float32, 44, _UNIFORM, "high", "kernel"),
    ("kernel_scan", torch.float32, 44, _UNIFORM, "highest", "kernel_scan"),
    ("kernel_lanes", torch.float32, 44, _UNIFORM, "highest", "kernel_lanes"),
    ("pallas_scan", torch.float32, 148, _UNIFORM, "highest", ValueError),
    ("pallas_lanes", torch.float32, 148, _UNIFORM, "highest", ValueError),
])
def test_select_engine_auto_takes_the_split_form(engine, dtype, n, schedules,
                                                 precision, want):
    """auto: float32 CUDA beyond the kernels' N takes torch_dev (the
    Natraj N) at any product mode, float64 the plain torch engine; at the
    headline N = 44 the scan at "highest", the layer step at "high"; the
    scan and lanes engines run by their port names, and the JAX names
    raise. No card needed: only the device's type is read."""
    cuda = torch.device("cuda")
    if want is ValueError:
        with pytest.raises(ValueError):
            select_engine(engine, cuda, dtype, n, schedules, precision)
    else:
        assert select_engine(engine, cuda, dtype, n, schedules,
                             precision) == want


@pytest.mark.parametrize("n", range(1, 76))
def test_dev_kernel_arena_fits_hopper_up_to_its_largest_n(n):
    """The split-form team kernel takes every N up to max_n() = 75: its
    launch fits one block's 227 KB, with a float4 row stride ld >= N + 2,
    teams of whole warps within the block's thread bound and named
    barriers, and tiles that store every output of its products (widths N,
    N + 1, N + 2, 2N + 1, 2N + 2 and 3N + 2) exactly once. Beyond 75 the
    wrapper refuses."""
    from vsmartmom_torch.cuda import build
    assert ldk.max_n() == 75
    cfg = ldk.launch_config(n)
    cls = build.tile_class(n, build.DEV_TILE_CLASSES)
    assert cls[0] >= n and cfg.team_threads == cls[1]
    assert cfg.points >= 1 and cfg.smem_bytes <= build.MAX_SHARED_BYTES
    assert cfg.smem_bytes == 4 * (build.round4(n)
                                  + cfg.points * ldk.arena_floats(n, cfg.ld))
    assert cfg.ld >= n + 2 and cfg.ld % 4 == 0
    assert cfg.ld % 8 == 4 or cfg.ld == build.round4(n + 2)
    assert cfg.team_threads % 32 == 0
    assert cfg.points * cfg.team_threads <= build.MAX_BLOCK_THREADS
    assert cfg.team_threads == 32 or cfg.points <= 15   # bar.sync ids 1..15
    for k in (n, n + 1, n + 2, 2 * n + 1, 2 * n + 2, 3 * n + 2):
        cover = _tile_cover(n, k, cls)
        assert len(cover) == n * k and set(cover) == {
            (i, j) for i in range(n) for j in range(k)}, (n, k)
    with pytest.raises(ValueError):
        ldk.launch_config(ldk.max_n() + 1)


def test_kernel_engines_refuse_layers_without_schedules():
    """Under LU a uniform profile has no NS schedule: kernel_dev and
    kernel_doubling raise where JAX falls back to its exact twin."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 30.0, [0.0], 1)
    band = BandRTInputs(tau=np.full((2, 3), 0.2), omega=np.ones((2, 3)),
                        zw=np.ones((2, 1, 3)),
                        greeks=[get_greek_rayleigh(0.0)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    for engine in ("kernel_dev", "kernel_doubling"):
        with pytest.raises(ValueError, match="schedule"):
            rt_run_band(pol, quad, band, [0.0], [0.0], 1, surf,
                        device="cpu", solver="lu", engine=engine)


def _tiny_model():
    """A minimal RTModel stand-in: one Rayleigh band of 3 points, 2
    layers, no aerosols or absorption."""
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 30.0, [0.0, 20.0], pol.n)
    params = types.SimpleNamespace(
        float_type="Float64", max_m=2,
        surfaces=[{"type": "LambertianSurfaceScalar", "albedo": 0.1}])
    return types.SimpleNamespace(
        params=params, pol=pol, quad_points=quad,
        obs_geom=types.SimpleNamespace(vza=[0.0, 20.0], vaz=[0.0, 0.0]),
        tau_rayl=[np.array([[0.05, 0.2]] * 3)],
        tau_abs=[np.zeros((3, 2))], tau_aer=[np.zeros((0, 2))],
        aerosol_optics=[[]], greek_rayleigh=get_greek_rayleigh(0.0))


def test_rt_run_passes_the_engine_through():
    from vsmartmom_torch.core.api import build_band_inputs, rt_run
    model = _tiny_model()
    R, _ = rt_run(model, device="cpu", engine="torch_dev")
    Rb, _ = rt_run_band(model.pol, model.quad_points,
                        build_band_inputs(model, 0), model.obs_geom.vza,
                        model.obs_geom.vaz, 2, model.params.surfaces[0],
                        device="cpu", engine="torch_dev")
    np.testing.assert_array_equal(R, Rb)
    with pytest.raises(ValueError, match="unknown engine"):
        rt_run(model, device="cpu", engine="xla_dev")


def _entry_points():
    import vsmartmom_torch as port
    from vsmartmom_torch.core.api import rt_run
    from vsmartmom_torch.cuda.voigt_kernel import VoigtPlan
    from vsmartmom_torch.spectroscopy import profiles, voigt
    return {"rt_run": rt_run, "rt_run_band": rt_run_band,
            "model_from_parameters": port.model_from_parameters,
            "compute_absorption_profile": profiles.compute_absorption_profile,
            "make_voigt_plan": voigt.make_voigt_plan,
            "compute_absorption_cross_section":
                voigt.compute_absorption_cross_section,
            "VoigtPlan": VoigtPlan}


def test_entry_points_default_to_cuda():
    """Every public entry point runs on the card unless the caller asks for
    the CPU; without CUDA a call that names no device raises instead of
    running on the CPU."""
    for name, fn in _entry_points().items():
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", (name, default)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the calls would run")
    from vsmartmom_torch.core.api import rt_run
    from vsmartmom_torch.cuda.voigt_kernel import VoigtPlan
    from vsmartmom_torch.spectroscopy.hitran import read_hitran
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile
    from vsmartmom_torch.spectroscopy.voigt import (
        compute_absorption_cross_section, make_hitran_model, make_voigt_plan)
    hm = make_hitran_model(read_hitran(os.path.join(
        os.path.dirname(__file__), "data", "testCO2.par")))
    grid = np.arange(6214.0, 6214.1, 0.01)
    model = _tiny_model()
    import vsmartmom_torch as port
    calls = {
        "rt_run": lambda: rt_run(model),
        "rt_run_band": lambda: rt_run_band(
            model.pol, model.quad_points,
            BandRTInputs(tau=np.full((1, 2), 0.1), omega=np.ones((1, 2)),
                         zw=np.ones((1, 1, 2)),
                         greeks=[get_greek_rayleigh(0.0)]),
            [0.0], [0.0], 1, model.params.surfaces[0]),
        "model_from_parameters": lambda: port.model_from_parameters(
            port.default_parameters()),
        "compute_absorption_profile": lambda: compute_absorption_profile(
            np.zeros((len(grid), 2)), "CO2", None, grid, 4e-4, None),
        "make_voigt_plan": lambda: make_voigt_plan(hm, grid),
        "VoigtPlan": lambda: VoigtPlan(grid, [6214.05], 5.0),
        "compute_absorption_cross_section":
            lambda: compute_absorption_cross_section(hm, grid, 1000.0,
                                                     296.0),
    }
    assert set(calls) == set(_entry_points())
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
