"""Port's rt_run_band against the JAX package and the reference's gates.

float64 LU runs match JAX to rtol 1e-10 (same algebra, different matmul
summation order); the port passes the 6SV1 (< 0.006) and Natraj
(I < 0.002, Q/U < 0.008) tables on its own. The "kernel" engine (plain
layer-step version on the CPU) runs float32 Newton-Schulz against the
JAX fused kernel in interpret mode at max|dR| / max|R| < 1e-5.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core.rt_run import (ENGINES, BandRTInputs,
                                         build_layer_schedules, rt_run_band,
                                         select_engine)
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
VZA_16 = [0.0, 11.4783, 16.2602, 23.0739, 32.8599, 43.9455, 50.2082, 58.6677,
          66.4218, 71.3371, 73.7398, 78.463, 80.7931, 84.2608, 86.5602,
          88.854]
POL = Polarization.from_name("Stokes_IQUV")
LAMB0 = {"type": "LambertianSurfaceScalar", "albedo": 0.0}


def _rayleigh_band(tau):
    """Single Rayleigh layer of optical depth tau, two spectral points."""
    return BandRTInputs(tau=np.full((1, 2), tau), omega=np.ones((1, 2)),
                        zw=np.ones((1, 1, 2)),
                        greeks=[get_greek_rayleigh(0.0)])


def _both(pol_name, quad_args, band_args, vza, vaz, max_m, surf, **kw):
    """The same rt_run_band through the port and through JAX."""
    tau, omega, zw, depol = band_args
    t = rt_run_band(Polarization.from_name(pol_name),
                    rt_set_streams(*quad_args), BandRTInputs(
                        tau=tau, omega=omega, zw=zw,
                        greeks=[get_greek_rayleigh(depol)]),
                    vza, vaz, max_m, surf, device="cpu", **kw)
    j = jax_rt_run_band(JaxPol.from_name(pol_name),
                        jax_streams(*quad_args), JaxBand(
                            tau=tau, omega=omega, zw=zw,
                            greeks=[jax_greek(depol)]),
                        vza, vaz, max_m, surf, **kw)
    return t, j


CASES_6SV1 = [
    (1, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.1, 0.0),
    (2, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.1, 0.25),
    (3, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.25, 0.0),
    (4, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.25, 0.25),
    (5, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.50, 0.0),
    (6, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.50, 0.25),
]


@pytest.mark.parametrize("case", CASES_6SV1, ids=lambda c: f"case{c[0]}")
def test_port_against_6sv1(case):
    """Scalar Rayleigh reflectance vs 6SV1 (ref: test_CoreRT.jl:3-38)."""
    r_trues = np.asarray(json.load(open(f"{DATA}/6sv1_r_trues.json")))
    ci, azs, szas, tau, rho = case
    worst = 0.0
    for sza_i, sza in enumerate(szas):
        quad = rt_set_streams("RadauQuad", 20, sza, VZA_16, POL.n)
        for az_i, az in enumerate(azs):
            R, _ = rt_run_band(POL, quad, _rayleigh_band(tau), VZA_16,
                               [az] * 16, 3,
                               {"type": "LambertianSurfaceScalar",
                                "albedo": rho}, device="cpu")
            r_model = R[:, 0, 0] / quad.mu0
            r_true = r_trues[ci - 1, sza_i, az_i]
            worst = max(worst, np.max(np.abs(r_true - r_model) / r_true))
    assert worst < 0.006, worst


def test_port_against_natraj():
    """Polarized I/Q/U vs Natraj et al. tables (ref: test_CoreRT.jl:40-83)."""
    d = np.load(f"{DATA}/natraj_trues.npz")
    I_t, Q_t, U_t = d["I_trues"], d["Q_trues"], d["U_trues"]
    mu = np.array([0.02, 0.06, 0.10, 0.16, 0.20, 0.28, 0.32, 0.40, 0.52,
                   0.64, 0.72, 0.84, 0.92, 0.96, 0.98, 1.00])
    vza = np.degrees(np.arccos(mu))
    quad = rt_set_streams("RadauQuad", 20, np.degrees(np.arccos(0.2)), vza,
                          POL.n)
    I_m, Q_m, U_m = (np.zeros((16, 7)) for _ in range(3))
    for j, phi in enumerate(np.arange(0.0, 181.0, 30.0)):
        R, _ = rt_run_band(POL, quad, _rayleigh_band(0.5), vza, [phi] * 16,
                           3, LAMB0, device="cpu")
        I_m[:, j], Q_m[:, j], U_m[:, j] = R[:, 0, 0], R[:, 1, 0], R[:, 2, 0]
    assert np.max(np.abs(I_t - I_m) / I_t) < 0.002
    q_mask = Q_m >= 0.01
    assert np.max(np.abs(Q_t - Q_m)[q_mask] / np.abs(Q_t)[q_mask]) < 0.008
    u_mask = U_m >= 0.01
    with np.errstate(invalid="ignore"):
        u_rel = np.abs(U_t - U_m)[u_mask] / np.abs(U_t)[u_mask]
    assert np.nanmax(u_rel) < 0.008


@pytest.mark.parametrize("sza,vaz,tau,rho", [(23.0739, 90.0, 0.1, 0.0),
                                             (66.4218, 180.0, 0.5, 0.25)])
def test_rt_run_band_matches_jax_6sv1_model(sza, vaz, tau, rho):
    band = (np.full((1, 2), tau), np.ones((1, 2)), np.ones((1, 1, 2)), 0.0)
    surf = {"type": "LambertianSurfaceScalar", "albedo": rho}
    (R, T), (Rj, Tj) = _both("Stokes_IQUV", ("RadauQuad", 20, sza, VZA_16, 4),
                             band, VZA_16, [vaz] * 16, 3, surf)
    np.testing.assert_allclose(R, Rj, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(T, Tj, rtol=1e-10, atol=1e-14)


def test_rt_run_band_matches_jax_natraj_model():
    mu = np.array([0.02, 0.2, 0.52, 0.84, 1.0])
    vza = np.degrees(np.arccos(mu))
    band = (np.full((1, 2), 0.5), np.ones((1, 2)), np.ones((1, 1, 2)), 0.0)
    (R, T), (Rj, Tj) = _both(
        "Stokes_IQUV", ("RadauQuad", 20, np.degrees(np.arccos(0.2)), vza, 4),
        band, vza, [60.0] * 5, 3, LAMB0)
    np.testing.assert_allclose(R, Rj, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(T, Tj, rtol=1e-10, atol=1e-14)


def test_hdr_and_non_sfi_match_jax():
    """Multi-layer aerosol-free profile: the hemispheric outputs and the
    non-SFI synthesis through both packages."""
    rng = np.random.default_rng(4)
    n_z, n_spec = 3, 5
    tau_r = np.array([[0.02], [0.1], [0.3]]) * np.ones((1, n_spec))
    tau = tau_r + rng.uniform(0, 0.2, (n_z, n_spec))
    band = (tau, tau_r / tau, np.ones((n_z, 1, n_spec)), 0.03)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.25}
    quad = ("RadauQuad", 12, 40.0, [0.0, 30.0], 3)
    t, j = _both("Stokes_IQU", quad, band, [0.0, 30.0], [0.0, 60.0], 3,
                 surf, return_hdr=True)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    t, j = _both("Stokes_IQU", quad, band, [0.0, 30.0], [0.0, 60.0], 3,
                 surf, sfi=False)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


def test_spectral_albedo_and_schulz_match_jax():
    """Spectral Lambertian albedo, per-layer static schedules under the
    float64 Newton-Schulz solver (the torch engine's bucketed path)."""
    rng = np.random.default_rng(5)
    n_z, n_spec = 6, 4
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    band = (tau, tau_scat / tau, np.ones((n_z, 1, n_spec)), 0.028)
    surf = {"type": "LambertianSurfaceSpectrum",
            "albedo": np.linspace(0.05, 0.3, n_spec)}
    (R, T), (Rj, Tj) = _both(
        "Stokes_IQU", ("GaussQuadFullSphere", 10, 45.0, [0.0, 30.0], 3),
        band, [0.0, 30.0], [0.0, 90.0], 3, surf, solver="schulz")
    np.testing.assert_allclose(R, Rj, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(T, Tj, rtol=1e-10, atol=1e-14)


def test_kernel_engine_matches_jax_pallas_step():
    """Per-layer static schedules (the model of
    tests/test_pallas_doubling.py:187-209): the port's kernel engine
    (plain layer step on the CPU) vs JAX pallas_step_interpret, f32
    Newton-Schulz."""
    rng = np.random.default_rng(0)
    n_z, n_spec = 6, 8
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    band = (tau, tau_scat / tau, np.ones((n_z, 1, n_spec)), 0.028)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    quad = ("GaussQuadFullSphere", 10, 45.0, [0.0, 30.0], 3)
    min_mu = float(np.min(rt_set_streams(*quad).qp_mu))
    _, _, scheds = build_layer_schedules(tau, tau_scat / tau, min_mu,
                                         "schulz")
    assert scheds is not None and len(set(scheds)) >= 2
    R32, _ = rt_run_band(Polarization.from_name("Stokes_IQU"),
                         rt_set_streams(*quad), BandRTInputs(
                             tau=tau, omega=tau_scat / tau,
                             zw=np.ones((n_z, 1, n_spec)),
                             greeks=[get_greek_rayleigh(0.028)]),
                         [0.0, 30.0], [0.0, 90.0], 3, surf,
                         dtype=torch.float32, solver="schulz",
                         engine="kernel", device="cpu")
    Rj, _ = jax_rt_run_band(JaxPol.from_name("Stokes_IQU"),
                            jax_streams(*quad), JaxBand(
                                tau=tau, omega=tau_scat / tau,
                                zw=np.ones((n_z, 1, n_spec)),
                                greeks=[jax_greek(0.028)]),
                            [0.0, 30.0], [0.0, 90.0], 3, surf,
                            dtype=jnp.float32, solver="schulz",
                            doubling_engine="pallas_step_interpret")
    assert np.abs(R32 - Rj).max() / np.abs(Rj).max() < 1e-5


CUDA, CPU = torch.device("cuda"), torch.device("cpu")
#: per-layer (ndoubl, ns_schedule, ni) entries: one uniform bucket, two
#: buckets, a bucket whose schedule is shorter than its ndoubl, and no
#: static NS schedules (the lu solver; per-layer counts)
ONE_BUCKET = ((4, (0, 1, 2, 3), 4),) * 3
TWO_BUCKETS = ((4, (0, 0, 1, 2), 2),) * 2 + ((8, (0,) * 5 + (1, 2, 3), 4),)
SHORT_SCHEDULE = ((4, (0, 1, 2), 4),) + ((8, (0,) * 5 + (1, 2, 3), 4),)
NO_NS = ((4, None, None),) * 3
NO_STATIC = ((None, None, None),) * 3


def _select_under(transform, *args):
    """select_engine(*args) called inside ``transform`` ("jvp" or
    "vmap") of a function of one tensor."""
    picked = []

    def f(x):
        picked.append(select_engine(*args))
        return x * 2.0

    if transform == "jvp":
        torch.func.jvp(f, (torch.ones(2),), (torch.ones(2),))
    else:
        torch.func.vmap(f)(torch.ones(3, 2))
    return picked[0]


_JAX_NAMES = ("xla", "xla_dev", "pallas_dd", "pallas", "pallas_scan",
              "pallas_lanes")


@pytest.mark.parametrize("engine, device, dtype, n, schedules, precision, "
                         "want", [
    # auto: the fused layer scan where it runs the band as the kernel
    # engine would
    ("auto", CUDA, torch.float32, 12, ONE_BUCKET, "highest", "kernel_scan"),
    ("auto", CUDA, torch.float32, 30, TWO_BUCKETS, "highest", "kernel_scan"),
    ("auto", CUDA, torch.float32, 63, ONE_BUCKET, "highest", "kernel_scan"),
    # auto: the layer step at a reduced product mode or where a schedule
    # is not ndoubl steps long
    ("auto", CUDA, torch.float32, 12, ONE_BUCKET, "high", "kernel"),
    ("auto", CUDA, torch.float32, 12, ONE_BUCKET, "default", "kernel"),
    ("auto", CUDA, torch.float32, 30, SHORT_SCHEDULE, "highest", "kernel"),
    # auto beyond the kernels' N, off CUDA, off float32, without NS
    # schedules
    ("auto", CUDA, torch.float32, 64, ONE_BUCKET, "highest", "torch_dev"),
    ("auto", CUDA, torch.float64, 12, ONE_BUCKET, "highest", "torch"),
    ("auto", CUDA, torch.float32, 12, NO_NS, "highest", "torch"),
    ("auto", CUDA, torch.float32, 12, NO_STATIC, "highest", "torch"),
    ("auto", CPU, torch.float32, 12, ONE_BUCKET, "highest", "torch"),
    # explicit engines by their port names; the JAX names raise
    *((e, CPU, torch.float64, 12, ONE_BUCKET, "highest", e)
      for e in ENGINES),
    *((e, CPU, torch.float64, 12, ONE_BUCKET, "highest", ValueError)
      for e in _JAX_NAMES),
])
def test_engine_selection(engine, device, dtype, n, schedules, precision,
                          want):
    assert {"kernel_scan", "kernel_lanes"} <= set(ENGINES)
    if want is ValueError:
        with pytest.raises(ValueError):
            select_engine(engine, device, dtype, n, schedules, precision)
    else:
        assert select_engine(engine, device, dtype, n, schedules,
                             precision) == want


@pytest.mark.parametrize("transform", ["jvp", "vmap"])
def test_engine_selection_under_a_transform(transform):
    """Under an active torch.func transform auto keeps the layer step: the
    scan kernel has no forward rule."""
    args = ("auto", CUDA, torch.float32, 12, ONE_BUCKET)
    assert select_engine(*args) == "kernel_scan"
    assert _select_under(transform, *args) == "kernel"


def test_scan_takes_every_n_auto_gives_it():
    """auto's N bound for the kernels fits the scan kernel's arena too."""
    from vsmartmom_torch.core.rt_run import KERNEL_MAX_N
    from vsmartmom_torch.cuda import layer_scan_kernel as sk
    assert sk.max_n() >= KERNEL_MAX_N


def test_auto_choices_counts_each_call():
    """rt_run_band counts each call's resolution of auto (none for an
    explicit engine); clearing the dict resets it."""
    from vsmartmom_torch.core import rt_run as rtr
    quad = rt_set_streams("GaussQuadFullSphere", 2, 30.0, [0.0], 1)

    def run(engine):
        rt_run_band(Polarization.from_name("Stokes_I"), quad,
                    _rayleigh_band(0.1), [0.0], [0.0], 1, LAMB0,
                    device="cpu", engine=engine)

    rtr.auto_choices.clear()
    run("auto")
    run("auto")
    run("torch")
    assert rtr.auto_choices == {"torch": 2}
    rtr.auto_choices.clear()
    assert rtr.auto_choices == {}
    run("auto")
    assert rtr.auto_choices == {"torch": 1}


def test_schedule_builder_errors_propagate():
    """A failure of the schedule builder raises out of rt_run_band instead
    of handing the run to the per-layer-count torch path."""
    quad = rt_set_streams("GaussQuadFullSphere", 8, 30.0, [0.0], 1)
    band = BandRTInputs(tau=np.full((2, 3), 0.1), omega=np.ones((2, 4)),
                        zw=np.ones((2, 1, 3)), greeks=[get_greek_rayleigh(0.0)])
    with pytest.raises(ValueError):
        build_layer_schedules(band.tau, band.omega, 0.1, "schulz")
    with pytest.raises(ValueError):
        rt_run_band(Polarization.from_name("Stokes_I"), quad, band, [0.0],
                    [0.0], 1, LAMB0, dtype=torch.float32, solver="schulz",
                    device="cpu")


def test_rt_run_rejects_unported_runs():
    """rt_run refuses what the Raman path does not run: an unknown
    rs_type, an engine other than auto with Raman, and (rt_run_band_rrs)
    a surface other than LambertianSurfaceScalar; each before any work."""
    from vsmartmom_torch.core.api import rt_run
    from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
    from vsmartmom_torch.inelastic import make_rrs
    with pytest.raises(ValueError, match="unknown rs_type"):
        rt_run(None, rs_type="RRS_plus")
    for engine in ("kernel", "torch", "kernel_scan"):
        with pytest.raises(ValueError, match="engine"):
            rt_run(None, rs_type="RRS", engine=engine)
    grid = np.arange(12740.0, 13268.0, 24.0)
    band = BandRTInputs(tau=np.full((1, len(grid)), 0.1),
                        omega=np.ones((1, len(grid))),
                        zw=np.ones((1, 1, len(grid))),
                        greeks=[get_greek_rayleigh(0.03)])
    for surf in ({"type": "RossLiSurfaceScalar", "fiso": 0.1, "fvol": 0.0,
                  "fgeo": 0.0},
                 {"type": "LambertianSurfaceSpectrum",
                  "albedo": np.full(len(grid), 0.1)}):
        with pytest.raises(ValueError, match="LambertianSurfaceScalar"):
            rt_run_band_rrs(POL, rt_set_streams("GaussQuadFullSphere", 6,
                                                30.0, [0.0], 4),
                            band, make_rrs(grid), np.ones((1, len(grid))),
                            [0.0], [0.0], 1, surf, device="cpu")
