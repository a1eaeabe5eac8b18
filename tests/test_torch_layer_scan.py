"""Port's fused layer-scan kernel (plain version on the CPU), the kernel_scan
engine and the bucketed-engine check against the JAX package.

JAX runs as its own tests run it: CPU, Pallas ``fused_layer_scan`` in
interpret mode (``pallas_scan_interpret`` end to end). Tolerances, each with
its reason, sit beside the asserts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core.rt import LayerRT as JaxLayerRT
from vsmartmom.core.rt import vacuum_layer as jax_vacuum_layer
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.pallas.layer_scan_kernel import fused_layer_scan as jax_scan
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

import vsmartmom_torch.core.rt_run as rtr
from vsmartmom_torch.check_bucketed import run_check
from vsmartmom_torch.core.rt import (LayerRT, ns_doubling_schedule,
                                     vacuum_layer)
from vsmartmom_torch.core.rt_run import (BandRTInputs, build_layer_schedules,
                                         rt_run_band)
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import layer_scan_kernel as sk
from vsmartmom_torch.scattering.phase import (Polarization, compute_Z_moments,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

from test_torch_layer_step import check_team_launch

torch.set_num_threads(2)

SURF = {"type": "LambertianSurfaceScalar", "albedo": 0.2}


def _bucket(m, n_z=3, S=24, nd=6, seed=0):
    """One bucket of IQU layers (N = 15) with two distinct scattering
    components (Rayleigh at depolarization 0.03 and 0.3) in random
    proportions, at Fourier moment m; numpy float64 arrays."""
    rng = np.random.default_rng(seed)
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [10.0], pol.n)
    n = len(quad.qp_mu_n)
    zs = [compute_Z_moments(pol, quad.qp_mu, get_greek_rayleigh(dp), m)
          for dp in (0.03, 0.3)]
    tau_scat = rng.uniform(0.05, 0.3, (n_z, S))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, S))
    zw = rng.uniform(0.2, 1.0, (n_z, 2, S))
    zw /= zw.sum(axis=1, keepdims=True)
    i0 = np.zeros(n)
    i0[quad.i_mu0_n:quad.i_mu0_n + pol.n] = pol.i0
    arrays = dict(
        tau=tau, omega=tau_scat / tau, zw=zw,
        tau_sum=np.cumsum(np.concatenate([np.zeros((1, S)), tau]), 0)[:n_z],
        z_pp_c=np.stack([z[0] for z in zs]),
        z_mp_c=np.stack([z[1] for z in zs]),
        qp=quad.qp_mu_n, wct2=quad.wt_mu_n / (2.0 if m == 0 else 4.0),
        i0_vec=i0, d_vec=np.tile(pol.d, quad.n_quad))
    statics = dict(ns_schedule=ns_doubling_schedule(
        float(tau_scat.max()), float(np.min(quad.qp_mu)), nd),
        i_mu0_n=quad.i_mu0_n, n_stokes=pol.n, inter_iters=4)
    scalars = (float(quad.mu0), float(quad.qp_mu_n[quad.i_mu0_n]),
               0.5 if m == 0 else 0.25)
    return arrays, scalars, statics


def _run_both(comp_np, arrays, scalars, statics):
    """fused_layer_scan through JAX (interpret, 16-point blocks: S = 24 is
    ragged) and through the port (plain version), float32."""
    jx = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    ref = jax_scan(JaxLayerRT(*(jnp.asarray(x, jnp.float32)
                                for x in comp_np)),
                   jx["tau"], jx["omega"], jx["zw"], jx["tau_sum"],
                   jx["z_pp_c"], jx["z_mp_c"], jx["qp"], jx["wct2"],
                   jx["i0_vec"], jx["d_vec"], *scalars, block_s=16,
                   interpret=True, **statics)
    tx = {k: torch.as_tensor(v, dtype=torch.float32)
          for k, v in arrays.items()}
    got = sk.fused_layer_scan(
        LayerRT(*(torch.as_tensor(x, dtype=torch.float32) for x in comp_np)),
        tx["tau"], tx["omega"], tx["zw"], tx["tau_sum"], tx["z_pp_c"],
        tx["z_mp_c"], tx["qp"], tx["wct2"], tx["i0_vec"], tx["d_vec"],
        *scalars, **statics)
    return ref, got


@pytest.mark.parametrize("composite", ["vacuum", "layered"])
def test_scan_plain_matches_jax_interpret(composite):
    """The plain version against JAX's kernel in interpret mode, float32,
    S = 24, IQU, K = 2, under a vacuum composite (moment 0) and under the
    composite of two earlier JAX-scanned layers (moment 1). Bound 1e-5 of
    each field's max, the float32 bound of the doubling tests
    (test_torch_doubling.py): besides another library's summation order,
    the TPU kernel's Taylor expm1 and its t M association (the port doubles
    as t (M X)) round differently (measured: 1.7e-6)."""
    m = 0 if composite == "vacuum" else 1
    arrays, scalars, statics = _bucket(m)
    S, n = arrays["tau"].shape[1], arrays["qp"].shape[0]
    comp = [np.array(x, np.float64) for x in jax_vacuum_layer(S, n,
                                                                jnp.float64)]
    if composite == "layered":
        above, _, st_above = _bucket(m, n_z=2, seed=1)
        ref_above, _ = _run_both(comp, above, scalars, st_above)
        comp = [np.array(x) for x in ref_above]
    ref, got = _run_both(comp, arrays, scalars, statics)
    for name, a, b in zip(LayerRT._fields, ref, got):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == torch.float32
        rel = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert rel < 1e-5, (name, rel)


def _spread_band():
    """The bucketed model of tests/test_pallas_doubling.py:135-175."""
    rng = np.random.default_rng(5)
    n_z, n_spec = 6, 8
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    return tau, tau_scat / tau, np.ones((n_z, 1, n_spec))


def _uniform_band():
    """The model of tests/test_pallas_doubling.py:110-132."""
    rng = np.random.default_rng(2)
    n_spec, n_z = 24, 3
    tau_r = np.full((n_z, n_spec), 0.08)
    tau = tau_r + rng.uniform(0, 0.3, (n_z, n_spec))
    return tau, tau_r / tau, np.ones((n_z, 1, n_spec))


def _port(band, engine, dtype):
    tau, om, zw = band
    return rt_run_band(Polarization.from_name("Stokes_IQU"),
                       rt_set_streams("GaussQuadFullSphere", 8, 45.0, [10.0],
                                      3),
                       BandRTInputs(tau=tau, omega=om, zw=zw,
                                    greeks=[get_greek_rayleigh(0.03)]),
                       [10.0], [30.0], 2, SURF, dtype=dtype, device="cpu",
                       solver="schulz", engine=engine)


def _jax(band, engine, dtype=jnp.float32):
    tau, om, zw = band
    return jax_rt_run_band(JaxPol.from_name("Stokes_IQU"),
                           jax_streams("GaussQuadFullSphere", 8, 45.0,
                                       [10.0], 3),
                           JaxBand(tau=tau, omega=om, zw=zw,
                                   greeks=[jax_greek(0.03)]),
                           [10.0], [30.0], 2, SURF, dtype=dtype,
                           solver="schulz", doubling_engine=engine)


@pytest.mark.parametrize("model", ["uniform", "bucketed"])
def test_kernel_scan_engine_matches_jax_pallas_scan(model):
    """End to end, float32: kernel_scan (plain version) against JAX
    pallas_scan_interpret, at the bounds the JAX tests hold that engine to
    against XLA: rtol 5e-6, atol 1e-9 on the uniform model (:131) and 5e-5
    of max R/T on the bucketed one (:172), where the Taylor expm1 compounds
    over a 12-step doubling (measured: 3e-7 elementwise on both)."""
    band = _uniform_band() if model == "uniform" else _spread_band()
    if model == "bucketed":
        tau, om, _ = band
        min_mu = float(np.min(rt_set_streams("GaussQuadFullSphere", 8, 45.0,
                                             [10.0], 3).qp_mu))
        _, _, scheds = build_layer_schedules(tau, om, min_mu, "schulz")
        assert scheds is not None and len({s[:2] for s in scheds}) >= 2
    R, T = _port(band, "kernel_scan", torch.float32)
    Rj, Tj = _jax(band, "pallas_scan_interpret")
    if model == "uniform":
        np.testing.assert_allclose(R, Rj, rtol=5e-6, atol=1e-9)
        np.testing.assert_allclose(T, Tj, rtol=5e-6, atol=1e-9)
    else:
        assert np.abs(R - Rj).max() < 5e-5 * np.abs(Rj).max()
        assert np.abs(T - Tj).max() < 5e-5 * np.abs(Tj).max()


def test_scan_plain_is_the_torch_engine_in_float64():
    """float64 pins the algebra: the plain scan equals the torch engine at
    the same schedules (Z mixing, elemental, doubling and the schulz
    two-solve interaction are the same operations), within 1e-10 of max."""
    band = _spread_band()
    R, T = _port(band, "kernel_scan", torch.float64)
    R0, T0 = _port(band, "torch", torch.float64)
    assert np.abs(R - R0).max() <= 1e-10 * np.abs(R0).max()
    assert np.abs(T - T0).max() <= 1e-10 * np.abs(T0).max()


def test_kernel_scan_refuses_a_bucket_whose_schedule_misses_its_ndoubl():
    """The scan doubles len(schedule) times: a bucket entry whose ndoubl
    differs raises instead of running another discretization."""
    S, dt = 3, torch.float64
    geom = rtr.geometry(Polarization.from_name("Stokes_I"),
                        rt_set_streams("GaussQuadFullSphere", 4, 30.0, [0.0],
                                       1), dt, "cpu")
    n = geom.qp.shape[0]
    args = [torch.full((1, S), 0.1, dtype=dt), torch.ones((1, S), dtype=dt),
            torch.ones((1, 1, S), dtype=dt),
            torch.zeros((1, n, n), dtype=dt), torch.zeros((1, n, n),
                                                          dtype=dt),
            geom, torch.zeros((), dtype=dt), None]
    with pytest.raises(ValueError, match="ndoubl"):
        rtr._fourier_step(*args, m=0, solver="schulz",
                          layer_schedules=((3, (1, 1), 2),),
                          engine="kernel_scan")


@pytest.mark.parametrize("n", range(1, 65))
def test_scan_arena_fits_hopper_up_to_its_largest_n(n):
    """The per-point arena takes the headline N = 44 and every N up to
    max_n() = 64, with whole warps per team and tiles that cover the n x n
    and n x (2n+1) products; the wrapper refuses beyond."""
    assert sk.max_n() == 64
    cfg = sk.launch_config(n)
    check_team_launch(n, cfg, (n, 2 * n + 1, 2 * n + 2))
    assert cfg.smem_bytes == 4 * cfg.points * sk.arena_floats(n, cfg.ld)
    assert 4 * sk.arena_floats(sk.max_n() + 1, sk.max_n() + 1) \
        > build.MAX_SHARED_BYTES


def test_scan_wrapper_refuses_other_devices():
    comp = vacuum_layer(2, 3, torch.float32, "meta")
    x = torch.empty((1, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.fused_layer_scan(comp, x, x, x, x, x, x, x, x, x, x, 0.5, 0.5,
                            0.5, ns_schedule=(1,), i_mu0_n=0, n_stokes=1,
                            inter_iters=1)


def test_check_bucketed_on_the_cpu():
    """The bucketed check at a small size on the CPU: every kernel engine
    (plain versions) within its 6e-3 gate of the torch engine at most 6
    schedule entries, and none engaged, since no kernel launches on the
    CPU; so ok is false here and needs the card."""
    out = run_check(n_spec=16, max_m=2, device="cpu")
    assert out["bucket_cap_ok"] and out["n_schedule_buckets"] >= 2
    assert out["torch_launched_kernels"] == []
    for engine in ("kernel", "kernel_scan", "kernel_lanes"):
        assert out[f"{engine}_max_rel_diff_vs_torch"] < 6e-3
        assert out[f"{engine}_launches"] == 0
        assert out[f"{engine}_engaged"] is False
    assert out["ok"] is False
