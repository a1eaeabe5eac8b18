"""Port's lanes-layout layer step (plain version on the CPU) and the
kernel_lanes engine against the JAX package.

JAX runs as its own tests run it: the lanes body ``lanes_layer_step_math``
as plain jnp (tests/test_pallas_doubling.py:217), and the
``pallas_lanes_interpret`` engine end to end on its tiny case (:278).
Tolerances, each with its reason, sit beside the asserts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.pallas.lanes_kernel import lanes_layer_step_math
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core.rt import (LayerRT, doubling, interaction,
                                     make_rsolve, ns_doubling_schedule,
                                     vacuum_layer)
import vsmartmom_torch.core.rt_run as rtr
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import lanes_kernel as lk
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)


def _fixture(d_vec, S=24, nd=6, seed=3):
    """tests/test_pallas_doubling.py:217-254 in numpy (float64): a passive
    elemental slab (flipped space) and the composite of one earlier doubled
    layer under a vacuum, built with the port's float64 torch core."""
    n = len(d_vec)
    rng = np.random.default_rng(seed)
    tau_scat, mqm = 0.4, 0.15
    sched = ns_doubling_schedule(tau_scat, mqm, nd)
    dtau = tau_scat / 2 ** nd
    r0 = rng.uniform(0, 1, (S, n, n)) * dtau / (n * mqm)
    t0 = (np.broadcast_to(np.eye(n) * np.exp(-dtau / mqm), (S, n, n)).copy()
          + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
    jp0 = rng.uniform(0, dtau, (S, n))
    jm0 = rng.uniform(0, dtau, (S, n))
    ek = np.full((S,), np.exp(-dtau / 0.7))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    eye = torch.eye(n, dtype=torch.float64).expand(S, n, n)
    rs = make_rsolve("schulz", 4)
    rd, td, jpd, jmd = doubling(t(r0), t(t0), t(jp0), t(jm0), t(ek), nd,
                                eye, rsolve=rs, ns_schedule=sched)
    d = t(d_vec)
    r_mp = d[None, :, None] * rd
    sgn = d[None, :, None] * d[None, None, :]
    comp = interaction(vacuum_layer(S, n, torch.float64, "cpu"),
                       LayerRT(r_mp, sgn * r_mp, td, sgn * td, jpd,
                               d[None, :] * jmd), eye, rsolve=rs)
    comp_l = [x.numpy() for x in lk.to_lanes(comp)]
    elem_l = [r0.transpose(1, 2, 0), t0.transpose(1, 2, 0), jp0.T, jm0.T]
    return sched, comp_l, elem_l, ek


# float32: the bound the JAX test holds its body to against its XLA engine,
# 2e-5 of each field's max (measured here: 5.8e-6, products summed in another
# order by another library); float64 pins the algebra.
BOUNDS = {"float32": 2e-5, "float64": 1e-12}


@pytest.mark.parametrize("n", [15, 1, 16, 17, 33, 63, 72])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("stokes", ["I", "IQU"])
def test_lanes_plain_matches_jax_lanes_math(stokes, dtype, n):
    """lanes_layer_step_plain against JAX lanes_layer_step_math on the
    fixture of tests/test_pallas_doubling.py:217 (D = +1) and on an IQU slab
    whose D vector has -1 entries, at N = 15 (that fixture's width), the
    edges of the team kernel's width classes (1, 16, 17, 33, 63) and one
    width of the wide path (72). The plain version is the yardstick of both
    kernel paths on the card."""
    d_vec = (np.ones(n) if stokes == "I"
             else np.resize([1.0, 1.0, -1.0], n))
    sched, comp_l, elem_l, ek = _fixture(d_vec, S=24 if n == 15 else 6)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = lanes_layer_step_math(
        *(jnp.asarray(x, jdt) for x in comp_l + elem_l),
        jnp.asarray(ek, jdt).reshape(1, -1),
        jnp.asarray(d_vec, jdt).reshape(-1, 1), ns_schedule=sched, ni=4)
    got = lk.fused_layer_step_lanes(
        LayerRT(*(torch.as_tensor(x, dtype=tdt) for x in comp_l)),
        *(torch.as_tensor(x, dtype=tdt) for x in elem_l),
        torch.as_tensor(ek, dtype=tdt), torch.as_tensor(d_vec, dtype=tdt),
        ns_schedule=sched, ni=4)
    for name, a, b in zip(LayerRT._fields, ref, got):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == tdt
        rel = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert rel < BOUNDS[dtype], (name, rel)


@pytest.mark.parametrize("n", range(1, 64))
def test_team_arena_fits_hopper_shared_memory(n):
    """The team kernel's launch at every N it takes (<= 63) fits one
    block's 227 KB with the block's D diagonal and one arena per team, with
    teams of whole warps within the block's thread bound and named barriers,
    and a float4 row stride."""
    assert lk.team_path(n) and lk.TEAM_MAX_N == rtr.KERNEL_MAX_N
    cfg = lk.launch_config(n)
    assert cfg.smem_bytes == 4 * (build.round4(n)
                                  + cfg.points * lk.arena_floats(n, cfg.ld))
    assert cfg.points >= 1 and cfg.smem_bytes <= build.MAX_SHARED_BYTES
    assert cfg.team_threads == build.tile_class(n)[1]
    assert cfg.team_threads % 32 == 0
    assert cfg.points * cfg.team_threads <= build.MAX_BLOCK_THREADS
    assert cfg.team_threads == 32 or cfg.points <= 15   # bar.sync ids 1..15
    assert cfg.ld >= n and cfg.ld % 4 == 0


class _FakeLib:
    """Stands in for the kernel library: records each entry called and its
    arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vsm_lanes"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("n", [1, 15, 44, 63, 64, 72, 92, 136])
def test_width_dispatch_team_and_wide_paths(n, monkeypatch):
    """N <= 63 launches the team kernel (vsm_lanes) at its launch config;
    N > 63 the wide path (vsm_lanes_wide) at wide_launch_config. Neither
    allocates a workspace."""
    fake, S = _FakeLib(), 5
    monkeypatch.setattr(build, "lib", lambda: fake)
    allocs = []
    real_empty = torch.empty

    def counting_empty(*size, **kw):
        allocs.append(size)
        return real_empty(*size, **kw)

    monkeypatch.setattr(torch, "empty", counting_empty)
    m = real_empty((n, n, S))
    v = real_empty((n, S))
    ins = [m] * 4 + [v] * 2 + [m, m, v, v, real_empty(S), real_empty(n)]
    outs = [m] * 4 + [v] * 2
    assert lk._launch(ins, outs, (2, 3), 4, 0) == 0
    (name, args), = fake.calls
    assert not allocs
    if n <= 63:
        assert lk.team_path(n) and name == "vsm_lanes"
        pts, smem, ld, _ = lk.launch_config(n)
        assert args[18:21] == (S, n, ld) and args[22:] == (2, 4, pts, smem, 0)
        assert list(args[21]) == [2, 3]
    else:
        cfg = lk.wide_launch_config(n)
        assert not lk.team_path(n) and name == "vsm_lanes_wide"
        assert args[18:24] == (S, n, cfg.cluster, cfg.rows, cfg.ld,
                               cfg.threads)
        assert args[25:] == (2, 4, cfg.smem_bytes, 0)
        assert list(args[24]) == [2, 3]


@pytest.mark.parametrize("n", [64, 72, 92, 136])
def test_wide_launch_fits_hopper(n):
    """The wide path's launch at N = 64 (its first width), 72, 92 (the
    PureRayleighParameters.yaml streams) and 136 (Natraj, its widest):
    each CTA's arena within one block's 227 KB, a cluster of at most 8
    CTAs that all own rows (one CTA up to N = 96, then 2), whole
    warps within 1 024 threads and the kernel's launch bound, one thread
    per output tile of a CTA's rows (4 x 4, 8 x 4 in a cluster), and a
    float4 row stride."""
    cs, rows, ld, threads, smem = cfg = lk.wide_launch_config(n)
    assert smem == 4 * lk.wide_arena_floats(n, rows, ld)
    assert smem <= build.MAX_SHARED_BYTES
    assert cs <= 8 and cs == (1 if n <= 96 else 2)
    assert (cs - 1) * rows < n <= cs * rows
    assert cs == 1 or rows % 4 == 0
    k = lk.WIDE_CLUSTERS.index(cs)
    assert threads % 32 == 0
    assert threads <= min(1024, lk.WIDE_MAX_THREADS[k])
    assert threads >= -(-rows // lk.WIDE_TILE_ROWS[k]) * -(-n // 4)
    assert ld >= n and ld % 4 == 0
    assert cfg == lk.wide_launch_config(n)


def test_wide_path_refuses_wider_n(monkeypatch):
    """Beyond WIDE_MAX_N (136) the wide path raises ValueError naming the
    limit, before any launch; the constants mirror csrc/lanes.cu."""
    with open(build.CSRC + "/lanes.cu") as f:
        src = f.read()
    rows, most = lk.WIDE_TILE_ROWS, lk.WIDE_MAX_THREADS
    assert f"TM = CS == 1 ? {rows[0]} : {rows[1]}, TN = 4;" in src
    assert f"kThreads = CS == 1 ? {most[0]} : {most[1]};" in src
    assert f"constexpr int kWideVecs = {lk.WIDE_VECTORS};" in src
    for cs in lk.WIDE_CLUSTERS:
        assert f"lanes_wide_kernel<{cs}>" in src
    lk.wide_launch_config(lk.WIDE_MAX_N)
    with pytest.raises(ValueError, match="N <= 136"):
        lk.wide_launch_config(lk.WIDE_MAX_N + 1)
    fake, n = _FakeLib(), lk.WIDE_MAX_N + 1
    monkeypatch.setattr(build, "lib", lambda: fake)
    m, v = torch.empty((n, n, 1)), torch.empty((n, 1))
    with pytest.raises(ValueError, match="N <= 136"):
        lk._launch([m] * 4 + [v] * 2 + [m, m, v, v, torch.empty(1),
                                         torch.empty(n)],
                   [m] * 4 + [v] * 2, (1,), 1, 0)
    assert not fake.calls


#: the streams of tests/data/ref_yaml/PureRayleighParameters.yaml (RadauQuad,
#: l_trunc 20, sza 30, nine views, Stokes_IQUV): N = 92, the wide path
PURE_RAYLEIGH_STREAMS = ("RadauQuad", 20, 30.0,
                         [60.0, 45.0, 30.0, 15.0, 0.0, 15.0, 30.0, 45.0,
                          60.0], 4)


def test_lanes_plain_matches_jax_at_the_wide_width():
    """The plain version, the wide kernel's yardstick on the card, against
    JAX lanes_layer_step_math at N = 92 (S = 4, one composite layer, an
    IQUV D vector), float64: 1e-12 of each field's max, as BOUNDS pins the
    algebra."""
    d_vec = np.resize([1.0, 1.0, -1.0, -1.0], 92)
    sched, comp_l, elem_l, ek = _fixture(d_vec, S=4)
    ref = lanes_layer_step_math(
        *(jnp.asarray(x) for x in comp_l + elem_l),
        jnp.asarray(ek).reshape(1, -1), jnp.asarray(d_vec).reshape(-1, 1),
        ns_schedule=sched, ni=4)
    got = lk.fused_layer_step_lanes(
        LayerRT(*(torch.as_tensor(x) for x in comp_l)),
        *(torch.as_tensor(x) for x in elem_l), torch.as_tensor(ek),
        torch.as_tensor(d_vec), ns_schedule=sched, ni=4)
    for name, a, b in zip(LayerRT._fields, ref, got):
        a = np.asarray(a)
        rel = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert b.shape == a.shape and rel < BOUNDS["float64"], (name, rel)


def test_kernel_lanes_at_the_wide_width_equals_torch():
    """rt_run_band(engine="kernel_lanes") at the N = 92 streams (8 points,
    2 layers, 3 moments, float64, the schulz solver) against the torch
    engine at the same schedules, within 1e-10 of max R and max T: the
    engines differ only in how the interaction's second solve is reached
    (two NS solves against the push-through identity)."""
    rng = np.random.default_rng(0)
    tau_scat = np.array([[0.02], [0.05]]) * np.ones((1, 8))
    tau = tau_scat + rng.uniform(0.0, 0.5, (2, 8))
    pol = Polarization.from_name("Stokes_IQUV")
    quad = rt_set_streams(*PURE_RAYLEIGH_STREAMS)
    assert len(quad.qp_mu_n) == 92 and not lk.team_path(92)
    args = (pol, quad, BandRTInputs(tau=tau, omega=tau_scat / tau,
                                    zw=np.ones((2, 1, 8)),
                                    greeks=[get_greek_rayleigh(0.0)]),
            PURE_RAYLEIGH_STREAMS[3], [0.0] * 9, 3,
            {"type": "LambertianSurfaceScalar", "albedo": 0.15})
    R, T = rt_run_band(*args, device="cpu", solver="schulz",
                       engine="kernel_lanes")
    R0, T0 = rt_run_band(*args, device="cpu", solver="schulz",
                         engine="torch")
    assert np.abs(R - R0).max() <= 1e-10 * np.abs(R0).max()
    assert np.abs(T - T0).max() <= 1e-10 * np.abs(T0).max()


def test_lanes_layout_round_trip():
    rng = np.random.default_rng(0)
    comp = LayerRT(*(torch.as_tensor(rng.normal(size=(5, 4, 4)))
                     for _ in range(4)),
                   *(torch.as_tensor(rng.normal(size=(5, 4)))
                     for _ in range(2)))
    lanes = lk.to_lanes(comp)
    assert lanes.r_mp.shape == (4, 4, 5) and lanes.j_p.shape == (4, 5)
    assert all(x.is_contiguous() for x in lanes)
    assert lanes.t_pp[1, 2, 3] == comp.t_pp[3, 1, 2]
    assert lanes.j_m[2, 4] == comp.j_m[4, 2]
    back = lk.from_lanes(lanes)
    for a, b in zip(comp, back):
        assert b.is_contiguous() and torch.equal(a, b)


def _tiny_band():
    """The model of tests/test_pallas_doubling.py:278-302."""
    rng = np.random.default_rng(1)
    n_spec, n_z = 8, 2
    tau_r = np.array([[0.02], [0.2]]) * np.ones((1, n_spec))
    tau = tau_r + rng.uniform(0, 0.1, (n_z, n_spec))
    return tau, tau_r / tau, np.ones((n_z, 1, n_spec))


def test_kernel_lanes_engine_matches_jax_pallas_lanes():
    """End to end, float32: kernel_lanes (plain version) against JAX
    pallas_lanes_interpret at rtol 3e-5, atol 1e-9, the JAX test's own
    bound for its engine against XLA."""
    tau, om, zw = _tiny_band()
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    quad = ("GaussQuadFullSphere", 8, 45.0, [10.0], 1)
    R, T = rt_run_band(Polarization.from_name("Stokes_I"),
                       rt_set_streams(*quad),
                       BandRTInputs(tau=tau, omega=om, zw=zw,
                                    greeks=[get_greek_rayleigh(0.03)]),
                       [10.0], [30.0], 1, surf, dtype=torch.float32,
                       device="cpu", solver="schulz", engine="kernel_lanes")
    Rj, Tj = jax_rt_run_band(JaxPol.from_name("Stokes_I"),
                             jax_streams(*quad),
                             JaxBand(tau=tau, omega=om, zw=zw,
                                     greeks=[jax_greek(0.03)]),
                             [10.0], [30.0], 1, surf, dtype=jnp.float32,
                             solver="schulz",
                             doubling_engine="pallas_lanes_interpret")
    np.testing.assert_allclose(R, Rj, rtol=3e-5, atol=1e-9)
    np.testing.assert_allclose(T, Tj, rtol=3e-5, atol=1e-9)


@pytest.mark.parametrize("pol_name", ["Stokes_I", "Stokes_IQU"])
def test_kernel_lanes_equals_kernel_in_float64(pol_name):
    """float64, on the spread 6-layer profile of
    tests/test_pallas_doubling.py:178 (per-layer schedules): kernel_lanes
    against the kernel engine at the same schedules, within 1e-10 of max.
    The two interactions differ only in how the second solve is reached
    (two NS solves against the push-through identity), which agrees far
    below that bound at these schedules' residuals."""
    rng = np.random.default_rng(0)
    n_z, n_spec = 6, 8
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    pol = Polarization.from_name(pol_name)
    args = (pol, rt_set_streams("GaussQuadFullSphere", 10, 45.0,
                                [0.0, 30.0], pol.n),
            BandRTInputs(tau=tau, omega=tau_scat / tau,
                         zw=np.ones((n_z, 1, n_spec)),
                         greeks=[get_greek_rayleigh(0.028)]),
            [0.0, 30.0], [0.0, 90.0], 2,
            {"type": "LambertianSurfaceScalar", "albedo": 0.2})
    R, T = rt_run_band(*args, device="cpu", solver="schulz",
                       engine="kernel_lanes")
    R0, T0 = rt_run_band(*args, device="cpu", solver="schulz",
                         engine="kernel")
    assert np.abs(R - R0).max() <= 1e-10 * np.abs(R0).max()
    assert np.abs(T - T0).max() <= 1e-10 * np.abs(T0).max()


def test_lanes_wrapper_refuses_other_devices():
    comp = lk.to_lanes(vacuum_layer(2, 3, torch.float32, "meta"))
    m = torch.empty((3, 3, 2), device="meta")
    v = torch.empty((3, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lk.fused_layer_step_lanes(comp, m, m, v, v,
                                  torch.empty(2, device="meta"),
                                  torch.empty(3, device="meta"),
                                  ns_schedule=(1,), ni=1)
