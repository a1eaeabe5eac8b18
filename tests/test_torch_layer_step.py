"""Port's fused layer step (kernel 1) and RT core against the JAX package.

The port's wrapper takes its plain torch version for CPU tensors; the JAX
side runs its Pallas kernel in interpret mode. Both in float64, so the two
differ only by the summation order of the batched matmuls: the bound is
max|diff| / max|ref| < 1e-12.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core import rt as jrt
from vsmartmom.pallas.layer_step_kernel import fused_layer_step as jax_step

import vsmartmom_torch.core.rt_run as rtr
from vsmartmom_torch.core import rt as trt
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda.layer_step_kernel import (arena_floats,
                                                    fused_layer_step,
                                                    launch_config)

torch.set_num_threads(2)

F64_BOUND = 1e-12


def _elemental(S, n, nd, seed, tau_scat=0.5, mqm=0.2):
    """Passive elemental-like slab (sub-stochastic r, t ~ attenuated I), as
    tests/test_pallas_doubling.py:_fixture builds it."""
    rng = np.random.default_rng(seed)
    sched = jrt.ns_doubling_schedule(tau_scat, mqm, nd)
    dtau = tau_scat / 2 ** nd
    r0 = rng.uniform(0, 1, (S, n, n)) * dtau / (n * mqm)
    t0 = (np.broadcast_to(np.eye(n) * np.exp(-dtau / mqm), (S, n, n)).copy()
          + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
    jp = rng.uniform(0, dtau, (S, n))
    jm = rng.uniform(0, dtau, (S, n))
    ek = np.full((S,), np.exp(-dtau / 0.7))
    return sched, r0, t0, jp, jm, ek


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


# (S, N, D pattern, nd, ns_schedule override, ni): the doubling fixture of
# test_pallas_doubling.py (N = 16), Stokes_I at N = 12 and at the flagship's
# N = 15, polarized signs, ragged S, zero-iteration schedules
CASES = [
    (40, 16, (1.0,), 6, None, 4),
    (40, 15, (1.0,), 12, None, 3),
    (40, 16, (1.0, 1.0, -1.0, -1.0), 6, None, 2),
    (40, 12, (1.0,), 8, None, 4),
    (37, 12, (1.0,), 4, (0, 0, 1, 2), 0),
    (40, 12, (1.0, 1.0, -1.0), 5, (4, 4, 4, 4, 4), 1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"S{c[0]}N{c[1]}"
                         f"d{len(c[2])}nd{c[3]}ni{c[5]}")
def test_fused_layer_step_matches_jax_interpret(case):
    S, n, dpat, nd, sched_override, ni = case
    sched, r0, t0, jp, jm, ek = _elemental(S, n, nd, seed=n + nd)
    if sched_override is not None:
        sched = sched_override
    d = np.tile(dpat, n // len(dpat))
    # a non-trivial composite: two JAX layer steps from vacuum
    comp = jrt.vacuum_layer(S, n, jnp.float64)
    for scale, it in ((1.0, 4), (0.6, 3)):
        comp = jax_step(comp, jnp.asarray(r0 * scale), jnp.asarray(t0),
                        jnp.asarray(jp), jnp.asarray(jm), jnp.asarray(ek), d,
                        ns_schedule=sched, ni=it, interpret=True)
    ref = jax_step(comp, jnp.asarray(r0 * 0.8), jnp.asarray(t0),
                   jnp.asarray(jp), jnp.asarray(jm), jnp.asarray(ek), d,
                   ns_schedule=sched, ni=ni, interpret=True)
    got = fused_layer_step(trt.LayerRT(*(_t(x) for x in comp)),
                           _t(r0 * 0.8), _t(t0), _t(jp), _t(jm), _t(ek),
                           _t(d), ns_schedule=sched, ni=ni)
    for name, a, b in zip(trt.LayerRT._fields, ref, got):
        assert b.shape == np.asarray(a).shape
        assert _rel(a, b.numpy()) < F64_BOUND, (name, _rel(a, b.numpy()))


@pytest.mark.parametrize("sched", [None, "schulz"])
def test_doubling_matches_jax(sched):
    S, n, nd = 24, 12, 6
    ns, r0, t0, jp, jm, ek = _elemental(S, n, nd, seed=7)
    eye_j = jnp.broadcast_to(jnp.eye(n), (S, n, n))
    eye_t = torch.eye(n, dtype=torch.float64).expand(S, n, n)
    kw_j = dict(rsolve=jrt.rsolve_lu)
    kw_t = dict(rsolve=trt.rsolve_lu)
    if sched == "schulz":
        kw_j = dict(rsolve=jrt.make_rsolve("schulz"), ns_schedule=ns)
        kw_t = dict(rsolve=trt.make_rsolve("schulz"), ns_schedule=ns)
    ref = jrt.doubling(jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(jp),
                       jnp.asarray(jm), jnp.asarray(ek), nd, eye_j, **kw_j)
    got = trt.doubling(_t(r0), _t(t0), _t(jp), _t(jm), _t(ek), nd, eye_t,
                       **kw_t)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_interaction_matches_jax(solver):
    S, n, nd = 24, 12, 5
    ns, r0, t0, jp, jm, ek = _elemental(S, n, nd, seed=11)
    rng = np.random.default_rng(12)
    eye_j = jnp.broadcast_to(jnp.eye(n), (S, n, n))
    eye_t = torch.eye(n, dtype=torch.float64).expand(S, n, n)
    comp = [r0 * 3.0, r0.transpose(0, 2, 1) * 2.0, t0 * 0.9, t0 * 0.8,
            jp * 2.0, jm * 3.0]
    added = [r0, r0 * 0.5, t0, t0 * 0.95, jp,
             jm + rng.uniform(0, 1e-3, jm.shape)]
    ref = jrt.interaction(jrt.LayerRT(*map(jnp.asarray, comp)),
                          jrt.LayerRT(*map(jnp.asarray, added)), eye_j,
                          rsolve=jrt.make_rsolve(solver))
    got = trt.interaction(trt.LayerRT(*map(_t, comp)),
                          trt.LayerRT(*map(_t, added)), eye_t,
                          rsolve=trt.make_rsolve(solver))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-15)


def test_schedule_helpers_match_jax():
    assert trt.ns_doubling_schedule(0.7, 0.05, 9) == \
        jrt.ns_doubling_schedule(0.7, 0.05, 9)
    tau = [1e-4, 1e-3, 0.01, 0.3, 1.0]
    assert trt.ns_interaction_iters(tau, 0.07) == \
        jrt.ns_interaction_iters(tau, 0.07)
    for b in (0.0, 0.1, 0.64, 0.99, 1.0):
        assert trt.ns_iters_for_bound(b) == jrt.ns_iters_for_bound(b)


def _tile_cover(n, k, cls):
    """Every (i, j) of an n x k product that the team kernels' tiles store
    (rows rg + r RG, columns c0 + cg TN + c of thread (rg, cg), as
    csrc/rt_device.cuh:mm maps them), with repeats."""
    np_, tt, tm, tn = cls
    rg_n, cg_n = np_ // tm, tt // (np_ // tm)
    out = []
    for t in range(tt):
        rg, cg = divmod(t, cg_n)
        for c0 in range(0, k, cg_n * tn):
            out += [(rg + r * rg_n, c0 + cg * tn + c)
                    for r in range(tm) for c in range(tn)
                    if rg + r * rg_n < n and c0 + cg * tn + c < k]
    return out


def check_team_launch(n, cfg, widths):
    """A team launch at width n fits one block's 227 KB, has a team of
    whole warps within the block's thread bound and named barriers, and its
    tiles store every output of each product width exactly once."""
    cls = build.tile_class(n)
    assert cls[0] >= n and cfg.team_threads == cls[1]
    assert cfg.team_threads % 32 == 0
    assert cfg.points >= 1 and cfg.smem_bytes <= build.MAX_SHARED_BYTES
    assert cfg.points * cfg.team_threads <= build.MAX_BLOCK_THREADS
    assert cfg.team_threads == 32 or cfg.points <= 15   # bar.sync ids 1..15
    # float4 rows: ld a multiple of 4, and 4 mod 8 (distinct banks) unless
    # that arena would not fit
    assert n <= cfg.ld < n + 8 and cfg.ld % 4 == 0
    assert cfg.ld % 8 == 4 or cfg.ld == build.round4(n)
    for k in widths:
        cover = _tile_cover(n, k, cls)
        assert len(cover) == n * k and set(cover) == {
            (i, j) for i in range(n) for j in range(k)}, (n, k)


@pytest.mark.parametrize("n", range(1, 64))
def test_launch_config_fits_hopper_shared_memory(n):
    """Every N the kernel takes (<= 63) fits one block's 227 KB, with whole
    warps per team and tiles that cover the n x n, n x (2n+1) and
    n x (4n+2) products; the engine's bound is unchanged."""
    assert rtr.KERNEL_MAX_N == 63
    cfg = launch_config(n)
    check_team_launch(n, cfg, (n, 2 * n + 1, 2 * n + 2, 4 * n + 2))
    assert cfg.smem_bytes == 4 * (build.round4(n)
                                  + cfg.points * arena_floats(n, cfg.ld))


def test_tile_classes_match_the_cuda_header():
    """build.DEV_TILE_CLASSES (TILE_CLASSES and the split-form step's fifth
    class) and MAX_BLOCK_THREADS are the Cfg<...> classes and kMaxBlock of
    csrc/rt_device.cuh."""
    with open(os.path.join(build.CSRC, "rt_device.cuh")) as f:
        src = f.read()
    found = tuple(tuple(int(x) for x in m) for m in re.findall(
        r"using C\d+ = Cfg<(\d+), (\d+), (\d+), (\d+)>;", src))
    assert found == build.DEV_TILE_CLASSES
    assert build.DEV_TILE_CLASSES[:-1] == build.TILE_CLASSES
    assert f"constexpr int kMaxBlock = {build.MAX_BLOCK_THREADS};" in src
