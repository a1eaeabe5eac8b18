"""Port's doubling-only kernel (plain version on the CPU) and the
kernel_doubling engine against the JAX package, and the kernel build's
source hashing.

JAX runs as its own tests run it: CPU, Pallas ``fused_doubling`` in
interpret mode. Tolerances are those of tests/test_pallas_doubling.py:
1e-6 of each field's max for the doubled layer (float32), and rtol 5e-6,
atol 1e-9 for whole float32 runs.
"""
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core.rt import ns_doubling_schedule
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.pallas.doubling_kernel import fused_doubling as jax_doubling
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core import rt as trt
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import doubling_kernel as dk
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)


def _fixture(S=40, n=16, nd=6, seed=0):
    """tests/test_pallas_doubling.py:_fixture (numpy, float32)."""
    rng = np.random.default_rng(seed)
    tau_scat, mqm = 0.5, 0.2
    sched = ns_doubling_schedule(tau_scat, mqm, nd)
    dtau = tau_scat / 2 ** nd
    r0 = rng.uniform(0, 1, (S, n, n)) * dtau / (n * mqm)
    t0 = (np.broadcast_to(np.eye(n) * np.exp(-dtau / mqm), (S, n, n)).copy()
          + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
    jp = rng.uniform(0, dtau, (S, n))
    jm = rng.uniform(0, dtau, (S, n))
    ek = np.full((S,), np.exp(-dtau / 0.7))
    return sched, [x.astype(np.float32) for x in (r0, t0, jp, jm, ek)]


# float32: products summed in another order by another library. On this
# fixture each package's float32 result is 5e-6 to 3e-5 of max from its
# float64 result, and the two float32 results are 2e-6 to 7e-6 apart, so the
# float32 bound is 1e-5; float64 pins the algebra, ragged S included.
BOUNDS = {"float32": 1e-5, "float64": 1e-12}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S,n,nd", [(40, 16, 6), (48, 16, 6), (37, 12, 8)],
                         ids=["S40-ragged", "S48", "S37N12"])
def test_fused_doubling_matches_jax_interpret(S, n, nd, dtype):
    """fused_doubling (plain version on the CPU) against JAX fused_doubling
    in interpret mode with 16-point blocks: S = 40 and 37 are ragged (JAX
    pads, the port's kernel masks)."""
    sched, arrays = _fixture(S, n, nd)
    ref = jax_doubling(*(jnp.asarray(x, getattr(jnp, dtype))
                         for x in arrays),
                       ns_schedule=sched, block_s=16, interpret=True)
    got = dk.fused_doubling(*(torch.as_tensor(x, dtype=getattr(torch, dtype))
                              for x in arrays), ns_schedule=sched)
    for name, a, b in zip(("r", "t", "jp", "jm"), ref, got):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == getattr(torch, dtype)
        d = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert d < BOUNDS[dtype], (name, d)


def test_fused_doubling_plain_is_the_torch_doubling():
    """The kernel's plain version and core.rt.doubling under the same
    schedule are the same products (float64)."""
    sched, arrays = _fixture(24, 12, 6)
    r, t, jp, jm, ek = (torch.as_tensor(x, dtype=torch.float64)
                        for x in arrays)
    eye = torch.eye(12, dtype=torch.float64).expand(24, 12, 12)
    ref = trt.doubling(r, t, jp, jm, ek, 6, eye, ns_schedule=sched)
    got = dk.fused_doubling(r, t, jp, jm, ek, ns_schedule=sched)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13,
                                   atol=1e-17)


def _uniform_band():
    """The model of tests/test_pallas_doubling.py:85-107."""
    rng = np.random.default_rng(1)
    n_spec, n_z = 24, 3
    tau_r = np.full((n_z, n_spec), 0.08)
    tau = tau_r + rng.uniform(0, 0.3, (n_z, n_spec))
    return tau, tau_r / tau, np.ones((n_z, 1, n_spec))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_doubling_engine_matches_jax_pallas_interpret(dtype):
    """The model of tests/test_pallas_doubling.py:85-107 through the
    kernel_doubling engine and JAX pallas_interpret. float32: within 1e-5
    of max R/T (the float32 floor, as above; elementwise the runs differ by
    up to rtol 5.3e-6); float64: 1e-10 of max."""
    tau, om, zw = _uniform_band()
    quad = ("GaussQuadFullSphere", 8, 45.0, [10.0], 3)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    R, T = rt_run_band(Polarization.from_name("Stokes_IQU"),
                       rt_set_streams(*quad),
                       BandRTInputs(tau=tau, omega=om, zw=zw,
                                    greeks=[get_greek_rayleigh(0.03)]),
                       [10.0], [30.0], 2, surf,
                       dtype=getattr(torch, dtype), device="cpu",
                       solver="schulz", engine="kernel_doubling")
    Rj, Tj = jax_rt_run_band(JaxPol.from_name("Stokes_IQU"),
                             jax_streams(*quad),
                             JaxBand(tau=tau, omega=om, zw=zw,
                                     greeks=[jax_greek(0.03)]),
                             [10.0], [30.0], 2, surf,
                             dtype=getattr(jnp, dtype), solver="schulz",
                             doubling_engine="pallas_interpret")
    bound = 1e-5 if dtype == "float32" else 1e-10
    assert np.abs(R - Rj).max() < bound * np.abs(Rj).max()
    assert np.abs(T - Tj).max() < bound * np.abs(Tj).max()


def test_kernel_doubling_engine_runs_every_scheduled_bucket():
    """On a spread profile the port runs the doubling kernel in every
    bucket (where JAX's pallas engine takes XLA doubling): the float64 run
    equals the torch engine at the same schedules."""
    rng = np.random.default_rng(5)
    n_z, n_spec = 6, 4
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.028)])
    args = (Polarization.from_name("Stokes_IQU"),
            rt_set_streams("GaussQuadFullSphere", 10, 45.0, [0.0, 30.0], 3),
            band, [0.0, 30.0], [0.0, 90.0], 2,
            {"type": "LambertianSurfaceScalar", "albedo": 0.2})
    calls = []
    real = dk.fused_doubling

    def counting(*a, **kw):
        calls.append(kw["ns_schedule"])
        return real(*a, **kw)

    dk.fused_doubling = counting
    try:
        R, _ = rt_run_band(*args, device="cpu", solver="schulz",
                           engine="kernel_doubling")
    finally:
        dk.fused_doubling = real
    assert len(calls) == 2 * n_z and len(set(calls)) >= 2
    R0, _ = rt_run_band(*args, device="cpu", solver="schulz",
                        engine="torch")
    np.testing.assert_allclose(R, R0, rtol=1e-12, atol=1e-16)


def test_doubling_kernel_arena_fits_hopper():
    for n in (1, 15, 44, 63):
        pts, smem, ld, team = dk.launch_config(n)
        assert pts >= 1 and smem <= build.MAX_SHARED_BYTES, (n, pts, smem)
        assert smem == 4 * pts * dk.arena_floats(n, ld) and team % 32 == 0


def test_added_layer_kernel_doubling_needs_a_schedule():
    with pytest.raises(ValueError, match="schedule"):
        trt.make_added_layer(*([None] * 15), None, ndoubl_static=None,
                             doubling_engine="kernel")


def test_library_name_hashes_headers(tmp_path, monkeypatch):
    """An edit of any file under csrc/, a header included, names a new
    library, so a stale build is never reused."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = build.source_digest()
    header = csrc / "rt_device.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.source_digest() != before
    assert "rt_device.cuh" in {p.name for p in csrc.iterdir()}
