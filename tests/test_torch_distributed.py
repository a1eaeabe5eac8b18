"""The port's multi-process layer (vsmartmom_torch/parallel/distributed.py)
and its scaling harness (vsmartmom_torch/scaling_bench.py) on the CPU,
mirroring tests/test_distributed.py.

The two-process run joins a gloo group on 127.0.0.1 at a free port, each
rank on the CPU with a wall-clock limit, and must equal the single run of
the same 32-point band (rtol 1e-12, atol 1e-15; float64, LU).
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vsmartmom_torch.parallel import distributed as dist

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: torch's rendezvous variables, cleared so that a test run is one process
TORCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK", "VSMARTMOM_MULTIHOST")


@pytest.fixture
def one_process(monkeypatch):
    for k in TORCH_ENV:
        monkeypatch.delenv(k, raising=False)


def test_init_multihost_single_process_noop(one_process):
    """Without an address or VSMARTMOM_MULTIHOST=1 this stays a one-process
    run, and a second call says the same."""
    assert dist.init_multihost() is False
    assert dist.init_multihost() is False
    assert dist.world_size() == 1 and dist.rank() == 0


def test_global_spectral_devices_and_slice(one_process):
    assert dist.global_spectral_devices("cpu") == [torch.device("cpu")]
    # one process owns the whole axis; of 8 processes, rank 0 the first 8th
    assert dist.process_spectral_slice(64) == (0, 64)
    assert dist.process_spectral_slice(64, 8) == (0, 8)
    assert dist.process_spectral_slice(64, ["cpu"] * 4) == (0, 16)


def test_process_slice_divisibility_error(one_process):
    with pytest.raises(ValueError, match="divisible"):
        dist.process_spectral_slice(65, 2)


def test_global_spectral_array_single_process(one_process):
    x = np.arange(32.0).reshape(2, 16)
    np.testing.assert_array_equal(dist.global_spectral_array(x, axis=1), x)


def test_scaling_harness_runs(one_process):
    """The weak-scaling harness runs on ["cpu"] * 8 and reports 1, 2, 4, 8
    devices with finite throughput, and the overhead record."""
    from vsmartmom_torch import scaling_bench as sb
    out = sb.main(["cpu"] * 8, spec_per_dev=32, reps=1)
    assert [r["n_devices"] for r in out["rows"]] == [1, 2, 4, 8]
    assert all(r["pts_per_s"] > 0 for r in out["rows"])
    assert all(np.isfinite(r["scaling_efficiency"]) for r in out["rows"])
    po = out["partition_overhead"]
    assert po["n_shards"] == 8 and po["n_spec"] == 256
    assert np.isfinite(po["overhead_frac"])


_RANK = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from vsmartmom_torch.core.rt_run import BandRTInputs
from vsmartmom_torch.parallel import distributed as dist
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.quadrature import rt_set_streams
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert dist.init_multihost(addr, 2, rank) is True
assert dist.init_multihost() is True
assert dist.global_spectral_devices("cpu") == [torch.device("cpu")] * 2
lo, hi = dist.process_spectral_slice(64)
assert (lo, hi) == (32 * rank, 32 * rank + 32)
x = np.arange(128.0).reshape(2, 64)
np.testing.assert_array_equal(
    dist.global_spectral_array(x[:, lo:hi], axis=1), x)
d = np.load(out + ".in.npz")
pol = Polarization.from_name("Stokes_IQU")
quad = rt_set_streams("GaussQuadFullSphere", 10, 45.0, [0.0, 30.0], pol.n)
band = BandRTInputs(tau=d["tau"], omega=d["omega"], zw=d["zw"],
                    greeks=[get_greek_rayleigh(0.028)])
R, T = dist.rt_run_band_distributed(
    pol, quad, band, [0.0, 30.0], [0.0, 90.0], 3,
    {"type": "LambertianSurfaceScalar", "albedo": 0.2}, device="cpu")
np.savez(f"{out}.{rank}.npz", R=R, T=T)
from vsmartmom_torch import scaling_bench
rec = scaling_bench.main(["cpu"], spec_per_dev=16, reps=1)
assert rec["process_count"] == 2
assert [r["n_devices"] for r in rec["rows"]] == [1, 2]
assert all(r["pts_per_s"] > 0 for r in rec["rows"])
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_single(one_process, tmp_path):
    """Two gloo ranks each run half of a 32-point band; both gather the
    whole R and T, equal to the single run. The scaling harness then runs
    across the two ranks (rows for 1 and 2 processes)."""
    from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    rng = np.random.default_rng(0)
    tau_scat = np.full((3, 32), 0.1)
    tau = tau_scat + rng.uniform(0.0, 0.5, (3, 32))
    omega, zw = tau_scat / tau, np.ones((3, 1, 32))
    out = str(tmp_path / "run")
    np.savez(out + ".in.npz", tau=tau, omega=omega, zw=zw)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, addr, str(r),
                               out], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            errs.append((p.returncode, err[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs

    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 45.0, [0.0, 30.0],
                          pol.n)
    R, T = rt_run_band(pol, quad, BandRTInputs(
        tau=tau, omega=omega, zw=zw, greeks=[get_greek_rayleigh(0.028)]),
        [0.0, 30.0], [0.0, 90.0], 3,
        {"type": "LambertianSurfaceScalar", "albedo": 0.2}, device="cpu")
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        np.testing.assert_allclose(got["R"], R, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got["T"], T, rtol=1e-12, atol=1e-15)
