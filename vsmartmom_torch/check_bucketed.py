"""Check of the bucketed kernel engines on a heterogeneous profile.

The shape is the one the JAX package's check uses (Stokes-I, 34 layers,
2048 spectral points, heterogeneous tau): its per-layer schedules split the
layer scan into schedule buckets. The kernel, kernel_scan and kernel_lanes
engines run it in float32 with the Newton-Schulz solver beside the torch
engine at the same schedules.

For each kernel engine the check reports whether the engine was engaged:
its kernel's launch counter moved during the engine's runs and no other
kernel's counter did (the wrappers count only launches on CUDA tensors, so
on the CPU no engine is engaged). It also reports the number of distinct
schedule entries (at most 6), each engine's first and steady seconds, and
its largest difference from the torch engine relative to
max(|R|, 1e-3 max |R|). ``ok`` needs every engine engaged, every difference
below 6e-3 (the 6SV1 gate) and finite radiances.

Run on the card:  python3 -m vsmartmom_torch.check_bucketed [nSpec]
It prints one JSON line.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from vsmartmom_torch.core.rt_run import (BandRTInputs, build_layer_schedules,
                                         rt_run_band)
from vsmartmom_torch.cuda import (doubling_kernel, lanes_kernel,
                                  layer_scan_kernel, layer_step_dev_kernel,
                                  layer_step_kernel)
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.quadrature import rt_set_streams

#: each kernel engine and the module whose launches it counts
KERNEL_ENGINES = {"kernel": layer_step_kernel,
                  "kernel_scan": layer_scan_kernel,
                  "kernel_lanes": lanes_kernel}
#: every layer kernel's launch counter, each engine's and the others'
_COUNTED = {**KERNEL_ENGINES, "kernel_dev": layer_step_dev_kernel,
            "kernel_doubling": doubling_kernel}


def heterogeneous_band(n_z=34, n_spec=2048, seed=0) -> BandRTInputs:
    """Flagship-like tau profile: thin stratosphere over thick low layers,
    with strong spectral structure (absorption lines)."""
    rng = np.random.default_rng(seed)
    # Rayleigh-like scattering tau: exponential in layer index
    tau_scat = 0.25 * np.exp(np.linspace(-8.0, 0.0, n_z))[:, None] \
        * np.ones((1, n_spec))
    # absorption: random "lines" spanning 4 orders of magnitude
    tau_abs = (tau_scat * 0.1
               + np.exp(rng.uniform(-9.0, 2.0, (n_z, n_spec))) * 0.05)
    tau = tau_scat + tau_abs
    return BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.028)])


def _counts():
    return {e: m.launches for e, m in _COUNTED.items()}


def run_check(n_spec=2048, n_z=34, max_m=3, device="cuda") -> dict:
    """Run the engines on ``device`` and return the check's report."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 20, 60.0, [30.0], pol.n)
    band = heterogeneous_band(n_z=n_z, n_spec=n_spec)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.15}

    def run(engine):
        R, _ = rt_run_band(pol, quad, band, [30.0], [0.0], max_m, surf,
                           dtype=torch.float32, device=device,
                           solver="schulz", engine=engine)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return R

    out = {"n_spec": n_spec, "n_z": n_z, "device": str(device)}
    _, _, scheds = build_layer_schedules(
        band.tau, band.omega, float(np.min(quad.qp_mu)), "schulz")
    out["n_schedule_buckets"] = len(set(scheds)) if scheds is not None else 1
    out["bucket_cap_ok"] = out["n_schedule_buckets"] <= 6

    radiances = {}
    for engine in ("torch", *KERNEL_ENGINES):
        before = _counts()
        t0 = time.perf_counter()
        radiances[engine] = run(engine)
        out[f"{engine}_total_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(engine)
        out[f"{engine}_steady_s"] = time.perf_counter() - t0
        moved = {e for e, c in _counts().items() if c != before[e]}
        if engine != "torch":
            out[f"{engine}_launches"] = _counts()[engine] - before[engine]
            out[f"{engine}_engaged"] = moved == {engine}
        else:
            out["torch_launched_kernels"] = sorted(moved)

    R_t = radiances["torch"]
    scale = np.maximum(np.abs(R_t), 1e-3 * float(np.abs(R_t).max()))
    ok = out["bucket_cap_ok"] and not out["torch_launched_kernels"]
    for engine in KERNEL_ENGINES:
        R = radiances[engine]
        diff = float(np.max(np.abs(R - R_t) / scale))
        out[f"{engine}_max_rel_diff_vs_torch"] = diff
        ok = (ok and out[f"{engine}_engaged"] and diff < 6e-3
              and bool(np.isfinite(R).all()))
    out["ok"] = bool(ok)
    return out


if __name__ == "__main__":
    print(json.dumps(run_check(
        n_spec=int(sys.argv[1]) if len(sys.argv) > 1 else 2048)))
