#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vsmartmom_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Builds the two hand-written kernels from vsmartmom_torch/csrc (nvcc,
   sm_90a) and prints each kernel's registers, shared and local memory
   (cuobjdump on the built library).
2. Drives the flagship O2 A-band forward run through the public API at full
   width (default_parameters with float_type Float32 -> model_from_parameters
   -> rt_run on cuda:0: 22 669 points, 34 layers, 3 Fourier moments) with the
   launch counts reset just before, and checks that the model build launched
   the Voigt kernel once per layer (34) and rt_run the layer-step kernel once
   per layer and moment (102).
3. Re-runs both kernels' call sites with every launch compared against the
   kernel's plain torch version on the same inputs (layer step: max|diff| /
   max < 1e-5 per field; Voigt: max|diff| <= 2e-5 max sigma, and <= 1e-3 max
   sigma against the dense f64 engine), plus the layer step at N = 44
   (Stokes IQUV), and times kernel and plain version with CUDA events.
4. Checks R and T: finite, physical, and within 1e-3 (max|dR| / max R) of the
   float64 torch engine at the same Newton-Schulz schedules on the card.

The last two lines of standard output are one JSON object with the kernels'
launch counts, errors and times, then the result line
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time


def fail(msg, code=1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(code)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of fn() over reps calls (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "vsmartmom_torch")):
        fail(f"vsmartmom_torch not found beside {__file__}: run from a "
             f"checkout of the repository")
    sys.path.insert(0, here)

    import numpy as np

    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt import LayerRT, vacuum_layer
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.cuda import build
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile
    from vsmartmom_torch.spectroscopy.voigt import (
        compute_absorption_cross_section, make_hitran_model)

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    tag = f"[card: {card}]"
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s) {tag}")

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s {tag}")
    for line in build.resource_usage(build.build()).splitlines():
        if line.strip().startswith(("Function", "REG:")):
            print(line.strip())

    # ---- 2. the flagship forward run, launches counted ----------------------
    params = vt.default_parameters()
    params.float_type = "Float32"
    grid = np.asarray(params.spec_bands[0], np.float64)
    n_spec = len(grid)

    vk.launches = 0
    lsk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = vt.model_from_parameters(params, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    R, T = vt.rt_run(model, device=dev)
    torch.cuda.synchronize()
    t_rt_first = time.perf_counter() - t0
    n_voigt = vk.launches
    n_step = lsk.launches
    n_z = model.profile.n_layers
    max_m = params.max_m
    print(f"flagship: nSpec={n_spec}, nZ={n_z}, max_m={max_m}, "
          f"N={len(model.quad_points.qp_mu_n)}; launches: voigt {n_voigt}, "
          f"layer step {n_step} {tag}")
    check(n_voigt == n_z, f"{n_voigt} Voigt launches in the build, "
          f"expected {n_z}")
    check(n_step == max_m * n_z, f"{n_step} layer-step launches in rt_run, "
          f"expected {max_m * n_z}")
    check(R.shape == (len(params.vza), 1, n_spec) and T.shape == R.shape,
          f"R/T shape {R.shape}/{T.shape}")
    check(np.isfinite(R).all() and np.isfinite(T).all(), "non-finite R/T")
    nadir = R[4, 0]
    check(np.all(nadir > 0) and np.all(nadir < 1), "nadir R outside (0, 1)")

    t_steady = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        vt.rt_run(model, device=dev)
        torch.cuda.synchronize()
        t_steady = min(t_steady, time.perf_counter() - t0)
    ap = params.absorption_params
    tau = np.zeros((n_spec, n_z))
    t0 = time.perf_counter()
    compute_absorption_profile(tau, "O2", ap, grid, 0.21, model.profile,
                               engine="kernel", device=dev)
    torch.cuda.synchronize()
    t_voigt = time.perf_counter() - t0
    print(f"model build {t_build:.3f} s (Voigt for O2 alone {t_voigt:.3f} s); "
          f"rt_run first {t_rt_first:.3f} s, steady {t_steady:.3f} s = "
          f"{n_spec / t_steady:.1f} points/s {tag}")

    # ---- 3a. Voigt kernel vs plain version at every layer's (p, T) ----------
    v_stats = {"rel": 0.0, "abs": 0.0, "calls": 0, "ms": [], "plain_ms": []}
    real_voigt = vk.voigt_tiles

    def compare_voigt(*args):
        out = real_voigt(*args)
        ref = vk.voigt_tiles_plain(*args)
        err = float((out - ref).abs().max())
        v_stats["abs"] = max(v_stats["abs"], err)
        v_stats["rel"] = max(v_stats["rel"], err / float(ref.abs().max()))
        v_stats["calls"] += 1
        v_stats["ms"].append(cuda_ms(torch, lambda: real_voigt(*args), 10))
        v_stats["plain_ms"].append(
            cuda_ms(torch, lambda: vk.voigt_tiles_plain(*args), 2))
        return out

    vk.voigt_tiles = compare_voigt
    try:
        compute_absorption_profile(np.zeros((n_spec, n_z)), "O2", ap, grid,
                                   0.21, model.profile, engine="kernel",
                                   device=dev)
    finally:
        vk.voigt_tiles = real_voigt
    check(v_stats["calls"] == n_z, "Voigt comparison did not run per layer")
    check(v_stats["rel"] <= 2e-5, f"Voigt kernel vs plain: "
          f"{v_stats['rel']:.3e} of max sigma > 2e-5")
    # against the dense f64 engine at the bottom layer's (p, T)
    from vsmartmom_torch.spectroscopy.profiles import (hitran_artifact,
                                                       read_linelist)
    ht = read_linelist(hitran_artifact("O2"), "O2", grid.min() - 40.0,
                       grid.max() + 40.0)
    hm = make_hitran_model(ht, ap.broadening, wing_cutoff=ap.wing_cutoff,
                           cef=ap.cef)
    p_b, t_b = float(model.profile.p_full[-1]), float(model.profile.T[-1])
    sig_k = compute_absorption_cross_section(
        hm, grid, p_b, t_b, device=dev, engine="kernel").double()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig_d = compute_absorption_cross_section(hm, grid, p_b, t_b, device=dev)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    dense_rel = float((sig_k - sig_d).abs().max() / sig_d.abs().max())
    check(dense_rel <= 1e-3, f"Voigt kernel vs dense f64: {dense_rel:.3e}")
    v_ms = float(np.mean(v_stats["ms"]))
    v_plain = float(np.mean(v_stats["plain_ms"]))
    print(f"voigt: {len(ht)} lines, {n_z} layers: max|diff| vs plain "
          f"{v_stats['abs']:.3e} ({v_stats['rel']:.3e} of max sigma), vs "
          f"dense f64 {dense_rel:.3e} of max sigma; kernel {v_ms:.4f} ms, "
          f"plain {v_plain:.4f} ms, dense f64 {1e3 * t_dense:.2f} ms per "
          f"layer {tag}")

    # ---- 3b. layer-step kernel vs plain version at every layer and moment ---
    s_stats = {"rel": 0.0, "abs": 0.0, "calls": 0, "ms": [], "plain_ms": []}
    real_step = lsk.fused_layer_step

    def compare_step(comp, *args, **kw):
        out = real_step(comp, *args, **kw)
        ref = lsk.fused_layer_step_plain(comp, *args, **kw)
        for a, b in zip(out, ref):
            err = float((a - b).abs().max())
            s_stats["abs"] = max(s_stats["abs"], err)
            s_stats["rel"] = max(s_stats["rel"],
                                 err / max(float(b.abs().max()), 1e-30))
        s_stats["calls"] += 1
        s_stats["ms"].append(
            cuda_ms(torch, lambda: real_step(comp, *args, **kw), 3))
        s_stats["plain_ms"].append(cuda_ms(
            torch, lambda: lsk.fused_layer_step_plain(comp, *args, **kw), 1))
        return out

    lsk.fused_layer_step = compare_step
    try:
        vt.rt_run(model, device=dev)
    finally:
        lsk.fused_layer_step = real_step
    check(s_stats["calls"] == max_m * n_z, "layer-step comparison did not "
          "run per layer")
    check(s_stats["rel"] < 1e-5, f"layer-step kernel vs plain: max|diff| / "
          f"max = {s_stats['rel']:.3e} >= 1e-5")
    s_ms = float(np.mean(s_stats["ms"]))
    s_plain = float(np.mean(s_stats["plain_ms"]))
    print(f"layer step (N={len(model.quad_points.qp_mu_n)}, S={n_spec}): "
          f"{s_stats['calls']} calls, max|diff| vs plain {s_stats['abs']:.3e}"
          f" ({s_stats['rel']:.3e} of max); kernel {s_ms:.3f} ms, plain "
          f"{s_plain:.3f} ms per layer step (mean) {tag}")

    # the IQUV shape: N = 44, 20 000 points, a passive random slab under a
    # composite built by two plain steps
    rng = np.random.default_rng(0)
    S, n, nd = 20000, 44, 8
    sched = (0, 0, 1, 1, 2, 3, 4, 4)
    dtau, mqm = 0.5 / 2 ** nd, 0.2

    def slab(scale):
        r = torch.as_tensor(rng.uniform(0, 1, (S, n, n)) * dtau * scale
                            / (n * mqm), dtype=torch.float32, device=dev)
        t = (torch.eye(n, device=dev) * float(np.exp(-dtau / mqm))
             + torch.as_tensor(rng.uniform(0, 1, (S, n, n)) * dtau
                               / (2 * n * mqm), dtype=torch.float32,
                               device=dev)).contiguous()
        v = [torch.as_tensor(rng.uniform(0, dtau, (S, n)),
                             dtype=torch.float32, device=dev)
             for _ in range(2)]
        return r, t, v[0], v[1]

    d44 = torch.as_tensor(np.tile([1.0, 1.0, -1.0, -1.0], n // 4),
                          dtype=torch.float32, device=dev)
    ek = torch.full((S,), float(np.exp(-dtau / 0.7)), device=dev)
    comp = vacuum_layer(S, n, torch.float32, dev)
    for scale in (1.0, 0.6):
        comp = LayerRT(*(x.contiguous() for x in lsk.fused_layer_step_plain(
            comp, *slab(scale), ek, d44, ns_schedule=sched, ni=4)))
    args44 = (comp, *slab(0.8), ek, d44)
    out = lsk.fused_layer_step(*args44, ns_schedule=sched, ni=3)
    ref = lsk.fused_layer_step_plain(*args44, ns_schedule=sched, ni=3)
    rel44 = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(out, ref))
    check(rel44 < 1e-5, f"layer step N=44: {rel44:.3e} >= 1e-5")
    ms44 = cuda_ms(torch, lambda: lsk.fused_layer_step(
        *args44, ns_schedule=sched, ni=3), 3)
    plain44 = cuda_ms(torch, lambda: lsk.fused_layer_step_plain(
        *args44, ns_schedule=sched, ni=3), 1)
    print(f"layer step (N=44, S={S}, nd={nd}): max|diff| / max {rel44:.3e};"
          f" kernel {ms44:.3f} ms, plain {plain44:.3f} ms {tag}")
    del comp, args44, out, ref

    # ---- 4. against the float64 torch engine at the same schedules ----------
    band = build_band_inputs(model, 0)
    t0 = time.perf_counter()
    R64, T64 = rt_run_band(model.pol, model.quad_points, band,
                           model.obs_geom.vza, model.obs_geom.vaz, max_m,
                           params.surfaces[0], dtype=torch.float64,
                           device=dev, solver="schulz", engine="torch")
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    rel_r = float(np.abs(R - R64).max() / np.abs(R64).max())
    rel_t = float(np.abs(T - T64).max() / np.abs(T64).max())
    print(f"float32 kernel path vs float64 torch engine: max|dR|/max R = "
          f"{rel_r:.3e}, max|dT|/max T = {rel_t:.3e} (float64 run "
          f"{t64:.2f} s) {tag}")
    check(rel_r < 1e-3 and rel_t < 1e-3, "flagship R/T off the float64 "
          "reference by >= 1e-3")

    kernels = [
        {"name": "fused_layer_step", "route": "cuda",
         "source": "vsmartmom_torch/csrc/layer_step.cu",
         "replaces": "vsmartmom/pallas/layer_step_kernel.py:67",
         "launches": n_step, "max_abs_err": s_stats["abs"],
         "ms": s_ms, "plain_ms": s_plain},
        {"name": "voigt_tiles", "route": "cuda",
         "source": "vsmartmom_torch/csrc/voigt.cu",
         "replaces": "vsmartmom/pallas/voigt_kernel.py:90",
         "launches": n_voigt, "max_abs_err": v_stats["abs"],
         "ms": v_ms, "plain_ms": v_plain},
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
