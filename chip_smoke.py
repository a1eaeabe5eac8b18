#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vsmartmom_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Builds the seven hand-written kernels from the six sources in
   vsmartmom_torch/csrc (one nvcc per source, all started together, sm_90a;
   row 1's tangent kernel, csrc/layer_step_tangent.cu, is checked alone by
   tangent_only();
   the split-form step has two bodies: the CUDA cores for "highest" and
   "default", the tensor cores for "bf16x3"; the layer step and the
   doubling have two too: the tensor cores for "high" at N <= 16, the
   CUDA cores for the rest) and prints each kernel's registers, stack,
   shared and local memory (cuobjdump on the built library); fails on
   local memory (spills) or a stack above 32 bytes in the team kernels
   (both bodies of the layer step, the split-form step and the doubling,
   layer scan, lanes step) and the lanes step's wide kernel, and on local
   memory in the Voigt kernel and its reduction.
1b. Runs those five team kernels against their plain versions at every
   width class of csrc/rt_device.cuh and its edges (N = 1, 13, 15, 16, 17,
   24, 32, 33, 44, 48, 49, 63, and 64 for the scan and the split-form step)
   at a ragged S = 1 007 on a synthetic slab, the split-form step's fifth
   class at N = 65, 72 and 75, and the lanes step's wide path at N = 64,
   72, 92 and 136 (one CTA a point; a cluster of two at N = 136): every
   field within 1e-5 of its max; rows 1, 3 and 4 also at each reduced mode
   (phase 17) against the plain version at that mode, which differs from
   the plain version at "highest": bit-equal on the CUDA cores; on the
   tensor cores (their sums in their own order) nearer it than the plain
   version at "highest", and within 1e-5 of max (row 3 at bf16x3) or
   within the plain version's own distance between "high" and "highest"
   (rows 1 and 4 at "high", N <= 16) (reduced_ok);
   times the wide path at each of its widths beside its plain version and
   its bound.
2. Drives the flagship O2 A-band forward run through the public API at full
   width (default_parameters with float_type Float32 -> model_from_parameters
   -> rt_run on cuda:0: 22 669 points, 34 layers, 3 Fourier moments) with the
   launch counts reset just before, and checks that the model build launched
   the Voigt kernel once per molecule with lines in the band (O2: one launch
   for all 34 layers; the band is a declared line-free window of CO2),
   that rt_run under auto launched the layer-scan kernel once per schedule
   bucket and moment (18) and no other layer kernel (rt_run.auto_choices:
   one kernel_scan), and that rt_run(engine="kernel") launched the
   layer-step kernel once per layer and moment (102) and nothing else;
   first and steady seconds of both.
3. Re-runs both kernels' call sites (the layer step's through
   engine="kernel") with every launch compared against the
   kernel's plain torch version on the same inputs (layer step: max|diff| /
   max < 1e-5 per field; Voigt: max|diff| <= 2e-5 max sigma, and <= 1e-3 max
   sigma against the dense f64 engine at the bottom layer), plus the layer
   step at N = 44 (Stokes IQUV) on a synthetic slab, and times kernel and
   plain version with CUDA events.
3c. The Voigt kernel at the HAPI gate's CO2 shape (data/hitran/CO2.npz,
   6 000-6 400 cm^-1 at 0.01 cm^-1: 40 001 points, 9 915 lines, 40 cm^-1
   cutoff, the flagship profile's 34 (p, T)), one launch through
   compute_absorption_profile, held against the plain version at all 34
   layers (max|diff| <= 2e-5 max sigma) and timed with CUDA events, with
   its bound per launch and per layer; both Voigt phases print the
   blocking plan of their shape.
4. Checks R and T of the auto run and of the kernel engine's: finite,
   physical, and within 1e-3 (max|dR| / max R) of the float64 torch engine
   at the same Newton-Schulz schedules on the card.
5. (a) The flagship again through rt_run(engine="kernel_dev"): 102 launches
   of the split-form layer-step kernel and none of the plain one, every
   launch within 1e-5 of its plain version per field, R/T within 1e-3 of
   float64, steady time.
6. (b) The headline IQUV shape (N = 44, 20 000 points, 10 layers, 3 moments,
   the bench.py harness's atmosphere) through rt_run_band with each of the
   kernel, kernel_dev and kernel_doubling engines: 30 launches each, every
   launch within 1e-5 of its plain version, R within 1e-3 of the float64
   torch engine, kernel and plain version timed with CUDA events.
7. (c) Natraj (IQUV, RadauQuad l_trunc 20 + 16 views: N = 136) in float32 on
   cuda:0 with engine="auto": the run takes torch_dev and passes the Natraj
   gates (I < 0.002, Q/U < 0.008).
8. (d) The flagship through rt_run(engine="kernel_scan"): one launch of the
   fused layer-scan kernel per schedule bucket and moment (the count derived
   from the profile's schedule buckets) and none of any other layer kernel,
   every launch within 1e-5 of its plain version per field, R/T within 1e-3
   of float64, first and steady time.
9. (e) The flagship through rt_run(engine="kernel_lanes"): one launch of the
   lanes-layout layer step per layer and moment (102) and none of the
   others, every launch within 1e-5 of its plain version, R/T within 1e-3
   of float64, steady time.
10. (f) The headline shape of phase 6 through kernel_scan (one launch per
   moment: the uniform profile is one bucket) and kernel_lanes (30), with
   the checks and CUDA-event times of phase 6.
11. (g) python3 -m vsmartmom_torch.check_bucketed on the card: the kernel,
   kernel_scan and kernel_lanes engines on a 34-layer heterogeneous Stokes-I
   profile, each engaged and within 6e-3 of the torch engine; ok must be
   true.
12. (h) The reference's 3-band configuration (tests/data/ref_yaml/
   3BandParameters.yaml with float_type Float32: O2 A-band, weak and strong
   CO2, 29 944 points on one concatenated axis, Stokes_IQU N = 30, 34
   layers, 3 moments, merged spectral albedo): the model build with the
   launch counts reset just before (one Voigt launch per band and molecule
   with lines: 3) and rt_run(model, i_band=[0, 1, 2]) under auto (24
   layer-scan launches, one a schedule bucket and moment, and nothing
   else; rt_run.auto_choices: one kernel_scan), its host stage spans,
   then kernel (102 layer-step launches), kernel_scan, kernel_dev and
   kernel_lanes with launch counts, each within 1e-3 of the float64 torch
   engine; kernel_dev at dd_precision
   "bf16x3" (the tensor-core body: 102 launches, counted, every launch
   within 1e-5 of max of its plain version at the mode, R within 1e-3 of
   float64); the concatenated run against
   the three per-band runs at its schedules (float32 within 1e-5, float64
   within 1e-10); an RPV surface on every band through auto (24
   layer-scan launches and nothing else) within 1e-3 of float64; the layer
   step, the split-form step, the layer scan and the lanes step at this
   shape, every launch within 1e-5 of its plain version
   (the compared launches counted) and timed, and each Voigt launch of the
   build within 2e-5 of max sigma, with their bounds.
13. (i) The Raman path (vsmartmom_torch/core/rt_raman.py: torch ops and
   torch.matmul, no kernel of its own; no TPU kernel on its path either):
   (a) tests/data/ref_yaml/O2Parameters.yaml as written (Float64, 6 837
   points, Stokes_IQU N = 15, 5 layers, 3 moments, 172 Raman shift rows):
   the model build with the launch counts reset just before (one Voigt
   launch, O2) and rt_run(model, rs_type="RRS"), which launches no layer
   kernel; shapes (4, 3, 6 837), finite, ieR nonzero, I of R + ieR
   positive; first and steady seconds, points/s and peak device memory;
   the build's Voigt launch held against its plain version (2e-5 of max
   sigma) and timed, with its bound; (b) the same run in float32, R, T,
   ieR and ieT each within 1e-4 of their max in (a); (e) the file's elastic
   run in float32 through kernel_scan, where the 60 deg view merges with
   the Gauss node 0.5 (the scan kernel's merged-node branch): launches
   counted, every launch within 1e-5 of its plain version (the compared
   launches counted) and timed, R/T within 1e-3 of the float64 torch
   engine; (c) tests/test_raman.py's band (88 points, 2 layers) in float64
   on the card within 1e-10 of the port's CPU run, the energy check at
   band centre (rel 2e-3) and the Ring filling-in (core / continuum >
   1.2) on the card; (d) the bench.py raman_rrs shape (2 048 points, 10
   layers, Stokes_I) in float32, first and steady seconds and points/s.
14. (j) The rest of the elastic scope (core/multisensor.py, core/canopy.py,
   core/rami.py: torch ops, no kernel of their own; no TPU kernel on their
   path either): (a) rt_run_ms on the flagship in Float32 (22 669 points,
   34 layers, N = 15) at sensor levels [0, 12, 24, 34] under the default
   schulz solver, with the launch counts reset just before the build (one
   Voigt launch, held against its plain version within 2e-5 of max sigma)
   and before the run (no layer kernel may launch); first and steady
   seconds, points/s and peak device memory; the TOA and BOA anchors in
   float64 with lu against rt_run_band(engine="torch", solver="lu") within
   1e-9 of max (at BOA with the direct beam added, which T carries at the
   solar node); float32 within 1e-3 of float64 at every sensor; the
   interior physics of tests/test_multisensor.py; (b) rt_run_canopy with
   the flagship's band above the canopy of vsmartmom_torch/canopy_demo.py
   (LAI 3 in 3 slabs, chi 0.1, leaf ssa 0.25-0.95, soil 0.05, sensor levels
   0-3): float32 within 1e-3 of float64 per output, the G = 1 reduction
   against rt_run_band on the 35-layer band at rtol 2e-7 (float64), and
   float32 black leaves at LAI 20 in one slab and chi = 0.6, each finite
   and within 1e-3 of float64; (c) run_rami_scenario on a HOM00 Rayleigh
   scene (band 8a, Lambertian 0.2, sza 30) at run_rami_scenario's defaults (dnu
   1, 20 layers, l_trunc 40, max_m 20, Float64, 152 views) on a stand-in
   AFGL profile interpolated from default_parameters' (p, T, q), the card
   within 1e-10 of the port's CPU run of the same scene and solver.
15. (k) Forward-mode AD (core/autodiff.py, scattering/mie_ad.py,
   spectroscopy/voigt.py:absorption_cross_section; rows 1 and 3 are
   torch.autograd.Functions with the kernel as primal, row 1's tangent
   its tangent kernel, row 3's the plain version's jvp) at
   the flagship's full width, state (log scattering scale, albedo, log
   absorption scale) of vsmartmom_torch/retrieval_demo.py: the float64
   torch engine's torch.func.jacfwd Jacobian on the card against central
   differences (1e-5 of max); (a) the Jacobian through engine "kernel" in
   float32 at the static schulz schedules, with the launch counts set to 0
   just before it (102 row-1 launches and nothing else; 102 launches of
   row 1's tangent kernel and no plain tangent), within 2e-3 of
   max of float64, its R within 1e-6 of rt_run_band's on that engine,
   first and steady seconds, the primal's seconds and peak device memory;
   (b) the same through "kernel_dev" (102 row-3 launches); (c)
   Gauss-Newton through "kernel" at full width from the demo's start to
   its truth within 5e-3 in 6 iterations (612 launches) and the demo on
   the card; (d) aerosol_optics_with_derivs at the flagship's aerosol (mu
   1.3, sigma 2.0, n_r 1.3, n_i 1e-8, lambda 0.77, r_max 50, 2 500 radii)
   in float64: values within 1e-10 of the numpy NAI2 path, derivatives
   within 1e-5 of max of central differences beyond their rounding; (e)
   absorption_cross_section(autodiff=True) of the flagship's O2 lines on
   its grid at the bottom layer's (p, T), within 1e-6 of central
   differences; (f) torch.func.jvp through rows 2, 4, 5 and 6 raises
   NotImplementedError and launches nothing.
16. (l) Spectral sharding (parallel/sharding.py, parallel/distributed.py,
   scaling_bench.py; no kernel of its own: under auto each shard launches
   row 5, the model build row 2): (a) the flagship in Float32, the build
   with the launch counts reset just before (one Voigt launch) and
   rt_run_band_sharded over 4 shards on cuda:0 under auto (4 x 18 row-5
   launches and nothing else) and through engine "kernel" (4 x 102 row-1
   launches and nothing else), every launch held against its plain version
   (1e-5 of max per field), R/T of each within 1e-6 of max of the
   unsharded rt_run on the same engine (bit equality printed), the float64
   torch engine sharded against unsharded at rtol 1e-12 (atol 1e-15),
   steady seconds of both; (b)
   O2Parameters.yaml as written (Float64) through rt_run_band_rrs_sharded
   over 4 shards with the Raman halo, R, T, ieR and ieT within rtol 1e-11
   (atol 1e-16) of phase 13 (a), each shard's halo and redundant share,
   seconds and peak device memory; (c) two gloo processes (init_multihost,
   each on cuda:0, started after the kernels are built, each with a 300 s
   limit) running the flagship in float64 through the torch engine, the
   gathered R/T within rtol 1e-12 of the single run; (d) python3 -m
   vsmartmom_torch.scaling_bench: the 1-device row and 4 shards on the card
   against the same load unsharded (mechanics, not scaling); (e)
   read_hitran(engine="native") on data/hitran/O2.par and H2O.par (g++
   build on this machine) field for field against engine="python", with
   the parse seconds.
17. (m) The matrix-product precision modes of rows 1, 3 and 4
   (core/precision.py; the kernels are templates on the mode): (a) the
   Float32 flagship through rt_run with engine kernel at matmul_precision
   "high" and "default", kernel_dev at dd_precision "bf16x3" and
   "default", kernel_doubling at "high" and "default", the launch counts
   set to 0 just before each run (102 launches of its row and nothing
   else), every launch against its plain version at the same mode as
   reduced_ok says (bit-equal on the CUDA cores; rows 1 and 4 at "high"
   run on the tensor cores at the flagship's N = 15), R against the
   float64 torch engine (row 3 at bf16x3 within 1e-3), first and steady
   seconds; (b) rows 1, 3 and 4 at every mode (the highest
   included) on a synthetic slab at N = 44 and 20 000 points, each
   against its plain version (at the reduced modes as reduced_ok says;
   1e-5 of max at "highest"),
   with CUDA-event times and bounds; (c) python3 -m vsmartmom_torch.qualify_precision's six tokens
   (6SV1 and Natraj in float32 at N = 136-140), its lines printed, the
   kernel deltas of "highest" and the dev tokens below 1e-5 and the dev
   tokens inside the gates; (d) the bench.py raman_rrs shape at
   ie_precision "high" and "default" against "highest" (R and T within
   1e-6, ieR within 1e-2). precision_only() runs the build and this phase
   alone.
18. (n) The lanes step's wide path on a full-width run: rt_run_band with
   engine kernel_lanes in float32 on the headline atmosphere of phase 6
   under the streams of tests/data/ref_yaml/PureRayleighParameters.yaml
   (RadauQuad, l_trunc 20, sza 30, nine views, Stokes_IQUV: N = 92; one
   schedule bucket of 10 doublings), the launch counts set to 0 just
   before (30 wide launches and nothing else); first and steady seconds,
   points/s, peak device memory (< 40 GiB) and the mean milliseconds of
   the steady run's launches (CUDA events); the first launch held against
   its plain version (1e-5 of max per field) and both timed; R and T
   within 1e-3 of the float32 torch engine at the same schedules and the
   first 512 points within 1e-3 of float64. lanes_wide_only() runs the
   build, the wide widths of phase 1b and this phase alone.

Each kernel's bound is the larger of its matrix-product (or Voigt) FLOPs over
67 TFLOP/s (H100 SXM float32 outside the tensor cores) and its device bytes
(inputs read once, outputs written once) over 3.35 TB/s, from this run's
shapes and schedules; at a reduced mode the FLOPs times the mode's bf16
passes (3 or 1) over 989 TFLOP/s (dense bf16 on the tensor cores), the gap
a tensor-core kernel would close. No single PyTorch call computes any of
these kernels' functions, so library_ms is null. The kernels line lists
each row at each mode that ran (``name[mode]``).

The last two lines of standard output are one JSON object with the kernels'
launch counts, errors, times and bounds, then the result line
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.

step_tc_only() runs the build and step_tc_phase alone: rows 1 and 4 at
each mode on the flagship with launch counts (102 each), on the N = 44
slab and at the widths N = 1, 15, 16, 17, 30, 32, 33, 44, 48, 49, 63
(S = 1 007), each with its time, plain time, bound and error
(python3 -c 'import chip_smoke; chip_smoke.step_tc_only()');
step_tc_times() runs the phase alone, beside an older tree too.

dev_tc_only() runs the build and dev_tc_phase alone: row 3 at each mode
on the flagship (N = 15) and 3-band (N = 30) paths with launch counts, on
the N = 44 slab and at the widths N = 1, 15, 16, 17, 30, 44, 64, 65 and 75
(S = 1 007), each with its time, plain time, bound and error
(python3 -c 'import chip_smoke; chip_smoke.dev_tc_only()'); dev_tc_times()
runs the phase alone, beside an older tree too.

voigt_only() holds the Voigt kernel against the dense f64 engine at every
layer of the flagship grid and of the three band grids of the 3-band
configuration (tests/data/ref_yaml/3BandParameters.yaml), one launch a band
and molecule with lines, with the window's pairs the plan counted
(``window_pairs``) against those the plain version kept, and each launch's
time and share of its bound:
python3 -c 'import chip_smoke; chip_smoke.voigt_only()'.

kernel_times() times the Voigt kernel alone at the flagship and the
HAPI-grid CO2 shapes and the layer-scan kernel at the headline shape through
entry points that every design of those kernels has kept, so a copy of this
script beside an older tree of the repository times that tree's design:
python3 -c 'import chip_smoke; chip_smoke.kernel_times()'.
lanes_wide_times() does the same for the first launch of phase 18's run
(the lanes step's wide path and its plain version).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np


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


#: H100 SXM peaks at 700 W (NVIDIA data sheet): float32 outside the
#: tensor cores, dense bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: bf16 passes of a product in each mode (core/precision.py)
MODE_PASSES = {"high": 3, "bf16x3": 3, "default": 1}


class KernelStats:
    """One kernel's launches compared with its plain version: the largest
    errors, the times, and the work (FLOPs, device bytes) they needed.
    ``mode``: the product mode; a reduced mode's operations bound is its
    product FLOPs times its bf16 passes over the dense bf16 tensor-core
    peak, "highest"'s its FLOPs over the float32 peak."""

    def __init__(self, mode="highest"):
        self.rel = self.abs = 0.0
        self.calls = 0
        self.ms, self.plain_ms = [], []
        self.flops = self.nbytes = 0
        self.mode = mode
        #: launches that did not hold (reduced_judge), and the largest
        #: distance of the plain version at the mode from "highest" on a
        #: launch's inputs, where measured
        self.failed, self.sep = [], 0.0

    def mean_ms(self):
        return float(np.mean(self.ms)), float(np.mean(self.plain_ms))

    def bound(self):
        """(least ms per launch, what bounds it) over the compared launches."""
        t_ops = (self.flops / PEAK_F32_FLOPS if self.mode == "highest"
                 else self.flops * MODE_PASSES[self.mode] / PEAK_BF16_FLOPS)
        t_bytes = self.nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes) / self.calls,
                "operations" if t_ops >= t_bytes else "bytes")

    def entry(self, name, source, replaces, launches):
        ms, plain_ms = self.mean_ms()
        bound_ms, bound_by = self.bound()
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": self.abs, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}


def field_err(torch, a, b):
    """(max|a - b|, max finite |b|) of one field: entries equal, or NaN in
    both, count as no difference; a NaN or infinity in one only as an
    infinite one."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.nan_to_num(torch.where(same, torch.zeros_like(a),
                                        (a - b).abs()), nan=float("inf"))
    scale = torch.where(torch.isfinite(b), b.abs(), torch.zeros_like(b))
    return float(diff.max()), float(scale.max())


def compare_hook(torch, stats, real, plain, work, reps=(3, 1), judge=None):
    """A stand-in for a kernel wrapper that launches the kernel, holds every
    output field against the plain version on the same inputs (max|diff| /
    max of the field, field_err), counts the call's work and times both.
    ``judge(outs, refs, args, kw)``, if given, sees each launch's outputs
    and the plain version's."""
    def wrapper(*args, **kw):
        out = real(*args, **kw)
        ref = plain(*args, **kw)
        outs, refs = ((out, ref) if isinstance(out, tuple)
                      else ((out,), (ref,)))
        for a, b in zip(outs, refs):
            err, scale = field_err(torch, a, b)
            stats.abs = max(stats.abs, err)
            stats.rel = max(stats.rel, err / max(scale, 1e-30))
        if judge is not None:
            judge(outs, refs, args, kw)
        flops, nbytes = work(*args, **kw)
        stats.calls += 1
        stats.flops += flops
        stats.nbytes += nbytes
        stats.ms.append(cuda_ms(torch, lambda: real(*args, **kw), reps[0]))
        stats.plain_ms.append(
            cuda_ms(torch, lambda: plain(*args, **kw), reps[1]))
        return out
    return wrapper


def rel_field(torch, a, b):
    """max|a - b| / max|b| of one field (field_err)."""
    err, scale = field_err(torch, a, b)
    return err / max(scale, 1e-30)


def rel_err(a, b):
    """max|a - b| / max|b|; 0 where both are exactly 0, inf where only b
    is."""
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    return err / scale if scale > 0 else (0.0 if err == 0 else np.inf)


#: the HAPI gate's grid (tests/test_hapi_gate.py): 40 001 points
HAPI_GRID = 6000.0 + 0.01 * np.arange(40001)


def voigt_shapes(params):
    """(name, molecule, grid, vmr) of the Voigt kernel's two shapes: O2 over
    the flagship band, CO2 over the HAPI gate's grid."""
    return [("flagship", "O2", np.asarray(params.spec_bands[0], np.float64),
             0.21), ("co2_hapi", "CO2", HAPI_GRID, 4e-4)]


def voigt_compared(torch, vk, absorption_profile, mol, grid, vmr, ap,
                   profile, dev):
    """absorption_profile (kernel engine) of one molecule over grid with
    every call of the Voigt entry point held against its plain version, its
    work counted and both timed: (KernelStats, tau)."""
    stats = KernelStats()
    real = vk.voigt_tiles
    vk.voigt_tiles = compare_hook(torch, stats, real, vk.voigt_tiles_plain,
                                  vk.voigt_work, reps=(10, 2))
    try:
        tau = absorption_profile(np.zeros((len(grid), profile.n_layers)),
                                 mol, ap, grid, vmr, profile,
                                 engine="kernel", device=dev)
    finally:
        vk.voigt_tiles = real
    check(np.isfinite(tau).all() and tau.max() > 0,
          f"{mol}: tau not finite and positive")
    return stats, tau


def voigt_geometry(vk, grid, nu, cutoff, n_layers):
    """The blocking plan of a Voigt shape, built on the CPU: point blocks,
    line items, lines swept per grid point against lines within the cutoff
    of it (means over the grid) and the workspace of n_layers layers."""
    plan = vk.VoigtPlan(grid, nu, cutoff, device="cpu")
    n_real = np.minimum(vk.BLOCK,
                        len(grid) - vk.BLOCK * np.arange(plan.n_blocks))
    swept = np.sum((plan.last - plan.first) * n_real) / len(grid)
    nu = np.sort(nu)
    window = (np.searchsorted(nu, grid + cutoff, side="right")
              - np.searchsorted(nu, grid - cutoff, side="left"))
    mb = n_layers * plan.n_items * vk.BLOCK * 4e-6
    return (f"plan: {plan.n_blocks} point blocks, {plan.n_items} items, "
            f"{swept:.2f} lines swept per point against {window.mean():.2f} "
            f"in window, workspace {mb:.1f} MB")


def has_lines(mol, grid, cutoff):
    """Whether the line list of molecule ``mol`` has lines within
    ``cutoff`` of ``grid`` (the Voigt kernel engine launches once for each
    such molecule of a band)."""
    from vsmartmom_torch.spectroscopy.hitran import HitranEmptyError
    from vsmartmom_torch.spectroscopy.profiles import (hitran_artifact,
                                                       read_linelist)
    try:
        read_linelist(hitran_artifact(mol), mol, float(np.min(grid)) - cutoff,
                      float(np.max(grid)) + cutoff)
    except HitranEmptyError:
        return False
    return True


def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"


#: the directory of this script: the root of a checkout of the repository
HERE = os.path.dirname(os.path.abspath(__file__))


def setup():
    """torch, once a CUDA device and the package beside this script are
    there; fails otherwise."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not os.path.isdir(os.path.join(HERE, "vsmartmom_torch")):
        fail(f"vsmartmom_torch not found beside {__file__}: run from a "
             f"checkout of the repository")
    sys.path.insert(0, HERE)
    return torch


def headline_shape():
    """The headline IQUV shape of the bench.py harness (bench.py:50-111):
    N = 44 streams, 20 000 points, 10 layers of scattering tau 0.05 with
    absorption uniform on [0, 0.5) from seed 0, Rayleigh, albedo 0.15.
    Returns (pol, quad, band, surface); views at 0 and 30 degrees."""
    from vsmartmom_torch.core.rt_run import BandRTInputs
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    pol = Polarization.from_name("Stokes_IQUV")
    quad = rt_set_streams("GaussQuadFullSphere", 15, 45.0, [0.0, 30.0],
                          pol.n)
    nz, ns = 10, 20_000
    rng = np.random.default_rng(0)
    tau_scat = np.full((nz, ns), 0.05)
    tau = tau_scat + rng.uniform(0.0, 0.5, size=(nz, ns))
    band = BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((nz, 1, ns)),
                        greeks=[get_greek_rayleigh(0.0)])
    return pol, quad, band, {"type": "LambertianSurfaceScalar",
                             "albedo": 0.15}


def launch_counters():
    """The kernel wrapper modules by engine name, each counting its
    launches in ``launches``."""
    from vsmartmom_torch.cuda import (doubling_kernel, lanes_kernel,
                                      layer_scan_kernel,
                                      layer_step_dev_kernel,
                                      layer_step_kernel, voigt_kernel)
    return {"kernel": layer_step_kernel, "kernel_dev": layer_step_dev_kernel,
            "kernel_doubling": doubling_kernel, "voigt": voigt_kernel,
            "kernel_scan": layer_scan_kernel, "kernel_lanes": lanes_kernel}


def reset_counts():
    for mod in launch_counters().values():
        mod.launches = 0


def counts():
    return {name: mod.launches for name, mod in launch_counters().items()}


def ad_only():
    """Phase 15 (forward-mode AD) alone, on the card:
    python3 -c 'import chip_smoke; chip_smoke.ad_only()'."""
    torch = setup()
    ad_phase(torch, torch.device("cuda:0"), f"[card: {card_name()}]",
             reset_counts, counts)


def span_clock_only():
    """The stage spans against the profiler's clock on the card: the
    headline shape through the kernel engine (30 layer steps) under a
    profiler of the device's activity alone (the benchmark's); each
    ``layer_step`` span must hold its launch's cudaLaunchKernel runtime
    event, matched to the launch by correlation id. One JSON line: the
    spans, launches and launches held, the offsets of the launch's start
    after the span's start and of the span's end after the launch's end
    (min, median, max, microseconds), and whether the profiler probe read
    True:
    python3 -c 'import chip_smoke; chip_smoke.span_clock_only()'."""
    torch = setup()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.util import timing
    dev = torch.device("cuda:0")
    pol, quad, band, surf = headline_shape()

    def run():
        rt_run_band(pol, quad, band, [0.0, 30.0], [0.0, 0.0], 3, surf,
                    dtype=torch.float32, device=dev, engine="kernel")
    run()                                      # build and warm-up
    torch.cuda.synchronize()
    timing.reset_timer()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    probe = torch.autograd._profiler_enabled()
    run()
    torch.cuda.synchronize()
    prof.stop()
    steps = [sp for sp in timing.spans() if sp.name == "layer_step"]
    events = list(prof.profiler.kineto_results.events())
    kernel = {e.correlation_id() for e in events
              if e.device_type() == DeviceType.CUDA
              and "layer_step_kernel" in e.name()}
    launches = [e for e in events if e.device_type() == DeviceType.CPU
                and e.name().startswith("cudaLaunchKernel")
                and e.correlation_id() in kernel]
    before, after = [], []
    for e in launches:
        held = [sp for sp in steps
                if sp.start_ns <= e.start_ns() and e.end_ns() <= sp.end_ns]
        if held:
            before.append((e.start_ns() - held[0].start_ns) / 1e3)
            after.append((held[0].end_ns - e.end_ns()) / 1e3)

    def spread(xs):
        return [float(np.min(xs)), float(np.median(xs)), float(np.max(xs))] \
            if xs else None
    print(json.dumps({"card": card_name(), "profiler_probe": probe,
                      "layer_step_spans": len(steps),
                      "launches": len(launches), "held": len(before),
                      "launch_after_span_start_us": spread(before),
                      "span_end_after_launch_us": spread(after)}))
    check(probe and len(steps) == len(launches) == len(before) == 30,
          "a layer_step span does not hold its launch's cudaLaunchKernel")


def voigt_only(reps=10):
    """The Voigt kernel alone at the flagship grid and at the three band
    grids of the 3-band configuration, on each configuration's 34 layers,
    one launch a band and molecule with lines: each launch against the
    dense f64 engine at every layer (the largest gap as a share of the
    layer's max sigma) and against its plain version, with the pairs in the
    window that the plan counted (``window_pairs``) beside those the plain
    version kept, its time by CUDA events and its share of its bound (the
    evaluated pairs' operations over 67 TFLOP/s, or the bytes over 3.35
    TB/s). One JSON line a launch:
    python3 -c 'import chip_smoke; chip_smoke.voigt_only()'."""
    torch = setup()
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.atmosphere import compute_atmos_profile_fields
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.spectroscopy import voigt as tv
    from vsmartmom_torch.spectroscopy.profiles import (hitran_artifact,
                                                       read_linelist)
    dev = torch.device("cuda:0")
    card = card_name()
    flagship = vt.default_parameters()
    three = vt.parameters_from_yaml(os.path.join(
        HERE, "tests", "data", "ref_yaml", "3BandParameters.yaml"))
    worst = 0.0
    for cfg, params in (("flagship", flagship), ("3band", three)):
        ap = params.absorption_params
        prof = compute_atmos_profile_fields(params.T, params.p, params.q,
                                            ap.vmr)
        for ib, band in enumerate(params.spec_bands):
            grid = np.asarray(band, np.float64)
            for mol in ap.molecules[ib]:
                shape = f"{cfg} band {ib + 1} {mol}"
                if not has_lines(mol, grid, ap.wing_cutoff):
                    print(json.dumps({"shape": shape, "points": len(grid),
                                      "lines": 0, "launches": 0}),
                          flush=True)
                    continue
                ht = read_linelist(hitran_artifact(mol), mol,
                                   grid.min() - ap.wing_cutoff,
                                   grid.max() + ap.wing_cutoff)
                model = tv.make_hitran_model(ht, ap.broadening,
                                             wing_cutoff=ap.wing_cutoff,
                                             cef=ap.cef)
                pars = tv.line_parameters(model, prof.p_full, prof.T)
                plan = tv.make_voigt_plan(model, grid, device=dev)
                args = plan.call_args(*plan.line_inputs(*pars))
                vk.launches = vk.window_pairs = 0
                sigma = plan.run(*pars)
                check(vk.launches == 1, f"{shape}: {vk.launches} launches")
                counted = vk.window_pairs
                kept = sum(int(keep.sum()) for *_, keep in
                           vk._item_pairs(*args[:5], *args[6:13]))
                plain = vk.voigt_tiles_plain(*args)
                rel_plain = rel_field(torch, sigma, plain)
                gaps = []
                for iz in range(prof.n_layers):
                    dense = tv.compute_absorption_cross_section(
                        model, grid, float(prof.p_full[iz]),
                        float(prof.T[iz]), device=dev)
                    gaps.append(rel_field(torch, sigma[iz].double(), dense))
                worst = max(worst, max(gaps))
                ms = cuda_ms(torch, lambda: vk.voigt_tiles(*args), reps)
                ops, nbytes = vk.voigt_work(*args)
                t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
                bound_ms = 1e3 * max(t_ops, t_bytes)
                print(json.dumps({
                    "shape": shape, "points": len(grid),
                    "lines": len(ht.nu), "layers": prof.n_layers,
                    "launches": 1, "window_pairs": counted,
                    "plain_kept_pairs": kept,
                    "max_gap_of_max_sigma_vs_dense_f64": max(gaps),
                    "layer_of_max_gap": int(np.argmax(gaps)),
                    "max_rel_vs_plain": rel_plain, "ms_per_launch": ms,
                    "bound_ms": bound_ms, "bound_by": ("operations"
                                                      if t_ops >= t_bytes
                                                      else "bytes"),
                    "share_of_bound": bound_ms / ms, "card": card}),
                    flush=True)
                check(abs(kept - counted) <= 1e-5 * counted,
                      f"{shape}: the plan counted {counted} pairs in the "
                      f"window, the plain version kept {kept}")
                check(rel_plain <= 2e-5, f"{shape}: kernel vs plain "
                      f"{rel_plain:.3e} of max sigma > 2e-5")
    check(worst <= 1e-5, f"Voigt kernel vs dense f64: {worst:.3e} of max "
          f"sigma > 1e-5")
    print(json.dumps({"voigt_only": "ok", "max_gap_of_max_sigma": worst,
                      "card": card}), flush=True)


def kernel_times(shapes=("flagship", "co2_hapi", "headline")):
    """Kernels of the package beside this script alone, every launch held
    against its plain version, one JSON line per shape: the Voigt kernel at
    the shapes of voigt_shapes (over the flagship profile's 34 layers) and
    the layer-scan kernel at the headline shape (one bucket of 10 layers:
    one launch a moment through rt_run_band's kernel_scan engine). It uses
    only entry points that every design of these kernels kept, so a copy of
    this script beside an older tree times that tree's design:
    python3 -c 'import chip_smoke; chip_smoke.kernel_times()'."""
    torch = setup()
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.atmosphere import compute_atmos_profile_fields
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile
    params = vt.default_parameters()
    ap = params.absorption_params
    profile = compute_atmos_profile_fields(params.T, params.p, params.q,
                                           ap.vmr)
    card = card_name()
    for name, mol, grid, vmr in voigt_shapes(params):
        if name not in shapes:
            continue
        stats, _ = voigt_compared(torch, vk, compute_absorption_profile, mol,
                                  grid, vmr, ap, profile,
                                  torch.device("cuda:0"))
        check(stats.rel <= 2e-5, f"{name}: Voigt kernel vs plain "
              f"{stats.rel:.3e} of max sigma > 2e-5")
        print(json.dumps({
            "shape": name, "kernel": "voigt", "layers": profile.n_layers,
            "launches": stats.calls, "ms_per_launch": stats.mean_ms()[0],
            "ms_per_layer": float(np.sum(stats.ms)) / profile.n_layers,
            "plain_ms_per_layer": float(np.sum(stats.plain_ms))
            / profile.n_layers, "max_rel_err": stats.rel, "card": card}),
            flush=True)
    if "headline" not in shapes:
        return
    pol, quad, band, surf = headline_shape()
    stats = KernelStats()
    real = scn.fused_layer_scan
    scn.fused_layer_scan = compare_hook(
        torch, stats, real, scn.fused_layer_scan_plain,
        lambda *a, **kw: (0, 0), reps=(5, 1))
    try:
        rt_run_band(pol, quad, band, [0.0, 30.0], [0.0, 0.0], 3, surf,
                    dtype=torch.float32, device="cuda:0", solver="schulz",
                    engine="kernel_scan")
    finally:
        scn.fused_layer_scan = real
    check(stats.calls == 3 and stats.rel < 1e-5, f"scan: {stats.calls} "
          f"launches, {stats.rel:.3e} of max from the plain version")
    ms, plain_ms = stats.mean_ms()
    print(json.dumps({"shape": "headline", "kernel": "layer_scan",
                      "launches": stats.calls, "ms_per_launch": ms,
                      "plain_ms": plain_ms, "max_rel_err": stats.rel,
                      "card": card}), flush=True)


#: the team kernels (mangled names hold these): no local memory allowed, and
#: no stack above MAX_TEAM_STACK bytes (the N <= 16 layer step's once grew
#: to 56 bytes and ran 30 % slower)
TEAM_KERNELS = ("layer_step_kernel", "layer_step_tc_kernel",
                "layer_step_tangent_kernel",
                "layer_step_dev_kernel", "layer_step_dev_tc_kernel",
                "doubling_kernel", "doubling_tc_kernel", "layer_scan_kernel",
                "lanes_team_kernel", "lanes_wide_kernel")
MAX_TEAM_STACK = 32
#: the Voigt kernel and its reduction: no local memory allowed either
VOIGT_KERNELS = ("voigt_kernel", "voigt_reduce_kernel")
#: widths of the phase below: every tile class of csrc/rt_device.cuh and its
#: edges (the layer step, doubling and lanes team kernel take N <= 63, the
#: scan N <= 64), the widths of the split-form step's fifth class (N = 65 ..
#: 75), and the lanes step's wide path at N = 64 (its first width), 72, 92
#: (phase 18's) and 136 (Natraj's, its widest: two CTAs a point)
WIDTHS = (1, 13, 15, 16, 17, 24, 32, 33, 44, 48, 49, 63, 64)
DEV_WIDE_WIDTHS = (65, 72, 75)
LANES_WIDE_WIDTHS = (64, 72, 92, 136)
WIDTH_S = 1007


def build_phase(tag):
    """1. Build the kernels and print each one's resource usage; fail on
    local memory or a stack above MAX_TEAM_STACK bytes in a team kernel
    (every tile class and product mode), on local memory in the Voigt
    kernels, or on a kernel missing from the library."""
    from vsmartmom_torch.cuda import build
    t0 = time.perf_counter()
    build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s {tag}")
    spills, team_seen, voigt_seen = [], set(), set()
    fn = None
    for line in build.resource_usage(build.build()).splitlines():
        line = line.strip()
        if line.startswith("Function"):
            fn = line
        elif line.startswith("REG:"):
            print(f"{fn} {line}")
            local = int(line.split("LOCAL:")[1].split()[0])
            stack = int(line.split("STACK:")[1].split()[0])
            team = [k for k in TEAM_KERNELS if k in fn]
            team_seen.update(team)
            voigt = [k for k in VOIGT_KERNELS if k in fn]
            voigt_seen.update(voigt)
            if (team and (local or stack > MAX_TEAM_STACK)) \
                    or (voigt and local):
                spills.append(f"{fn} {line}")
    check(team_seen == set(TEAM_KERNELS),
          f"team kernels missing from the library: "
          f"{set(TEAM_KERNELS) - team_seen}")
    check(voigt_seen == set(VOIGT_KERNELS),
          f"Voigt kernels missing from the library: "
          f"{set(VOIGT_KERNELS) - voigt_seen}")
    check(not spills, f"local memory, or a stack above {MAX_TEAM_STACK} "
          f"bytes in a team kernel: {spills}")


#: the (row, reduced mode) pairs whose launches run on the tensor cores:
#: row 3 at bf16x3 at every width, rows 1 and 4 at "high" up to
#: STEP_TC_MAX_N
TC_MODES = (("kernel_dev", "bf16x3"), ("kernel", "high"),
            ("kernel_doubling", "high"))
#: the widest N at which this script holds rows 1 and 4 at "high" as
#: tensor-core launches (the N <= 16 class: a CPU emulation of the plain
#: form summed in another order put every wider class above sep, PERF.md
#: §6); at every other width and mode they are held bit-equal
STEP_TC_MAX_N = 16


def on_tensor_cores(engine, mode, n):
    """Whether this script holds a launch of the row of ``engine`` at
    ``mode`` and width n as a tensor-core launch: row 3 at bf16x3; rows 1
    and 4 at "high" up to STEP_TC_MAX_N."""
    if (engine, mode) not in TC_MODES:
        return False
    return engine == "kernel_dev" or n <= STEP_TC_MAX_N


def check_step_routing():
    """Fail if the wrappers of rows 1 and 4 route "high" to the tensor
    cores at a width beyond STEP_TC_MAX_N."""
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    wide = [n for n in range(1, 64)
            if lsk.on_tensor_cores("high", n) and n > STEP_TC_MAX_N]
    check(not wide, f"rows 1 and 4 route \"high\" to the tensor cores at "
          f"N = {wide}, beyond the N <= {STEP_TC_MAX_N} this script holds "
          f"to sep")


def reduced_ok(engine, mode, n, err, err_highest, sep):
    """Whether a row's launch at a reduced mode and width n holds against
    its plain version at that mode: err, the worst field's max|diff| / max
    against it, err_highest against the plain version at "highest", sep
    the plain version's own worst-field distance between the mode and
    "highest" on the same inputs. On the CUDA cores (fmaf chains in
    torch's order) bit-equal. On the tensor cores (on_tensor_cores) the
    sums follow the tensor cores' order: nearer the plain version at its
    mode than at "highest", and within 1e-5 of max (row 3 at bf16x3) or
    within sep (rows 1 and 4 at "high": the plain form at "high" moves by
    about as much as its distance from "highest" when its sums change
    order, so 1e-5 cannot hold; PERF.md §6)."""
    if not on_tensor_cores(engine, mode, n):
        return err == 0.0
    bound = 1e-5 if engine == "kernel_dev" else sep
    return err < bound and err < err_highest


def reduced_judge(torch, stats, engine, mode, plain):
    """A compare_hook judge for a row at a reduced mode: each launch as
    reduced_ok says. Where rows 1 and 4 run on the tensor cores it holds
    the launch against the plain version at "highest" on the same inputs
    too (row 3's bound is 1e-5 of max alone); stats.failed lists the
    launches that did not hold, stats.sep the largest sep."""
    def judge(outs, refs, args, kw):
        n = outs[0].shape[-1]
        err = max(rel_field(torch, a, b) for a, b in zip(outs, refs))
        err_h = sep = np.inf
        if on_tensor_cores(engine, mode, n) and engine != "kernel_dev":
            full = plain(*args, **dict(kw, precision="highest"))
            err_h = max(rel_field(torch, a, b) for a, b in zip(outs, full))
            sep = max(rel_field(torch, a, b) for a, b in zip(refs, full))
            stats.sep = max(stats.sep, sep)
        if not reduced_ok(engine, mode, n, err, err_h, sep):
            stats.failed.append(f"launch {stats.calls}: {err:.3e} of max "
                                f"(highest's {err_h:.3e}, sep {sep:.3e})")
    return judge


def dev_width_case(torch, dev, ldk, n, S, rng, nd=6, ni=3):
    """The split-form step's arguments at width n on S points of a passive
    random slab (nd doublings, pre-split) under a composite built by two
    plain steps at "highest", and the keywords but the mode."""
    from vsmartmom_torch.core.rt import (LayerRTDev, ns_doubling_schedule,
                                         vacuum_layer_dev)
    qp = np.linspace(0.1, 1.0, n) if n > 1 else np.array([0.5])
    sched = tuple(ns_doubling_schedule(0.5, float(qp.min()), nd))
    dtau, mqm = 0.5 / 2 ** nd, float(qp.min())

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    def dev_slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        e = rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm)
        g = np.full((S, n), np.exp(-dtau / mqm))
        return (f32(r), f32(g), f32(e), f32(rng.uniform(0, dtau, (S, n))),
                f32(rng.uniform(0, dtau, (S, n))))

    d = f32(np.resize([1.0, 1.0, -1.0, -1.0], n))
    ek = f32(np.full(S, np.exp(-dtau / 0.7)))
    dcomp = vacuum_layer_dev(S, n, torch.float32, dev)
    for scale in (1.0, 0.6):
        dcomp = LayerRTDev(*(x.contiguous() for x in
                             ldk.fused_layer_step_dev_plain(
                                 dcomp, *dev_slab(scale), ek, d,
                                 ns_schedule=sched, ni=4,
                                 precision="highest")))
    return (dcomp, *dev_slab(0.8), ek, d), dict(ns_schedule=sched, ni=ni)


def plain_width_case(torch, dev, lsk, LayerRT, n, S, rng, nd=6):
    """The plain-form layer step's arguments at width n on S points of a
    passive random slab (nd doublings, T with the direct diagonal
    e^(-dtau/mu)) under a composite built by two plain steps at "highest":
    (composite, elemental (r, t, jp, jm), ek, d, schedule). The doubling
    takes (*elemental, ek)."""
    from vsmartmom_torch.core.rt import ns_doubling_schedule, vacuum_layer
    qp = np.linspace(0.1, 1.0, n) if n > 1 else np.array([0.5])
    sched = tuple(ns_doubling_schedule(0.5, float(qp.min()), nd))
    dtau, mqm = 0.5 / 2 ** nd, float(qp.min())

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    def slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        t = (np.eye(n) * np.exp(-dtau / mqm)
             + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
        return (f32(r), f32(t), f32(rng.uniform(0, dtau, (S, n))),
                f32(rng.uniform(0, dtau, (S, n))))

    d = f32(np.resize([1.0, 1.0, -1.0, -1.0], n))
    ek = f32(np.full(S, np.exp(-dtau / 0.7)))
    comp = vacuum_layer(S, n, torch.float32, dev)
    for scale in (1.0, 0.6):
        comp = LayerRT(*(x.contiguous() for x in lsk.fused_layer_step_plain(
            comp, *slab(scale), ek, d, ns_schedule=sched, ni=4)))
    return comp, slab(0.8), ek, d, sched


def step_work(comp, r_f, *args, ns_schedule, ni, **kw):
    """(product FLOPs, device bytes) of one layer step launch (row 1)."""
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    s_, n_ = r_f.shape[0], r_f.shape[1]
    return (s_ * lsk.step_flops(n_, ns_schedule, ni),
            s_ * lsk.step_bytes(n_))


def scan_work(comp, tau_, omega_, zw_, *args, ns_schedule, inter_iters,
              **kw):
    """(product FLOPs, device bytes) of one layer-scan launch (row 5)."""
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    (nz_, s_), n_, k_ = tau_.shape, comp.r_mp.shape[-1], zw_.shape[1]
    return (s_ * nz_ * scn.scan_flops(n_, ns_schedule, inter_iters, k_),
            s_ * scn.scan_bytes(n_, nz_, k_))


def doubling_work(r, *args, ns_schedule, **kw):
    """(product FLOPs, device bytes) of one doubling launch (row 4)."""
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    s_, n_ = r.shape[0], r.shape[1]
    return (s_ * lsk.doubling_flops(n_, ns_schedule),
            s_ * dk.doubling_bytes(n_))


def dev_step_work(comp, r_f, *args, ns_schedule, ni, **kw):
    """(product FLOPs, device bytes) of one split-form step launch."""
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    s_, n_ = r_f.shape[0], r_f.shape[1]
    return (s_ * ldk.step_flops(n_, ns_schedule, ni),
            s_ * ldk.step_bytes(n_))


def width_class_phase(torch, dev, lsk, dk, scn, lnk, ldk, LayerRT,
                      wide_only=False):
    """The layer step, doubling, layer scan and lanes step kernels against
    their plain versions at every width of WIDTHS, the lanes step's wide
    path at LANES_WIDE_WIDTHS, and the split-form step at WIDTHS and
    DEV_WIDE_WIDTHS, at a ragged S (not a multiple of any block's points),
    on a passive random slab (nd = 6; the split form's pre-split) under a
    composite built by two plain steps. Each field within 1e-5 of its max.
    Rows 1, 3 and 4 also at each reduced mode of ROW_MODES against their
    plain version at that mode, which itself differs from the plain
    version at "highest" (reduced_ok). ``wide_only``: the lanes step's
    wide path alone.
    Returns the largest error per kernel (and mode) and N, and per wide
    width the wide path's milliseconds, its plain version's and its
    bound."""
    rng = np.random.default_rng(1)
    S, nd, ni, out, wide_ms = WIDTH_S, 6, 3, {}, {}

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    def worst(got, ref):
        return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(got, ref))

    def reduced(errs, name, engine, kernel, plain, args, kw):
        """A row at each reduced mode of ROW_MODES against its plain
        version at that mode, which is not the plain version at "highest",
        as reduced_ok says."""
        full = plain(*args, **kw, precision="highest")
        for mode in ROW_MODES[engine][1:]:
            ref = plain(*args, **kw, precision=mode)
            got = kernel(*args, **kw, precision=mode)
            e, sep = worst(got, ref), worst(ref, full)
            check(reduced_ok(engine, mode, n, e, worst(got, full), sep)
                  and sep > 0.0,
                  f"{name} at {mode} N={n} S={S}: {e:.3e} of max from its "
                  f"plain version at {mode}, which is {sep:.3e} of max from "
                  f"the plain version at highest")
            errs[f"{name}[{mode}]"] = e

    widths = (LANES_WIDE_WIDTHS if wide_only
              else {*WIDTHS, *DEV_WIDE_WIDTHS, *LANES_WIDE_WIDTHS})
    for n in sorted(widths):
        qp = np.linspace(0.1, 1.0, n) if n > 1 else np.array([0.5])
        errs = {}
        if not wide_only and (n in WIDTHS or n in DEV_WIDE_WIDTHS):
            dargs, dkw = dev_width_case(torch, dev, ldk, n, S, rng, nd, ni)
            errs["layer_step_dev"] = worst(
                ldk.fused_layer_step_dev(*dargs, **dkw, precision="highest"),
                ldk.fused_layer_step_dev_plain(*dargs, **dkw,
                                               precision="highest"))
            reduced(errs, "layer_step_dev", "kernel_dev",
                    ldk.fused_layer_step_dev, ldk.fused_layer_step_dev_plain,
                    dargs, dkw)
            del dargs
        comp, el, ek, d, sched = plain_width_case(torch, dev, lsk, LayerRT,
                                                  n, S, rng, nd)
        if n <= 63:
            args = (comp, *el, ek, d)
            errs["layer_step"] = worst(
                lsk.fused_layer_step(*args, ns_schedule=sched, ni=ni),
                lsk.fused_layer_step_plain(*args, ns_schedule=sched, ni=ni))
            errs["doubling"] = worst(
                dk.fused_doubling(*el, ek, ns_schedule=sched),
                dk.fused_doubling_plain(*el, ek, ns_schedule=sched))
            reduced(errs, "layer_step", "kernel", lsk.fused_layer_step,
                    lsk.fused_layer_step_plain, args,
                    dict(ns_schedule=sched, ni=ni))
            reduced(errs, "doubling", "kernel_doubling", dk.fused_doubling,
                    dk.fused_doubling_plain, (*el, ek),
                    dict(ns_schedule=sched))
        if n <= 63 or n in LANES_WIDE_WIDTHS:
            largs = (lnk.to_lanes(comp), *(lnk.to_lanes_m(x) for x in el[:2]),
                     *(lnk.to_lanes_v(x) for x in el[2:]), ek, d)
            lkw = dict(ns_schedule=sched, ni=ni)
            name = "lanes" if n <= 63 else "lanes_wide"
            errs[name] = worst(lnk.fused_layer_step_lanes(*largs, **lkw),
                               lnk.lanes_layer_step_plain(*largs, **lkw))
        if n in LANES_WIDE_WIDTHS:
            check(not lnk.team_path(n), f"N = {n} took the team path")
            wide_ms[n] = (cuda_ms(torch, lambda: lnk.fused_layer_step_lanes(
                                      *largs, **lkw), 3),
                          cuda_ms(torch, lambda: lnk.lanes_layer_step_plain(
                              *largs, **lkw), 1),
                          1e3 * max(S * lnk.step_flops(n, sched, ni)
                                    / PEAK_F32_FLOPS,
                                    S * lnk.step_bytes(n) / PEAK_BYTES))
        if n in WIDTHS and not wide_only:
            # the scan: two layers of a synthetic band, two Z components
            # whose rows sum to one against the weights
            nz, k = 2, 2
            wct2 = np.full(n, 1.0 / n)
            zc = rng.uniform(0.2, 1.0, (2, k, n, n))
            zc /= (zc * wct2).sum(-1, keepdims=True)
            tau = rng.uniform(0.2, 0.5, (nz, S))
            omega = rng.uniform(0.3, 0.9, (nz, S))
            zw = rng.uniform(0.2, 1.0, (nz, k, S))
            zw /= zw.sum(1, keepdims=True)
            i0 = np.zeros(n)
            i0[n // 2] = 1.0
            args = (comp, f32(tau), f32(omega), f32(zw),
                    f32(np.cumsum(tau, 0) - tau), f32(zc[0]), f32(zc[1]),
                    f32(qp), f32(wct2), f32(i0), d, 0.6, float(qp[n // 2]),
                    0.5 / np.pi)
            kw = dict(ns_schedule=sched, i_mu0_n=n // 2, n_stokes=1,
                      inter_iters=ni)
            errs["layer_scan"] = worst(
                scn.fused_layer_scan(*args, **kw),
                scn.fused_layer_scan_plain(*args, **kw))
        torch.cuda.synchronize()
        for name, e in errs.items():
            # a reduced mode ([mode]) is held as reduced_ok says
            check("[" in name or e < 1e-5, f"{name} N={n} S={S}: max|diff| "
                  f"/ max {e:.3e} >= 1e-5")
            out.setdefault(name, {})[n] = float(f"{e:.3e}")
    return out, wide_ms


#: the streams of tests/data/ref_yaml/PureRayleighParameters.yaml (RadauQuad,
#: l_trunc 20, sza 30, nine views, Stokes_IQUV): N = 92, the lanes step's
#: wide path
WIDE_PATH_STREAMS = ("RadauQuad", 20, 30.0,
                     [60.0, 45.0, 30.0, 15.0, 0.0, 15.0, 30.0, 45.0, 60.0], 4)


def wide_path_shape():
    """The headline atmosphere (headline_shape: 20 000 points, 10 layers, 3
    moments) under WIDE_PATH_STREAMS. Returns (pol, quad, band, surface,
    vza)."""
    from vsmartmom_torch.util.quadrature import rt_set_streams
    pol, _, band, surf = headline_shape()
    return (pol, rt_set_streams(*WIDE_PATH_STREAMS), band, surf,
            WIDE_PATH_STREAMS[3])


class _FirstLaunchDone(Exception):
    """Ends a run after its first lanes launch was measured."""


def lanes_wide_path_phase(torch, dev, tag, reset_counts, counts):
    """18. The lanes step's wide path on a full-width run:
    rt_run_band(engine="kernel_lanes") in float32 on wide_path_shape()
    (N = 92, one schedule bucket of 10 doublings: one launch a layer and
    moment, 30). The launches counted (the counts set to 0 just before),
    first and steady seconds, points/s, peak device memory (< 40 GiB) and
    the mean milliseconds of a launch in the steady run (CUDA events); the
    first launch's inputs held against the plain version (each field within
    1e-5 of its max) and both timed; R and T within 1e-3 of the float32
    torch engine at the same schedules, and the first 512 points within
    1e-3 of a float64 torch run. Returns the KernelStats of the wide kernel
    (ms: the steady run's launches; plain_ms, work: the compared launch)
    and the launches of a run."""
    from vsmartmom_torch.core.rt import LayerRT
    from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom_torch.cuda import lanes_kernel as lnk
    pol, quad, band, surf, vza = wide_path_shape()
    n, (nz, ns), max_m = len(quad.qp_mu_n), band.tau.shape, 3
    check(n == 92 and not lnk.team_path(n), f"the wide path's streams give "
          f"N = {n}")

    def run(engine, dtype=torch.float32, band_=band):
        return rt_run_band(pol, quad, band_, vza, [0.0] * len(vza), max_m,
                           surf, dtype=dtype, device=dev, solver="schulz",
                           engine=engine)

    real = lnk.fused_layer_step_lanes
    first = []

    def capture(*args, **kw):
        if not first:
            first.append(([x.clone() for x in args[0]],
                          [x.clone() for x in args[1:]], dict(kw)))
        return real(*args, **kw)

    reset_counts()
    torch.cuda.synchronize()
    lnk.fused_layer_step_lanes = capture
    try:
        t0 = time.perf_counter()
        R, T = run("kernel_lanes")
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
    finally:
        lnk.fused_layer_step_lanes = real
    c = counts()
    launches = c["kernel_lanes"]
    check(launches == max_m * nz and sum(c.values()) == launches,
          f"N = 92 kernel_lanes: launches {c}, expected {max_m * nz} of "
          f"kernel_lanes only")
    check(np.isfinite(R).all() and np.isfinite(T).all(),
          "N = 92 kernel_lanes: non-finite R/T")

    events = []

    def timed(*args, **kw):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = real(*args, **kw)
        e[1].record()
        events.append(e)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    lnk.fused_layer_step_lanes = timed
    try:
        t0 = time.perf_counter()
        run("kernel_lanes")
        torch.cuda.synchronize()
        t_steady = time.perf_counter() - t0
    finally:
        lnk.fused_layer_step_lanes = real
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(peak < 40.0, f"N = 92 kernel_lanes: peak {peak:.2f} GiB >= 40")
    st = KernelStats()
    st.ms = [e[0].elapsed_time(e[1]) for e in events]
    check(len(st.ms) == launches, "N = 92: the steady run's launches")

    comp, rest, kw = first.pop()
    args = (LayerRT(*comp), *rest)
    out = real(*args, **kw)
    ref = lnk.lanes_layer_step_plain(*args, **kw)
    for a, b in zip(out, ref):
        err, scale = field_err(torch, a, b)
        st.abs = max(st.abs, err)
        st.rel = max(st.rel, err / max(scale, 1e-30))
    check(st.rel < 1e-5, f"N = 92 wide kernel vs plain: {st.rel:.3e} of "
          f"max >= 1e-5")
    del out, ref
    st.calls = 1
    st.flops = ns * lnk.step_flops(n, kw["ns_schedule"], kw["ni"])
    st.nbytes = ns * lnk.step_bytes(n)
    launch_ms = cuda_ms(torch, lambda: real(*args, **kw), 2)
    st.plain_ms = [cuda_ms(torch,
                           lambda: lnk.lanes_layer_step_plain(*args, **kw),
                           1)]
    del args, comp, rest

    t0 = time.perf_counter()
    Rt, Tt = run("torch")
    torch.cuda.synchronize()
    t_torch = time.perf_counter() - t0
    rel_r, rel_t = rel_err(R, Rt), rel_err(T, Tt)
    cut = BandRTInputs(tau=band.tau[:, :512], omega=band.omega[:, :512],
                       zw=band.zw[:, :, :512], greeks=band.greeks)
    R64, T64 = run("torch", torch.float64, cut)
    rel_r64, rel_t64 = rel_err(R[..., :512], R64), rel_err(T[..., :512], T64)
    ms, plain_ms = st.mean_ms()
    bound, by = st.bound()
    print(f"lanes wide path, N = {n} run (S = {ns}, {nz} layers, {max_m} "
          f"moments, schedule {kw['ns_schedule']}, ni {kw['ni']}): "
          f"{launches} launches; first {t_first:.3f} s, steady "
          f"{t_steady:.3f} s = {ns / t_steady:.1f} points/s, peak "
          f"{peak:.2f} GiB; kernel {ms:.3f} ms per launch (mean of the "
          f"steady run; {launch_ms:.3f} ms for the compared launch alone), "
          f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}), "
          f"{bound / ms:.2%} of bound; vs plain max|diff| {st.abs:.3e} "
          f"({st.rel:.3e} of max); vs the float32 torch engine "
          f"({t_torch:.3f} s) max|dR|/max R {rel_r:.3e}, max|dT|/max T "
          f"{rel_t:.3e}; first 512 points vs float64 {rel_r64:.3e}, "
          f"{rel_t64:.3e} {tag}")
    check(rel_r < 1e-3 and rel_t < 1e-3, "N = 92 kernel_lanes R/T off the "
          "float32 torch engine by >= 1e-3")
    check(rel_r64 < 1e-3 and rel_t64 < 1e-3, "N = 92 kernel_lanes R/T off "
          "float64 by >= 1e-3")
    return st, launches


def print_wide_widths(wide_ms, tag):
    for n, (ms, plain_ms, bound) in sorted(wide_ms.items()):
        print(f"lanes step, wide path (N = {n}, S = {WIDTH_S}): kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms, "
              f"{bound / ms:.2%} of bound {tag}")


def lanes_wide_only():
    """The build (phase 1), the lanes step's wide path at the widths of
    LANES_WIDE_WIDTHS (phase 1b) and on the N = 92 run (phase 18), on the
    card:
    python3 -c 'import chip_smoke; chip_smoke.lanes_wide_only()'."""
    torch = setup()
    from vsmartmom_torch.core.rt import LayerRT
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import lanes_kernel as lnk
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    dev = torch.device("cuda:0")
    card = card_name()
    tag = f"[card: {card}]"
    build_phase(tag)
    widths, wide_ms = width_class_phase(torch, dev, lsk, dk, scn, lnk, ldk,
                                        LayerRT, wide_only=True)
    print(f"wide widths (S = {WIDTH_S}): max|diff| / max by N: "
          f"{json.dumps(widths)} {tag}")
    print_wide_widths(wide_ms, tag)
    st, launches = lanes_wide_path_phase(torch, dev, tag, reset_counts,
                                         counts)
    print(f"card: {card}")
    print(json.dumps({"kernels": [st.entry(
        "lanes_wide_kernel", "vsmartmom_torch/csrc/lanes.cu",
        "vsmartmom/pallas/lanes_kernel.py:135", launches)]}))


def lanes_wide_times():
    """The first launch of the N = 92 run (phase 18) against its plain
    version, each timed with CUDA events, as one JSON line, through entry
    points that every design of the lanes step kept (rt_run_band's
    kernel_lanes engine, fused_layer_step_lanes, lanes_layer_step_plain),
    so that a copy of this script beside an older tree times that tree's
    wide path: python3 -c 'import chip_smoke; chip_smoke.lanes_wide_times()'.
    The run ends after that launch."""
    torch = setup()
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.cuda import lanes_kernel as lnk
    pol, quad, band, surf, vza = wide_path_shape()
    real, out = lnk.fused_layer_step_lanes, {}

    def first(comp_l, r_f, *args, ns_schedule, ni):
        a, kw = (comp_l, r_f, *args), dict(ns_schedule=ns_schedule, ni=ni)
        n, s = r_f.shape[0], r_f.shape[2]
        got = real(*a, **kw)
        ref = lnk.lanes_layer_step_plain(*a, **kw)
        out.update(
            n=n, S=s, schedule=list(ns_schedule), ni=ni,
            max_rel_err=max(float((x - y).abs().max() / y.abs().max())
                            for x, y in zip(got, ref)),
            ms=cuda_ms(torch, lambda: real(*a, **kw), 1),
            plain_ms=cuda_ms(torch,
                             lambda: lnk.lanes_layer_step_plain(*a, **kw), 1),
            bound_ms=1e3 * s * lnk.step_flops(n, ns_schedule, ni)
            / PEAK_F32_FLOPS)
        raise _FirstLaunchDone

    lnk.fused_layer_step_lanes = first
    try:
        rt_run_band(pol, quad, band, vza, [0.0] * len(vza), 3, surf,
                    dtype=torch.float32, device="cuda:0", solver="schulz",
                    engine="kernel_lanes")
    except _FirstLaunchDone:
        pass
    finally:
        lnk.fused_layer_step_lanes = real
    check(bool(out), "the N = 92 run made no lanes launch")
    print(json.dumps({"shape": "lanes_wide_n92", **out, "card": card_name()}),
          flush=True)

#: dev_tc_phase's widths: each tile class of the split-form step, its
#: edges and the flagship's, 3-band's and headline's N
DEV_TC_WIDTHS = (1, 15, 16, 17, 30, 44, 64, 65, 75)


def row3_mode_run(torch, dev, model, mode, expected, R64, **run_kw):
    """Row 3 at product mode ``mode`` on a model's run (rt_run, engine
    kernel_dev, dd_precision=mode, run_kw): the launch counts set to 0 just
    before it and read after it (``expected`` launches of row 3 and nothing
    else), R finite and within 1e-3 of max of R64 (the float64 torch
    engine); then the run again with every launch held against the plain
    version at that mode and timed with CUDA events. Returns (KernelStats,
    the launches of the counted run, R's error)."""
    import vsmartmom_torch as vt
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    kw = dict(device=dev, engine="kernel_dev", dd_precision=mode, **run_kw)
    reset_counts()
    torch.cuda.synchronize()
    R, _ = vt.rt_run(model, **kw)
    torch.cuda.synchronize()
    c = counts()
    check(c["kernel_dev"] == expected and sum(c.values()) == expected,
          f"kernel_dev at {mode}: launches {c}, expected {expected} of "
          f"kernel_dev only")
    rel_r = rel_err(R, R64)
    check(bool(np.isfinite(R).all()) and rel_r < 1e-3, f"kernel_dev at "
          f"{mode}: R {rel_r:.3e} of max off float64")
    st = KernelStats(mode)
    real = ldk.fused_layer_step_dev
    ldk.fused_layer_step_dev = compare_hook(
        torch, st, real, ldk.fused_layer_step_dev_plain, dev_step_work)
    try:
        vt.rt_run(model, **kw)
    finally:
        ldk.fused_layer_step_dev = real
    check(st.calls == expected, f"kernel_dev at {mode}: {st.calls} compared "
          f"launches, expected {expected}")
    return st, c["kernel_dev"], rel_r


def row3_line(label, mode, st, launches, rel_r, tag, highest_ms=None):
    """One printed line of row 3 at a mode on a path."""
    ms, plain_ms = st.mean_ms()
    bound, by = st.bound()
    than = f" ({ms / highest_ms:.2f}x highest)" if highest_ms else ""
    vs64 = "" if rel_r is None else f"; R vs float64 {rel_r:.3e}"
    return (f"row 3 {label} at {mode}: {launches} launches; vs plain at "
            f"{mode} max|diff| {st.abs:.3e} ({st.rel:.3e} of max, bit-equal "
            f"{st.abs == 0.0}); kernel {ms:.3f} ms{than}, plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), {bound / ms:.2%}"
            f" of bound per launch{vs64} {tag}")


def dev_tc_phase(torch, dev, tag):
    """Row 3 (the split-form step) at each mode of ROW_MODES: "bf16x3" on
    the tensor-core body, "highest" and "default" on the CUDA cores. (a) The
    Float32 flagship (N = 15) and (b) the 3-band configuration (N = 30)
    through rt_run with engine kernel_dev (row3_mode_run: 102 launches
    each, counted, every launch against its plain version at the mode, R
    against float64); (c) the N = 44 slab of headline_width_calls; (d) the
    widths DEV_TC_WIDTHS at the ragged WIDTH_S (dev_width_case). Each with
    the kernel's time, the plain version's and the bound. "highest" is
    bit-equal to its plain version; a reduced mode holds as reduced_ok
    says (bf16x3 within 1e-5 of max per field, "default" bit-equal). Prints
    every line, then fails if any did not hold. Returns the flagship's
    kernels-line entries."""
    import vsmartmom_torch as vt
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    modes = ROW_MODES["kernel_dev"]
    name, source, replaces = ROW_SOURCES["kernel_dev"]
    bad, entries = [], []

    def held(mode, err, err_highest, what):
        ok = err == 0.0 if mode == "highest" else reduced_ok(
            "kernel_dev", mode, None, err, err_highest, None)
        if not ok:
            bad.append(f"{what} at {mode}: {err:.3e} of max from its plain "
                       f"version ({err_highest:.3e} from highest's)")

    # ---- (a), (b) the flagship and the 3-band configuration ---------------
    for label, yaml in (("flagship", None), ("3-band", THREE_BAND_YAML)):
        params = (vt.default_parameters() if yaml is None
                  else vt.parameters_from_yaml(os.path.join(HERE, yaml)))
        params.float_type = "Float32"
        run_kw = {} if yaml is None else {
            "i_band": list(range(len(params.spec_bands)))}
        model = vt.model_from_parameters(params, device=dev)
        n_z, max_m = model.profile.n_layers, params.max_m
        n = len(model.quad_points.qp_mu_n)
        n_spec = sum(len(b) for b in params.spec_bands)
        R64, _ = vt.rt_run(model, dtype=torch.float64, device=dev,
                           engine="torch", **run_kw)
        highest_ms = None
        for mode in modes:
            st, launches, rel_r = row3_mode_run(torch, dev, model, mode,
                                                max_m * n_z, R64, **run_kw)
            held(mode, st.rel if mode != "highest" else st.abs, np.inf,
                 f"{label} kernel_dev")
            highest_ms = highest_ms or st.mean_ms()[0]
            print(row3_line(f"{label} (N={n}, S={n_spec})", mode, st,
                            launches, rel_r, tag, highest_ms), flush=True)
            if label == "flagship":
                entries.append(st.entry(f"{name}[{mode}]", source, replaces,
                                        launches))
        del model, R64

    # ---- (c) the N = 44 slab, (d) the widths -------------------------------
    calls, S, n, nd = headline_width_calls(torch, dev, lsk, ldk)
    cases = [(f"N = {n} slab (S={S}, nd={nd})", *calls["kernel_dev"])]
    del calls
    rng = np.random.default_rng(1)
    for w in DEV_TC_WIDTHS:
        cases.append((f"width N = {w} (S={WIDTH_S})",
                      *dev_width_case(torch, dev, ldk, w, WIDTH_S, rng)))
    for label, args, kw0 in cases:
        full = ldk.fused_layer_step_dev_plain(*args, **kw0,
                                              precision="highest")
        highest_ms = None
        for mode in modes:
            kw = dict(kw0, precision=mode)
            got = ldk.fused_layer_step_dev(*args, **kw)
            ref = ldk.fused_layer_step_dev_plain(*args, **kw)
            st = KernelStats(mode)
            st.calls = 1
            for a, b in zip(got, ref):
                err, scale = field_err(torch, a, b)
                st.abs = max(st.abs, err)
                st.rel = max(st.rel, err / max(scale, 1e-30))
            err_h = max(rel_field(torch, a, b) for a, b in zip(got, full))
            held(mode, st.rel if mode != "highest" else st.abs, err_h, label)
            del got, ref
            st.flops, st.nbytes = dev_step_work(*args, **kw0)
            st.ms = [cuda_ms(torch, lambda: ldk.fused_layer_step_dev(
                *args, **kw), 3)]
            st.plain_ms = [cuda_ms(
                torch, lambda: ldk.fused_layer_step_dev_plain(*args, **kw), 1)]
            highest_ms = highest_ms or st.ms[0]
            print(row3_line(label, mode, st, 1, None, tag, highest_ms)
                  + f" (vs plain at highest {err_h:.3e})", flush=True)
        del full
    check(not bad, "row 3: " + "; ".join(bad))
    return entries


def dev_tc_only():
    """The build (phase 1) and dev_tc_phase, on the card:
    python3 -c 'import chip_smoke; chip_smoke.dev_tc_only()'."""
    torch = setup()
    card = card_name()
    tag = f"[card: {card}]"
    build_phase(tag)
    entries = dev_tc_phase(torch, torch.device("cuda:0"), tag)
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))


def dev_tc_times():
    """dev_tc_phase alone: it uses only entry points that every design of
    row 3's modes kept (rt_run's kernel_dev engine with dd_precision,
    fused_layer_step_dev and its plain version), so a copy of this script
    beside an older tree times that tree's design:
    python3 -c 'import chip_smoke; chip_smoke.dev_tc_times()'."""
    torch = setup()
    dev_tc_phase(torch, torch.device("cuda:0"), f"[card: {card_name()}]")


#: step_tc_phase's widths: each tile class of the plain-form step and
#: doubling and its edges, and the flagship's, 3-band's and headline's N
STEP_TC_WIDTHS = (1, 15, 16, 17, 30, 32, 33, 44, 48, 49, 63)


def step_tc_line(name, label, mode, st, launches, tag, highest_ms,
                 extra=""):
    """One printed line of row 1 or 4 (its wrapper's name) at a mode on a
    path."""
    ms, plain_ms = st.mean_ms()
    bound, by = st.bound()
    sep = f", sep {st.sep:.3e}" if st.sep else ""
    return (f"{name} {label} at {mode}: {launches} launches; vs plain at "
            f"{mode} max|diff| {st.abs:.3e} ({st.rel:.3e} of max{sep}, "
            f"bit-equal {st.abs == 0.0}); kernel {ms:.3f} ms "
            f"({ms / highest_ms:.2f}x highest), plain {plain_ms:.3f} ms, "
            f"bound {bound:.4f} ms ({by}), {bound / ms:.2%} of bound per "
            f"launch{extra} {tag}")


def step_tc_phase(torch, dev, tag):
    """Rows 1 (the layer step) and 4 (the doubling) at each mode of
    ROW_MODES: "high" on the tensor-core bodies up to STEP_TC_MAX_N (held
    as reduced_ok says), on the CUDA cores beyond (held bit-equal);
    "highest" and "default" on the CUDA cores. (a) The Float32 flagship
    (N = 15) through rt_run with engine kernel and kernel_doubling at
    matmul_precision=mode, the launch counts set to 0 just before each run
    and read after it (102 launches of the row and nothing else), R against
    the float64 torch engine at the same schedules and the steady seconds
    printed; then the run again with every launch held against its plain
    version at the mode (reduced_judge) and timed with CUDA events; (b) the
    N = 44 slab of headline_width_calls; (c) the widths STEP_TC_WIDTHS at
    the ragged WIDTH_S (plain_width_case). Each with the kernel's time, the
    plain version's and the bound. "highest" within 1e-5 of max of its
    plain version, the reduced modes as reduced_ok says (bit-equal on the
    CUDA cores). It uses only entry points that every design of rows
    1 and 4 kept, so a copy of this script beside an older tree times that
    tree's design. Prints every line, then fails if any did not hold.
    Returns the flagship's kernels-line entries."""
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt import LayerRT
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    rows = {"kernel": (lsk, "fused_layer_step", lsk.fused_layer_step_plain,
                       step_work),
            "kernel_doubling": (dk, "fused_doubling",
                                dk.fused_doubling_plain, doubling_work)}
    bad, entries = [], []

    # ---- (a) the flagship ---------------------------------------------------
    params = vt.default_parameters()
    params.float_type = "Float32"
    model = vt.model_from_parameters(params, device=dev)
    n_z, max_m = model.profile.n_layers, params.max_m
    n, n_spec = len(model.quad_points.qp_mu_n), len(params.spec_bands[0])
    R64, _ = rt_run_band(model.pol, model.quad_points,
                         build_band_inputs(model, 0), model.obs_geom.vza,
                         model.obs_geom.vaz, max_m, params.surfaces[0],
                         dtype=torch.float64, device=dev, solver="schulz",
                         engine="torch")
    for engine, (mod, name, plain, work) in rows.items():
        highest_ms = None
        for mode in ROW_MODES[engine]:
            kw = dict(device=dev, engine=engine, matmul_precision=mode)
            reset_counts()
            torch.cuda.synchronize()
            R, _ = vt.rt_run(model, **kw)
            torch.cuda.synchronize()
            c = counts()
            if c[engine] != max_m * n_z or sum(c.values()) != c[engine]:
                bad.append(f"flagship {engine} at {mode}: launches {c}")
            t0 = time.perf_counter()
            vt.rt_run(model, **kw)
            torch.cuda.synchronize()
            t_steady = time.perf_counter() - t0
            st = KernelStats(mode)
            real = getattr(mod, name)
            setattr(mod, name, compare_hook(
                torch, st, real, plain, work,
                judge=(None if mode == "highest"
                       else reduced_judge(torch, st, engine, mode, plain))))
            try:
                vt.rt_run(model, **kw)
            finally:
                setattr(mod, name, real)
            if mode == "highest" and st.rel >= 1e-5:
                st.failed.append(f"{st.rel:.3e} of max")
            if st.calls != max_m * n_z or st.failed:
                bad.append(f"flagship {engine} at {mode}: {st.calls} "
                           f"compared launches; did not hold: "
                           f"{st.failed[:5]}")
            highest_ms = highest_ms or st.mean_ms()[0]
            print(step_tc_line(
                name, f"flagship (N={n}, S={n_spec})", mode, st, c[engine],
                tag,
                highest_ms,
                f"; tensor cores {on_tensor_cores(engine, mode, n)}; R "
                f"finite {bool(np.isfinite(R).all())}, vs float64 "
                f"{rel_err(R, R64):.3e}; rt_run steady {t_steady:.3f} s"),
                flush=True)
            entries.append(st.entry(f"{name}[{mode}]",
                                    ROW_SOURCES[engine][1],
                                    ROW_SOURCES[engine][2], c[engine]))
    del model, R64

    # ---- (b) the N = 44 slab, (c) the widths -------------------------------
    calls, S, n44, nd = headline_width_calls(torch, dev, lsk, ldk)
    cases = [(f"N = {n44} slab (S={S}, nd={nd})", n44,
              {e: calls[e] for e in rows})]
    del calls
    rng = np.random.default_rng(1)
    for w in STEP_TC_WIDTHS:
        comp, el, ek, d, sched = plain_width_case(torch, dev, lsk, LayerRT,
                                                  w, WIDTH_S, rng)
        cases.append((f"width N = {w} (S={WIDTH_S})", w, {
            "kernel": ((comp, *el, ek, d), dict(ns_schedule=sched, ni=3)),
            "kernel_doubling": ((*el, ek), dict(ns_schedule=sched))}))
    for label, w, row_args in cases:
        for engine, (mod, name, plain, work) in rows.items():
            args, kw0 = row_args[engine]
            real = getattr(mod, name)
            full = plain(*args, **kw0, precision="highest")
            highest_ms = None
            for mode in ROW_MODES[engine]:
                kw = dict(kw0, precision=mode)
                got, ref = real(*args, **kw), plain(*args, **kw)
                st = KernelStats(mode)
                st.calls = 1
                for a, b in zip(got, ref):
                    err, scale = field_err(torch, a, b)
                    st.abs = max(st.abs, err)
                    st.rel = max(st.rel, err / max(scale, 1e-30))
                err_h = max(rel_field(torch, a, b) for a, b in zip(got, full))
                st.sep = max(rel_field(torch, a, b) for a, b in zip(ref, full))
                ok = (st.rel < 1e-5 if mode == "highest" else reduced_ok(
                    engine, mode, w, st.rel, err_h, st.sep))
                if not ok:
                    bad.append(f"{name} {label} at {mode}: {st.rel:.3e} of "
                               f"max from its plain version ({err_h:.3e} "
                               f"from highest's, sep {st.sep:.3e})")
                del got, ref
                st.flops, st.nbytes = work(*args, **kw0)
                st.ms = [cuda_ms(torch, lambda: real(*args, **kw), 3)]
                st.plain_ms = [cuda_ms(torch, lambda: plain(*args, **kw), 1)]
                highest_ms = highest_ms or st.ms[0]
                print(step_tc_line(
                    name, label, mode, st, 1, tag, highest_ms,
                    f"; tensor cores {on_tensor_cores(engine, mode, w)}; vs "
                    f"plain at highest {err_h:.3e}"), flush=True)
            del full
    check(not bad, "rows 1 and 4: " + "; ".join(bad))
    return entries


def step_tc_only():
    """The build (phase 1), check_step_routing and step_tc_phase, on the
    card: python3 -c 'import chip_smoke; chip_smoke.step_tc_only()'."""
    torch = setup()
    card = card_name()
    tag = f"[card: {card}]"
    build_phase(tag)
    check_step_routing()
    entries = step_tc_phase(torch, torch.device("cuda:0"), tag)
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))


#: widths of tangent_only's synthetic check: the classes the tangent kernel
#: is built for, their edges and its widest width (44)
TANGENT_WIDTHS = (1, 13, 15, 16, 17, 30, 32, 33, 44)
#: tangent columns of a flagship Jacobian (the retrieval state's three)
TANGENT_K = 3


def plain_tangent(torch, lsk, prim, tan, ns_schedule, ni, precision):
    """The parent's tangent of row 1 for K columns: torch.func.jvp of the
    plain version (build.tangent_of_plain) under a vmap over the columns,
    as jacfwd runs it."""
    def one(*t):
        return torch.func.jvp(
            lambda *xs: lsk._plain_flat(*xs, ns_schedule, ni, precision),
            tuple(prim), t)[1]
    return torch.func.vmap(one)(*tan)


def tangent_work(lsk, prim, tan, ns_schedule, ni, **kw):
    """(FLOPs, device bytes) of one tangent launch of K columns: (1 + 2K)
    step_flops a point (the primal once, dA B + A dB a column); the primal
    inputs read once, each column's tangent inputs read and its output
    tangents written once."""
    s, n = prim[6].shape[0], prim[6].shape[1]
    k = tan[6].shape[0]
    out_b = 4 * (4 * n * n + 2 * n)
    in_b = lsk.step_bytes(n) - out_b
    return (s * (1 + 2 * k) * lsk.step_flops(n, ns_schedule, ni),
            s * (in_b + k * (in_b + out_b)))


def tangent_only(widths=TANGENT_WIDTHS, modes=("highest", "high", "default")):
    """Row 1's tangent kernel on the card (csrc/layer_step_tangent.cu), and
    the flagship Jacobian's routing: python3 -c 'import chip_smoke;
    chip_smoke.tangent_only()'.

    (a) The build (phase 1). (b) At each width of ``widths`` on a synthetic
    slab (S = 1 007, K = 3 random tangent columns) and each mode, the
    kernel's output tangents against the parent's (plain_tangent): "highest"
    within 1e-5 of each field's max; a reduced mode no farther from it
    than the plain version's tangent at "highest" is (sep). (c) One flagship Jacobian
    (jacfwd through engine kernel, float32, 3 columns) with the counters
    reset before: 102 primal launches, 102 tangent launches, no plain
    tangent. (d) The same Jacobian with every tangent launch held against
    the parent's tangent on its inputs (1e-5 of each field's max) and both
    timed with CUDA events; the kernel's share of its bound, FLOPs (1 + 2K)
    step_flops. Last line: one JSON object."""
    torch = setup()
    import vsmartmom_torch as vt
    import vsmartmom_torch.core.rt_run as rtr
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt import LayerRT
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.retrieval_demo import state_radiance
    card = card_name()
    tag = f"[card: {card}]"
    dev = torch.device("cuda:0")
    build_phase(tag)
    rng = np.random.default_rng(21)
    widths_out = {}
    for n in widths:
        comp, elem, ek, d, sched = plain_width_case(
            torch, dev, lsk, LayerRT, n, WIDTH_S, rng)
        prim = [*comp, *elem, ek, d]
        tan = [(torch.randn((TANGENT_K, *x.shape), device=dev,
                            generator=torch.Generator(dev).manual_seed(i))
                * x.abs().max().clamp_min(1e-3)).contiguous()
               for i, x in enumerate(prim)]
        ref_hi = plain_tangent(torch, lsk, prim, tan, sched, 3, "highest")
        row = {}
        for mode in modes:
            got = lsk._launch_tangent(prim, tan, sched, 3, mode)
            ref = (ref_hi if mode == "highest" else
                   plain_tangent(torch, lsk, prim, tan, sched, 3, mode))
            err = max(rel_field(torch, a, b) for a, b in zip(got, ref))
            sep = max(rel_field(torch, a, b) for a, b in zip(ref_hi, ref))
            row[mode] = (err, sep)
            check(err < 1e-5 if mode == "highest" else err <= sep,
                  f"tangent kernel N = {n} {mode}: {err:.3e} of max from "
                  f"the plain tangent (sep {sep:.3e})")
        widths_out[n] = row
        print(f"tangent kernel N = {n}, S = {WIDTH_S}, K = {TANGENT_K}: "
              f"(err, sep) by mode "
              f"{ {m: ('%.3e' % e, '%.3e' % s) for m, (e, s) in row.items()} }"
              f" {tag}")

    params = vt.default_parameters()
    params.float_type = "Float32"
    model = vt.model_from_parameters(params, device=dev)
    band = build_band_inputs(model, 0)
    f32, _ = state_radiance(model.pol, model.quad_points, band,
                            model.obs_geom.vza, model.obs_geom.vaz,
                            params.max_m, torch.float32, dev, "kernel",
                            "schulz")
    n_z = band.tau.shape[0]
    x = torch.tensor((0.0, float(params.surfaces[0]["albedo"]), 0.0),
                     dtype=torch.float32, device=dev)
    jac = torch.func.jacfwd(f32)
    jac(x)
    torch.cuda.synchronize()
    lsk.launches = lsk.tangent_launches = lsk.plain_tangents = 0
    t0 = time.perf_counter()
    J = jac(x)
    torch.cuda.synchronize()
    t_jac = time.perf_counter() - t0
    counters = {"launches": lsk.launches,
                "tangent_launches": lsk.tangent_launches,
                "plain_tangents": lsk.plain_tangents}
    print(f"flagship Jacobian (jacfwd, engine kernel, float32, "
          f"{TANGENT_K} columns): {t_jac:.3f} s, counters {counters} {tag}")
    check(counters == {"launches": params.max_m * n_z,
                       "tangent_launches": params.max_m * n_z,
                       "plain_tangents": 0},
          f"flagship Jacobian counters {counters}")

    stats = KernelStats()
    fields = {}
    real = lsk._launch_tangent

    def hooked(prim, tan, ns_schedule, ni, precision):
        out = real(prim, tan, ns_schedule, ni, precision)
        ref = plain_tangent(torch, lsk, prim, tan, ns_schedule, ni,
                            precision)
        for name, a, b in zip(LayerRT._fields, out, ref):
            fields[name] = max(fields.get(name, 0.0),
                               rel_field(torch, a, b))
        flops, nbytes = tangent_work(lsk, prim, tan, ns_schedule, ni)
        stats.calls += 1
        stats.flops += flops
        stats.nbytes += nbytes
        stats.ms.append(cuda_ms(torch, lambda: real(
            prim, tan, ns_schedule, ni, precision), 3))
        stats.plain_ms.append(cuda_ms(torch, lambda: plain_tangent(
            torch, lsk, prim, tan, ns_schedule, ni, precision), 1))
        return out
    lsk._launch_tangent = hooked
    try:
        J2 = jac(x)
    finally:
        lsk._launch_tangent = real
    entry = stats.entry("layer_step_tangent_kernel",
                        "csrc/layer_step_tangent.cu",
                        "build.tangent_of_plain (torch.func.jvp of row 1's "
                        "plain version)", stats.calls)
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    entry["max_rel_err_by_field"] = fields
    print(f"flagship tangent launches: {stats.calls}, kernel "
          f"{entry['ms']:.3f} ms a launch, plain tangent "
          f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), share {100 * entry['share_of_bound']:.2f}"
          f" %; largest gap of max by field "
          f"{ {k: '%.3e' % v for k, v in fields.items()} } {tag}")
    check(max(fields.values()) < 1e-5, f"flagship tangent off the plain "
          f"tangent by >= 1e-5 of max: {fields}")
    check(rel_field(torch, J2, J) < 1e-6, "flagship Jacobian changed when "
          "hooked")
    print(f"card: {card}")
    print(json.dumps({"tangent_kernel": entry, "jacobian_s": t_jac,
                      "counters": counters,
                      "widths": {str(k): v for k, v in widths_out.items()}}))


def step_tc_times():
    """step_tc_phase alone, without the build's resource check, for a copy
    of this script beside an older tree:
    python3 -c 'import chip_smoke; chip_smoke.step_tc_times()'."""
    torch = setup()
    step_tc_phase(torch, torch.device("cuda:0"), f"[card: {card_name()}]")


#: the reference's OCO-2-style configuration (tests/data/ref_yaml): O2
#: A-band, weak and strong CO2 on one concatenated spectral axis
THREE_BAND_YAML = os.path.join("tests", "data", "ref_yaml",
                               "3BandParameters.yaml")
#: an RPV surface for every band (the concatenated-BRDF branch)
THREE_BAND_RPV = {"type": "rpvSurfaceScalar", "rho0": 0.1, "rho_c": 0.6,
                  "k": 0.7, "theta": -0.1}


def three_band_phase(torch, dev, tag, reset_counts, counts, works):
    """12. (h) The reference's 3-band configuration at full width in
    Float32: model build (Voigt launches per band and molecule with lines)
    and rt_run(model, i_band=[0, 1, 2]) under auto (the scan), kernel,
    kernel_scan, kernel_dev and kernel_lanes, each held against the float64
    torch engine; the
    concatenated run against per-band runs at its schedules; an RPV surface
    on every band; rows 1, 3, 5 and 6 at this shape, every launch held
    against its plain version and timed with CUDA events (works maps each
    engine to the function that counts a launch's work)."""
    import vsmartmom_torch as vt
    import vsmartmom_torch.core.rt_run as rtr
    from vsmartmom_torch.core.api import (_concat_surface, band_spec_lim,
                                          concat_band_inputs)
    from vsmartmom_torch.cuda import lanes_kernel as lnk
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile
    from vsmartmom_torch.util import timing

    params = vt.parameters_from_yaml(os.path.join(HERE, THREE_BAND_YAML))
    params.float_type = "Float32"
    ap = params.absorption_params
    bands = list(range(len(params.spec_bands)))

    voigt_calls = [(ib, mol) for ib in bands for mol in ap.molecules[ib]
                   if has_lines(mol, params.spec_bands[ib], ap.wing_cutoff)]

    # the main path: build and one run, launches counted
    reset_counts()
    rtr.auto_choices.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = vt.model_from_parameters(params, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_voigt = vk.launches
    t0 = time.perf_counter()
    R, T = vt.rt_run(model, i_band=bands, device=dev)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    c = counts()
    n_spec = sum(len(b) for b in params.spec_bands)
    n_z, max_m = model.profile.n_layers, params.max_m
    n = len(model.quad_points.qp_mu_n)
    band = concat_band_inputs(model, bands)
    min_mu = float(np.min(model.quad_points.qp_mu))
    sched = rtr.build_layer_schedules(band.tau, band.omega, min_mu, "schulz")
    n_scan = max_m * len(rtr.schedule_buckets(
        rtr._per_layer_schedules(n_z, "schulz", *sched)))
    print(f"3-band: nSpec={n_spec} ({[len(b) for b in params.spec_bands]}),"
          f" nZ={n_z}, max_m={max_m}, N={n}, K={band.zw.shape[1]}; build "
          f"{t_build:.3f} s; launches: voigt {n_voigt}, rt_run {c} (auto "
          f"took {rtr.auto_choices}) {tag}")
    check(n_voigt == len(voigt_calls), f"3-band: {n_voigt} Voigt launches, "
          f"expected one per band and molecule with lines: {voigt_calls}")
    check(rtr.auto_choices == {"kernel_scan": 1}, f"3-band auto took "
          f"{rtr.auto_choices}, expected kernel_scan")
    check(c["kernel_scan"] == n_scan and sum(c.values()) == n_scan
          + n_voigt, f"3-band auto: launches {c}, expected {n_scan} "
          f"layer-scan launches and nothing else")
    check(R.shape == (1, 3, n_spec) and T.shape == R.shape,
          f"3-band R/T shape {R.shape}/{T.shape}")
    check(np.isfinite(R).all() and np.isfinite(T).all(),
          "3-band: non-finite R/T")
    check(np.all(R[0, 0] > 0) and np.all(R[0, 0] < 1),
          "3-band: I outside (0, 1)")

    def steady(**kw):
        best = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            vt.rt_run(model, i_band=bands, device=dev, **kw)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    t_auto = steady()
    timing.reset_timer()
    timing.enable_timer()
    try:
        vt.rt_run(model, i_band=bands, device=dev)
    finally:
        timing.enable_timer(False)
    report = timing.timer_report().replace("\n", " | ")
    print(f"3-band auto: rt_run first {t_first:.3f} s, steady {t_auto:.3f} "
          f"s = {n_spec / t_auto:.1f} points/s; host spans: "
          f"{report} {tag}")

    # the float64 torch engine at the same Newton-Schulz schedules
    t0 = time.perf_counter()
    R64, T64 = vt.rt_run(model, i_band=bands, dtype=torch.float64,
                         device=dev, engine="torch")
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    rel_r, rel_t = rel_err(R, R64), rel_err(T, T64)
    print(f"3-band auto vs float64 torch engine ({t64:.2f} s): max|dR|/max R"
          f" = {rel_r:.3e}, max|dT|/max T = {rel_t:.3e} {tag}")
    check(rel_r < 1e-3 and rel_t < 1e-3, "3-band auto R/T off the float64 "
          "reference by >= 1e-3")

    for engine, expected in (("kernel", max_m * n_z),
                             ("kernel_scan", n_scan),
                             ("kernel_dev", max_m * n_z),
                             ("kernel_lanes", max_m * n_z)):
        reset_counts()
        Re, Te = vt.rt_run(model, i_band=bands, device=dev, engine=engine)
        torch.cuda.synchronize()
        ce = counts()
        check(ce[engine] == expected and sum(ce.values()) == expected,
              f"3-band {engine}: launches {ce}, expected {expected}")
        rel_re, rel_te = rel_err(Re, R64), rel_err(Te, T64)
        print(f"3-band {engine}: {ce[engine]} launches, steady "
              f"{steady(engine=engine):.3f} s; vs float64 max|dR|/max R = "
              f"{rel_re:.3e}, max|dT|/max T = {rel_te:.3e} {tag}")
        check(rel_re < 1e-3 and rel_te < 1e-3, f"3-band {engine} R/T off "
              f"the float64 reference by >= 1e-3")
        del Re, Te

    # row 3 on the tensor cores, launches counted, every launch held
    # against its plain version at the mode
    st, launches, rel_rm = row3_mode_run(torch, dev, model, "bf16x3",
                                         max_m * n_z, R64, i_band=bands)
    check(st.rel < 1e-5, f"3-band kernel_dev at bf16x3 vs plain: "
          f"{st.rel:.3e} of max >= 1e-5")
    print(row3_line(f"3-band (N={n}, S={n_spec})", "bf16x3", st, launches,
                    rel_rm, tag), flush=True)

    # per-band runs at the concatenated run's schedules: a band's own
    # doubling counts would discretize it differently
    real_schedules = rtr.build_layer_schedules
    rtr.build_layer_schedules = lambda *a, **kw: sched
    surface = _concat_surface(model, bands)
    worst32 = worst64 = 0.0
    try:
        for ib, sl in zip(bands, band_spec_lim(model, bands)):
            Rb, Tb = vt.rt_run(model, i_band=ib, device=dev)
            worst32 = max(worst32, rel_err(R[..., sl], Rb),
                          rel_err(T[..., sl], Tb))
            Rb, Tb = vt.rt_run(model, i_band=ib, dtype=torch.float64,
                               device=dev, engine="torch")
            worst64 = max(worst64, rel_err(R64[..., sl], Rb),
                          rel_err(T64[..., sl], Tb))
    finally:
        rtr.build_layer_schedules = real_schedules
    print(f"3-band concatenated vs per-band runs ({surface['type']}): "
          f"float32 auto {worst32:.3e}, float64 torch {worst64:.3e} (max "
          f"|d|/max per band and field) {tag}")
    check(worst32 < 1e-5 and worst64 < 1e-10, "3-band concatenated run "
          "differs from the per-band runs")

    # an RPV surface on every band: one run over the concatenated axis
    params.surfaces = [dict(THREE_BAND_RPV) for _ in bands]
    check(_concat_surface(model, bands) == THREE_BAND_RPV,
          "identical RPV surfaces did not merge")
    reset_counts()
    Rr, Tr = vt.rt_run(model, i_band=bands, device=dev)
    torch.cuda.synchronize()
    cr = counts()
    Rr64, Tr64 = vt.rt_run(model, i_band=bands, dtype=torch.float64,
                           device=dev, engine="torch")
    rel_rr, rel_tr = rel_err(Rr, Rr64), rel_err(Tr, Tr64)
    print(f"3-band RPV auto: launches {cr}; vs float64 max|dR|/max R = "
          f"{rel_rr:.3e}, max|dT|/max T = {rel_tr:.3e}; nadir I / the "
          f"Lambertian run's: {float(np.median(Rr[0, 0] / R[0, 0])):.4f} "
          f"(median) {tag}")
    check(cr["kernel_scan"] == n_scan and sum(cr.values()) == n_scan,
          f"3-band RPV auto: launches {cr}, expected {n_scan} layer-scan "
          f"launches and nothing else")
    check(np.isfinite(Rr).all() and rel_rr < 1e-3 and rel_tr < 1e-3,
          "3-band RPV R/T off the float64 reference by >= 1e-3")
    del Rr, Tr, Rr64, Tr64, R64, T64

    # rows 1, 3, 5, 6 and 2 at this shape, every launch held against its
    # plain version and timed with CUDA events
    for engine, mod, fname, plain, expected in (
            ("kernel", lsk, "fused_layer_step", lsk.fused_layer_step_plain,
             max_m * n_z),
            ("kernel_dev", ldk, "fused_layer_step_dev",
             ldk.fused_layer_step_dev_plain, max_m * n_z),
            ("kernel_scan", scn, "fused_layer_scan",
             scn.fused_layer_scan_plain, n_scan),
            ("kernel_lanes", lnk, "fused_layer_step_lanes",
             lnk.lanes_layer_step_plain, max_m * n_z)):
        st = KernelStats()
        real = getattr(mod, fname)
        setattr(mod, fname, compare_hook(torch, st, real, plain,
                                         works[engine], reps=(2, 1)))
        try:
            vt.rt_run(model, i_band=bands, device=dev, engine=engine)
        finally:
            setattr(mod, fname, real)
        check(st.calls == expected, f"3-band {fname}: {st.calls} compared "
              f"launches, expected {expected}")
        check(st.rel < 1e-5, f"3-band {fname} vs plain: {st.rel:.3e} >= "
              f"1e-5")
        ms, plain_ms = st.mean_ms()
        bound, by = st.bound()
        print(f"3-band {fname} (N={n}, S={n_spec}): {st.calls} launches, "
              f"max|diff| vs plain {st.abs:.3e} ({st.rel:.3e} of max); "
              f"kernel {ms:.3f} ms per launch (min {min(st.ms):.3f}, max "
              f"{max(st.ms):.3f}), plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms ({by}) per launch {tag}")
    for ib, mol in voigt_calls:
        grid = np.asarray(params.spec_bands[ib], np.float64)
        st, _ = voigt_compared(torch, vk, compute_absorption_profile, mol,
                               grid, model.profile.vmr[mol], ap,
                               model.profile, dev)
        check(st.calls == 1 and st.rel <= 2e-5, f"3-band Voigt band {ib} "
              f"{mol}: {st.calls} launches, {st.rel:.3e} of max sigma")
        ms, plain_ms = st.mean_ms()
        bound, by = st.bound()
        print(f"3-band voigt (band {ib}, {mol}, {len(grid)} points, {n_z} "
              f"layers): 1 launch, max|diff| vs plain {st.rel:.3e} of max "
              f"sigma; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms ({by}) {tag}")


O2_YAML = os.path.join("tests", "data", "ref_yaml", "O2Parameters.yaml")


def ring_band(tau_abs_center, device):
    """tests/test_raman.py's RRS band (88 points at 6 cm^-1, 2 Rayleigh
    layers of tau 0.15, an absorption line of peak tau_abs_center at the
    centre) under GaussQuadFullSphere l_trunc 8, Stokes_I, sza 45, nadir,
    black surface, 2 moments. Returns (R_cab, ieR) of the Raman run and
    R_full of the full-Rayleigh elastic run, float64 on ``device``."""
    import torch
    from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
    from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom_torch.inelastic import make_rrs
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.0}
    grid = np.arange(12740.0, 13268.0, 6.0)
    n_spec = len(grid)
    rrs = make_rrs(grid, T=250.0)
    tau_rayl = np.full((2, n_spec), 0.15)
    tau = tau_rayl + tau_abs_center * np.exp(
        -0.5 * (np.arange(n_spec) - n_spec // 2) ** 2)[None, :]
    greeks = [get_greek_rayleigh(rrs.depol_rayl)]
    cab = BandRTInputs(tau=tau, omega=tau_rayl * rrs.omega_cabannes / tau,
                       zw=np.ones((2, 1, n_spec)), greeks=greeks)
    full = BandRTInputs(tau=tau, omega=tau_rayl / tau,
                        zw=np.ones((2, 1, n_spec)), greeks=greeks)
    out = rt_run_band_rrs(pol, quad, cab, rrs, tau_rayl / tau, [0.0], [0.0],
                          2, surf, dtype=torch.float64, device=device)
    R_full, _ = rt_run_band(pol, quad, full, [0.0], [0.0], 2, surf,
                            dtype=torch.float64, device=device)
    return out, R_full


def bench_raman_shape():
    """The raman_rrs shape of bench.py:223-268: 2 048 points at 0.25
    cm^-1 from 12 700 cm^-1, RRS at 250 K, 10 layers of Rayleigh tau 0.04
    with an absorption line at 12 950 cm^-1 (peak 0.3 x uniform[0, 1) per
    layer, seed 0), Stokes_I, GaussQuadFullSphere l_trunc 8, sza 45, vza
    30, albedo 0.05, 3 moments. Returns the rt_run_band_rrs arguments."""
    from vsmartmom_torch.core.rt_run import BandRTInputs
    from vsmartmom_torch.inelastic import make_rrs
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    n_spec, n_z = 2048, 10
    grid = 12700.0 + 0.25 * np.arange(n_spec)
    rrs = make_rrs(grid, T=250.0)
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    rng = np.random.default_rng(0)
    tau_rayl = np.full((n_z, n_spec), 0.04)
    tau = tau_rayl + 0.3 * rng.random((n_z, 1)) * np.exp(
        -0.5 * ((grid - 12950.0) / 2.0) ** 2)[None, :]
    band = BandRTInputs(tau=tau, omega=tau_rayl * rrs.omega_cabannes / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(rrs.depol_rayl)])
    return (pol, quad, band, rrs, tau_rayl / tau, [30.0], [0.0], 3,
            {"type": "LambertianSurfaceScalar", "albedo": 0.05})


def raman_phase(torch, dev, tag, reset_counts, counts, scan_work,
                n_buckets):
    """13. The Raman path (core/rt_raman.py: torch ops, no kernel of its
    own). (a) O2Parameters.yaml as written (Float64) at full width:
    model_from_parameters on the card (one Voigt launch, O2) and
    rt_run(model, rs_type="RRS") with the launch counts reset just before
    (no layer kernel may launch), first and steady seconds and peak device
    memory, and the build's Voigt launch held against its plain version
    (2e-5 of max sigma) and timed; (b) the same in float32 within 1e-4 of
    (a) per field (the float64-limit forms of ie_elemental; the JAX forms
    gave 7.5e-4 in ieR and 3.7e-3 in ieT); (e) the file's elastic run in
    float32 through kernel_scan, where the 60 deg view merges with the Gauss
    node 0.5 (the scan kernel's merged-node branch): launches counted,
    every launch within 1e-5 of its plain version, R/T within 1e-3 of the
    float64 torch engine (the dropped coupling cost 1.3 % of R); (c)
    tests/test_raman.py's band on the card in float64 against the port's
    CPU run (1e-10 of max), its energy check and Ring filling-in; (d) the
    bench.py raman_rrs shape in float32, first and steady seconds."""
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import _raman_specs, build_band_inputs
    from vsmartmom_torch.core.rt import merged_nodes
    from vsmartmom_torch.core.rt_raman import ie_chunk_rows, rt_run_band_rrs
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) full width, Float64 as written
    params = vt.parameters_from_yaml(os.path.join(HERE, O2_YAML))
    ap = params.absorption_params
    grid = np.asarray(params.spec_bands[0], np.float64)
    n_lines = sum(has_lines(m, grid, ap.wing_cutoff)
                  for m in ap.molecules[0])
    reset_counts()
    model, t_build = timed(lambda: vt.model_from_parameters(params,
                                                            device=dev))
    n_voigt = vk.launches
    torch.cuda.reset_peak_memory_stats()
    out64, t_first = timed(lambda: vt.rt_run(model, rs_type="RRS",
                                             device=dev))
    c = counts()
    peak64 = torch.cuda.max_memory_allocated()
    n_spec, n_z = len(grid), model.profile.n_layers
    n = len(model.quad_points.qp_mu_n)
    n_r = _raman_specs(model, 0, "RRS")[0].n_raman
    rows = ie_chunk_rows(n_r, n_spec, n, torch.float64, dev)
    print(f"Raman O2Parameters.yaml (Float64): nSpec={n_spec}, N={n}, "
          f"nZ={n_z}, max_m={params.max_m}, nR={n_r} ({rows} rows a "
          f"chunk), one ie field {n_r * n_spec * n * n * 8 / 1e9:.3f} GB; "
          f"build {t_build:.3f} s, launches: voigt {n_voigt}, rt_run {c} "
          f"{tag}")
    check(n_voigt == n_lines == 1, f"Raman O2 build: {n_voigt} Voigt "
          f"launches, expected one (O2)")
    check(sum(c.values()) == n_voigt, f"Raman O2 rt_run launched layer "
          f"kernels: {c}")
    R, T, ieR, ieT = out64
    check(all(x.shape == (4, 3, n_spec) for x in out64),
          f"Raman O2 shapes {[x.shape for x in out64]}")
    check(all(np.isfinite(x).all() for x in out64),
          "Raman O2 float64: non-finite output")
    check(np.abs(ieR).max() > 0, "Raman O2 float64: ieR is zero")
    check(np.all(R[:, 0] + ieR[:, 0] > 0), "Raman O2 float64: I of R + "
          "ieR not positive")
    _, t_steady = timed(lambda: vt.rt_run(model, rs_type="RRS", device=dev))
    fill = ieR[:, 0] / R[:, 0]
    # phase 16 (b) holds the sharded run against this one
    unsharded = {"model": model, "out": out64, "t_steady": t_steady,
                 "peak": peak64}
    print(f"Raman O2 float64: rt_run first {t_first:.3f} s, steady "
          f"{t_steady:.3f} s = {n_spec / t_steady:.1f} points/s; peak "
          f"device memory {peak64 / 2**30:.2f} GiB; ieR/R in I "
          f"{fill.min():.4e} .. {fill.max():.4e} {tag}")
    # the build's Voigt launch (0.05 cm^-1, this file's profile) against its
    # plain version
    st, _ = voigt_compared(torch, vk, compute_absorption_profile, "O2", grid,
                           model.profile.vmr["O2"], ap, model.profile, dev)
    ms, plain_ms = st.mean_ms()
    bound, by = st.bound()
    print(f"Raman O2 voigt ({n_spec} points, {n_z} layers): {st.calls} "
          f"compared launch, max|diff| vs plain {st.abs:.3e} ({st.rel:.3e} "
          f"of max sigma); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({by}) {tag}")
    check(st.calls == 1 and st.rel <= 2e-5, f"Raman O2 Voigt: {st.calls} "
          f"compared launches, {st.rel:.3e} of max sigma > 2e-5")

    # (b) the same in float32
    torch.cuda.reset_peak_memory_stats()
    out32, t_first32 = timed(lambda: vt.rt_run(model, rs_type="RRS",
                                               dtype=torch.float32,
                                               device=dev))
    peak32 = torch.cuda.max_memory_allocated()
    _, t_steady32 = timed(lambda: vt.rt_run(model, rs_type="RRS",
                                            dtype=torch.float32,
                                            device=dev))
    errs = [rel_err(a, b) for a, b in zip(out32, out64)]
    print(f"Raman O2 float32: rt_run first {t_first32:.3f} s, steady "
          f"{t_steady32:.3f} s = {n_spec / t_steady32:.1f} points/s; peak "
          f"device memory {peak32 / 2**30:.2f} GiB; vs float64 max|d|/max "
          f"R {errs[0]:.3e}, T {errs[1]:.3e}, ieR {errs[2]:.3e}, ieT "
          f"{errs[3]:.3e} {tag}")
    check(all(np.isfinite(x).all() for x in out32),
          "Raman O2 float32: non-finite output")
    check(max(errs) < 1e-4, "Raman O2 float32 R/T/ieR/ieT off float64 by "
          ">= 1e-4")
    del out32

    # (e) the elastic run in float32 through kernel_scan: the 60 deg view
    # merges with the Gauss node 0.5, which the scan kernel's elemental
    # couples as torch's elemental does
    qp32 = torch.as_tensor(model.quad_points.qp_mu_n, dtype=torch.float32)
    n_merged = int(merged_nodes(qp32[:, None] == qp32[None, :],
                                model.pol.n).sum())
    check(n_merged > 0, "O2 elastic float32: no merged quadrature nodes")
    expected = params.max_m * n_buckets(build_band_inputs(model, 0),
                                        model.quad_points)
    reset_counts()
    (Re, Te), t_scan = timed(lambda: vt.rt_run(
        model, dtype=torch.float32, device=dev, engine="kernel_scan"))
    c = counts()
    check(c["kernel_scan"] == expected and sum(c.values()) == expected,
          f"O2 elastic kernel_scan: launches {c}, expected {expected}")
    R64, T64 = vt.rt_run(model, dtype=torch.float64, device=dev,
                         engine="torch")
    rel_r, rel_t = rel_err(Re, R64), rel_err(Te, T64)
    st = KernelStats()
    real = scn.fused_layer_scan
    scn.fused_layer_scan = compare_hook(torch, st, real,
                                        scn.fused_layer_scan_plain,
                                        scan_work, reps=(2, 1))
    try:
        vt.rt_run(model, dtype=torch.float32, device=dev,
                  engine="kernel_scan")
    finally:
        scn.fused_layer_scan = real
    ms, plain_ms = st.mean_ms()
    bound, by = st.bound()
    print(f"O2 elastic float32 kernel_scan ({n_merged} merged-node entries "
          f"of N={n}): {c['kernel_scan']} launches, run {t_scan:.3f} s; vs "
          f"float64 torch max|dR|/max R = {rel_r:.3e}, max|dT|/max T = "
          f"{rel_t:.3e}; {st.calls} compared launches, max|diff| vs plain "
          f"{st.abs:.3e} ({st.rel:.3e} of max); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}) per launch {tag}")
    check(st.calls == expected and st.rel < 1e-5, f"O2 elastic "
          f"fused_layer_scan: {st.calls} compared launches (expected "
          f"{expected}), {st.rel:.3e} of max from the plain version")
    check(np.isfinite(Re).all() and rel_r < 1e-3 and rel_t < 1e-3,
          "O2 elastic kernel_scan R/T off float64 by >= 1e-3")
    del Re, Te, R64, T64, model

    # (c) the card against the CPU, energy and Ring on the card
    (card, r_full), t_card = timed(lambda: ring_band(0.0, dev))
    (cpu, _), _ = timed(lambda: ring_band(0.0, "cpu"))
    card_cpu = max(rel_err(a, b) for a, b in zip(card, cpu))
    R_cab, _, ie_cab, _ = card
    mid = R_cab.shape[-1] // 2
    energy = (R_cab[0, 0, mid] + ie_cab[0, 0, mid]) / r_full[0, 0, mid] - 1
    (ring, _), _ = timed(lambda: ring_band(2.0, dev))
    fill = ring[2][0, 0] / ring[0][0, 0]
    print(f"Raman test band (88 points): card vs CPU float64 "
          f"max|d|/max {card_cpu:.3e}; energy at band centre "
          f"(R_cab + ieR) / R_full - 1 = {energy:.3e}; Ring filling-in core "
          f"/ continuum {fill[mid] / fill[2]:.3f} ({t_card:.2f} s) {tag}")
    check(card_cpu < 1e-10, "Raman test band: card differs from the CPU")
    check(abs(energy) < 2e-3, "Raman test band: energy check off 2e-3")
    check(fill[mid] > 1.2 * fill[2], "Raman test band: no Ring filling-in")

    # (d) the bench.py raman_rrs shape in float32
    args = bench_raman_shape()
    torch.cuda.reset_peak_memory_stats()
    out, t_first = timed(lambda: rt_run_band_rrs(*args, dtype=torch.float32,
                                                 device=dev))
    _, t_steady = timed(lambda: rt_run_band_rrs(*args, dtype=torch.float32,
                                                device=dev))
    check(np.isfinite(out[2]).all() and np.abs(out[2]).max() > 0,
          "Raman bench shape: ieR non-finite or zero")
    print(f"Raman bench raman_rrs shape (float32, nSpec=2048, nZ=10, N="
          f"{len(args[1].qp_mu_n)}, nR={args[3].n_raman}): first "
          f"{t_first:.3f} s, steady {t_steady:.3f} s = "
          f"{2048 / t_steady:.1f} points/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    return unsharded


# ---- 14. the rest of the elastic scope --------------------------------------

#: the multi-sensor levels of phase 14 (a): TOA, two interior, BOA
MS_LEVELS = [0, 12, 24, 34]
#: a HOM00 Rayleigh scene of RAMI4ATM for phase 14 (c)
RAMI_SCENARIO = {
    "name": "HOM00_RAYLEIGH_LAM", "measures": [{"bands": ["8a"]}],
    "atmosphere": {"atmosphere_type": "AtmosphereType.RAYLEIGH",
                   "aerosols": [], "concentrations": {}},
    "illumination": {"sza": {"value": 30.0}},
    "surface": {"name": "LAM", "surface_parameters": {"reflectance": [0.2]}},
}


def rtol_ratio(a, b, rtol, atol):
    """max of |a - b| / (atol + rtol |b|): at most 1 where
    numpy.testing.assert_allclose(a, b, rtol, atol) passes."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())


def direct_beam(quad, pol, tau_total, vza):
    """The direct solar beam at the surface that rt_run_band's T carries
    at the solar node (the Lambertian surface layer's J^+, moment 0, weight
    1/2) and a sensor's downwelling does not: (n_vza, n_stokes, nSpec)."""
    from vsmartmom_torch.util.quadrature import nearest_point
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    out = np.zeros((len(vza), pol.n, len(tau_total)))
    for i, za in enumerate(vza):
        i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(za)))
        if pol.n * i_mu == quad.i_mu0_n:
            out[i] = 0.5 * np.asarray(pol.i0)[:, None] \
                * np.exp(-tau_total / mu0_node)[None, :]
    return out


def rami_standin_profile(params, dz_km=0.25):
    """A stand-in for the RAMI4ATM AFGL file, from a parameter set's
    (p, T, q): levels every dz_km of a 7.6 km scale height from its surface
    to its top pressure, T and q interpolated in log p from its layers
    (its own 35 levels leave 50 hPa bins of a 20-layer reduction empty),
    H2O from q, the other gases constant."""
    from vsmartmom_torch.core.rami import AFGLProfile
    p_half = np.asarray(params.p, np.float64)
    lnp_mid = np.log(0.5 * (p_half[1:] + p_half[:-1]))
    z_top = 7.6 * np.log(p_half[-1] / p_half[0])
    z = np.append(np.arange(0.0, z_top, dz_km), z_top)
    p_lev = p_half[-1] * np.exp(-z / 7.6)
    T = np.interp(np.log(p_lev), lnp_mid, np.asarray(params.T, np.float64))
    w = np.interp(np.log(p_lev), lnp_mid,
                  np.asarray(params.q, np.float64)) / 1000.0
    ones = np.ones_like(p_lev)
    vmr = {"H2O": w * 28.9644 / (18.01534 * (1.0 - w) + w * 28.9644),
           "CO2": 400e-6 * ones, "O3": 0.05e-6 * ones, "N2O": 0.32e-6 * ones,
           "CO": 0.15e-6 * ones, "CH4": 1.8e-6 * ones, "O2": 0.209 * ones}
    return AFGLProfile(z_km=z, p_hpa=p_lev, T=T,
                       n_air=p_lev * 100.0 / (1.380649e-23 * T) * 1e-6,
                       vmr=vmr)


def elastic_scope_phase(torch, dev, tag, reset_counts, counts):
    """14. The rest of the elastic scope (torch ops, no kernel of its own;
    no TPU kernel on its path either): (a) rt_run_ms on the flagship in
    Float32 at sensor levels [0, 12, 24, 34] under the default (schulz)
    solver, the build's Voigt launch held against its plain version, the
    TOA/BOA anchors in float64 with lu against rt_run_band(engine="torch",
    solver="lu") within 1e-9 of max (BOA: the direct beam, which T carries
    at the solar node, added to the downwelling), float32 within 1e-3 of
    float64 at every sensor, the interior physics of
    tests/test_multisensor.py; (b) rt_run_canopy with the flagship's band
    above the demo's canopy, float32 within 1e-3 of float64 per output, the
    G = 1 reduction against rt_run_band on the 35-layer band at rtol 2e-7
    (float64), and two float32 stress scenes (black leaves at LAI 20 in one
    slab; chi = 0.6) finite and within 1e-3 of float64; (c)
    run_rami_scenario on a HOM00 Rayleigh scene at run_rami_scenario's defaults
    on a stand-in AFGL profile, the card (schulz, its default) within 1e-10
    of the port's CPU run of the same scene (lu, the CPU's default). The
    launch counts are set to 0 before each part's runs and read after
    them: none of these drivers may launch a layer kernel."""
    import tempfile

    import vsmartmom_torch as vt
    from vsmartmom_torch.canopy_demo import CANOPY
    from vsmartmom_torch.canopy_demo import SOIL as CANOPY_SOIL
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.canopy import (CanopyRTInputs,
                                             bilambertian_greek,
                                             rt_run_canopy)
    from vsmartmom_torch.core.multisensor import rt_run_band_ms, rt_run_ms
    from vsmartmom_torch.core.rami import (run_rami_scenario,
                                           write_afgl_profile)
    from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    # (a) multi-sensor on the flagship, Float32
    params = vt.default_parameters()
    params.float_type = "Float32"
    ap = params.absorption_params
    grid = np.asarray(params.spec_bands[0], np.float64)
    n_lines = sum(has_lines(m, grid, ap.wing_cutoff)
                  for m in ap.molecules[0])
    reset_counts()
    model, t_build = timed(lambda: vt.model_from_parameters(params,
                                                            device=dev))
    n_voigt = vk.launches
    check(n_voigt == n_lines == 1, f"multi-sensor flagship build: "
          f"{n_voigt} Voigt launches, expected one (O2)")
    st, _ = voigt_compared(torch, vk, compute_absorption_profile, "O2", grid,
                           model.profile.vmr["O2"], ap, model.profile, dev)
    ms, plain_ms = st.mean_ms()
    bound, by = st.bound()
    check(st.calls == 1 and st.rel <= 2e-5, f"multi-sensor build Voigt: "
          f"{st.calls} compared launches, {st.rel:.3e} of max sigma > 2e-5")
    print(f"multi-sensor flagship build {t_build:.3f} s: voigt {n_voigt} "
          f"launch, {st.rel:.3e} of max sigma from its plain version; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} "
          f"ms ({by}) {tag}")
    quad, pol = model.quad_points, model.pol
    band = build_band_inputs(model, 0)
    n_spec, n_z = len(grid), model.profile.n_layers
    vza, vaz = model.obs_geom.vza, model.obs_geom.vaz
    surf = params.surfaces[0]
    check(MS_LEVELS[-1] == n_z, f"flagship has {n_z} layers")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (uw32, dw32), t_first = timed(lambda: rt_run_ms(model, MS_LEVELS,
                                                    device=dev))
    c = counts()
    check(sum(c.values()) == 0, f"rt_run_ms launched kernels: {c}")
    peak32 = peak_gib()
    _, t_steady = timed(lambda: rt_run_ms(model, MS_LEVELS, device=dev))
    torch.cuda.reset_peak_memory_stats()
    (uw64, dw64), t64 = timed(lambda: rt_run_band_ms(
        pol, quad, band, vza, vaz, params.max_m, surf, MS_LEVELS,
        dtype=torch.float64, device=dev, solver="lu"))
    peak64 = peak_gib()
    R, T = rt_run_band(pol, quad, band, vza, vaz, params.max_m, surf,
                       dtype=torch.float64, device=dev, solver="lu",
                       engine="torch")
    toa = rel_err(uw64[0], R)
    boa = rel_err(dw64[-1] + direct_beam(quad, pol, band.tau.sum(axis=0),
                                         vza), T)
    e32 = [max(rel_err(uw32[s], uw64[s]), rel_err(dw32[s], dw64[s]))
           for s in range(len(MS_LEVELS))]
    print(f"multi-sensor flagship (nSpec={n_spec}, nZ={n_z}, N="
          f"{len(quad.qp_mu_n)}, levels {MS_LEVELS}): Float32 schulz first "
          f"{t_first:.3f} s, steady {t_steady:.3f} s = "
          f"{n_spec / t_steady:.1f} points/s, peak device memory "
          f"{peak32:.2f} GiB; float64 lu {t64:.3f} s, peak {peak64:.2f} "
          f"GiB; TOA uw vs rt_run_band R {toa:.3e}, BOA dw + direct beam vs "
          f"T {boa:.3e} of max; float32 vs float64 by level "
          f"{['%.3e' % e for e in e32]} {tag}")
    check(toa < 1e-9 and boa < 1e-9, "multi-sensor TOA/BOA anchors off "
          "rt_run_band by >= 1e-9 of max")
    check(all(np.isfinite(x).all() for x in (uw32, dw32, uw64, dw64)),
          "multi-sensor: non-finite output")
    check(max(e32) < 1e-3, "multi-sensor float32 off float64 by >= 1e-3")
    check(np.all(dw64[1, :, 0, :] >= dw64[0, :, 0, :] - 1e-12)
          and np.all(uw64[:, :, 0, :] > 0), "multi-sensor interior "
          "physics: downwelling falls toward the surface or upwelling I "
          "not positive")
    del uw32, dw32, uw64, dw64, R, T

    # (b) the demo's canopy under the flagship atmosphere
    ssa = np.linspace(0.25, 0.95, n_spec)

    def canopy_run(dtype, levels=(0, 1, 2, 3), **kw):
        can = CanopyRTInputs(**{**CANOPY, "ssa": ssa, **kw})
        return rt_run_canopy(pol, quad, band, can, vza, vaz, params.max_m,
                             CANOPY_SOIL, dtype=dtype, device=dev,
                             sensor_levels=list(levels) or None)

    names = ("R", "T", "hdr", "bhr_uw", "bhr_dw", "uw", "dw")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out32, t32 = timed(lambda: canopy_run(torch.float32))
    peak32 = peak_gib()
    torch.cuda.reset_peak_memory_stats()
    out64, t64 = timed(lambda: canopy_run(torch.float64))
    peak64 = peak_gib()
    e32 = {k: rel_err(a, b) for k, a, b in zip(names, out32, out64)}
    print(f"canopy under the flagship (nSpec={n_spec}, 34 + 3 canopy "
          f"layers, levels 0-3): float32 {t32:.3f} s (peak "
          f"{peak32:.2f} GiB), float64 {t64:.3f} s (peak {peak64:.2f} "
          f"GiB); float32 vs float64 "
          f"{ {k: '%.3e' % v for k, v in e32.items()} } {tag}")
    check(all(np.isfinite(x).all() for x in out32 + out64),
          "canopy: non-finite output")
    check(max(e32.values()) < 1e-3, "canopy float32 off float64 by >= "
          "1e-3")
    del out32, out64

    # G = 1: the canopy is a plain layer with the bi-Lambertian phase
    (g1, t_g1) = timed(lambda: canopy_run(torch.float64, levels=(),
                                          g_override=1.0, n_layers=1))
    gc_can, _ = bilambertian_greek(CANOPY["rho_l"], CANOPY["tau_l"])
    k = band.zw.shape[1]
    zw2 = np.zeros((n_z + 1, k + 1, n_spec))
    zw2[:n_z, :k] = band.zw
    zw2[n_z, k] = 1.0
    band2 = BandRTInputs(
        tau=np.vstack([band.tau, np.full((1, n_spec), CANOPY["lai"])]),
        omega=np.vstack([band.omega, ssa[None, :]]), zw=zw2,
        greeks=list(band.greeks) + [gc_can])
    ref = rt_run_band(pol, quad, band2, vza, vaz, params.max_m, CANOPY_SOIL,
                      dtype=torch.float64, device=dev, solver="lu",
                      engine="torch", return_hdr=True)
    ratios = [rtol_ratio(a, b, 2e-7, 1e-12 if i < 3 else 0.0)
              for i, (a, b) in enumerate(zip(g1, ref))]
    print(f"canopy G = 1 vs rt_run_band on the 35-layer band (float64): "
          f"max |d| / (atol + 2e-7 |ref|) per output "
          f"{['%.3e' % r for r in ratios]} ({t_g1:.3f} s) {tag}")
    check(max(ratios) <= 1.0, "canopy G = 1 differs from rt_run_band "
          "beyond rtol 2e-7")
    del g1, ref

    for label, kw in (("black leaves, LAI 20, one slab",
                       dict(lai=20.0, n_layers=1, ssa=np.full(n_spec, 1e-9))),
                      ("chi = 0.6", dict(chi=0.6))):
        levels = () if kw.get("n_layers") == 1 else (0, 1, 2, 3)
        a32, t_s = timed(lambda: canopy_run(torch.float32, levels, **kw))
        a64 = canopy_run(torch.float64, levels, **kw)
        err = max(rel_err(a, b) for a, b in zip(a32, a64))
        finite = all(np.isfinite(x).all() for x in a32)
        print(f"canopy float32 stress, {label}: finite {finite}, vs "
              f"float64 {err:.3e} of max ({t_s:.3f} s) {tag}")
        check(finite and err < 1e-3, f"canopy float32 stress ({label}): "
              f"non-finite or off float64 by >= 1e-3")
    c = counts()
    check(sum(c.values()) == 0, f"the canopy runs launched kernels: {c}")
    del model

    # (c) RAMI, HOM00 Rayleigh at run_rami_scenario's defaults
    with tempfile.TemporaryDirectory() as data_dir:
        write_afgl_profile(
            os.path.join(data_dir, "RAMI4ATM_AFGLUSstandard_ap_v1.0.txt"),
            rami_standin_profile(vt.default_parameters()))
        print("RAMI: the AFGL profile is a stand-in, interpolated from "
              "default_parameters' (p, T, q); the RAMI4ATM files are not "
              "in the repository")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        card, t_card = timed(lambda: run_rami_scenario(
            RAMI_SCENARIO, data_dir, device=dev))
        peak = peak_gib()
        _, t_steady = timed(lambda: run_rami_scenario(
            RAMI_SCENARIO, data_dir, device=dev))
        c = counts()
        check(sum(c.values()) == 0, f"run_rami_scenario launched kernels: "
              f"{c}")
        t0 = time.perf_counter()
        cpu = run_rami_scenario(RAMI_SCENARIO, data_dir, device="cpu")
        t_cpu = time.perf_counter() - t0
    errs = {k: rel_err(card[k], cpu[k]) for k in ("brf", "hdrf", "bhr")}
    n_rami = len(card["nu"])
    print(f"RAMI HOM00 Rayleigh, band 8a (nSpec={n_rami}, 20 layers, "
          f"l_trunc 40, max_m 20, Float64, {len(card['vza'])} views): card "
          f"first {t_card:.3f} s, steady {t_steady:.3f} s = "
          f"{n_rami / t_steady:.1f} points/s, peak {peak:.2f} GiB; CPU "
          f"{t_cpu:.3f} s; card (schulz) vs CPU (lu) "
          f"{ {k: '%.3e' % v for k, v in errs.items()} }; bhr "
          f"{card['bhr'].min():.6f} .. {card['bhr'].max():.6f} {tag}")
    check(all(np.isfinite(card[k]).all() for k in errs),
          "RAMI: non-finite output")
    check(max(errs.values()) < 1e-10, "RAMI: the card differs from the "
          "CPU by >= 1e-10 of max")


#: central-difference steps of phase 15 (d) in (mu, sigma, n_r, n_i): the
#: flagship's n_i of 1e-8 leaves Mie resonances a few 1e-8 wide in n_r
MIE_STEPS = (1e-6, 1e-6, 1e-10, 1e-10)


def fd_error(ad, fd, f_scale, step):
    """(max|ad - fd|, the central difference's rounding 4 eps max|f| /
    step), both over max|fd|."""
    scale = float(np.abs(fd).max())
    floor = 4 * np.finfo(np.float64).eps * f_scale / step
    return float(np.abs(ad - fd).max()) / scale, floor / scale


def ad_phase(torch, dev, tag, reset_counts, counts):
    """15. Forward-mode AD at the flagship's full width, (a) to (f) of the
    module docstring. The launch counts are set to 0 just before each
    Jacobian, Gauss-Newton run and (f), and read just after."""
    import vsmartmom_torch as vt
    import vsmartmom_torch.core.rt_run as rtr
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.autodiff import gauss_newton
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.retrieval_demo import (X_START, X_TRUE, retrieve,
                                                state_radiance)
    from vsmartmom_torch.scattering.mie import Aerosol
    from vsmartmom_torch.scattering.mie_ad import (
        aerosol_optics_with_derivs, greek_stack, make_setup)
    from vsmartmom_torch.scattering.nai2 import \
        compute_aerosol_optical_properties
    from vsmartmom_torch.spectroscopy.profiles import (hitran_artifact,
                                                       read_linelist)
    from vsmartmom_torch.spectroscopy.voigt import (
        absorption_cross_section, line_parameters, make_hitran_model)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    params = vt.default_parameters()
    params.float_type = "Float32"
    model = vt.model_from_parameters(params, device=dev)
    band = build_band_inputs(model, 0)
    pol, quad = model.pol, model.quad_points
    vza, vaz = model.obs_geom.vza, model.obs_geom.vaz
    surf, max_m = params.surfaces[0], params.max_m
    n_z, n_spec = band.tau.shape
    nd, sched, scheds = rtr.build_layer_schedules(
        band.tau, band.omega, float(np.min(quad.qp_mu)), "schulz")
    static = dict(ndoubl_static=nd, ns_schedule=sched,
                  layer_schedules=scheds)

    def radiance(dtype, engine):
        """f(x) -> R.ravel() at state x (retrieval_demo.state_radiance)
        and make_radiance_fn's fn, at the band's static schedules."""
        return state_radiance(pol, quad, band, vza, vaz, max_m, dtype, dev,
                              engine, "schulz")

    x_a = (0.0, float(surf["albedo"]), 0.0)
    # the float64 torch engine's Jacobian on the card, and its central
    # differences
    f64, _ = radiance(torch.float64, "torch")
    x64 = torch.tensor(x_a, dtype=torch.float64, device=dev)
    J64, t_j64 = timed(lambda: torch.func.jacfwd(f64)(x64).cpu().numpy())
    eps = 1e-6
    fd = np.stack([((f64(x64 + eps * e) - f64(x64 - eps * e))
                    / (2 * eps)).cpu().numpy()
                   for e in torch.eye(3, dtype=torch.float64, device=dev)],
                  axis=-1)
    e_fd = [rel_err(J64[:, k], fd[:, k]) for k in range(3)]
    print(f"AD flagship (nSpec={n_spec}, nZ={n_z}, N={len(quad.qp_mu_n)}, "
          f"{max_m} moments, {len(vza)} views, state (log scattering "
          f"scale, albedo, log absorption scale) at {x_a}): float64 torch "
          f"Jacobian {t_j64:.3f} s, against central differences (step "
          f"1e-6) {['%.3e' % e for e in e_fd]} of max by column {tag}")
    check(np.isfinite(J64).all() and np.abs(J64).max() > 0,
          "AD: float64 Jacobian not finite or zero")
    check(max(e_fd) < 1e-5, "AD: float64 Jacobian off central differences "
          "by >= 1e-5 of max")

    # (a), (b): float32 through the two layer-step kernels
    for engine, mod in (("kernel", "kernel"), ("kernel_dev", "kernel_dev")):
        f32, fn32 = radiance(torch.float32, engine)
        direct = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (band.tau, band.omega, band.zw)]
        R_fn = fn32(*direct, float(surf["albedo"])).cpu().numpy()
        R_band, _ = rtr.rt_run_band(pol, quad, band, vza, vaz, max_m, surf,
                                    dtype=torch.float32, device=dev,
                                    solver="schulz", engine=engine)
        e_r = rel_err(R_fn, R_band)
        x32 = torch.tensor(x_a, dtype=torch.float32, device=dev)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lsk.tangent_launches = lsk.plain_tangents = 0
        J32, t_first = timed(lambda: torch.func.jacfwd(f32)(x32))
        c = counts()
        tangents = (lsk.tangent_launches, lsk.plain_tangents)
        peak = torch.cuda.max_memory_allocated() / 2**30
        t_steady = min(timed(lambda: torch.func.jacfwd(f32)(x32))[1]
                       for _ in range(2))
        t_primal = min(timed(lambda: f32(x32))[1] for _ in range(2))
        J32 = J32.cpu().numpy()
        e_j = rel_err(J32, J64)
        print(f"AD ({'a' if engine == 'kernel' else 'b'}) {engine}, "
              f"float32: R vs rt_run_band {e_r:.3e} of max; jacfwd "
              f"launches {c}, row 1's tangent launches and plain tangents "
              f"{tangents}; first {t_first:.3f} s, steady {t_steady:.3f} "
              f"s per Jacobian (the primal alone {t_primal:.3f} s), peak "
              f"{peak:.2f} GiB; finite {bool(np.isfinite(J32).all())}; vs "
              f"float64 {e_j:.3e} of max {tag}")
        check(e_r < 1e-6, f"AD {engine}: make_radiance_fn R off "
              f"rt_run_band by >= 1e-6 of max")
        check(c[mod] == max_m * n_z
              and sum(c.values()) == c[mod], f"AD {engine}: launches {c}, "
              f"expected {max_m * n_z} of {mod} and nothing else")
        check(tangents == ((max_m * n_z, 0) if engine == "kernel"
                           else (0, 0)), f"AD {engine}: row 1's tangent "
              f"launches and plain tangents {tangents}")
        check(np.isfinite(J32).all(), f"AD {engine}: non-finite tangent")
        check(e_j < 2e-3, f"AD {engine}: float32 Jacobian off float64 by "
              f">= 2e-3 of max")
        del J32, fn32, f32

    # (c) Gauss-Newton through the kernel at full width
    f32, _ = radiance(torch.float32, "kernel")
    truth = torch.tensor(X_TRUE, dtype=torch.float32, device=dev)
    y = f32(truth)
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(
        y.shape), dtype=torch.float32, device=dev)
    y = y * (1.0 + 1e-5 * noise)
    reset_counts()
    (x_hat, hist), t_gn = timed(lambda: gauss_newton(
        lambda x: f32(x) - y,
        torch.tensor(X_START, dtype=torch.float32, device=dev), n_iter=6))
    c = counts()
    x_hat = x_hat.cpu().numpy()
    err = np.abs(x_hat - np.asarray(X_TRUE)).max()
    print(f"AD (c) Gauss-Newton through kernel, float32, 6 iterations from "
          f"{X_START}: {x_hat.tolist()} (truth {X_TRUE}, max err "
          f"{err:.3e}); chi2 {['%.3e' % h for h in hist]}; {t_gn:.3f} s, "
          f"launches {c} {tag}")
    check(err < 5e-3, "AD Gauss-Newton missed the truth by >= 5e-3")
    check(hist[-1] < hist[0], "AD Gauss-Newton: chi2 did not fall")
    check(c["kernel"] == 6 * max_m * n_z and sum(c.values()) == c["kernel"],
          f"AD Gauss-Newton launches {c}")
    reset_counts()
    (x_t, x_d, hist_d, _), t_demo = timed(lambda: retrieve(dev))
    c = counts()
    err_d = np.abs(x_d - x_t).max()
    print(f"AD (c) retrieval demo on the card (engine kernel, float32): "
          f"{x_d.tolist()}, max err {err_d:.3e}, {t_demo:.3f} s, launches "
          f"{c} {tag}")
    check(err_d < 5e-3 and c["kernel"] > 0, "retrieval demo missed the "
          "truth by >= 5e-3 or launched no layer step")
    del f32

    # (d) Mie AD at the flagship's aerosol
    sp = params.scattering_params
    a = sp.rt_aerosols[0]
    theta = (a.mu, a.sigma, a.n_r, a.n_i)
    torch.cuda.reset_peak_memory_stats()
    (optics, der), t_mie = timed(lambda: aerosol_optics_with_derivs(
        *theta, sp.lambda_ref, sp.r_max, sp.nquad_radius, device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref = compute_aerosol_optical_properties(
        Aerosol(*theta), sp.lambda_ref, sp.r_max, sp.nquad_radius)
    names = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")
    e_val = max([float(np.abs(getattr(optics.greek_coefs, nm)
                              - getattr(ref.greek_coefs, nm)).max())
                 for nm in names]
                + [abs(optics.ssa - ref.ssa), abs(optics.k - ref.k)])
    setup = make_setup(sp.lambda_ref, sp.r_max, sp.nquad_radius)
    th = torch.tensor(theta, dtype=torch.float64, device=dev)
    e_der = {}
    for i, step in enumerate(MIE_STEPS):
        dv = torch.zeros(4, dtype=torch.float64, device=dev)
        dv[i] = step
        hi, lo = greek_stack(setup, th + dv), greek_stack(setup, th - dv)
        for key, j, v in (("d_greeks", 0, hi[0]), ("d_ssa", 1, hi[1]),
                          ("d_k", 2, hi[2])):
            fdv = ((hi[j] - lo[j]) / (2 * step)).cpu().numpy()
            e_der[(key, i)] = fd_error(der[key][i], fdv,
                                       float(v.abs().max()), step)
    shown = {f"{k}/{i}": ("%.3e" % e, "%.1e" % r)
             for (k, i), (e, r) in e_der.items()}
    print(f"AD (d) Mie at the flagship's aerosol (mu, sigma, n_r, n_i = "
          f"{theta}, lambda {sp.lambda_ref}, r_max {sp.r_max}, "
          f"{sp.nquad_radius} radii, L = {ref.greek_coefs.l_max}), float64: "
          f"{t_mie:.3f} s, peak {peak:.2f} GiB; values vs numpy NAI2 "
          f"{e_val:.3e}; derivatives vs central differences (steps "
          f"{MIE_STEPS}) of max, (difference, rounding) by output and "
          f"parameter: {shown} {tag}")
    check(e_val < 1e-10, "AD Mie values off the numpy path by >= 1e-10")
    check(all(e < 1e-5 + r for e, r in e_der.values()), "AD Mie "
          "derivatives off central differences by >= 1e-5 of max beyond "
          "their rounding")

    # (e) cross-section AD of the flagship's O2 lines on its grid
    ap = params.absorption_params
    grid = np.asarray(params.spec_bands[0], np.float64)
    ht = read_linelist(hitran_artifact("O2"), "O2",
                       grid.min() - ap.wing_cutoff,
                       grid.max() + ap.wing_cutoff)
    hm = make_hitran_model(ht, ap.broadening, wing_cutoff=ap.wing_cutoff,
                           vmr=0.21, cef=ap.cef)
    p_b, t_b = float(model.profile.p_full[-1]), float(model.profile.T[-1])
    torch.cuda.reset_peak_memory_stats()
    (sig, jac), t_x = timed(lambda: absorption_cross_section(
        hm, grid, p_b, t_b, autodiff=True, device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    e_x = []
    for k, h in enumerate((0.1, 0.01)):
        x = [p_b, t_b]
        x[k] += h
        hi = absorption_cross_section(hm, grid, *x, device=dev)
        x[k] -= 2 * h
        lo = absorption_cross_section(hm, grid, *x, device=dev)
        e_x.append(rel_err(jac[:, k].cpu().numpy(),
                           ((hi - lo) / (2 * h)).cpu().numpy()))
    print(f"AD (e) O2 cross-section, {len(ht.nu)} lines on {len(grid)} "
          f"points at (p, T) = ({p_b:.2f} hPa, {t_b:.2f} K), float64: "
          f"{t_x:.3f} s, peak {peak:.2f} GiB; d/dp, d/dT vs central "
          f"differences (0.1 hPa, 0.01 K) {['%.3e' % e for e in e_x]} of "
          f"max {tag}")
    check(sig.shape == (len(grid),) and np.isfinite(
        jac.cpu().numpy()).all(), "AD cross-section: bad shape or "
        "non-finite Jacobian")
    check(max(e_x) < 1e-6, "AD cross-section Jacobian off central "
          "differences by >= 1e-6")

    # (f) the kernels without a forward rule raise under torch.func.jvp
    sl = slice(0, 256)
    small = rtr.BandRTInputs(tau=band.tau[:, sl], omega=band.omega[:, sl],
                             zw=band.zw[:, :, sl], greeks=band.greeks)
    raised = {}
    reset_counts()
    for engine in ("kernel_doubling", "kernel_scan", "kernel_lanes"):
        try:
            fourier_jvp(torch, rtr, pol, quad, small, surf, dev, engine,
                        static)
            raised[engine] = None
        except NotImplementedError as e:
            raised[engine] = str(e).split(" has no")[0]
    plan = vk.VoigtPlan(grid[:1024], hm.hitran.nu, hm.wing_cutoff,
                        device=dev)
    nu, *rest = plan.line_inputs(*line_parameters(hm, p_b, t_b))
    try:
        torch.func.jvp(lambda v: vk.voigt_tiles(*plan.call_args(
            v, *rest)), (nu,), (torch.ones_like(nu),))
        raised["voigt"] = None
    except NotImplementedError as e:
        raised["voigt"] = str(e).split(" has no")[0]
    c = counts()
    print(f"AD (f) torch.func.jvp through the kernels without a forward "
          f"rule: NotImplementedError from {raised}; launches {c} {tag}")
    check(all(raised.values()), f"AD: a kernel without a forward rule ran "
          f"under torch.func.jvp: {raised}")
    check(sum(c.values()) == 0, f"AD (f) launched kernels: {c}")


def fourier_jvp(torch, rtr, pol, quad, band, surf, dev, engine, static):
    """torch.func.jvp of moment 0's Fourier step through ``engine`` with
    respect to tau, in float32 on ``dev`` (what make_radiance_fn refuses
    for the engines without a forward rule)."""
    geom = rtr.geometry(pol, quad, torch.float32, dev)
    z_pp_c, z_mp_c = geom.z_moments(band.greeks, 0)
    schedules = rtr._per_layer_schedules(
        band.tau.shape[0], "schulz", static["ndoubl_static"],
        static["ns_schedule"], static["layer_schedules"])

    def step(tau):
        comp, _ = rtr._fourier_step(
            tau, geom.to_dev(band.omega), geom.to_dev(band.zw), z_pp_c,
            z_mp_c, geom, geom.to_dev(surf["albedo"]), None, m=0,
            solver="schulz", layer_schedules=schedules, engine=engine)
        return comp.j_m
    tau = geom.to_dev(band.tau)
    return torch.func.jvp(step, (tau,), (torch.ones_like(tau),))


# ---- 16. spectral sharding on the one card ----------------------------------

#: shards of phase 16 (a) and (b), all on cuda:0
N_SHARDS = 4
#: processes of phase 16 (c), both on cuda:0
N_RANKS = 2
#: wall-clock limit of each child process of phase 16 (c) and (d)
CHILD_TIMEOUT = 300


def mp_rank(addr, rank, path):
    """One rank of phase 16 (c): joins the gloo group at ``addr``, runs its
    slice of the pickled band (``path``.pkl) through
    rt_run_band_distributed on cuda:0 in float64 with the torch engine, and
    rank 0 writes the gathered R and T to ``path``.npz:
    python3 -c 'import chip_smoke; chip_smoke.mp_rank(addr, r, path)'."""
    import pickle
    torch = setup()
    from vsmartmom_torch.parallel import distributed as dist
    with open(path + ".pkl", "rb") as f:
        args = pickle.load(f)
    check(dist.init_multihost(addr, N_RANKS, int(rank)),
          "init_multihost: not a multi-process run")
    t0 = time.perf_counter()
    R, T = dist.rt_run_band_distributed(*args, device="cuda:0",
                                        dtype=torch.float64, engine="torch")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if dist.rank() == 0:
        np.savez(path + ".npz", R=R, T=T, seconds=dt)
    torch.distributed.destroy_process_group()


def run_children(cmds, what):
    """Start every command of ``cmds`` (from the repository root), wait for
    each within CHILD_TIMEOUT, kill any left; fails unless each exits 0.
    Returns their standard outputs."""
    procs = [subprocess.Popen(c, cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            res.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        fail(f"{what}: a child process ran past {CHILD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _, err in res:
        check(rc == 0, f"{what}: a child process exited {rc}: {err[-3000:]}")
    return [out for _, out, _ in res]


def sharding_only():
    """Phase 16 (spectral sharding) alone, on the card, with its own
    unsharded Raman run: python3 -c 'import chip_smoke;
    chip_smoke.sharding_only()'."""
    torch = setup()
    from vsmartmom_torch.cuda import build
    t0 = time.perf_counter()
    build.lib()
    tag = f"[card: {card_name()}]"
    print(f"kernel build: {time.perf_counter() - t0:.2f} s {tag}")
    sharding_phase(torch, torch.device("cuda:0"), tag, reset_counts, counts)


def sharding_phase(torch, dev, tag, reset_counts, counts, raman_ref=None):
    """16. Spectral sharding (parallel/sharding.py, parallel/distributed.py,
    scaling_bench.py, the native HITRAN parser) on the one card. (a) The
    flagship in Float32 at full width, model build (one Voigt launch) and
    rt_run_band_sharded over 4 shards on cuda:0 under auto and through
    engine "kernel", with the launch counts reset just before (4 x 18
    row-5 launches under auto, 4 x 102 row-1 launches through kernel,
    nothing else), every launch held against its plain version (1e-5 of
    max per field), R/T within 1e-6 of max of the unsharded rt_run on the
    same engine, and the float64 torch engine sharded against unsharded at
    rtol 1e-12; steady seconds of both. (b)
    O2Parameters.yaml as written (Float64) through rt_run_band_rrs_sharded
    over 4 shards with the Raman halo, R, T, ieR and ieT within rtol 1e-11
    of phase 13 (a)'s unsharded run; halo per shard, seconds and peak
    memory. (c) Two gloo processes on cuda:0, the flagship in float64
    through the torch engine, the gathered R/T within rtol 1e-12 of the
    single run. (d) python3 -m vsmartmom_torch.scaling_bench: the 1-device
    row and 4 shards on the card against the same load unsharded. (e)
    read_hitran(engine="native") on data/hitran/O2.par and H2O.par, field
    for field against engine="python", with the parse seconds.
    ``raman_ref``: phase 13 (a)'s unsharded run ({"model", "out",
    "t_steady", "peak"}), or None to make it here."""
    import pickle
    import shutil
    import socket
    import tempfile
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import (_band_surface, _raman_specs,
                                          build_band_inputs)
    from vsmartmom_torch.core.rt_raman import build_coupling
    from vsmartmom_torch.core.rt_run import (build_layer_schedules,
                                             rt_run_band, schedule_buckets)
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.parallel.sharding import (
        raman_halo, raman_halo_stats, rt_run_band_rrs_sharded,
        rt_run_band_sharded, shard_bounds)
    from vsmartmom_torch.spectroscopy.hitran import read_hitran

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def steady(fn):
        return min(timed(fn)[1] for _ in range(2))

    devices = [str(dev)] * N_SHARDS

    # (a) the flagship, Float32, 4 shards on the card under auto
    params = vt.default_parameters()
    params.float_type = "Float32"
    reset_counts()
    model = vt.model_from_parameters(params, device=dev)
    c_build = counts()
    band = build_band_inputs(model, 0)
    surf = _band_surface(model, 0)
    args = (model.pol, model.quad_points, band, model.obs_geom.vza,
            model.obs_geom.vaz, params.max_m, surf)
    n_z, n_spec = band.tau.shape
    check(c_build["voigt"] == 1 and sum(c_build.values()) == 1,
          f"sharded flagship build: launches {c_build}, expected one Voigt")
    _, _, ls = build_layer_schedules(band.tau, band.omega,
                                     float(np.min(model.quad_points.qp_mu)),
                                     "schulz")
    n_buckets = len(schedule_buckets(ls)) if ls is not None else 1
    # auto takes row 5 on every shard (the whole band's static schedules);
    # row 1 runs by name
    for engine, mod, fname, plain, work, key, per_shard in (
            ("auto", scn, "fused_layer_scan", scn.fused_layer_scan_plain,
             scan_work, "kernel_scan", params.max_m * n_buckets),
            ("kernel", lsk, "fused_layer_step", lsk.fused_layer_step_plain,
             step_work, "kernel", params.max_m * n_z)):
        R1, T1 = vt.rt_run(model, device=dev, engine=engine)
        reset_counts()
        Rs, Ts = rt_run_band_sharded(*args, devices=devices,
                                     dtype=torch.float32, engine=engine)
        torch.cuda.synchronize()
        c = counts()
        expected = N_SHARDS * per_shard
        print(f"sharded flagship {engine} (Float32, nSpec={n_spec} in "
              f"{N_SHARDS} shards of "
              f"{sorted({hi - lo for lo, hi in shard_bounds(n_spec, N_SHARDS)})}"
              f" points on {dev}): launches: build {c_build}, sharded run "
              f"{c} {tag}")
        check(c[key] == expected and sum(c.values()) == expected,
              f"sharded flagship {engine}: launches {c}, expected "
              f"{expected} {key} launches and nothing else")
        st = KernelStats()
        real = getattr(mod, fname)
        setattr(mod, fname, compare_hook(torch, st, real, plain, work))
        try:
            rt_run_band_sharded(*args, devices=devices, dtype=torch.float32,
                                engine=engine)
        finally:
            setattr(mod, fname, real)
        check(st.calls == expected and st.rel < 1e-5, f"sharded flagship "
              f"{engine}: {st.calls} compared launches (expected "
              f"{expected}), {st.rel:.3e} of max from the plain version")
        err_r, err_t = rel_err(Rs, R1), rel_err(Ts, T1)
        bit = bool(np.array_equal(Rs, R1) and np.array_equal(Ts, T1))
        t_sh = steady(lambda: rt_run_band_sharded(
            *args, devices=devices, dtype=torch.float32, engine=engine))
        t_un = steady(lambda: vt.rt_run(model, device=dev, engine=engine))
        ms, plain_ms = st.mean_ms()
        bound, by = st.bound()
        print(f"sharded flagship float32 {engine}: vs unsharded rt_run "
              f"max|dR|/max R {err_r:.3e}, max|dT|/max T {err_t:.3e}, "
              f"bit-equal {bit}; {st.calls} compared {key} launches, "
              f"max|diff| vs plain {st.abs:.3e} ({st.rel:.3e} of max); "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms ({by}) per launch (mean); steady sharded "
              f"{t_sh:.3f} s, unsharded {t_un:.3f} s {tag}")
        check(err_r < 1e-6 and err_t < 1e-6, f"sharded flagship float32 "
              f"{engine} off the unsharded run by >= 1e-6 of max")
    (R64, T64), t64 = timed(lambda: rt_run_band(
        *args, dtype=torch.float64, device=dev, engine="torch"))
    (Rs64, Ts64), t64s = timed(lambda: rt_run_band_sharded(
        *args, devices=devices, dtype=torch.float64, engine="torch"))
    q64 = max(rtol_ratio(Rs64, R64, 1e-12, 1e-15),
              rtol_ratio(Ts64, T64, 1e-12, 1e-15))
    print(f"sharded flagship float64 torch engine: max |d| / (1e-15 + "
          f"1e-12 |ref|) {q64:.3e} (<= 1); sharded {t64s:.3f} s, unsharded {t64:.3f} s "
          f"{tag}")
    check(q64 <= 1.0, "sharded flagship float64 off unsharded beyond rtol "
          "1e-12")

    # (b) Raman, O2Parameters.yaml as written, 4 shards with the halo
    if raman_ref is None:
        rm = vt.model_from_parameters(vt.parameters_from_yaml(
            os.path.join(HERE, O2_YAML)), device=dev)
        torch.cuda.reset_peak_memory_stats()
        ref_out = vt.rt_run(rm, rs_type="RRS", device=dev)
        raman_ref = {"model": rm, "out": ref_out,
                     "peak": torch.cuda.max_memory_allocated(),
                     "t_steady": timed(lambda: vt.rt_run(
                         rm, rs_type="RRS", device=dev))[1]}
    rm = raman_ref["model"]
    specs = _raman_specs(rm, 0, "RRS")
    cab = min(getattr(s, "omega_cabannes", 1.0) for s in specs)
    rband = build_band_inputs(rm, 0, omega_cabannes=cab)
    f_rayl = rm.tau_rayl[0].T / np.maximum(rband.tau, 1e-300)
    n_rs = rband.tau.shape[1]
    bounds = shard_bounds(n_rs, N_SHARDS)
    coupling = build_coupling(specs, n_rs)
    halo = raman_halo_stats([raman_halo(coupling, lo, hi)
                             for lo, hi in bounds], bounds)
    torch.cuda.reset_peak_memory_stats()
    rs_out, t_rs = timed(lambda: rt_run_band_rrs_sharded(
        rm.pol, rm.quad_points, rband, specs, f_rayl, rm.obs_geom.vza,
        rm.obs_geom.vaz, rm.params.max_m, _band_surface(rm, 0),
        devices=devices, dtype=torch.float64))
    peak = torch.cuda.max_memory_allocated()
    q = [rtol_ratio(a, b, 1e-11, 1e-16)
         for a, b in zip(rs_out, raman_ref["out"])]
    errs = [rel_err(a, b) for a, b in zip(rs_out, raman_ref["out"])]
    print(f"sharded Raman O2Parameters.yaml (Float64, nSpec={n_rs}, "
          f"nR={coupling[0].shape[0]}, {N_SHARDS} shards): per shard "
          f"[lo, hi) points halo (left, right) redundant share: "
          + "; ".join(f"[{h['lo']}, {h['hi']}) {h['points']} {h['halo']} "
                      f"({h['halo_left']}, {h['halo_right']}) "
                      f"{h['redundant_share']:.4f}" for h in halo)
          + f" {tag}")
    print(f"sharded Raman vs unsharded (phase 13 a): max |d| / (1e-16 + "
          f"1e-11 |ref|)"
          f" R {q[0]:.3e}, T {q[1]:.3e}, ieR {q[2]:.3e}, ieT {q[3]:.3e} (<= "
          f"1); max|d|/max {', '.join(f'{e:.3e}' for e in errs)}; sharded "
          f"{t_rs:.3f} s, peak {peak / 2**30:.2f} GiB; unsharded "
          f"{raman_ref['t_steady']:.3f} s, peak "
          f"{raman_ref['peak'] / 2**30:.2f} GiB {tag}")
    check(max(q) <= 1.0, "sharded Raman off the unsharded run beyond rtol "
          "1e-11")

    # (c) two gloo processes on the one card, the flagship in float64
    tmp = tempfile.mkdtemp(prefix="mp_", dir=os.path.join(HERE, "build"))
    path = os.path.join(tmp, "flagship")
    with open(path + ".pkl", "wb") as f:
        pickle.dump(args, f)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sk.getsockname()[1]}"
    t0 = time.perf_counter()
    run_children([[sys.executable, "-c", f"import chip_smoke; "
                   f"chip_smoke.mp_rank({addr!r}, {r}, {path!r})"]
                  for r in range(N_RANKS)], "two-process run")
    t_mp = time.perf_counter() - t0
    got = dict(np.load(path + ".npz"))
    shutil.rmtree(tmp)
    q_mp = max(rtol_ratio(got["R"], R64, 1e-12, 1e-15),
               rtol_ratio(got["T"], T64, 1e-12, 1e-15))
    print(f"two gloo processes on {dev} (flagship float64 torch engine, "
          f"{n_spec} points, 2 slices): max |d| / (1e-15 + 1e-12 |ref|) "
          f"{q_mp:.3e} "
          f"(<= 1); rank 0 run {float(got['seconds']):.3f} s, both "
          f"processes {t_mp:.1f} s wall {tag}")
    check(q_mp <= 1.0, "two-process run off the single run beyond rtol "
          "1e-12")

    # (d) the scaling harness: one card, 4 shards on it
    out = run_children([[sys.executable, "-m",
                         "vsmartmom_torch.scaling_bench"]],
                       "scaling_bench")[0]
    rec = json.loads(out.strip().splitlines()[-1])
    print(f"scaling_bench: {json.dumps(rec)} {tag}")
    po = rec.get("partition_overhead", {})
    check([r["n_devices"] for r in rec["rows"]] == [1]
          and rec["rows"][0]["pts_per_s"] > 0
          and po.get("n_shards") == N_SHARDS
          and np.isfinite(po.get("overhead_frac", np.nan)),
          f"scaling_bench record: {rec}")

    # (e) the native HITRAN parser (built with g++ on this machine by the
    # first model build's read_hitran(engine="auto"))
    for name in ("O2.par", "H2O.par"):
        path_par = os.path.join(HERE, "data", "hitran", name)
        nat, t_first = timed(lambda: read_hitran(path_par, engine="native"))
        _, t_nat = timed(lambda: read_hitran(path_par, engine="native"))
        py, t_py = timed(lambda: read_hitran(path_par, engine="python"))
        for f in ("mol", "iso", "nu", "sw", "a", "gamma_air", "gamma_self",
                  "elower", "n_air", "delta_air", "gp", "gpp"):
            check(np.array_equal(getattr(nat, f), getattr(py, f)),
                  f"native HITRAN parse of {name}: field {f} differs")
        for f in ("global_upper_quanta", "global_lower_quanta",
                  "local_upper_quanta", "local_lower_quanta", "ierr",
                  "iref", "line_mixing_flag"):
            check(getattr(nat, f) == getattr(py, f),
                  f"native HITRAN parse of {name}: field {f} differs")
        print(f"native HITRAN parser, {name} ({len(nat)} lines): field-"
              f"exact; native {t_nat:.4f} s (first call of this phase "
              f"{t_first:.4f} s; the model builds above built and used the "
              f"scanner), python {t_py:.4f} s (host)")


# ---- 17. matrix-product precision modes -------------------------------------

#: phase 17 (a): (engine, rt_run keyword, mode) of the flagship's runs at
#: the reduced modes
PRECISION_RUNS = (("kernel", "matmul_precision", "high"),
                  ("kernel", "matmul_precision", "default"),
                  ("kernel_dev", "dd_precision", "bf16x3"),
                  ("kernel_dev", "dd_precision", "default"),
                  ("kernel_doubling", "matmul_precision", "high"),
                  ("kernel_doubling", "matmul_precision", "default"))
#: phase 17 (b): each row's modes at the headline width
ROW_MODES = {"kernel": ("highest", "high", "default"),
             "kernel_dev": ("highest", "bf16x3", "default"),
             "kernel_doubling": ("highest", "high", "default")}
#: phase 17 (b): the points of the headline width
PRECISION_S = 20000
#: each row's wrapper, source and TPU kernel (the kernels line)
ROW_SOURCES = {
    "kernel": ("fused_layer_step", "vsmartmom_torch/csrc/layer_step.cu",
               "vsmartmom/pallas/layer_step_kernel.py:67"),
    "kernel_dev": ("fused_layer_step_dev",
                   "vsmartmom_torch/csrc/layer_step_dev.cu",
                   "vsmartmom/pallas/layer_step_kernel.py:132"),
    "kernel_doubling": ("fused_doubling",
                        "vsmartmom_torch/csrc/layer_step.cu",
                        "vsmartmom/pallas/doubling_kernel.py:105")}


def headline_width_calls(torch, dev, lsk, ldk):
    """Rows 1, 3 and 4's arguments at the headline width: a synthetic slab
    of N = 44, PRECISION_S points and 8 doublings (seed 0) under composites
    built by two plain steps. Returns ({engine: (args, keywords but the
    mode)}, S, N, doublings)."""
    from vsmartmom_torch.core.rt import (LayerRT, LayerRTDev, vacuum_layer,
                                         vacuum_layer_dev)
    rng = np.random.default_rng(0)
    S, n, nd = PRECISION_S, 44, 8
    sched = (0, 0, 1, 1, 2, 3, 4, 4)
    dtau, mqm = 0.5 / 2 ** nd, 0.2

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        e = rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm)
        t = np.eye(n) * np.exp(-dtau / mqm) + e
        v = [rng.uniform(0, dtau, (S, n)) for _ in range(2)]
        return f32(r), f32(t), f32(e), f32(v[0]), f32(v[1])

    d44 = f32(np.tile([1.0, 1.0, -1.0, -1.0], n // 4))
    ek = torch.full((S,), float(np.exp(-dtau / 0.7)), device=dev)
    g = torch.full((S, n), float(np.exp(-dtau / mqm)), device=dev)
    comp = vacuum_layer(S, n, torch.float32, dev)
    dcomp = vacuum_layer_dev(S, n, torch.float32, dev)
    for scale in (1.0, 0.6):
        r, t, e, jp, jm = slab(scale)
        comp = LayerRT(*(x.contiguous() for x in lsk.fused_layer_step_plain(
            comp, r, t, jp, jm, ek, d44, ns_schedule=sched, ni=4)))
        dcomp = LayerRTDev(*(x.contiguous() for x in
                             ldk.fused_layer_step_dev_plain(
                                 dcomp, r, g, e, jp, jm, ek, d44,
                                 ns_schedule=sched, ni=4,
                                 precision="highest")))
    r, t, e, jp, jm = slab(0.8)
    return ({"kernel": ((comp, r, t, jp, jm, ek, d44),
                        dict(ns_schedule=sched, ni=3)),
             "kernel_dev": ((dcomp, r, g, e, jp, jm, ek, d44),
                            dict(ns_schedule=sched, ni=3)),
             "kernel_doubling": ((r, t, jp, jm, ek),
                                 dict(ns_schedule=sched))}, S, n, nd)


def precision_only(qual_out=None):
    """Phase 17 (precision modes) alone, after the build and its resource
    check: python3 -c 'import chip_smoke; chip_smoke.precision_only()'.
    ``qual_out``: a file the qualification appends its lines to."""
    torch = setup()
    tag = f"[card: {card_name()}]"
    build_phase(tag)
    kernels = precision_phase(torch, torch.device("cuda:0"), tag, qual_out)
    print(json.dumps({"kernels": kernels}))


def precision_phase(torch, dev, tag, qual_out=None):
    """17. The matrix-product precision modes (core/precision.py) of rows
    1, 3 and 4. (a) The Float32 flagship through rt_run at each reduced
    mode of PRECISION_RUNS, the launch counts set to 0 just before each run
    and read after it (102 launches of its row and nothing else), every
    launch against its plain version at the same mode as reduced_ok says
    (reduced_judge), R against the float64 torch engine at
    the same schedules (row 3 at bf16x3 within 1e-3), first and steady
    seconds; (b) rows 1, 3 and 4 at every mode of ROW_MODES on a synthetic
    slab at the headline width (headline_width_calls: N = 44, 20 000
    points, 8 doublings), each against its plain version (at the reduced
    modes as reduced_ok says, 1e-5 of max at "highest"), CUDA-event times
    and bounds; (c) the qualification
    (vsmartmom_torch.qualify_precision, all six tokens): the kernel deltas
    of "highest" and the dev tokens below 1e-5 and the dev tokens inside
    the gates; (d) the bench.py raman_rrs shape at ie_precision "high" and
    "default" against "highest": R and T within 1e-6 (bit equality
    printed), ieR within 1e-2. Returns the kernels-line entries of (a)."""
    import vsmartmom_torch as vt
    from vsmartmom_torch import qualify_precision
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    t_phase = time.perf_counter()

    rows = {"kernel": (lsk, lsk.fused_layer_step_plain, step_work),
            "kernel_dev": (ldk, ldk.fused_layer_step_dev_plain,
                           dev_step_work),
            "kernel_doubling": (dk, dk.fused_doubling_plain, doubling_work)}

    def entry(engine, mode, st, launches):
        name, source, replaces = ROW_SOURCES[engine]
        return st.entry(f"{name}[{mode}]", source, replaces, launches)

    # ---- (a) the flagship at each reduced mode ------------------------------
    params = vt.default_parameters()
    params.float_type = "Float32"
    model = vt.model_from_parameters(params, device=dev)
    n_spec, n_z = len(params.spec_bands[0]), model.profile.n_layers
    max_m, n_flag = params.max_m, len(model.quad_points.qp_mu_n)
    R64, _ = rt_run_band(model.pol, model.quad_points,
                         build_band_inputs(model, 0), model.obs_geom.vza,
                         model.obs_geom.vaz, max_m, params.surfaces[0],
                         dtype=torch.float64, device=dev, solver="schulz",
                         engine="torch")
    entries = []
    for engine, key, mode in PRECISION_RUNS:
        mod, plain, work = rows[engine]
        name = ROW_SOURCES[engine][0]
        kw = dict(device=dev, engine=engine, **{key: mode})
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R, _ = vt.rt_run(model, **kw)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        c = counts()
        check(c[engine] == max_m * n_z and sum(c.values()) == c[engine],
              f"flagship {engine} at {mode}: launches {c}, expected "
              f"{max_m * n_z} of {engine} only")
        t0 = time.perf_counter()
        vt.rt_run(model, **kw)
        torch.cuda.synchronize()
        t_steady = time.perf_counter() - t0
        st = KernelStats(mode)
        real = getattr(mod, name)
        setattr(mod, name, compare_hook(
            torch, st, real, plain, work,
            judge=reduced_judge(torch, st, engine, mode, plain)))
        try:
            vt.rt_run(model, **kw)
        finally:
            setattr(mod, name, real)
        check(st.calls == max_m * n_z, f"flagship {engine} at {mode}: "
              f"{st.calls} compared launches")
        tc = on_tensor_cores(engine, mode, n_flag)
        check(not st.failed, f"flagship {engine} at {mode} vs plain: max|diff|"
              f" {st.abs:.3e} ({st.rel:.3e} of max); launches that did not "
              f"hold as reduced_ok says: {st.failed[:5]}")
        if engine == "kernel_dev" and tc:
            check(rel_err(R, R64) < 1e-3, f"flagship {engine} at {mode}: R "
                  f"{rel_err(R, R64):.3e} of max off float64")
        ms, plain_ms = st.mean_ms()
        bound, by = st.bound()
        finite = bool(np.isfinite(R).all())
        sep = f", sep {st.sep:.3e}" if st.sep else ""
        print(f"precision (a) flagship {engine} {key}={mode} (N={n_flag}, "
              f"S={n_spec}): {c[engine]} launches; tensor cores {tc}; vs "
              f"plain at {mode} max|diff| {st.abs:.3e} ({st.rel:.3e} of max"
              f"{sep}, bit-equal {st.abs == 0.0}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} "
              f"ms, bound {bound:.4f} ms ({by}, {MODE_PASSES[mode]} bf16 "
              f"passes at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s) per launch; "
              f"R finite {finite}, max|dR|/max R vs float64 "
              f"{rel_err(R, R64):.3e}; rt_run first {t_first:.3f} s, steady "
              f"{t_steady:.3f} s {tag}", flush=True)
        entries.append(entry(engine, mode, st, c[engine]))
    del model

    # ---- (b) rows 1, 3 and 4 at every mode at the headline width -----------
    calls, S, n, nd = headline_width_calls(torch, dev, lsk, ldk)
    row_ms = {}
    for engine, modes in ROW_MODES.items():
        mod, plain, work = rows[engine]
        args, kw0 = calls[engine]
        for mode in modes:
            kw = dict(kw0, precision=mode)
            st = KernelStats(mode)
            real = getattr(mod, ROW_SOURCES[engine][0])
            compare_hook(torch, st, real, plain, work)(*args, **kw)
            torch.cuda.synchronize()
            # a reduced mode as reduced_ok says (a launch that computed
            # "highest" instead would sit within 1e-5 of max, but not
            # nearer the mode's plain version than highest's)
            if mode == "highest":
                ok = st.rel < 1e-5
            else:
                got, ref = real(*args, **kw), plain(*args, **kw)
                full = plain(*args, **dict(kw, precision="highest"))
                ok = reduced_ok(engine, mode, n, st.rel, max(
                    rel_field(torch, a, b) for a, b in zip(got, full)), max(
                    rel_field(torch, a, b) for a, b in zip(ref, full)))
                del got, ref, full
            check(ok, f"{engine} at {mode}, N={n}: {st.abs:.3e} "
                  f"({st.rel:.3e} of max) from the plain version")
            ms, plain_ms = st.mean_ms()
            bound, by = st.bound()
            row_ms[engine, mode] = ms
            print(f"precision (b) {ROW_SOURCES[engine][0]} at {mode} (N={n}"
                  f", S={S}, nd={nd}): vs plain {st.abs:.3e} ({st.rel:.3e} "
                  f"of max, bit-equal {st.abs == 0.0}); kernel {ms:.3f} ms "
                  f"({ms / row_ms[engine, modes[0]]:.2f}x {modes[0]}), "
                  f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}) "
                  f"{tag}", flush=True)
    del calls

    # ---- (c) the qualification ----------------------------------------------
    t0 = time.perf_counter()
    reset_counts()
    recs = {r["precision"]: r for r in qualify_precision.main(
        qualify_precision.TOKENS, out=qual_out, device=dev)}
    print(f"precision (c) qualification: {len(recs)} tokens in "
          f"{time.perf_counter() - t0:.1f} s, launches {counts()} {tag}",
          flush=True)
    for tok in ("highest", "dev", "dev_highest", "dev_high"):
        check(recs[tok]["kernel_vs_torch_delta"] < 1e-5,
              f"qualification {tok}: kernel vs torch engine "
              f"{recs[tok]['kernel_vs_torch_delta']:.3e}")
    for tok in ("dev", "dev_highest", "dev_high"):
        check(recs[tok]["gates_pass"], f"qualification {tok} off its gates")

    # ---- (d) the Raman bench shape at each ie mode --------------------------
    args = bench_raman_shape()
    ref = None
    for mode in ("highest", "high", "default"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rt_run_band_rrs(*args, dtype=torch.float32, device=dev,
                              ie_precision=mode)
        t_run = time.perf_counter() - t0
        check(all(np.isfinite(x).all() for x in out),
              f"Raman bench shape at ie_precision {mode}: not finite")
        if ref is None:
            ref = out
            print(f"precision (d) Raman bench shape ({args[2].tau.shape[1]}"
                  f" points, nR {args[3].n_raman}) at ie_precision highest: "
                  f"{t_run:.3f} s {tag}", flush=True)
            continue
        d_rt = max(rel_err(out[0], ref[0]), rel_err(out[1], ref[1]))
        bit = all(np.array_equal(a, b) for a, b in zip(out[:2], ref[:2]))
        d_ie = rel_err(out[2], ref[2])
        print(f"precision (d) Raman bench shape at ie_precision {mode}: "
              f"ieR vs highest {d_ie:.3e} of max, ieT "
              f"{rel_err(out[3], ref[3]):.3e}; R/T vs highest {d_rt:.3e} "
              f"(bit-equal {bit}); {t_run:.3f} s {tag}", flush=True)
        check(d_rt < 1e-6 and d_ie < 1e-2, f"Raman at ie_precision {mode}:"
              f" R/T {d_rt:.3e}, ieR {d_ie:.3e} from highest")
    print(f"precision phase: {time.perf_counter() - t_phase:.1f} s {tag}")
    return entries


def main():
    torch = setup()

    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt import LayerRT, vacuum_layer
    import vsmartmom_torch.core.rt_run as rtr
    from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom_torch.check_bucketed import run_check
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import lanes_kernel as lnk
    from vsmartmom_torch.cuda import layer_scan_kernel as scn
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.scattering.phase import get_greek_rayleigh
    from vsmartmom_torch.util.quadrature import rt_set_streams
    from vsmartmom_torch.spectroscopy.profiles import (
        compute_absorption_profile, hitran_artifact, read_linelist)
    from vsmartmom_torch.spectroscopy.voigt import (
        compute_absorption_cross_section, make_hitran_model)

    dev = torch.device("cuda:0")

    def n_buckets(band_, quad_):
        """Schedule buckets of a profile under the schulz solver (a uniform
        profile is one bucket)."""
        _, _, ls = rtr.build_layer_schedules(
            band_.tau, band_.omega, float(np.min(quad_.qp_mu)), "schulz")
        return len(rtr.schedule_buckets(ls)) if ls is not None else 1
    card = card_name()
    tag = f"[card: {card}]"
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s) {tag}")

    # ---- 1. build -----------------------------------------------------------
    build_phase(tag)
    check_step_routing()

    # ---- 1b. the team kernels at every width class and its edges -----------
    widths, wide_ms = width_class_phase(torch, dev, lsk, dk, scn, lnk, ldk,
                                        LayerRT)
    print(f"width classes (S = {WIDTH_S}): every launch within 1e-5 of max "
          f"per field of its plain version, at a reduced mode ([mode]) "
          f"bit-equal to it (on the tensor cores: as reduced_ok says); "
          f"max|diff| / max by "
          f"N: "
          f"{json.dumps(widths)} {tag}")
    print_wide_widths(wide_ms, tag)

    # ---- 2. the flagship forward run, launches counted ----------------------
    params = vt.default_parameters()
    params.float_type = "Float32"
    grid = np.asarray(params.spec_bands[0], np.float64)
    n_spec = len(grid)
    ap = params.absorption_params

    # the kernel engine launches once per molecule with lines in the band
    voigt_mols = [m for m in ap.molecules[0]
                  if has_lines(m, grid, ap.wing_cutoff)]

    reset_counts()
    rtr.auto_choices.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = vt.model_from_parameters(params, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    R, T = vt.rt_run(model, device=dev)
    torch.cuda.synchronize()
    t_rt_first = time.perf_counter() - t0
    c_auto = counts()
    n_voigt = vk.launches
    n_z = model.profile.n_layers
    max_m = params.max_m
    band = build_band_inputs(model, 0)
    nb_flag = n_buckets(band, model.quad_points)
    # the same run through row 1, by name
    reset_counts()
    t0 = time.perf_counter()
    R_k, T_k = vt.rt_run(model, device=dev, engine="kernel")
    torch.cuda.synchronize()
    t_k_first = time.perf_counter() - t0
    c_k = counts()
    n_step = c_k["kernel"]
    print(f"flagship: nSpec={n_spec}, nZ={n_z}, max_m={max_m}, "
          f"N={len(model.quad_points.qp_mu_n)}, {nb_flag} schedule buckets; "
          f"launches: auto {c_auto} (auto took {rtr.auto_choices}), "
          f"kernel {c_k} {tag}")
    check(n_voigt == len(voigt_mols), f"{n_voigt} Voigt launches in the "
          f"build, expected one per molecule with lines: {voigt_mols}")
    check(rtr.auto_choices == {"kernel_scan": 1}, f"flagship auto took "
          f"{rtr.auto_choices}, expected kernel_scan")
    check(c_auto["kernel_scan"] == max_m * nb_flag
          and sum(c_auto.values()) == c_auto["kernel_scan"] + n_voigt,
          f"flagship auto: launches {c_auto}, expected {max_m * nb_flag} "
          f"layer-scan launches and nothing else")
    check(n_step == max_m * n_z and sum(c_k.values()) == n_step,
          f"flagship kernel: launches {c_k}, expected {max_m * n_z} "
          f"layer-step launches and nothing else")
    for name, (R_, T_) in (("auto", (R, T)), ("kernel", (R_k, T_k))):
        check(R_.shape == (len(params.vza), 1, n_spec)
              and T_.shape == R_.shape,
              f"{name} R/T shape {R_.shape}/{T_.shape}")
        check(np.isfinite(R_).all() and np.isfinite(T_).all(),
              f"non-finite {name} R/T")
        nadir = R_[4, 0]
        check(np.all(nadir > 0) and np.all(nadir < 1),
              f"{name} nadir R outside (0, 1)")

    def steady_flag(**kw):
        best = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            vt.rt_run(model, device=dev, **kw)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    t_steady = steady_flag()
    t_k_steady = steady_flag(engine="kernel")
    tau = np.zeros((n_spec, n_z))
    t0 = time.perf_counter()
    compute_absorption_profile(tau, "O2", ap, grid, 0.21, model.profile,
                               engine="kernel", device=dev)
    torch.cuda.synchronize()
    t_voigt = time.perf_counter() - t0
    print(f"model build {t_build:.3f} s (Voigt for O2 alone {t_voigt:.3f} s); "
          f"rt_run auto first {t_rt_first:.3f} s, steady {t_steady:.3f} s = "
          f"{n_spec / t_steady:.1f} points/s; kernel first {t_k_first:.3f} "
          f"s, steady {t_k_steady:.3f} s = {n_spec / t_k_steady:.1f} "
          f"points/s {tag}")

    # ---- 3a. Voigt kernel vs plain version, all layers in one launch -------
    (_, mol, _, vmr), (_, mol_c, grid_c, vmr_c) = voigt_shapes(params)
    v_stats, _ = voigt_compared(torch, vk, compute_absorption_profile, mol,
                                grid, vmr, ap, model.profile, dev)
    check(v_stats.calls == 1, "the O2 Voigt comparison did not run once")
    check(v_stats.rel <= 2e-5, f"Voigt kernel vs plain: "
          f"{v_stats.rel:.3e} of max sigma > 2e-5")
    # against the dense f64 engine at the bottom layer's (p, T)
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
    v_ms, v_plain = v_stats.mean_ms()
    v_bound, v_by = v_stats.bound()
    print(f"voigt (flagship O2): {len(ht)} lines, {n_z} layers in "
          f"{v_stats.calls} launch: max|diff| vs plain {v_stats.abs:.3e} "
          f"({v_stats.rel:.3e} of max sigma), vs dense f64 {dense_rel:.3e} "
          f"of max sigma at the bottom layer; kernel {v_ms:.4f} ms per launch"
          f" = {v_ms / n_z:.5f} ms per layer, plain {v_plain:.4f} ms, dense "
          f"f64 {1e3 * t_dense:.2f} ms per layer, bound {v_bound:.4f} ms "
          f"({v_by}) per launch = {v_bound / n_z:.5f} ms per layer {tag}")
    print(f"voigt (flagship O2) "
          f"{voigt_geometry(vk, grid, ht.nu, ap.wing_cutoff, n_z)}")

    # ---- 3c. Voigt kernel at the HAPI gate's CO2 shape ----------------------
    c_stats, _ = voigt_compared(torch, vk, compute_absorption_profile, mol_c,
                                grid_c, vmr_c, ap, model.profile, dev)
    check(c_stats.calls == 1, f"CO2: {c_stats.calls} Voigt launches, "
          f"expected 1")
    check(c_stats.rel <= 2e-5, f"CO2 Voigt kernel vs plain: "
          f"{c_stats.rel:.3e} of max sigma > 2e-5")
    c_ms, c_plain = c_stats.mean_ms()
    c_bound, c_by = c_stats.bound()
    ct = read_linelist(hitran_artifact(mol_c), mol_c,
                       grid_c.min() - ap.wing_cutoff,
                       grid_c.max() + ap.wing_cutoff)
    print(f"voigt (HAPI-grid CO2): {len(ct)} lines, {len(grid_c)} points, "
          f"{n_z} layers in {c_stats.calls} launch: max|diff| vs plain "
          f"{c_stats.abs:.3e} ({c_stats.rel:.3e} of max sigma) over every "
          f"layer; kernel {c_ms:.4f} ms per launch = {c_ms / n_z:.5f} ms per "
          f"layer, plain {c_plain:.2f} ms per launch, bound {c_bound:.4f} ms "
          f"({c_by}, {c_stats.flops:.4g} operations, {c_stats.nbytes} bytes)"
          f" per launch = {c_bound / n_z:.5f} ms per layer {tag}")
    print(f"voigt (HAPI-grid CO2) "
          f"{voigt_geometry(vk, grid_c, ct.nu, ap.wing_cutoff, n_z)}")

    # ---- 3b. layer-step kernel vs plain version at every layer and moment ---
    def lanes_work(comp_l, r_f, *args, ns_schedule, ni, **kw):
        n_, s_ = r_f.shape[0], r_f.shape[2]
        return (s_ * lnk.step_flops(n_, ns_schedule, ni),
                s_ * lnk.step_bytes(n_))

    s_stats = KernelStats()
    real_step = lsk.fused_layer_step
    lsk.fused_layer_step = compare_hook(torch, s_stats, real_step,
                                        lsk.fused_layer_step_plain,
                                        step_work)
    try:
        vt.rt_run(model, device=dev, engine="kernel")
    finally:
        lsk.fused_layer_step = real_step
    check(s_stats.calls == max_m * n_z, "layer-step comparison did not "
          "run per layer")
    check(s_stats.rel < 1e-5, f"layer-step kernel vs plain: max|diff| / "
          f"max = {s_stats.rel:.3e} >= 1e-5")
    s_ms, s_plain = s_stats.mean_ms()
    s_bound, s_by = s_stats.bound()
    n_flag = len(model.quad_points.qp_mu_n)
    print(f"layer step (N={n_flag}, S={n_spec}): {s_stats.calls} calls, "
          f"max|diff| vs plain {s_stats.abs:.3e} ({s_stats.rel:.3e} of "
          f"max); kernel {s_ms:.3f} ms, plain {s_plain:.3f} ms, bound "
          f"{s_bound:.4f} ms ({s_by}) per layer step (mean) {tag}")

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
    bound44 = 1e3 * max(S * lsk.step_flops(n, sched, 3) / PEAK_F32_FLOPS,
                        S * lsk.step_bytes(n) / PEAK_BYTES)
    print(f"layer step (N=44, S={S}, nd={nd}): max|diff| / max {rel44:.3e};"
          f" kernel {ms44:.3f} ms, plain {plain44:.3f} ms, bound "
          f"{bound44:.3f} ms {tag}")
    del comp, args44, out, ref

    # ---- 4. against the float64 torch engine at the same schedules ----------
    t0 = time.perf_counter()
    R64, T64 = rt_run_band(model.pol, model.quad_points, band,
                           model.obs_geom.vza, model.obs_geom.vaz, max_m,
                           params.surfaces[0], dtype=torch.float64,
                           device=dev, solver="schulz", engine="torch")
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    rel_r, rel_t = rel_err(R, R64), rel_err(T, T64)
    rel_rk, rel_tk = rel_err(R_k, R64), rel_err(T_k, T64)
    print(f"float32 auto (kernel_scan) vs float64 torch engine: max|dR|/max "
          f"R = {rel_r:.3e}, max|dT|/max T = {rel_t:.3e}; kernel engine "
          f"{rel_rk:.3e}, {rel_tk:.3e} (float64 run {t64:.2f} s) {tag}")
    check(rel_r < 1e-3 and rel_t < 1e-3, "flagship auto R/T off the float64 "
          "reference by >= 1e-3")
    check(rel_rk < 1e-3 and rel_tk < 1e-3, "flagship kernel R/T off the "
          "float64 reference by >= 1e-3")
    del R_k, T_k

    # ---- 5. (a) the flagship through the split-form kernel ------------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Rd, Td = vt.rt_run(model, device=dev, engine="kernel_dev")
    torch.cuda.synchronize()
    t_dev_first = time.perf_counter() - t0
    n_dev = counts()
    print(f"flagship kernel_dev: launches {n_dev} {tag}")
    check(n_dev["kernel_dev"] == max_m * n_z and n_dev["kernel"] == 0,
          f"flagship kernel_dev launches {n_dev}, expected "
          f"{max_m * n_z} split-form and 0 plain layer steps")
    check(np.isfinite(Rd).all() and np.isfinite(Td).all(),
          "non-finite kernel_dev R/T")
    t_dev = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        vt.rt_run(model, device=dev, engine="kernel_dev")
        torch.cuda.synchronize()
        t_dev = min(t_dev, time.perf_counter() - t0)
    d_stats = KernelStats()
    real_dev = ldk.fused_layer_step_dev
    ldk.fused_layer_step_dev = compare_hook(
        torch, d_stats, real_dev, ldk.fused_layer_step_dev_plain,
        dev_step_work)
    try:
        vt.rt_run(model, device=dev, engine="kernel_dev")
    finally:
        ldk.fused_layer_step_dev = real_dev
    check(d_stats.calls == max_m * n_z, "split-form comparison did not run "
          "per layer")
    check(d_stats.rel < 1e-5, f"split-form kernel vs plain: max|diff| / max"
          f" = {d_stats.rel:.3e} >= 1e-5")
    d_ms, d_plain = d_stats.mean_ms()
    d_bound, d_by = d_stats.bound()
    rel_rd, rel_td = rel_err(Rd, R64), rel_err(Td, T64)
    print(f"split-form layer step (N={n_flag}, S={n_spec}): "
          f"{d_stats.calls} calls, max|diff| vs plain {d_stats.abs:.3e} "
          f"({d_stats.rel:.3e} of max); kernel {d_ms:.3f} ms, plain "
          f"{d_plain:.3f} ms, bound {d_bound:.4f} ms ({d_by}) per layer "
          f"step (mean) {tag}")
    print(f"flagship vs float64 torch engine: kernel_dev max|dR|/max R = "
          f"{rel_rd:.3e}, max|dT|/max T = {rel_td:.3e}; kernel (plain form) "
          f"{rel_rk:.3e}, {rel_tk:.3e}; rt_run kernel_dev first "
          f"{t_dev_first:.3f} s, steady {t_dev:.3f} s = "
          f"{n_spec / t_dev:.1f} points/s {tag}")
    check(rel_rd < 1e-3 and rel_td < 1e-3, "flagship kernel_dev R/T off the "
          "float64 reference by >= 1e-3")

    # ---- 8. (d), 9. (e) the flagship through kernel_scan and kernel_lanes --
    flag = {"kernel_scan": (scn, "fused_layer_scan",
                            scn.fused_layer_scan_plain, scan_work,
                            max_m * nb_flag),
            "kernel_lanes": (lnk, "fused_layer_step_lanes",
                             lnk.lanes_layer_step_plain, lanes_work,
                             max_m * n_z)}
    f_stats, f_launches = {}, {}
    for engine, (mod, fname, plain, work, expected) in flag.items():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Rf, Tf = vt.rt_run(model, device=dev, engine=engine)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        c = counts()
        f_launches[engine] = c[engine]
        check(c[engine] == expected and sum(c.values()) == expected,
              f"flagship {engine}: launches {c}, expected {expected} of "
              f"{engine} only ({nb_flag} schedule buckets)")
        check(np.isfinite(Rf).all() and np.isfinite(Tf).all(),
              f"non-finite flagship {engine} R/T")
        t_eng = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            vt.rt_run(model, device=dev, engine=engine)
            torch.cuda.synchronize()
            t_eng = min(t_eng, time.perf_counter() - t0)
        st = f_stats[engine] = KernelStats()
        real = getattr(mod, fname)
        setattr(mod, fname, compare_hook(torch, st, real, plain, work))
        try:
            vt.rt_run(model, device=dev, engine=engine)
        finally:
            setattr(mod, fname, real)
        check(st.calls == expected, f"flagship {engine} comparison did not "
              f"run per launch")
        check(st.rel < 1e-5, f"flagship {engine} kernel vs plain: max|diff| "
              f"/ max = {st.rel:.3e} >= 1e-5")
        ms, plain_ms = st.mean_ms()
        bound, by = st.bound()
        rel_rf, rel_tf = rel_err(Rf, R64), rel_err(Tf, T64)
        print(f"flagship {engine} (N={n_flag}, S={n_spec}, {nb_flag} "
              f"schedule buckets): {c[engine]} launches, max|diff| vs plain "
              f"{st.abs:.3e} ({st.rel:.3e} of max); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}) per "
              f"launch (mean); vs float64 max|dR|/max R = {rel_rf:.3e}, "
              f"max|dT|/max T = {rel_tf:.3e}; rt_run first {t_first:.3f} s, "
              f"steady {t_eng:.3f} s = {n_spec / t_eng:.1f} points/s {tag}")
        check(rel_rf < 1e-3 and rel_tf < 1e-3, f"flagship {engine} R/T off "
              f"the float64 reference by >= 1e-3")
        del Rf, Tf
    del model, band

    # ---- 6. (b), 10. (f) the headline IQUV shape through the kernel engines
    pol_h, quad_h, band_h, surf_h = headline_shape()
    (nz_h, ns_h), n_h, m_h = band_h.tau.shape, len(quad_h.qp_mu_n), 3

    def run_h(engine, dtype=torch.float32):
        return rt_run_band(pol_h, quad_h, band_h, [0.0, 30.0], [0.0, 0.0],
                           m_h, surf_h, dtype=dtype, device=dev,
                           solver="schulz", engine=engine)

    t0 = time.perf_counter()
    R64h, _ = run_h("torch", torch.float64)
    torch.cuda.synchronize()
    print(f"headline (N={n_h}, S={ns_h}, {nz_h} layers, {m_h} moments): "
          f"float64 torch engine {time.perf_counter() - t0:.2f} s {tag}")
    check(n_h == 44, f"headline quadrature has N = {n_h}, expected 44")
    check(scn.max_n() >= n_h, f"layer-scan kernel takes N <= {scn.max_n()}")
    # 10. (f): kernel_scan launches once per schedule bucket and moment
    hooks = {"kernel": (lsk, "fused_layer_step", lsk.fused_layer_step_plain,
                        step_work),
             "kernel_dev": (ldk, "fused_layer_step_dev",
                            ldk.fused_layer_step_dev_plain, dev_step_work),
             "kernel_doubling": (dk, "fused_doubling", dk.fused_doubling_plain,
                                 doubling_work),
             "kernel_scan": (scn, "fused_layer_scan",
                             scn.fused_layer_scan_plain, scan_work),
             "kernel_lanes": (lnk, "fused_layer_step_lanes",
                              lnk.lanes_layer_step_plain, lanes_work)}
    expected_h = {e: m_h * nz_h for e in hooks}
    expected_h["kernel_scan"] = m_h * n_buckets(band_h, quad_h)
    h_stats, h_launches = {}, {}
    for engine, (mod, fname, plain, work) in hooks.items():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Rh, Th = run_h(engine)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        c = counts()
        h_launches[engine] = c[engine]
        check(c[engine] == expected_h[engine]
              and sum(c.values()) == c[engine],
              f"headline {engine}: launches {c}, expected "
              f"{expected_h[engine]} of {engine} only")
        st = h_stats[engine] = KernelStats()
        real = getattr(mod, fname)
        setattr(mod, fname, compare_hook(torch, st, real, plain, work,
                                         reps=(2, 1)))
        try:
            run_h(engine)
        finally:
            setattr(mod, fname, real)
        check(st.calls == expected_h[engine], f"headline {engine} "
              f"comparison did not run per launch")
        check(st.rel < 1e-5, f"headline {engine} kernel vs plain: "
              f"{st.rel:.3e} >= 1e-5")
        rel_h = rel_err(Rh, R64h)
        check(np.isfinite(Rh).all() and rel_h < 1e-3,
              f"headline {engine}: R off float64 by {rel_h:.3e}")
        ms, plain_ms = st.mean_ms()
        bound, by = st.bound()
        print(f"headline {engine}: {c[engine]} launches, run {t_run:.3f} s, "
              f"max|dR|/max R vs float64 {rel_h:.3e}; kernel vs plain "
              f"max|diff| {st.abs:.3e} ({st.rel:.3e} of max); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
              f"({by}) per launch (mean) {tag}")
        del Rh, Th

    # ---- 7. (c) float32 Natraj (N = 136) under auto -------------------------
    nat = np.load(os.path.join(HERE, "tests", "data", "natraj_trues.npz"))
    mu = np.array([0.02, 0.06, 0.10, 0.16, 0.20, 0.28, 0.32, 0.40, 0.52,
                   0.64, 0.72, 0.84, 0.92, 0.96, 0.98, 1.00])
    vza = np.degrees(np.arccos(mu))
    quad_n = rt_set_streams("RadauQuad", 20, np.degrees(np.arccos(0.2)), vza,
                            pol_h.n)
    band_n = BandRTInputs(tau=np.full((1, 2), 0.5), omega=np.ones((1, 2)),
                          zw=np.ones((1, 1, 2)),
                          greeks=[get_greek_rayleigh(0.0)])
    picked = []
    real_select = rtr.select_engine

    def recording_select(*a, **kw):
        picked.append(real_select(*a, **kw))
        return picked[-1]

    I_m, Q_m, U_m = (np.zeros((16, 7)) for _ in range(3))
    reset_counts()
    rtr.select_engine = recording_select
    try:
        for j, phi in enumerate(np.arange(0.0, 181.0, 30.0)):
            Rn, _ = rt_run_band(pol_h, quad_n, band_n, vza, [phi] * 16, 3,
                                {"type": "LambertianSurfaceScalar",
                                 "albedo": 0.0}, dtype=torch.float32,
                                device=dev, engine="auto")
            I_m[:, j], Q_m[:, j], U_m[:, j] = Rn[:, 0, 0], Rn[:, 1, 0], \
                Rn[:, 2, 0]
    finally:
        rtr.select_engine = real_select
    n_q = len(quad_n.qp_mu_n)
    err_i = float(np.max(np.abs(nat["I_trues"] - I_m) / nat["I_trues"]))
    q_mask, u_mask = Q_m >= 0.01, U_m >= 0.01
    err_q = float(np.max(np.abs(nat["Q_trues"] - Q_m)[q_mask]
                         / np.abs(nat["Q_trues"])[q_mask]))
    with np.errstate(invalid="ignore"):
        err_u = float(np.nanmax(np.abs(nat["U_trues"] - U_m)[u_mask]
                                / np.abs(nat["U_trues"])[u_mask]))
    print(f"Natraj float32 auto (N={n_q}): engines {sorted(set(picked))}, "
          f"launches {counts()}; max rel err I {err_i:.3e} (< 0.002), "
          f"Q {err_q:.3e}, U {err_u:.3e} (< 0.008) {tag}")
    check(n_q > rtr.KERNEL_MAX_N, f"Natraj quadrature has N = {n_q}, "
          f"expected more than {rtr.KERNEL_MAX_N}")
    check(picked == ["torch_dev"] * 7, f"Natraj auto took {picked}")
    check(sum(counts().values()) == 0, "Natraj torch_dev launched kernels")
    check(err_i < 0.002 and err_q < 0.008 and err_u < 0.008,
          "float32 Natraj off its gates")

    # ---- 11. (g) the bucketed-engine check on the card ----------------------
    reset_counts()
    t0 = time.perf_counter()
    bucketed = run_check(device=dev)
    print(f"check_bucketed ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(bucketed)} {tag}")
    check(bucketed["ok"], "the bucketed-engine check failed")

    # ---- 12. (h) the reference's 3-band configuration at full width -------
    three_band_phase(torch, dev, tag, reset_counts, counts,
                     {"kernel": step_work, "kernel_dev": dev_step_work,
                      "kernel_scan": scan_work, "kernel_lanes": lanes_work})

    # ---- 13. (i) the Raman path --------------------------------------------
    raman_ref = raman_phase(torch, dev, tag, reset_counts, counts, scan_work,
                            n_buckets)

    # ---- 14. (j) the rest of the elastic scope ------------------------------
    elastic_scope_phase(torch, dev, tag, reset_counts, counts)

    # ---- 15. (k) forward-mode AD --------------------------------------------
    ad_phase(torch, dev, tag, reset_counts, counts)

    # ---- 16. (l) spectral sharding on the one card --------------------------
    sharding_phase(torch, dev, tag, reset_counts, counts, raman_ref)

    # ---- 17. (m) the precision modes of rows 1, 3 and 4 ---------------------
    precision_entries = precision_phase(torch, dev, tag)

    # ---- 18. (n) the lanes step's wide path on the N = 92 run ---------------
    wide_stats, wide_launches = lanes_wide_path_phase(torch, dev, tag,
                                                      reset_counts, counts)

    kernels = [
        s_stats.entry("fused_layer_step",
                      "vsmartmom_torch/csrc/layer_step.cu",
                      "vsmartmom/pallas/layer_step_kernel.py:67", n_step),
        v_stats.entry("voigt_tiles", "vsmartmom_torch/csrc/voigt.cu",
                      "vsmartmom/pallas/voigt_kernel.py:90", n_voigt),
        d_stats.entry("fused_layer_step_dev",
                      "vsmartmom_torch/csrc/layer_step_dev.cu",
                      "vsmartmom/pallas/layer_step_kernel.py:132",
                      n_dev["kernel_dev"]),
        h_stats["kernel_doubling"].entry(
            "fused_doubling", "vsmartmom_torch/csrc/layer_step.cu",
            "vsmartmom/pallas/doubling_kernel.py:105",
            h_launches["kernel_doubling"]),
        f_stats["kernel_scan"].entry(
            "fused_layer_scan", "vsmartmom_torch/csrc/layer_scan.cu",
            "vsmartmom/pallas/layer_scan_kernel.py:59",
            f_launches["kernel_scan"]),
        f_stats["kernel_lanes"].entry(
            "fused_layer_step_lanes", "vsmartmom_torch/csrc/lanes.cu",
            "vsmartmom/pallas/lanes_kernel.py:135",
            f_launches["kernel_lanes"]),
        wide_stats.entry("lanes_wide_kernel", "vsmartmom_torch/csrc/lanes.cu",
                         "vsmartmom/pallas/lanes_kernel.py:135",
                         wide_launches),
        *precision_entries,
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
