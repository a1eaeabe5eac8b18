"""Where the time of the flagship forward run goes, on one CUDA device.

Run from the repository root:

    python3 -m vsmartmom_torch.profile_flagship [--engine E] [--jacobian]
        [--trace DIR]

Builds the Float32 flagship (default_parameters -> model_from_parameters)
once to warm up, then profiles with ``torch.profiler`` (CPU + CUDA
activities) one model build and one steady ``rt_run`` through engine E
(``auto`` by default; any engine ``rt_run`` takes). With ``--jacobian`` it
profiles instead one steady radiance and one steady torch.func.jacfwd
Jacobian of the retrieval demo's state (retrieval_demo.state_radiance:
log scattering scale, albedo, log absorption scale) through AD engine E
(``kernel`` for ``auto``) at the band's static schulz schedules. For each
it prints:

- wall: host seconds around the call, synchronized, profiler on;
- device busy: the union of the device intervals (kernels, copies, sets)
  that the profiler recorded inside the call;
- idle share: 1 - busy / wall. The profiler slows the host, so this is an
  upper bound of the unprofiled idle share;
- the port's own kernels (csrc/) against every other device event (torch
  ops, copies): summed time, share of device busy and launches;
- per device kernel: launches, summed time and its share of device busy.

``--trace DIR`` also writes each phase's Chrome trace into DIR.
"""
import argparse
import collections
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def device_intervals(prof):
    """(name, start_us, end_us) of every device-side event."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def union_us(intervals):
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


#: name fragments of the port's own kernels (csrc/)
PORT_KERNELS = ("layer_step_kernel", "layer_step_dev_kernel",
                "doubling_kernel", "layer_scan_kernel", "lanes_team_kernel",
                "lanes_wide_kernel", "voigt_kernel", "voigt_reduce_kernel")


def report(phase, wall_s, prof, card, top):
    iv = device_intervals(prof)
    if not iv:
        sys.exit(f"{phase}: the profiler recorded no device time")
    busy_ms = union_us(iv) / 1e3
    wall_ms = 1e3 * wall_s
    print(f"{phase}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1.0 - busy_ms / wall_ms:.3f}, {len(iv)} device "
          f"events [card: {card}]")
    per = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in iv:
        per[name][0] += 1
        per[name][1] += (e - s) / 1e3
    own = [(n, ms) for name, (n, ms) in per.items()
           if any(k in name for k in PORT_KERNELS)]
    own_n, own_ms = sum(n for n, _ in own), sum(ms for _, ms in own)
    print(f"  port kernels {own_ms:.3f} ms ({100 * own_ms / busy_ms:.2f} % "
          f"of busy) in {own_n} launches; other device events "
          f"{busy_ms - own_ms:.3f} ms in {len(iv) - own_n} [card: {card}]")
    for name, (n, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f} % {n:6d}x  "
              f"{name[:90]}")


def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"


def jacobian_phases(model, params, dev, engine):
    """The radiance and its jacfwd Jacobian at the flagship's state, each
    run once to warm up."""
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.retrieval_demo import state_radiance
    engine = "kernel" if engine == "auto" else engine
    f, _ = state_radiance(model.pol, model.quad_points,
                          build_band_inputs(model, 0), params.vza,
                          params.vaz, params.max_m, torch.float32, dev,
                          engine, "schulz")
    x = torch.tensor([0.0, params.surfaces[0]["albedo"], 0.0], device=dev)
    phases = {f"radiance ({engine})": lambda: f(x),
              f"jacfwd ({engine})": lambda: torch.func.jacfwd(f)(x)}
    for fn in phases.values():
        fn()
    torch.cuda.synchronize()
    return phases


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="auto",
                    help="rt_run engine (default auto)")
    ap.add_argument("--jacobian", action="store_true",
                    help="profile a radiance and its Jacobian instead")
    ap.add_argument("--trace", help="directory for the Chrome traces")
    ap.add_argument("--top", type=int, default=12,
                    help="device kernels listed per phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import vsmartmom_torch as vt

    card = card_name()
    dev = torch.device("cuda:0")
    params = vt.default_parameters()
    params.float_type = "Float32"
    model = vt.model_from_parameters(params, device=dev)     # warm-up
    vt.rt_run(model, device=dev, engine=args.engine)
    torch.cuda.synchronize()

    phases = {"model build": lambda: vt.model_from_parameters(params,
                                                              device=dev),
              f"rt_run ({args.engine})":
                  lambda: vt.rt_run(model, device=dev, engine=args.engine)}
    if args.jacobian:
        phases = jacobian_phases(model, params, dev, args.engine)
    for phase, fn in phases.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(phase, wall, prof, card, args.top)
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.trace, phase.split(" (")[0].replace(" ", "_")
                + f"_{args.engine}.json"))


if __name__ == "__main__":
    main()
