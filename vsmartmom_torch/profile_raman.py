"""Where the time of the Raman run goes, on one CUDA device.

Run from the repository root:

    python3 -m vsmartmom_torch.profile_raman [--top N] [--trace DIR]

Builds tests/data/ref_yaml/O2Parameters.yaml as written (6 837 points,
N = 15, 5 layers, 3 moments, 172 Raman shift rows), runs
``rt_run(model, rs_type="RRS")`` once in float64 to warm up, then profiles
one steady run in float64 and one in float32 with ``torch.profiler`` and
prints, for each, the report of ``profile_flagship``: wall, device busy
(the union of device intervals), idle share (an upper bound: the profiler
slows the host) and the device kernels by summed time.
"""
import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from vsmartmom_torch._paths import REPO_ROOT
from vsmartmom_torch.profile_flagship import card_name, report

YAML = os.path.join(REPO_ROOT, "tests", "data", "ref_yaml",
                    "O2Parameters.yaml")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="directory for the Chrome traces")
    ap.add_argument("--top", type=int, default=15,
                    help="device kernels listed per run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import vsmartmom_torch as vt

    card = card_name()
    dev = torch.device("cuda:0")
    model = vt.model_from_parameters(vt.parameters_from_yaml(YAML),
                                     device=dev)
    vt.rt_run(model, rs_type="RRS", device=dev)               # warm-up
    torch.cuda.synchronize()
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vt.rt_run(model, rs_type="RRS", dtype=dtype, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"rt_run RRS O2Parameters.yaml ({name})", wall, prof, card,
               args.top)
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace,
                                                  f"raman_{name}.json"))


if __name__ == "__main__":
    main()
