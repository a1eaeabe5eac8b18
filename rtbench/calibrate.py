"""Readings of the comparison over many seeds, in one process, for setting
a cell's limits (``rtbench/limits/<cell>.json``).

    python3 -m rtbench.calibrate --workload o2a-fwd --calls 3 \
        --seeds 11 12 13 --sides program control [--out FILE]

For each side it builds the cell's model once, then for each seed runs
``--calls`` calls of the seed's traffic through the timed path and compares
them with the plain reference as a run does. "program" is the program as
the configuration states it (the lower readings); "control" puts the plain
reference with its products rounded to bfloat16 in the program's place
(the upper readings). One JSON line per side and seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from rtbench import run


def worst(mix, outputs) -> dict:
    """Where each output's widest gap lies: the call, the index (view,
    Stokes, spectral point), the program's and the reference's values and
    the reference's intensity there."""
    import numpy as np
    out = {}
    for i, ref in mix.references.items():
        for key in ("R", "T", "K"):
            if key not in ref:
                continue
            gap = np.abs(outputs[i][key] - ref[key])
            k = np.unravel_index(np.argmax(gap), gap.shape)
            if key in out and out[key]["gap"] >= float(gap[k]):
                continue
            out[key] = {"call": i, "index": [int(x) for x in k],
                        "point": int(mix.sample[k[2]]),
                        "gap": float(gap[k]),
                        "program": float(outputs[i][key][k]),
                        "reference": float(ref[key][k]),
                        "reference_I": float(ref["R"][k[0], 0, k[2]])}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control"],
                    choices=["program", "control"])
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    run.run_environment()
    import torch
    from rtbench import calls

    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    cell, config = run.find_cell(bench, args.workload)
    spec = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
    path = os.path.join(run.ROOT, config["file"])
    for side in args.sides:
        mix = calls.Mix(spec, path, args.seeds[0], torch.device("cuda"),
                        side == "control")
        mix.setup()
        for seed in args.seeds:
            mix.reseed(seed)
            outputs = {i: mix.call(i) for i in range(args.calls)}
            line = json.dumps({"workload": args.workload,
                               "side": side, "seed": seed,
                               "calls": args.calls,
                               "readings": mix.check(outputs),
                               "worst": worst(mix, outputs)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        mix.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
