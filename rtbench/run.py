"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python -m rtbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration's parameter file, its traffic mix in ``rtbench/traffic/``
and the kind of call the mix names in ``rtbench/kinds/``, the limits of its
comparison in ``rtbench/limits/`` and each metric's reader in
``rtbench/metrics/``.

A run: set-up (the program's import and kernel build, the model build from
the configuration, one warm-up call), then calls back to back for at least
``--seconds``; the window runs from the first call's start to the last
call's end. With ``--trace 1`` the profiler records the first
``trace_calls`` calls of the window, and the per-layer metrics are read
from it. Once the window has closed and the program's state is freed, the
plain reference checks a sample of the calls drawn from the seed. The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "rtbench")
#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "vsmartmom")


def process_start() -> float:
    """The process's start on the clock of ``time.time``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


#: threads of the host's numeric libraries: one process, few threads
HOST_THREADS = "1"


def run_environment():
    """Keep every build and kernel cache at a fixed path in the checkout,
    keep libraries from loading JAX, and give the host's numeric libraries
    few threads (a steady load from one process)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, config


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics."""
    def applies(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if applies(m) and m["moves"] in names]


def load_reader(name: str):
    """The ``read(ctx)`` of ``rtbench/metrics/<name>.py``; a name with a
    suffix (``<base>.<part>``, one quantity split by the end-to-end metric
    it moves) that has no file of its own reads ``<base>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(HERE, "metrics", name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    """The card's name, power limit, SM clock, temperature and power draw
    as nvidia-smi gives them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                              "clocks.sm,temperature.gpu,power.draw",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return (smi.stdout.strip().splitlines() or ["?"])[0] \
        if smi.returncode == 0 else "nvidia-smi unavailable"


class Context:
    """What the metric readers read: the window, the set-up's spans, the
    trace of the first calls and their work, the device."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def launch_counts() -> dict:
    """The ``launches`` counters of the port's kernel modules loaded."""
    return {name.rsplit(".", 1)[1]: mod.launches
            for name, mod in list(sys.modules.items())
            if name.startswith("vsmartmom_torch.cuda.")
            and hasattr(mod, "launches")}


def reset_launches():
    for name, mod in list(sys.modules.items()):
        if name.startswith("vsmartmom_torch.cuda.") \
                and hasattr(mod, "launches"):
            mod.launches = 0


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", config_path=None, control=False, log=print):
    """One run of cell ``workload``; returns the result's dict. ``device``
    and ``config_path`` let a test drive the same run on the CPU at a small
    size; ``control`` puts the reference in bfloat16 in the program's
    place."""
    import torch
    from rtbench import calls, trace as tr

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, config = find_cell(bench, workload)
    spec = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", cell["name"] + ".json")
    config_path = config_path or os.path.join(ROOT, config["file"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mix = calls.Mix(spec, config_path, seed, dev, control)
    logging.getLogger("vsmartmom_torch").setLevel(logging.WARNING)
    mix.setup()
    reset_launches()

    # --- the window -------------------------------------------------------
    n_trace = spec["trace_calls"] if trace else 0
    outputs, ends = {}, []
    prof = None
    setup_s = time.time() - T_START
    t0 = time.perf_counter()
    i = 0
    while True:
        if i == 0 and n_trace:
            prof = tr.start()
            tp0 = time.perf_counter()
        outputs[i] = mix.call(i)
        i += 1
        ends.append(time.perf_counter())
        if i == n_trace:
            trace_wall = ends[-1] - tp0
            prof.stop()
        if ends[-1] - t0 >= seconds and i >= max(n_trace, 1):
            break
    window_s = ends[-1] - t0
    n_calls = i
    launches = {k: v / n_calls for k, v in launch_counts().items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    failed = sum(not all(_finite(v) for v in out.values())
                 for out in outputs.values())

    work = [mix.work(k) for k in range(n_trace)]
    spans = dict(mix.spans)
    log(f"card: {card_line() if dev.type == 'cuda' else 'cpu'}")
    log("call seconds " + " ".join(
        f"{b - a:.4f}" for a, b in zip([t0] + ends[:-1], ends)))
    log(f"set-up {setup_s:.3f} s, of which "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items()))
    log(f"calls {n_calls} in {window_s:.3f} s; launches per call "
        f"{json.dumps(launches)}; peak device memory {peak} bytes")

    ctx = Context(workload=cell["name"], seconds=window_s, calls=n_calls,
                  points=mix.n_spec, setup_s=setup_s, spans=spans,
                  trace=(tr.read(prof, trace_wall, n_trace, work)
                         if prof is not None else None))
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # --- the comparison, once the program's state is freed ----------------
    mix.release()
    readings = mix.check(outputs)
    correct = failed == 0 and all(
        readings.get(k, float("inf")) <= lim for k, lim in limits.items())
    compared = {k: {"value": readings.get(k), "limit": lim}
                for k, lim in limits.items()}
    result = {"correct": bool(correct), "attempted": n_calls,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.wall_s
        result["breakdown"] = ctx.trace.breakdown()
    result["compared"] = compared
    return result


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``vsmartmom_torch`` is not ``vsmartmom``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(a) -> bool:
    import numpy as np
    return bool(np.all(np.isfinite(a)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run_environment()
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, _ = find_cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), log=lambda s: print(s,
                                                            file=sys.stderr))
    loaded = forbidden_loaded()
    if loaded:
        print(f"modules of JAX or the JAX package loaded: {loaded}",
              file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
