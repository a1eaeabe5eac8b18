"""Spectral scaling harness of the port: Fourier-step throughput at 1, 2,
4, ... devices (counterpart of ``tools/scaling_bench.py``).

Weak scaling: each device holds ``spec_per_dev`` points, so the total
spectral load grows with the device count, as a hyperspectral run uses
more cards for more wavelengths. Each device count times one moment-0 and
two further rt_run._fourier_step calls (3 reps after a warm-up) on the
synthetic atmosphere of example_inputs (Stokes IQUV, 8 quadrature half-
points: N = 44, 10 layers, float32), with each layer's doubling schedule
taken over the whole band. It reports ``rows`` (n_devices,
pts_per_s, pts_per_s_per_dev, scaling_efficiency) and
``partition_overhead``: the same total load unsharded against k shards.

One process drives its devices' shards one after the other (CUDA launches
are asynchronous, so separate cards overlap); under a process group
(parallel/distributed.init_multihost, e.g. ``torchrun``) each rank drives
its own device and a row takes the slowest participating rank.
Several shards on one card (``--device cuda:0 --n-devices 4``, or the
overhead record's 4 shards on a one-card machine) measure the mechanics
of the split, not scaling.

    python3 -m vsmartmom_torch.scaling_bench             # the visible cards
    python3 -m vsmartmom_torch.scaling_bench --device cpu --n-devices 8

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

#: spectral points per device (weak scaling)
SCALING_SPEC_PER_DEV = 4096
#: shards of the overhead record when only one device is given
OVERHEAD_SHARDS = 4


def example_inputs(n_spec, n_quad_half=8, n_stokes=4, n_z=10,
                   dtype=np.float32):
    """Synthetic Rayleigh + absorber atmosphere (scattering tau 0.05 per
    layer, absorption uniform on [0, 0.5) from seed 0, albedo 0.15) on a
    Gauss full-sphere quadrature of ``2 n_quad_half - 1``: the inputs of
    the JAX package's __graft_entry__._example_inputs, built by the port.
    Returns (args, geom_at): host arrays of ``dtype`` (tau, omega, zw,
    albedo), and ``geom_at(device)``, the run's rt_run.Geometry on
    ``device`` with moment 0's Z pair (z_pp_c, z_mp_c) there, which every
    moment of the harness takes."""
    from vsmartmom_torch.core.rt_run import geometry
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    pol = Polarization.from_name(
        {1: "Stokes_I", 3: "Stokes_IQU", 4: "Stokes_IQUV"}[n_stokes])
    quad = rt_set_streams("GaussQuadFullSphere", 2 * n_quad_half - 1, 45.0,
                          [0.0, 30.0], pol.n)
    rng = np.random.default_rng(0)
    tau_scat = np.full((n_z, n_spec), 0.05)
    tau = tau_scat + rng.uniform(0.0, 0.5, size=(n_z, n_spec))
    args = dict(
        tau=tau.astype(dtype), omega=(tau_scat / tau).astype(dtype),
        zw=np.ones((n_z, 1, n_spec), dtype), albedo=dtype(0.15))
    tdtype = torch.float32 if dtype == np.float32 else torch.float64

    def geom_at(device):
        geom = geometry(pol, quad, tdtype, device)
        return geom, geom.z_moments([get_greek_rayleigh(0.0)], 0)
    return args, geom_at


class _Shards:
    """One band's Fourier step split over ``devices`` (one shard each),
    every layer on the whole band's static schulz schedules."""

    def __init__(self, n_spec, devices, dtype=np.float32):
        from vsmartmom_torch.core.rt_run import (_per_layer_schedules,
                                                 build_layer_schedules,
                                                 select_engine)
        from vsmartmom_torch.parallel.sharding import (
            global_tau_scat_max, replicate, shard_spectral)
        args, geom_at = example_inputs(n_spec, dtype=dtype)
        # one geometry and Z pair per shard, on its device
        self.geoms = [geom_at(d) for d in devices]
        g0 = self.geoms[0][0]
        self.tdtype = g0.dtype
        tsm = global_tau_scat_max(args["tau"], args["omega"])
        # the schedules of the run's own (rounded) smallest stream mu
        min_mu = float(g0.min_qp_mu)
        nd, sched, ls = build_layer_schedules(args["tau"], args["omega"],
                                              min_mu, "schulz", tsm)
        n_z = args["tau"].shape[0]
        self.schedules = _per_layer_schedules(n_z, "schulz", nd, sched, ls)
        self.engines = [select_engine("auto", d, self.tdtype,
                                      g0.qp.shape[0], self.schedules)
                        for d in devices]

        def put(x, axis=None):
            x = torch.as_tensor(np.asarray(x), dtype=self.tdtype)
            return (replicate(x, devices) if axis is None
                    else shard_spectral(x, devices, axis))

        self.tau, self.omega = put(args["tau"], 1), put(args["omega"], 1)
        self.zw = put(args["zw"], 2)
        self.albedo = put(args["albedo"])

    def run(self, m):
        """Fourier step m on every shard (launched in turn); returns each
        shard's j_m, not synchronised."""
        from vsmartmom_torch.core.rt_run import _fourier_step
        out = []
        for i, eng in enumerate(self.engines):
            geom, z = self.geoms[i]
            comp, _ = _fourier_step(
                self.tau[i], self.omega[i], self.zw[i], *z, geom,
                self.albedo[i], None, m=m, solver="schulz",
                layer_schedules=self.schedules, engine=eng)
            out.append(comp.j_m)
        return out


def _sync(outs):
    """Host value of every output (waits for each device)."""
    return sum(float(x.sum()) for x in outs)


def time_steps(shards: _Shards, reps: int = 3, full: bool = True) -> float:
    """Seconds of one (moment-0, two further moments) sequence of Fourier
    steps over every shard (``full``), or of one moment-0 step, averaged
    over ``reps`` after a warm-up."""
    from vsmartmom_torch.core.precision import matmul_precision
    moments = (0, 1, 2) if full else (0,)
    with matmul_precision("highest"):
        _sync([x for m in moments for x in shards.run(m)])
        t0 = time.perf_counter()
        outs = []
        for _ in range(reps):
            outs = [x for m in moments for x in shards.run(m)]
        _sync(outs)
        return (time.perf_counter() - t0) / reps


def _slowest(dt: float) -> float:
    """The largest of every rank's ``dt`` under a process group."""
    from vsmartmom_torch.parallel import distributed as dist
    if dist.world_size() == 1:
        return dt
    t = torch.tensor([dt], dtype=torch.float64)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def main(devices=None, spec_per_dev: int = SCALING_SPEC_PER_DEV,
         reps: int = 3):
    """Run the harness on ``devices`` (default: every visible CUDA device;
    under a process group, this rank's device, by default
    ``cuda:LOCAL_RANK``) and return (and print, on rank 0) its record."""
    from vsmartmom_torch.parallel import distributed as dist
    from vsmartmom_torch.parallel.sharding import spectral_devices
    from vsmartmom_torch.util.device import resolve_device

    multi = dist.init_multihost()
    if multi:
        mine = (dist.global_spectral_devices()[dist.rank()]
                if devices is None else resolve_device(devices[0]))
        n_all = dist.world_size()
    else:
        devices = (spectral_devices() if devices is None
                   else [resolve_device(d) for d in devices])
        n_all = len(devices)
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_all]
    rows = []
    for n_dev in sizes:
        if multi:
            # ranks below n_dev each run one shard of spec_per_dev points
            dt = 0.0
            if dist.rank() < n_dev:
                dt = time_steps(_Shards(spec_per_dev, [mine]), reps)
            dt = _slowest(dt)
        else:
            dt = time_steps(_Shards(spec_per_dev * n_dev, devices[:n_dev]),
                            reps)
        pts = spec_per_dev * n_dev / dt
        rows.append(dict(n_devices=n_dev, n_spec=spec_per_dev * n_dev,
                         seconds=dt, pts_per_s=pts,
                         pts_per_s_per_dev=pts / n_dev))
    base = rows[0]["pts_per_s_per_dev"]
    for r in rows:
        r["scaling_efficiency"] = r["pts_per_s_per_dev"] / base
    kind = (mine if multi else devices[0]).type
    out = dict(backend=kind,
               device=(torch.cuda.get_device_name(mine if multi
                                                  else devices[0])
                       if kind == "cuda" else "cpu"),
               process_count=dist.world_size(),
               spec_per_device=spec_per_dev, rows=rows)

    if not multi:
        # the same total load unsharded and split over k shards: the cost
        # of the split itself (on one device: k launches of 1/k the points)
        shard_devs = (devices if len(devices) > 1
                      else devices * OVERHEAD_SHARDS)
        k = len(shard_devs)
        n_spec = spec_per_dev * k
        t_single = time_steps(_Shards(n_spec, devices[:1]), reps, full=False)
        t_sharded = time_steps(_Shards(n_spec, shard_devs), reps,
                               full=False)
        out["partition_overhead"] = dict(
            n_shards=k, devices=sorted({str(d) for d in shard_devs}),
            n_spec=n_spec, t_single_s=t_single, t_sharded_s=t_sharded,
            overhead_frac=t_sharded / t_single - 1.0,
            note="same total load (one moment-0 Fourier step) unsharded "
                 "vs k shards; on one device it measures the split's "
                 "mechanics, not scaling")
    if dist.rank() == 0:
        print(json.dumps(out))
    return out


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device type of every shard (default: the visible "
                         "CUDA devices)")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="shards on --device (default 1 with --device)")
    ap.add_argument("--spec-per-dev", type=int,
                    default=SCALING_SPEC_PER_DEV)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    main([a.device] * (a.n_devices or 1) if a.device else None,
         a.spec_per_dev, a.reps)


if __name__ == "__main__":
    _cli()
