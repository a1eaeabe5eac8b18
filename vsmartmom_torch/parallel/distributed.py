"""Multi-process spectral split: torch.distributed set-up, one device per
process (port of ``vsmartmom/parallel/distributed.py``).

The reference is a single-GPU library; scaling beyond one card is a
capability of this framework. The elastic spectral axis needs no exchange
on the hot path, so each process runs its contiguous slice of the band and
the results are all-gathered once at the end. The layer uses the ``gloo``
backend and gathers host arrays: the outputs of rt_run_band are host numpy
already, and NCCL refuses two ranks on one GPU, which is the layout of a
one-card machine.

Usage (one process per card, e.g. under ``torchrun --nproc-per-node K``,
which sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK):

    from vsmartmom_torch.parallel import distributed as dist
    dist.init_multihost()                  # env-driven; or pass the address
    R, T = dist.rt_run_band_distributed(pol, quad, band, vza, vaz, max_m,
                                        surface)  # whole band on every rank

A single process needs no init: every function here then acts on a world
of one.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.parallel.sharding import (band_at, global_tau_scat_max,
                                               pad_to_multiple, surface_at,
                                               whole_band_surface)
from vsmartmom_torch.util.device import resolve_device

#: how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def _active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if _active() else 1


def rank() -> int:
    return tdist.get_rank() if _active() else 0


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Join a ``gloo`` process group for a multi-process run. Idempotent.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to torch's variables MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE and RANK. The call joins only when addressed by arguments
    or environment, or when VSMARTMOM_MULTIHOST=1 (then torch's own
    ``env://`` rendezvous reads the variables); a plain run stays one
    process. Returns True when more than one process runs.
    """
    if _active():
        return tdist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    want = (coordinator_address is not None or num_processes is not None
            or os.environ.get("VSMARTMOM_MULTIHOST") == "1")
    if not want:
        return False
    if coordinator_address is None:
        tdist.init_process_group("gloo", init_method="env://",
                                 timeout=TIMEOUT)
    else:
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return tdist.get_world_size() > 1


def global_spectral_devices(device=None) -> list:
    """One device per process, in rank order: ``cuda:LOCAL_RANK`` of each
    process (LOCAL_RANK 0 when unset), or ``device`` for every rank when the
    caller names one (e.g. "cpu"). A CUDA device without CUDA raises."""
    if device is not None:
        return [resolve_device(device)] * world_size()
    mine = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if world_size() == 1:
        return [mine]
    names = [None] * world_size()
    tdist.all_gather_object(names, str(mine))
    return [torch.device(n) for n in names]


def process_spectral_slice(n_spec: int, world=None) -> Tuple[int, int]:
    """[lo, hi) of the spectral axis this process owns: ``world`` is the
    number of processes (or a device list, one per process; default: the
    process group's size). n_spec must divide evenly (pad_to_multiple
    first)."""
    n_proc = (world_size() if world is None
              else world if isinstance(world, int) else len(world))
    if n_spec % n_proc:
        raise ValueError(f"n_spec={n_spec} not divisible by the "
                         f"{n_proc}-process split; pad_to_multiple first")
    per = n_spec // n_proc
    return rank() * per, (rank() + 1) * per


def global_spectral_array(local, axis: int = 0) -> np.ndarray:
    """The whole array on every rank, all-gathered from each process's
    slice along ``axis`` (process_spectral_slice: equal slices, rank
    order). One process: ``local`` itself."""
    local = np.asarray(local)
    if world_size() == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(t) for _ in range(world_size())]
    tdist.all_gather(parts, t)
    return np.concatenate([p.numpy() for p in parts], axis=axis)


def rt_run_band_distributed(pol, quad, band, vza, vaz, max_m: int, surface,
                            device=None, **kw):
    """rt_run_band over the process group: the band is edge-padded to a
    multiple of the world size, each process runs its slice on its device
    (global_spectral_devices(device)) with the whole band's per-layer
    maxima of tau * omega and surface albedo, and R, T (and the HDR
    outputs when asked) are all-gathered and trimmed. Every rank returns
    the whole result. ``kw`` goes to rt_run_band (not return_composite)."""
    if kw.get("return_composite"):
        raise ValueError("rt_run_band_distributed gathers no composites")
    n_world = world_size()
    n_spec = band.tau.shape[1]
    tau_scat_max = global_tau_scat_max(band.tau, band.omega)
    surface = whole_band_surface(surface, n_spec)
    padded = BandRTInputs(
        tau=pad_to_multiple(np.asarray(band.tau), n_world, axis=1)[0],
        omega=pad_to_multiple(np.asarray(band.omega), n_world, axis=1)[0],
        zw=pad_to_multiple(np.asarray(band.zw), n_world, axis=2)[0],
        greeks=band.greeks)
    if surface["type"] == "LambertianSurfaceSpectrum":
        surface = dict(surface, albedo=pad_to_multiple(
            np.asarray(surface["albedo"], np.float64), n_world)[0])
    lo, hi = process_spectral_slice(padded.tau.shape[1], n_world)
    sl = slice(lo, hi)
    out = rt_run_band(pol, quad, band_at(padded, sl), vza, vaz, max_m,
                      surface_at(surface, sl),
                      device=global_spectral_devices(device)[rank()],
                      tau_scat_max=tau_scat_max, **kw)
    return tuple(global_spectral_array(o, axis=-1)[..., :n_spec]
                 for o in out)
