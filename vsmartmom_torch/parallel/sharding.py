"""Spectral-axis sharding across devices (port of
``vsmartmom/parallel/sharding.py``).

The hyperspectral axis (nSpec) is the batch axis of every RT operation, so
an elastic run splits into contiguous spectral shards with no exchange on
the hot path. The JAX package gets the split from XLA SPMD: its inputs
carry a ``NamedSharding`` and the partitioner also computes every global
reduction and lowers the Raman gathers to collectives. Torch has no SPMD,
so this module splits the axis itself, and hands each shard what the
single-device run would compute over the whole band:

* each layer's maximum of tau * omega (``tau_scat_max``: the doubling
  counts and static schedules of rt_run_band and rt_run_band_rrs), taken
  once over the whole band;
* a Legendre or spectral surface albedo, evaluated over the whole band and
  sliced;
* for Raman, the halo: the coupling rows are built once on the global grid
  (rt_raman.build_coupling), and a shard that owns ``[lo, hi)`` runs on
  the sorted union of its points and every valid source of their rows.
  Every gather of the Raman algebra reads elastic fields (or inputs) at
  the source rows, never a first-order (ie) field, so the shard recomputes
  the elastic fields at its sources and needs no exchange inside the layer
  loop. The halo points' own rows are kept as the global grid gives them,
  and a row whose source falls outside the set is marked invalid; their ie
  results are dropped. The Raman axis is never padded: padded points would
  become valid sources at the edge of the grid.

The shards of one call run one after the other in this process, each on
its entry of ``devices`` (several entries may name one card). To drive
several cards at once, run one process per card (parallel/distributed.py).
"""
from __future__ import annotations

import contextlib
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from vsmartmom_torch.core.brdf import legendre_spectral_albedo
from vsmartmom_torch.core.rt_raman import build_coupling, rt_run_band_rrs
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.util.device import resolve_device

logger = logging.getLogger("vsmartmom_torch")

SPECTRAL_AXIS = "spec"


def spectral_devices(n_devices: Optional[int] = None) -> list:
    """The visible CUDA devices (the first ``n_devices`` of them) as a list
    of torch.device: the counterpart of the JAX package's spectral_mesh.
    Raises ValueError when fewer than ``n_devices`` (or none) are visible;
    pass an explicit list such as ``["cpu"] * 8`` to the drivers instead."""
    n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_vis == 0 or (n_devices is not None and n_vis < n_devices):
        raise ValueError(
            f"requested a {n_devices or 'default'}-device spectral split but "
            f"only {n_vis} CUDA devices are visible (pass devices=['cpu'] * "
            f"k to split on the CPU)")
    return [torch.device("cuda", i) for i in range(n_devices or n_vis)]


def pad_to_multiple(x: np.ndarray, m: int, axis: int = 0):
    """Pad axis length up to a multiple of m (edge-replicate padding keeps
    padded wavelengths numerically benign). Returns (padded, orig_len)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), n


def shard_bounds(n_spec: int, n_shards: int) -> list:
    """[lo, hi) of ``n_shards`` contiguous shards of ``n_spec`` points whose
    sizes differ by at most one (the larger ones first)."""
    if n_shards < 1 or n_spec < n_shards:
        raise ValueError(f"cannot split {n_spec} points into {n_shards} "
                         f"non-empty shards")
    sizes = [n_spec // n_shards + (i < n_spec % n_shards)
             for i in range(n_shards)]
    ends = np.cumsum([0] + sizes)
    return [(int(ends[i]), int(ends[i + 1])) for i in range(n_shards)]


def shard_spectral(x, devices, axis: int = 0) -> list:
    """``x`` split along ``axis`` into contiguous shards (shard_bounds), the
    i-th as a tensor on ``devices[i]``."""
    x = torch.as_tensor(x)
    return [x.narrow(axis, lo, hi - lo).to(resolve_device(d))
            for d, (lo, hi) in zip(devices,
                                   shard_bounds(x.shape[axis],
                                                len(devices)))]


def replicate(x, devices) -> list:
    """One copy of ``x`` on each of ``devices``."""
    x = torch.as_tensor(x)
    return [x.to(resolve_device(d)) for d in devices]


def _devices(devices) -> list:
    """``devices`` resolved (a CUDA entry without CUDA raises), or every
    visible CUDA device."""
    if devices is None:
        return spectral_devices()
    return [resolve_device(d) for d in devices]


def global_tau_scat_max(tau, omega) -> np.ndarray:
    """(nZ,) maximum of tau * omega of each layer over the whole band: what
    the single-device run reduces over the spectral axis (host float64, as
    build_layer_schedules takes it)."""
    return np.max(np.asarray(tau) * np.asarray(omega), axis=1)


def whole_band_surface(surface, n_spec: int):
    """``surface`` with a Legendre albedo evaluated over the whole band as a
    LambertianSurfaceSpectrum (whose albedo a shard slices); any other
    surface unchanged."""
    if surface["type"] == "LambertianSurfaceLegendre":
        return {"type": "LambertianSurfaceSpectrum",
                "albedo": legendre_spectral_albedo(surface["legendre_coeff"],
                                                   n_spec)}
    return surface


def surface_at(surface, idx):
    """A whole-band surface (whole_band_surface) at the points ``idx``."""
    if surface["type"] == "LambertianSurfaceSpectrum":
        return {"type": "LambertianSurfaceSpectrum",
                "albedo": np.asarray(surface["albedo"], np.float64)[idx]}
    return surface


def band_at(band: BandRTInputs, idx) -> BandRTInputs:
    """The band's inputs at the spectral points ``idx`` (a slice or an
    index array)."""
    return BandRTInputs(tau=np.asarray(band.tau)[:, idx],
                        omega=np.asarray(band.omega)[:, idx],
                        zw=np.asarray(band.zw)[:, :, idx],
                        greeks=band.greeks)


@contextlib.contextmanager
def _shard_banners_quiet():
    """The per-shard run banners (INFO) held back inside the block: a
    sharded call logs one line of its own."""
    prev = logger.level
    logger.setLevel(max(prev, logging.WARNING))
    try:
        yield
    finally:
        logger.setLevel(prev)


def _concat(outs):
    """Per-shard results joined along the spectral (last) axis."""
    return tuple(np.concatenate(parts, axis=-1) for parts in zip(*outs))


def rt_run_band_sharded(pol, quad, band: BandRTInputs, vza, vaz,
                        max_m: int, surface, devices=None, **kw):
    """rt_run_band with the spectral axis split into contiguous shards, one
    per entry of ``devices`` (default: every visible CUDA device), with
    sizes that differ by at most one.

    Each layer's maximum of tau * omega is taken once over the whole band
    (``tau_scat_max``) and a Legendre or spectral albedo is evaluated over
    the whole band and sliced, so every shard runs the single-device run's
    doubling counts and schedules. ``kw`` goes to rt_run_band (dtype,
    engine, solver, return_hdr, matmul_precision, dd_precision, ...; not
    ``device`` or ``return_composite``), so each shard runs at the same
    precision modes as the single-device run. Returns what rt_run_band
    returns, joined along the spectral axis.
    """
    if kw.get("return_composite"):
        raise ValueError("rt_run_band_sharded joins no composites")
    devices = _devices(devices)
    n_spec = band.tau.shape[1]
    tau_scat_max = global_tau_scat_max(band.tau, band.omega)
    surface = whole_band_surface(surface, n_spec)
    bounds = shard_bounds(n_spec, len(devices))
    logger.info("rt_run_band_sharded: nSpec=%d in %d shards of %s points "
                "on %s", n_spec, len(bounds),
                sorted({hi - lo for lo, hi in bounds}),
                ", ".join(sorted({str(d) for d in devices})))
    outs = []
    with _shard_banners_quiet():
        for dev, (lo, hi) in zip(devices, bounds):
            sl = slice(lo, hi)
            outs.append(rt_run_band(pol, quad, band_at(band, sl), vza, vaz,
                                    max_m, surface_at(surface, sl),
                                    device=dev, tau_scat_max=tau_scat_max,
                                    **kw))
    return _concat(outs)


class RamanHalo(NamedTuple):
    """One shard's Raman index set and its coupling rows.

    idx:      sorted global indices the shard runs on (its points and the
              valid sources of their rows)
    keep:     positions of the owned points ``[lo, hi)`` in ``idx``
    coupling: (srcs, valids, ws, gids) rows at ``idx``, sources remapped
              into it
    """
    idx: np.ndarray
    keep: np.ndarray
    coupling: tuple


def raman_halo(coupling, lo: int, hi: int) -> RamanHalo:
    """The halo of the shard that owns ``[lo, hi)`` under the global
    ``coupling`` rows of build_coupling: the sorted union of its points and
    every valid source of their rows (contiguous for a dense band of
    shifts, as rotational Raman's; not for sparse shifts, nor for
    AbsoluteRaman's one source column). Rows of the set keep the global
    grid's validity, less any source outside the set; the weights of an
    invalid entry are zero."""
    srcs, valids, ws, gids = coupling
    own = np.arange(lo, hi)
    idx = np.union1d(own, srcs[:, lo:hi][valids[:, lo:hi]])
    pos = np.full(srcs.shape[1], -1, np.int64)
    pos[idx] = np.arange(len(idx))
    src_l = pos[srcs[:, idx]]
    valid_l = valids[:, idx] & (src_l >= 0)
    ws_l = np.where(valid_l, ws[..., idx], 0.0)
    return RamanHalo(idx, pos[own],
                     (np.maximum(src_l, 0).astype(np.int32), valid_l, ws_l,
                      gids))


def raman_halo_stats(halos, bounds) -> list:
    """Per shard: owned points, index-set size, halo points (left and right
    of the owned range) and the redundant share of the set."""
    out = []
    for h, (lo, hi) in zip(halos, bounds):
        n_halo = len(h.idx) - (hi - lo)
        out.append({"lo": lo, "hi": hi, "points": len(h.idx),
                    "halo": n_halo, "halo_left": int(np.sum(h.idx < lo)),
                    "halo_right": int(np.sum(h.idx >= hi)),
                    "redundant_share": n_halo / len(h.idx)})
    return out


def rt_run_band_rrs_sharded(pol, quad, band: BandRTInputs, rrs, f_rayl, vza,
                            vaz, max_m: int, surface, devices=None, **kw):
    """rt_run_band_rrs with the spectral axis split into contiguous owned
    shards (shard_bounds), one per entry of ``devices`` (default: every
    visible CUDA device), each run on its Raman halo (raman_halo): the
    coupling is built once on the global grid, each shard's inputs
    (tau, omega, zw, f_rayl and per-layer weights) are gathered at its index
    set, and only its owned points are kept. ``tau_scat_max`` is taken
    once over the whole band. Logs one line (INFO) with each shard's halo
    points and their share of its index set.
    ``kw`` goes to rt_run_band_rrs (dtype, solver, static_schedules,
    ie_precision; not ``device``). Returns (R, T, ieR, ieT) joined along
    the spectral axis.
    """
    devices = _devices(devices)
    specs = list(rrs) if isinstance(rrs, (list, tuple)) else [rrs]
    n_spec = band.tau.shape[1]
    coupling = build_coupling(specs, n_spec)
    tau_scat_max = global_tau_scat_max(band.tau, band.omega)
    f_rayl = np.asarray(f_rayl)
    bounds = shard_bounds(n_spec, len(devices))
    halos = [raman_halo(coupling, lo, hi) for lo, hi in bounds]
    stats = raman_halo_stats(halos, bounds)
    logger.info("rt_run_band_rrs_sharded: nSpec=%d, nR=%d in %d shards on "
                "%s; halo points %s, redundant share %s", n_spec,
                coupling[0].shape[0], len(bounds),
                ", ".join(sorted({str(d) for d in devices})),
                [st["halo"] for st in stats],
                [round(st["redundant_share"], 3) for st in stats])
    outs = []
    with _shard_banners_quiet():
        for dev, h in zip(devices, halos):
            out = rt_run_band_rrs(pol, quad, band_at(band, h.idx), specs,
                                  f_rayl[:, h.idx], vza, vaz, max_m, surface,
                                  device=dev, tau_scat_max=tau_scat_max,
                                  coupling=h.coupling, **kw)
            outs.append([o[..., h.keep] for o in out])
    return _concat(outs)
