"""How far the split-form layer step moves at a product mode when its
products sum in another order.

A kernel whose sums follow another order than torch's (the tensor cores',
csrc/rt_device.cuh:mm_tc) cannot equal the plain version bit for bit; this
tool shows how far apart two such orders land, on the CPU, before any
kernel exists. It runs ``fused_layer_step_dev``'s algebra (core.rt
doubling_dev, the D-unflip and interaction_dev) twice at one mode: with
torch's products (the plain version) and with every bf16 pass summed in
float64 and rounded once to float32. The inputs are chip_smoke.py's width
case: S points of a passive random slab (seed 1, 6 doublings, 3
interaction iterations) under a composite built by two plain steps at
"highest". "bf16x3" keeps a low part, so the two orders stay within about
1e-6 of max; "default" has none, and an ulp of difference flips later bf16
roundings by 2^-8.

    python3 -m vsmartmom_torch.order_sensitivity [--widths N ...]
        [--points S] [--modes bf16x3 default]

prints one JSON line per width and mode: each field's max|diff| / max
between the two orders, and the plain version's distance from "highest".
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vsmartmom_torch.core.precision import DD_MODES, check_mode
from vsmartmom_torch.core.rt import (LayerRTDev, doubling_dev,
                                     interaction_dev, ns_doubling_schedule,
                                     vacuum_layer_dev)
from vsmartmom_torch.cuda.layer_step_dev_kernel import \
    fused_layer_step_dev_plain

WIDTHS = (1, 13, 15, 16, 17, 24, 32, 33, 44, 48, 49, 63, 64, 65, 72, 75)


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _once(a, b):
    """a @ b summed in float64, rounded once to float32."""
    return torch.matmul(a.double(), b.double()).float()


def exact_sum_mm(mode: str):
    """core.precision.batch_mm's function at ``mode`` with each pass summed
    in float64 and rounded once (another order than torch's)."""
    check_mode(mode, DD_MODES)

    def mm(a, b):
        if mode == "highest":
            return _once(a, b)
        ah, al = _split(a)
        bh, bl = _split(b)
        if mode == "default":
            return _once(ah, bh)
        return (_once(ah, bl) + _once(al, bh)) + _once(ah, bh)
    return mm


def _step(comp, r_f, g_el, e_el, jp, jm_f, ek, d_vec, sched, ni, mm):
    """fused_layer_step_dev_plain's algebra with the product ``mm``."""
    r_f2, g2, e2, jp2, jm_f2 = doubling_dev(
        r_f, g_el, e_el, jp, jm_f, ek, ns_schedule=sched,
        ndoubl=len(sched), mm=mm)
    r_mp = d_vec[None, :, None] * r_f2
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    added = LayerRTDev(r_mp=r_mp, r_pm=sgn * r_mp, e_pp=e2, e_mm=sgn * e2,
                       g=g2, j_p=jp2, j_m=d_vec[None, :] * jm_f2)
    return interaction_dev(comp, added, ni=ni, mm=mm)


def width_case(n: int, S: int, seed: int = 1, nd: int = 6):
    """The step's float32 CPU arguments at width n and its schedule."""
    rng = np.random.default_rng(seed)
    qp = np.linspace(0.1, 1.0, n) if n > 1 else np.array([0.5])
    sched = tuple(ns_doubling_schedule(0.5, float(qp.min()), nd))
    dtau, mqm = 0.5 / 2 ** nd, float(qp.min())

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    def slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        e = rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm)
        g = np.full((S, n), np.exp(-dtau / mqm))
        return (f32(r), f32(g), f32(e), f32(rng.uniform(0, dtau, (S, n))),
                f32(rng.uniform(0, dtau, (S, n))))

    d = f32(np.resize([1.0, 1.0, -1.0, -1.0], n))
    ek = f32(np.full(S, np.exp(-dtau / 0.7)))
    comp = vacuum_layer_dev(S, n, torch.float32, "cpu")
    for scale in (1.0, 0.6):
        comp = LayerRTDev(*(x.contiguous() for x in fused_layer_step_dev_plain(
            comp, *slab(scale), ek, d, ns_schedule=sched, ni=4,
            precision="highest")))
    return (comp, *slab(0.8), ek, d), sched


def sensitivity(n: int, S: int, mode: str, ni: int = 3) -> dict:
    """Each field's max|diff| / max between torch's order and the
    exact-sum order at ``mode``, and the plain version's worst field's
    distance from "highest"."""
    args, sched = width_case(n, S)
    ref = fused_layer_step_dev_plain(*args, ns_schedule=sched, ni=ni,
                                     precision=mode)
    alt = _step(*args, sched, ni, exact_sum_mm(mode))
    full = fused_layer_step_dev_plain(*args, ns_schedule=sched, ni=ni,
                                      precision="highest")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    return {"n": n, "S": S, "mode": mode,
            "fields": {k: rel(a, b) for k, a, b
                       in zip(LayerRTDev._fields, alt, ref)},
            "from_highest": max(rel(a, b) for a, b in zip(ref, full))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS))
    ap.add_argument("--points", type=int, default=1007)
    ap.add_argument("--modes", nargs="+", default=["bf16x3", "default"])
    args = ap.parse_args(argv)
    for n in args.widths:
        for mode in args.modes:
            print(json.dumps(sensitivity(n, args.points, mode)), flush=True)


if __name__ == "__main__":
    main()
