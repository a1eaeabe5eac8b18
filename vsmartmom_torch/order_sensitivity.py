"""How far the layer steps move at a product mode when their products sum
in another order.

A kernel whose sums follow another order than torch's (the tensor cores',
csrc/rt_device.cuh:mm_tc) cannot equal the plain version bit for bit; this
tool shows how far apart two such orders land, on the CPU, before any
kernel exists. It runs a step's algebra twice at one mode: with torch's
products (the plain version) and with every bf16 pass summed in float64
and rounded once to float32. ``--form dev`` (the default) takes
``fused_layer_step_dev``'s algebra (core.rt doubling_dev, the D-unflip and
interaction_dev); ``--form plain`` takes
``fused_layer_step_plain``'s and ``fused_doubling_plain``'s (rows 1 and
4). The inputs are chip_smoke.py's width cases: S points of a passive
random slab (``--seed``, 6 doublings unless ``--doublings`` says
otherwise, 3 interaction iterations) under a composite built by two plain
steps at "highest"; ``--flagship EVERY`` takes the plain form on the
flagship's own 102 launches at every EVERY-th point instead. The split
form at "bf16x3" keeps a low part, so the two orders stay within about
1e-6 of max; at "default" it has none, and an ulp of difference flips
later bf16 roundings by 2^-8. The plain form at "high" carries T's ~1.0
direct diagonal through every product: an ulp of difference flips the
rounding of its low part (2^-17 of it), which the doubling amplifies, so
the two orders land about as far apart as "high" lies from "highest".

    python3 -m vsmartmom_torch.order_sensitivity [--form dev|plain]
        [--widths N ...] [--points S] [--doublings ND] [--modes M ...]
        [--seed SEED] [--flagship EVERY]

prints one JSON line per width and mode: each field's max|diff| / max
between the two orders (the plain form: the step's fields, then the
doubling's under "doubling"), and the plain version's distance from
"highest" (the plain form: the other order's too).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vsmartmom_torch.core.precision import DD_MODES, check_mode
from vsmartmom_torch.core.rt import (LayerRT, LayerRTDev, doubling_dev,
                                     interaction_dev, ns_doubling_schedule,
                                     vacuum_layer, vacuum_layer_dev)
from vsmartmom_torch.cuda.doubling_kernel import fused_doubling_plain
from vsmartmom_torch.cuda.layer_step_dev_kernel import \
    fused_layer_step_dev_plain
from vsmartmom_torch.cuda.layer_step_kernel import (doubling_body,
                                                    fused_layer_step_plain,
                                                    layer_step_body)

WIDTHS = (1, 13, 15, 16, 17, 24, 32, 33, 44, 48, 49, 63, 64, 65, 72, 75)
#: the plain form's widths: rows 1 and 4 take N <= 63
PLAIN_WIDTHS = tuple(n for n in WIDTHS if n <= 63)
#: each form's modes by default, and the modes it takes
FORM_MODES = {"dev": (("bf16x3", "default"), DD_MODES),
              "plain": (("high",), ("highest", "high", "default"))}


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _once(a, b):
    """a @ b summed in float64, rounded once to float32."""
    return torch.matmul(a.double(), b.double()).float()


def exact_sum_mm(mode: str):
    """core.precision.batch_mm's function at ``mode`` with each pass summed
    in float64 and rounded once (another order than torch's)."""
    check_mode(mode, DD_MODES + ("high",))

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


def _f32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _slab_scales(n: int, nd: int):
    """The schedule of nd doublings at width n, dtau and the least mu."""
    qp = np.linspace(0.1, 1.0, n) if n > 1 else np.array([0.5])
    sched = tuple(ns_doubling_schedule(0.5, float(qp.min()), nd))
    return sched, 0.5 / 2 ** nd, float(qp.min())


def width_case(n: int, S: int, seed: int = 1, nd: int = 6):
    """The split-form step's float32 CPU arguments at width n and its
    schedule."""
    rng = np.random.default_rng(seed)
    sched, dtau, mqm = _slab_scales(n, nd)

    def slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        e = rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm)
        g = np.full((S, n), np.exp(-dtau / mqm))
        return (_f32(r), _f32(g), _f32(e),
                _f32(rng.uniform(0, dtau, (S, n))),
                _f32(rng.uniform(0, dtau, (S, n))))

    d = _f32(np.resize([1.0, 1.0, -1.0, -1.0], n))
    ek = _f32(np.full(S, np.exp(-dtau / 0.7)))
    comp = vacuum_layer_dev(S, n, torch.float32, "cpu")
    for scale in (1.0, 0.6):
        comp = LayerRTDev(*(x.contiguous() for x in fused_layer_step_dev_plain(
            comp, *slab(scale), ek, d, ns_schedule=sched, ni=4,
            precision="highest")))
    return (comp, *slab(0.8), ek, d), sched


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _worst(got, ref):
    """The worst field's max|diff| / max."""
    return max(_rel(a, b) for a, b in zip(got, ref))


def sensitivity(n: int, S: int, mode: str, ni: int = 3, nd: int = 6,
                seed: int = 1) -> dict:
    """Each field's max|diff| / max between torch's order and the
    exact-sum order at ``mode``, and the plain version's worst field's
    distance from "highest"."""
    args, sched = width_case(n, S, seed, nd)
    ref = fused_layer_step_dev_plain(*args, ns_schedule=sched, ni=ni,
                                     precision=mode)
    alt = _step(*args, sched, ni, exact_sum_mm(mode))
    full = fused_layer_step_dev_plain(*args, ns_schedule=sched, ni=ni,
                                      precision="highest")
    return {"n": n, "S": S, "mode": mode,
            "fields": {k: _rel(a, b) for k, a, b
                       in zip(LayerRTDev._fields, alt, ref)},
            "from_highest": max(_rel(a, b) for a, b in zip(ref, full))}


def plain_width_case(n: int, S: int, seed: int = 1, nd: int = 6):
    """The plain-form step's float32 CPU arguments at width n (T with the
    direct diagonal e^(-dtau/mu)) and its schedule, as chip_smoke.py's
    width case builds them."""
    rng = np.random.default_rng(seed)
    sched, dtau, mqm = _slab_scales(n, nd)

    def slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        t = (np.eye(n) * np.exp(-dtau / mqm)
             + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
        return (_f32(r), _f32(t), _f32(rng.uniform(0, dtau, (S, n))),
                _f32(rng.uniform(0, dtau, (S, n))))

    d = _f32(np.resize([1.0, 1.0, -1.0, -1.0], n))
    ek = _f32(np.full(S, np.exp(-dtau / 0.7)))
    comp = vacuum_layer(S, n, torch.float32, "cpu")
    for scale in (1.0, 0.6):
        comp = LayerRT(*(x.contiguous() for x in fused_layer_step_plain(
            comp, *slab(scale), ek, d, ns_schedule=sched, ni=4)))
    return (comp, *slab(0.8), ek, d), sched


def plain_sensitivity(n: int, S: int, mode: str = "high", ni: int = 3,
                      nd: int = 6, seed: int = 1) -> dict:
    """sensitivity() of the plain form (rows 1 and 4): the step's fields,
    and the doubling's (r, t, jp, jm) under "doubling", each between
    torch's order and the exact-sum order at ``mode``; the plain
    versions' worst fields' distances from "highest"."""
    check_mode(mode, FORM_MODES["plain"][1])
    args, sched = plain_width_case(n, S, seed, nd)
    el = args[1:6]
    alt_mm = exact_sum_mm(mode)

    def step(precision):
        return fused_layer_step_plain(*args, ns_schedule=sched, ni=ni,
                                      precision=precision)

    def dbl(precision):
        return fused_doubling_plain(*el, ns_schedule=sched,
                                    precision=precision)

    ref, ref_d = step(mode), dbl(mode)
    full, full_d = step("highest"), dbl("highest")
    alt = layer_step_body(*args, sched, ni, alt_mm)
    alt_d = doubling_body(*el[:4], el[4][:, None], sched, alt_mm)
    return {"n": n, "S": S, "mode": mode, "form": "plain", "nd": nd,
            "seed": seed,
            "fields": {k: _rel(a, b) for k, a, b
                       in zip(LayerRT._fields, alt, ref)},
            "doubling": {k: _rel(a, b) for k, a, b
                         in zip(("r", "t", "jp", "jm"), alt_d, ref_d)},
            "from_highest": _worst(ref, full),
            "doubling_from_highest": _worst(ref_d, full_d),
            "alt_from_highest": _worst(alt, full),
            "doubling_alt_from_highest": _worst(alt_d, full_d)}


def flagship_sensitivity(every: int = 20, mode: str = "high") -> dict:
    """The plain form on the flagship's own launches: default_parameters()
    in Float32 on the CPU, every ``every``-th spectral point, through
    rt_run_band at the schulz solver's schedules (those of the card) with
    engine "kernel" (row 1) and "kernel_doubling" (row 4) at ``mode``. For
    each launch, its worst field between torch's order and the exact-sum
    order, and the plain version's worst field between ``mode`` and
    "highest", on that launch's inputs. Returns, per engine,
    the largest of each, the largest ratio of the first to the second,
    and to the exact-sum order's own distance from "highest"
    ("ratio_to_alt": below 1, the exact-sum order lies nearer the plain
    version at ``mode`` than at "highest")."""
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    params = vt.default_parameters()
    params.float_type = "Float32"
    params.spec_bands = [params.spec_bands[0][::every]]
    model = vt.model_from_parameters(params, device="cpu")
    alt_mm = exact_sum_mm(mode)
    out = {}

    def step_alt(comp, r_f, t, jp, jm_f, ek, d_vec, *, ns_schedule, ni,
                 **_):
        return layer_step_body(comp, r_f, t, jp, jm_f, ek, d_vec,
                               tuple(ns_schedule), ni, alt_mm)

    def dbl_alt(r, t, jp, jm, ek, *, ns_schedule, **_):
        return doubling_body(r, t, jp, jm, ek[:, None], tuple(ns_schedule),
                             alt_mm)

    for engine, mod, name, alt in (
            ("kernel", lsk, "fused_layer_step", step_alt),
            ("kernel_doubling", dk, "fused_doubling", dbl_alt)):
        real, recs = getattr(mod, name), []

        def hook(*args, precision, real=real, alt=alt, recs=recs, **kw):
            ref = real(*args, precision=precision, **kw)
            full = real(*args, precision="highest", **kw)
            got = alt(*args, **kw)
            recs.append((_worst(got, ref), _worst(ref, full),
                         _worst(got, full)))
            return ref

        setattr(mod, name, hook)
        try:
            rt_run_band(model.pol, model.quad_points,
                        build_band_inputs(model, 0), model.obs_geom.vza,
                        model.obs_geom.vaz, params.max_m,
                        params.surfaces[0], dtype=torch.float32,
                        device="cpu", solver="schulz", engine=engine,
                        matmul_precision=mode)
        finally:
            setattr(mod, name, real)
        out[engine] = {"launches": len(recs),
                       "order": max(r[0] for r in recs),
                       "from_highest": max(r[1] for r in recs),
                       "ratio": max(r[0] / max(r[1], 1e-30) for r in recs),
                       "ratio_to_alt": max(r[0] / max(r[2], 1e-30)
                                           for r in recs)}
    return {"path": "flagship", "points": len(params.spec_bands[0]),
            "n": len(model.quad_points.qp_mu_n), "mode": mode, **out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", choices=tuple(FORM_MODES), default="dev")
    ap.add_argument("--widths", type=int, nargs="+")
    ap.add_argument("--points", type=int, default=1007)
    ap.add_argument("--doublings", type=int, default=6)
    ap.add_argument("--modes", nargs="+")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--flagship", type=int, metavar="EVERY",
                    help="the plain form on the flagship's launches at "
                         "every EVERY-th point instead of the widths")
    args = ap.parse_args(argv)
    if args.flagship:
        for mode in args.modes or FORM_MODES["plain"][0]:
            print(json.dumps(flagship_sensitivity(args.flagship, mode)),
                  flush=True)
        return
    widths = args.widths or (WIDTHS if args.form == "dev" else PLAIN_WIDTHS)
    modes = args.modes or FORM_MODES[args.form][0]
    for n in widths:
        for mode in modes:
            rec = (sensitivity(n, args.points, mode, nd=args.doublings,
                               seed=args.seed)
                   if args.form == "dev" else
                   plain_sensitivity(n, args.points, mode, nd=args.doublings,
                                     seed=args.seed))
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
