"""Qualify the matrix-product precision modes against the reference's
accuracy gates, on the card in float32 (counterpart of
``tools/qualify_precision.py``).

The CI gates run float64 on the CPU. This tool re-runs their cases in
float32 with the Newton-Schulz solver at each mode: the 6SV1 scalar
Rayleigh table (6 cases x 3 SZA x 3 azimuths, < 0.006 rel) and the Natraj
polarized table (7 azimuths; I < 0.002, Q/U < 0.008). Both take RadauQuad
l_trunc 20 with 16 VZA and Stokes IQUV, N = 136-140 (views on a Radau node
merge with it): beyond every kernel, so the torch engines run them. One
call takes all azimuths of a (case, SZA) as extra views: the quadrature
depends on SZA and VZA alone, so the numbers are those of one call per
azimuth.

Tokens (the JAX tool's): "highest", "high", "default" run the plain torch
engine at that ``matmul_precision``; "dev" and "dev_highest" the split
form (torch_dev) at "highest", "dev_high" at "high". Each token also holds
a kernel against its torch engine at the same mode
(``kernel_vs_torch_delta``): row 1 (engine kernel) against torch for plain
tokens, row 3 (kernel_dev) at the token's dd mode against torch_dev at
"highest" for dev tokens, at moment 0 on the N = 44 example atmosphere
(scaling_bench.example_inputs, 512 points, 6 layers).

    python3 -m vsmartmom_torch.qualify_precision [tokens] [--out PATH]

prints one JSON line per token and appends them, with a note line naming
the card (nvidia-smi's name and power limit), to ``--out`` (default
vsmartmom_torch/qualification/precision_h100.jsonl; "-" writes no file).
Needs a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from vsmartmom_torch._paths import REPO_ROOT

DATA = os.path.join(REPO_ROOT, "tests", "data")
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "qualification", "precision_h100.jsonl")
TOKENS = ("highest", "high", "default", "dev", "dev_highest", "dev_high")

VZA_16 = [0.0, 11.4783, 16.2602, 23.0739, 32.8599, 43.9455, 50.2082, 58.6677,
          66.4218, 71.3371, 73.7398, 78.463, 80.7931, 84.2608, 86.5602,
          88.854]
#: (case, azimuths, SZAs, tau, albedo) of the 6SV1 table
CASES_6SV1 = [
    (1, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.1, 0.0),
    (2, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.1, 0.25),
    (3, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.25, 0.0),
    (4, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.25, 0.25),
    (5, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.50, 0.0),
    (6, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.50, 0.25),
]
NATRAJ_MU = [0.02, 0.06, 0.10, 0.16, 0.20, 0.28, 0.32, 0.40, 0.52, 0.64,
             0.72, 0.84, 0.92, 0.96, 0.98, 1.00]
#: the gates: 6SV1 rel, Natraj I, Q and U rel
GATES = {"sv6": 0.006, "natraj_i": 0.002, "natraj_q": 0.008,
         "natraj_u": 0.008}


def run_kwargs(token: str, device) -> dict:
    """rt_run_band's keywords for a token: float32, schulz, the plain
    torch engine at the token's mode or the split form (dev tokens)."""
    if token not in TOKENS:
        raise ValueError(f"unknown token {token!r}: expected one of "
                         f"{TOKENS}")
    if token.startswith("dev"):
        engine = "torch_dev"
        mode = "high" if token == "dev_high" else "highest"
    else:
        engine, mode = "torch", token
    return dict(dtype=torch.float32, solver="schulz", engine=engine,
                matmul_precision=mode, device=device)


def _rayleigh_band(tau):
    from vsmartmom_torch.core.rt_run import BandRTInputs
    from vsmartmom_torch.scattering.phase import get_greek_rayleigh
    return BandRTInputs(tau=np.full((1, 2), tau), omega=np.ones((1, 2)),
                        zw=np.ones((1, 1, 2)),
                        greeks=[get_greek_rayleigh(0.0)])


def _pol():
    from vsmartmom_torch.scattering.phase import Polarization
    return Polarization.from_name("Stokes_IQUV")


def sv6_errors(kw: dict, cases=CASES_6SV1, sza_index=None) -> float:
    """Worst relative error of R / mu0 against the 6SV1 table over
    ``cases`` (every SZA, or the one at ``sza_index``), one rt_run_band
    call per (case, SZA) with the azimuths as extra views."""
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.util.quadrature import rt_set_streams
    with open(os.path.join(DATA, "6sv1_r_trues.json")) as f:
        r_trues = np.asarray(json.load(f))
    pol = _pol()
    worst = 0.0
    for ci, azs, szas, tau, rho in cases:
        for sza_i, sza in enumerate(szas):
            if sza_index is not None and sza_i != sza_index:
                continue
            quad = rt_set_streams("RadauQuad", 20, sza, VZA_16, pol.n)
            R, _ = rt_run_band(
                pol, quad, _rayleigh_band(tau), VZA_16 * len(azs),
                [float(a) for a in azs for _ in VZA_16], 3,
                {"type": "LambertianSurfaceScalar", "albedo": rho}, **kw)
            r_model = R[:, 0, 0].reshape(len(azs), 16) / quad.mu0
            r_true = r_trues[ci - 1, sza_i]
            worst = max(worst, float(np.max(np.abs(r_true - r_model)
                                            / r_true)))
    return worst


def natraj_errors(kw: dict):
    """(I, Q, U) worst relative errors against the Natraj table (tau 0.5,
    mu0 0.2, 7 azimuths as extra views of one call; Q and U where the
    model is >= 0.01, as the reference's test)."""
    from vsmartmom_torch.core.rt_run import rt_run_band
    from vsmartmom_torch.util.quadrature import rt_set_streams
    d = np.load(os.path.join(DATA, "natraj_trues.npz"))
    I_t, Q_t, U_t = d["I_trues"], d["Q_trues"], d["U_trues"]
    vza = list(np.degrees(np.arccos(NATRAJ_MU)))
    phis = np.arange(0.0, 181.0, 30.0)
    pol = _pol()
    quad = rt_set_streams("RadauQuad", 20, np.degrees(np.arccos(0.2)), vza,
                          pol.n)
    R, _ = rt_run_band(pol, quad, _rayleigh_band(0.5), vza * len(phis),
                       [float(p) for p in phis for _ in vza], 3,
                       {"type": "LambertianSurfaceScalar", "albedo": 0.0},
                       **kw)
    # (azimuth, view) -> (view, azimuth), as the tables
    I_m, Q_m, U_m = (R[:, k, 0].reshape(len(phis), 16).T for k in range(3))
    i_err = float(np.max(np.abs(I_t - I_m) / I_t))
    q_mask = Q_m >= 0.01
    q_err = float(np.max(np.abs(Q_t - Q_m)[q_mask] / np.abs(Q_t)[q_mask]))
    u_mask = U_m >= 0.01
    with np.errstate(invalid="ignore"):
        u_err = float(np.nanmax(np.abs(U_t - U_m)[u_mask]
                                / np.abs(U_t)[u_mask]))
    return i_err, q_err, u_err


def kernel_vs_torch_delta(token: str, device="cuda", n_spec: int = 512,
                          n_z: int = 6) -> float:
    """max |a - b| / max |b| of moment 0's j_m on the N = 44 example
    atmosphere: a = the kernel engine (row 1 for plain tokens, row 3 at
    the token's dd mode for dev tokens), b = its torch engine (torch at the
    token's mode, torch_dev at "highest"), both in float32 schulz."""
    from vsmartmom_torch.core import precision
    from vsmartmom_torch.core.rt_run import (_fourier_step,
                                             _per_layer_schedules,
                                             build_layer_schedules)
    from vsmartmom_torch.scaling_bench import example_inputs
    from vsmartmom_torch.util.device import resolve_device
    device = resolve_device(device)
    args, geom_at = example_inputs(n_spec, n_quad_half=8, n_stokes=4,
                                   n_z=n_z)
    geom, z = geom_at(device)
    nd, sched, ls = build_layer_schedules(
        args["tau"], args["omega"], float(geom.min_qp_mu), "schulz")
    schedules = _per_layer_schedules(n_z, "schulz", nd, sched, ls)
    t = {k: torch.as_tensor(np.asarray(v), device=device)
         for k, v in args.items()}

    def run(engine, mode, dd=None):
        with precision.matmul_precision(mode):
            comp, _ = _fourier_step(
                t["tau"], t["omega"], t["zw"], *z, geom, t["albedo"], None,
                m=0, solver="schulz", layer_schedules=schedules,
                engine=engine, matmul_precision=mode, dd_precision=dd)
        return comp.j_m.double().cpu().numpy()

    if token.startswith("dev"):
        dd = "bf16x3" if token == "dev_high" else "highest"
        a = run("kernel_dev", "highest", dd)
        b = run("torch_dev", "highest")
    else:
        a = run("kernel", token)
        b = run("torch", token)
    return float(np.abs(a - b).max() / np.abs(b).max())


def qualify(token: str, device="cuda") -> dict:
    """One token's record: the gates' worst errors, the kernel delta and
    whether every gate passes."""
    kw = run_kwargs(token, device)
    sv6 = sv6_errors(kw)
    i_err, q_err, u_err = natraj_errors(kw)
    rec = dict(precision=token, sv6=sv6, natraj_i=i_err, natraj_q=q_err,
               natraj_u=u_err,
               kernel_vs_torch_delta=kernel_vs_torch_delta(token, device))
    rec["gates_pass"] = all(rec[k] < g for k, g in GATES.items())
    return rec


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(tokens=TOKENS, out=DEFAULT_OUT, device="cuda") -> list:
    """Qualify each token, print its JSON line, and append the lines with
    a note naming the device to ``out`` (None: no file)."""
    for tok in tokens:
        run_kwargs(tok, device)          # reject unknown tokens first
    recs = []
    for tok in tokens:
        rec = qualify(tok, device)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if out is not None:
        where = (card_line() if torch.device(device).type == "cuda"
                 else "the CPU")
        note = {"note": f"{where}: python3 -m "
                        f"vsmartmom_torch.qualify_precision "
                        f"{' '.join(tokens)}; float32, schulz, torch "
                        f"engines at N = 136-140 (gates 6SV1 < 0.006, Natraj "
                        f"I < 0.002, Q/U < 0.008); kernel_vs_torch_delta "
                        f"at N = 44, 512 points, moment 0; torch "
                        f"{torch.__version__}"}
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps(note) + "\n")
    return recs


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tokens", nargs="*", default=list(TOKENS))
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help='JSON lines appended here ("-": none)')
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.tokens, None if a.out == "-" else a.out, a.device)


if __name__ == "__main__":
    _cli()
