"""Gauss-Newton retrieval demo: recover (AOD scaling, surface albedo, gas
scaling) from synthetic radiances with torch.func.jacfwd Jacobians.

Port twin of ``examples/retrieval_demo.py``, which mirrors the reference's
OCO-2 linearization prototype (ref: test/prototyping/AD_OCO2_test.jl:
71-160) with a synthetic truth in place of the L1b granule. On the card
the retrieval runs through the fused layer-step kernel (engine "kernel",
float32, static Newton-Schulz schedules): the kernel computes the primal
and its tangent kernel the tangent of every column in one launch, the
analogue of the reference
differentiating its CUBLAS path through Dual overloads (ref:
gpu_batched.jl:100-151). With ``--device cpu`` it runs the float64 torch
engine with LU solves.

Run: python -m vsmartmom_torch.retrieval_demo [--device cpu]
(the card by default).
"""
import argparse

import numpy as np
import torch

from vsmartmom_torch.core.autodiff import gauss_newton, make_radiance_fn
from vsmartmom_torch.core.rt_run import (BandRTInputs,
                                         build_layer_schedules)
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device
from vsmartmom_torch.util.quadrature import rt_set_streams

X_TRUE = (0.3, 0.25, -0.1)
X_START = (0.0, 0.1, 0.0)


def state_radiance(pol, quad, band: BandRTInputs, vza, vaz, max_m: int,
                   dtype, device, engine: str, solver: str):
    """The band's radiance as a function of the retrieval state x = (log
    scaling of the scattering depth, albedo, log scaling of the absorption
    depth): tau = tau omega e^x0 + tau (1 - omega) e^x2, omega = tau omega
    e^x0 / tau, zw unchanged. Returns (f, fn): f(x) -> R.ravel() and
    make_radiance_fn's fn(tau, omega, zw, albedo). Under the schulz solver
    the Jacobian is that of the band's static schedules at x = 0, which the
    kernel engines need."""
    static = {}
    if solver == "schulz":
        nd, sched, scheds = build_layer_schedules(
            band.tau, band.omega, float(np.min(quad.qp_mu)), "schulz")
        static = dict(layer_schedules=scheds, ndoubl_static=nd,
                      ns_schedule=sched)
    fn = make_radiance_fn(pol, quad, band.greeks, vza, vaz, max_m,
                          *band.tau.shape, dtype=dtype, device=device,
                          solver=solver, engine=engine, **static)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    t_scat, t_abs = t(band.tau * band.omega), t(band.tau * (1 - band.omega))
    zw = t(band.zw)

    def f(x):
        tau = t_scat * torch.exp(x[0]) + t_abs * torch.exp(x[2])
        return fn(tau, t_scat * torch.exp(x[0]) / tau, zw, x[1]).reshape(-1)
    return f, fn


def retrieve(device=DEFAULT_DEVICE, n_iter: int = 6):
    """(x_true, x_hat, chi^2 history, dtype) of the demo retrieval."""
    device = resolve_device(device)
    n_z, n_spec = 5, 64
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 12, 40.0, [0.0, 30.0],
                          pol.n)
    rng = np.random.default_rng(0)
    tau_scat = np.full((n_z, n_spec), 0.05)
    tau = tau_scat + rng.uniform(0.05, 0.8, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.028)])
    if device.type == "cuda":
        dtype, engine, solver = torch.float32, "kernel", "schulz"
    else:
        dtype, engine, solver = torch.float64, "torch", "lu"
    forward, _ = state_radiance(pol, quad, band, [0.0, 30.0], [0.0, 90.0],
                                3, dtype, device, engine, solver)

    x_true = torch.tensor(X_TRUE, dtype=dtype, device=device)
    y_meas = forward(x_true)
    noise = torch.as_tensor(rng.standard_normal(y_meas.shape), dtype=dtype,
                            device=device)
    y_noisy = y_meas * (1.0 + 1e-5 * noise)
    x_hat, hist = gauss_newton(
        lambda x: forward(x) - y_noisy,
        torch.tensor(X_START, dtype=dtype, device=device), n_iter=n_iter)
    return x_true.cpu().numpy(), x_hat.cpu().numpy(), hist, dtype


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    x_true, x_hat, hist, dtype = retrieve(args.device)
    print("truth:    ", x_true)
    print("retrieved:", x_hat)
    print("chi2 history:", [f"{h:.3e}" for h in hist])
    atol = 1e-3 if dtype == torch.float64 else 5e-3
    if not np.allclose(x_hat, x_true, atol=atol):
        raise SystemExit(f"retrieval missed the truth by more than {atol}")
    print("retrieval OK")


if __name__ == "__main__":
    main()
