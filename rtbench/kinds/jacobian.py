"""``jacobian``: ``torch.func.jacfwd`` of the state -> radiance map over
``core.autodiff.make_radiance_fn`` (``state_radiance`` below), with the
mix's engine, float32 and the schulz solver's static schedules of the
unperturbed band: one Gauss-Newton Jacobian with its radiance. The state x
= (x0, albedo, x2): the log scale of the scattering depth, the albedo, the
log scale of the absorption depth."""
from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import rt as ref_rt
from rtbench.reference import scene as ref_scene

#: the state's components, in the Jacobian's column order
COLUMNS = ("x0", "albedo", "x2")


def setup(mix):
    from vsmartmom_torch.core.api import build_band_inputs
    if mix.n_bands != 1:
        raise ValueError("the jacobian kind takes one band")
    p = mix.params
    f = state_radiance(mix.model.pol, mix.model.quad_points,
                       build_band_inputs(mix.model, 0), p.vza, p.vaz,
                       p.max_m, torch.float32, mix.device,
                       mix.spec["engine"], "schulz")

    def value_and_aux(x):
        r = f(x)
        return r, r
    mix.shared["jac"] = torch.func.jacfwd(value_and_aux, has_aux=True)


def _x(st, dtype, device):
    return torch.tensor([st["x0"], st["albedo"][0], st["x2"]], dtype=dtype,
                        device=device)


def call(mix, st):
    K, r = mix.shared["jac"](_x(st, torch.float32, mix.device))
    K, r = K.cpu().numpy(), r.cpu().numpy()
    shape = (len(mix.params.vza), mix.model.pol.n, mix.n_spec)
    return {"R": r.reshape(shape)[..., mix.sample],
            "K": K.reshape(shape + (len(COLUMNS),))[..., mix.sample, :]}


def work(mix, st):
    """A Jacobian's steps are tangents as well: no roofline count."""
    return []


def reference(mix, st, products):
    scene, [(idx, gas)] = mix.reference_inputs()
    dev = mix.device
    band = scene.bands[0]
    nds = ref_rt.doubling_counts(
        ref_scene.scattering_depth(band).max(axis=0),
        float(np.min(scene.quad.qp_mu)))
    tau, omega, zw = ref_scene.band_inputs(band, idx, gas)
    t_scat = ref_scene.to_torch(tau * omega, dev)
    t_abs = ref_scene.to_torch(tau * (1.0 - omega), dev)
    zw = ref_scene.to_torch(zw, dev)
    greeks = ref_scene.greeks(scene, band)

    def f(x):
        tau_x = t_scat * torch.exp(x[0]) + t_abs * torch.exp(x[2])
        r, _ = ref_rt.radiance(scene, greeks, tau_x,
                               t_scat * torch.exp(x[0]) / tau_x, zw, x[1],
                               nds, dev, products)
        return r, r
    K, r = torch.func.jacfwd(f, has_aux=True)(_x(st, torch.float64, dev))
    return {"R": r.cpu().numpy(), "K": K.cpu().numpy()}


def state_radiance(pol, quad, band, vza, vaz, max_m: int, dtype, device,
                   engine: str, solver: str):
    """The band's radiance as a function of the retrieval state x = (log
    scale of the scattering depth, albedo, log scale of the absorption
    depth): tau = tau omega e^x0 + tau (1 - omega) e^x2, omega = tau omega
    e^x0 / tau, zw unchanged; f(x) -> R.ravel(). Under the schulz solver the
    schedules are the band's at x = 0, which the kernel engines need.
    A copy of the port's ``retrieval_demo.state_radiance``."""
    from vsmartmom_torch.core.autodiff import make_radiance_fn
    from vsmartmom_torch.core.rt_run import build_layer_schedules
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
    return f
