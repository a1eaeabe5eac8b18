"""``forward``: ``rt_run(model, engine)`` over every band of the
configuration, on the model built in set-up with the call's state applied;
host arrays R and T back."""
from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.reference import rt as ref_rt
from rtbench.reference import scene as ref_scene


def setup(mix):
    """Nothing beyond the model build."""


def model_at(mix, st):
    """The set-up's model with the state applied: the surfaces' albedos,
    the aerosol depths scaled by e^x0 and the gas depths by e^x2."""
    m = mix.model
    surfaces = [dict(s, albedo=a) for s, a in
                zip(mix.params.surfaces, st["albedo"])]
    return dataclasses.replace(
        m, params=dataclasses.replace(m.params, surfaces=surfaces),
        tau_aer=[t * np.exp(st["x0"]) for t in m.tau_aer],
        tau_abs=[t * np.exp(st["x2"]) for t in m.tau_abs])


def call(mix, st):
    bands = list(range(mix.n_bands))
    R, T = mix.vt.rt_run(model_at(mix, st),
                         i_band=bands[0] if len(bands) == 1 else bands,
                         device=mix.device, engine=mix.spec["engine"])
    return {"R": R[..., mix.sample], "T": T[..., mix.sample]}


def tau_scat_max(mix, st) -> np.ndarray:
    """(nZ,) largest scattering depth of each layer over the call's
    spectral axis, at the call's state, from the program's model."""
    m = mix.model
    best = None
    for ib in range(mix.n_bands):
        scat = m.tau_rayl[ib].max(axis=0).copy()
        for i, optics in enumerate(m.aerosol_optics[ib]):
            scat += (np.exp(st["x0"]) * (1.0 - optics.f_t) * optics.ssa
                     * m.tau_aer[ib][i])
        best = scat if best is None else np.maximum(best, scat)
    return best


def work(mix, st):
    """One layer step per layer and Fourier moment, its doublings by the
    reference's rule from the call's state."""
    q = mix.model.quad_points
    nds = ref_rt.doubling_counts(tau_scat_max(mix, st),
                                 float(np.min(q.qp_mu)))
    n = len(q.qp_mu_n)
    return [(n, mix.n_spec, nd) for _ in range(mix.params.max_m)
            for nd in nds]


def reference(mix, st, products):
    scene, per_band = mix.reference_inputs()
    dev = mix.device
    ts = np.max([ref_scene.scattering_depth(b, np.exp(st["x0"]))
                 .max(axis=0) for b in scene.bands], axis=0)
    nds = ref_rt.doubling_counts(ts, float(np.min(scene.quad.qp_mu)))
    R, T = [], []
    for ib, (band, (idx, gas)) in enumerate(zip(scene.bands, per_band)):
        if not len(idx):
            continue
        tau, omega, zw = ref_scene.band_inputs(
            band, idx, gas, np.exp(st["x0"]), np.exp(st["x2"]))
        r, t = ref_rt.radiance(
            scene, ref_scene.greeks(scene, band),
            *(ref_scene.to_torch(a, dev) for a in (tau, omega, zw)),
            ref_scene.to_torch(st["albedo"][ib], dev), nds, dev, products)
        R.append(r.cpu().numpy())
        T.append(t.cpu().numpy())
    return {"R": np.concatenate(R, -1), "T": np.concatenate(T, -1)}
