"""Multi-sensor RT: radiances at arbitrary atmospheric levels.

Port of ``vsmartmom/core/multisensor.py``. Sensors sit at layer interfaces
s = 0 (TOA) .. nZ (BOA). For each sensor the atmosphere splits into a *top*
composite (layers above) and a *bot* composite (layers below + surface);
the up/downwelling radiance at the interface follows from coupling the two
slabs:

    dwJ = (I - R_top^{+-} R_bot^{-+})^{-1} (J_top^+ + R_top^{+-} J_bot^-)
    uwJ = (I - R_bot^{-+} R_top^{+-})^{-1} (J_bot^- + R_bot^{-+} J_top^+)

ref: src/CoreRT/rt_run_multisensor.jl:14-192,
     src/CoreRT/CoreKernel/interlayer_flux.jl:7-25,
     src/CoreRT/CoreKernel/rt_kernel_multisensor.jl (top/bot composition).

The layer scan runs in *segments* between consecutive sensor levels:
forward from TOA for the top composites, in reverse from the surface for the
bottom ones, so each layer is built once per direction (the Raman twin,
core/rt_raman.py:_fourier_step_rrs_ms, segments the same way). Torch ops
on ``device``; no layer kernel runs here, as no Pallas kernel runs in the
JAX package's multi-sensor run.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vsmartmom_torch.core.brdf import brdf_fourier_matrix
from vsmartmom_torch.core.rt import (bmm, bmv, interaction,
                                     make_added_layer, make_rsolve,
                                     mix_z, vacuum_layer)
from vsmartmom_torch.core.precision import matmul_precision
from vsmartmom_torch.core.rt_run import (BandRTInputs, default_solver,
                                         surface_inputs, synthesis_weights)
from vsmartmom_torch.core.surface import (brdf_surface_layer,
                                          lambertian_surface_layer)
from vsmartmom_torch.scattering.phase import Polarization, compute_Z_moments
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device
from vsmartmom_torch.util.quadrature import QuadPoints


def interlayer_flux(top, bot, eye, rsolve):
    """(uw, dw) source vectors at the interface between a top and a bottom
    composite (ref: CoreKernel/interlayer_flux.jl:7-25)."""
    def lsolve_vec(a, v):
        """a^{-1} v for batched (nSpec, N, N) a and (nSpec, N) v."""
        return rsolve(v[:, None, :], a.transpose(1, 2))[:, 0, :]

    a_dw = eye - bmm(top.r_pm, bot.r_mp)
    dw = lsolve_vec(a_dw, top.j_p + bmv(top.r_pm, bot.j_m))
    a_uw = eye - bmm(bot.r_mp, top.r_pm)
    uw = lsolve_vec(a_uw, bot.j_m + bmv(bot.r_mp, top.j_p))
    return uw, dw


def segmented_composites(layer, n_z: int, levels, surf, vacuum, eye,
                         rsolve):
    """Top and bottom composites at each interface in ``levels`` (0 = TOA
    .. n_z = the surface's top) of the layers ``layer(0) .. layer(n_z - 1)``
    over ``surf``: forward segments from TOA for the tops, reverse segments
    from the surface for the bottoms, so each layer is built at most once a
    direction. Returns ({level: top}, {level: bottom})."""
    levels = sorted(set(levels))
    tops = {}
    comp = vacuum
    prev = 0
    for s in levels:
        for iz in range(prev, s):
            comp = interaction(comp, layer(iz), eye, rsolve=rsolve)
        prev = s
        tops[s] = comp
    bots = {}
    acc = surf
    prev = n_z
    for s in reversed(levels):
        for iz in range(prev - 1, s - 1, -1):
            # prepend the layer on top of the accumulated bottom slab
            acc = interaction(layer(iz), acc, eye, rsolve=rsolve)
        prev = s
        bots[s] = acc
    return tops, bots


def _fourier_step_ms(tau, omega, zw, z_pp_c, z_mp_c, qp, wt, d_vec, i0_vec,
                     albedo, spectral_albedo, mu0, mu0_node, min_qp_mu,
                     rho_brdf=None, *, i_mu0_n, n_stokes, is_m0, solver,
                     sensor_levels):
    """One Fourier moment: the segmented scans and the coupling at every
    sensor. Returns (uw, dw), each (nSensor, nSpec, N)."""
    rsolve = make_rsolve(solver)
    dtype, device = tau.dtype, tau.device
    n_z, n_spec = tau.shape
    n = qp.shape[0]
    eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
    wct02 = torch.tensor(0.5 if is_m0 else 0.25, dtype=dtype, device=device)
    wct2 = wt / 2.0 if is_m0 else wt / 4.0
    tau_sum_all = torch.cat([torch.zeros((1, n_spec), dtype=dtype,
                                         device=device),
                             torch.cumsum(tau, dim=0)], dim=0)

    def layer(iz):
        z_pp = mix_z(zw[iz], z_pp_c)
        z_mp = mix_z(zw[iz], z_mp_c)
        return make_added_layer(
            tau[iz], omega[iz], z_pp, z_mp, tau_sum_all[iz], qp, wct2,
            wct02, i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
            min_qp_mu, eye, rsolve=rsolve)

    if rho_brdf is not None:
        surf = brdf_surface_layer(rho_brdf, n_spec, qp, wt, i0_vec,
                                  tau_sum_all[-1], mu0)
    else:
        surf = lambertian_surface_layer(
            albedo, n_spec, n_stokes, qp, wt, i0_vec, tau_sum_all[-1], mu0,
            is_m0, spectral_albedo=spectral_albedo)
    tops, bots = segmented_composites(
        layer, n_z, sensor_levels, surf, vacuum_layer(n_spec, n, dtype,
                                                      device), eye, rsolve)

    # --- interlayer flux coupling per sensor ------------------------------
    pairs = [interlayer_flux(tops[s], bots[s], eye, rsolve)
             for s in sensor_levels]
    return (torch.stack([u for u, _ in pairs]),
            torch.stack([d for _, d in pairs]))


def rt_run_band_ms(pol: Polarization, quad: QuadPoints, band: BandRTInputs,
                   vza, vaz, max_m: int, surface,
                   sensor_levels: Sequence[int], dtype=torch.float64,
                   device=DEFAULT_DEVICE, solver: Optional[str] = None):
    """Multi-sensor forward run for one band on ``device`` ("cuda" unless
    the caller asks for "cpu").

    sensor_levels: layer-interface indices, 0 = TOA .. nZ = BOA, in any
    order (duplicates allowed). Returns (uwJ, dwJ) of shape
    (nSensor, n_vza, n_stokes, nSpec) (ref: rt_run_multisensor.jl:14-192
    rt_run_test_ms). ``solver``: "lu" (default on the CPU) or "schulz"
    (default on CUDA). Surfaces: LambertianSurfaceScalar, -Spectrum,
    -Legendre, rpvSurfaceScalar and RossLiSurfaceScalar; anything else
    raises NotImplementedError. Float32 matmuls run in full float32 (TF32
    off) for the duration of the call.
    """
    device = resolve_device(device)
    solver = default_solver(device, solver)
    n_spec = band.tau.shape[1]
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    n_z = band.tau.shape[0]
    sensor_levels = tuple(int(s) for s in sensor_levels)
    if not all(0 <= s <= n_z for s in sensor_levels):
        raise ValueError(f"sensor levels {sensor_levels} outside 0..{n_z}")
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    def to_dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    i0_vec = np.zeros(n)
    i0_vec[quad.i_mu0_n:quad.i_mu0_n + n_stokes] = pol.i0
    d_vec = np.tile(pol.d, quad.n_quad)
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    min_qp_mu = float(np.min(quad.qp_mu))

    albedo, spectral_albedo, is_brdf = surface_inputs(surface, n_spec,
                                                      to_dev)

    uw_out = np.zeros((len(sensor_levels), len(vza), n_stokes, n_spec))
    dw_out = np.zeros_like(uw_out)
    with matmul_precision("highest"):
        tau_d, omega_d, zw_d = (to_dev(band.tau), to_dev(band.omega),
                                to_dev(band.zw))
        consts = dict(qp=to_dev(quad.qp_mu_n), wt=to_dev(quad.wt_mu_n),
                      d_vec=to_dev(d_vec), i0_vec=to_dev(i0_vec),
                      albedo=to_dev(albedo),
                      spectral_albedo=spectral_albedo, mu0=to_dev(quad.mu0),
                      mu0_node=to_dev(mu0_node), min_qp_mu=to_dev(min_qp_mu))
        for m in range(max_m):
            z_list = [compute_Z_moments(pol, quad.qp_mu, gc, m)
                      for gc in band.greeks]
            rho_brdf = (to_dev(brdf_fourier_matrix(surface, quad.qp_mu, m,
                                                   n_stokes))
                        if is_brdf else None)
            uw_j, dw_j = _fourier_step_ms(
                tau_d, omega_d, zw_d, to_dev(np.stack([z[0] for z in z_list])),
                to_dev(np.stack([z[1] for z in z_list])), rho_brdf=rho_brdf,
                i_mu0_n=quad.i_mu0_n, n_stokes=n_stokes, is_m0=(m == 0),
                solver=solver, sensor_levels=sensor_levels, **consts)
            uw_j = uw_j.cpu().numpy()
            dw_j = dw_j.cpu().numpy()

            # azimuthal synthesis (ref: tools/postprocessing_vza_ms.jl)
            for i, (sl, cs) in enumerate(
                    synthesis_weights(quad, vza, vaz, m, n_stokes)):
                uw_out[:, i] += (cs[None, :, None]
                                 * uw_j[:, :, sl].transpose(0, 2, 1))
                dw_out[:, i] += (cs[None, :, None]
                                 * dw_j[:, :, sl].transpose(0, 2, 1))
    return uw_out, dw_out


def rt_run_ms(model, sensor_levels: Sequence[int], i_band: int = 0,
              dtype=None, device=DEFAULT_DEVICE):
    """Multi-sensor run from an RTModel (mirrors rt_run_test_ms). ``dtype``
    defaults to the parameters' float_type."""
    from vsmartmom_torch.core.api import build_band_inputs
    if dtype is None:
        dtype = (torch.float32 if model.params.float_type == "Float32"
                 else torch.float64)
    band = build_band_inputs(model, i_band)
    return rt_run_band_ms(model.pol, model.quad_points, band,
                          model.obs_geom.vza, model.obs_geom.vaz,
                          model.params.max_m,
                          model.params.surfaces[i_band], sensor_levels,
                          dtype=dtype, device=device)
