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
from vsmartmom_torch.core.rt_run import (BandRTInputs, Geometry, Synthesis,
                                         default_solver, geometry,
                                         surface_inputs, surface_layer)
from vsmartmom_torch.scattering.phase import Polarization
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


def _fourier_step_ms(tau, omega, zw, z_pp_c, z_mp_c, geom: Geometry, albedo,
                     spectral_albedo, rho_brdf=None, *, m, solver,
                     sensor_levels):
    """Fourier moment m: the segmented scans and the coupling at every
    sensor. Returns (uw, dw), each (nSensor, nSpec, N)."""
    rsolve = make_rsolve(solver)
    dtype, device = tau.dtype, tau.device
    n_z, n_spec = tau.shape
    n = geom.qp.shape[0]
    eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
    streams = geom.layer_args(m)
    tau_sum_all = torch.cat([torch.zeros((1, n_spec), dtype=dtype,
                                         device=device),
                             torch.cumsum(tau, dim=0)], dim=0)

    def layer(iz):
        z_pp = mix_z(zw[iz], z_pp_c)
        z_mp = mix_z(zw[iz], z_mp_c)
        return make_added_layer(
            tau[iz], omega[iz], z_pp, z_mp, tau_sum_all[iz], *streams,
            geom.min_qp_mu, eye, rsolve=rsolve)

    surf = surface_layer(geom, m, tau_sum_all[-1], albedo, spectral_albedo,
                         rho_brdf)
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
    n_z = band.tau.shape[0]
    sensor_levels = tuple(int(s) for s in sensor_levels)
    if not all(0 <= s <= n_z for s in sensor_levels):
        raise ValueError(f"sensor levels {sensor_levels} outside 0..{n_z}")
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    geom = geometry(pol, quad, dtype, device)
    albedo, spectral_albedo, is_brdf = surface_inputs(surface, n_spec,
                                                      geom.to_dev)
    syn = Synthesis(geom, vza, vaz, n_spec, 2, n_sensor=len(sensor_levels))
    with matmul_precision("highest"):
        tau_d, omega_d, zw_d = (geom.to_dev(band.tau),
                                geom.to_dev(band.omega),
                                geom.to_dev(band.zw))
        albedo_d = geom.to_dev(albedo)
        for m in range(max_m):
            z_pp_c, z_mp_c = geom.z_moments(band.greeks, m)
            rho_brdf = (geom.to_dev(brdf_fourier_matrix(surface, quad.qp_mu,
                                                        m, pol.n))
                        if is_brdf else None)
            uw_j, dw_j = _fourier_step_ms(
                tau_d, omega_d, zw_d, z_pp_c, z_mp_c, geom, albedo_d,
                spectral_albedo, rho_brdf, m=m, solver=solver,
                sensor_levels=sensor_levels)
            # azimuthal synthesis (ref: tools/postprocessing_vza_ms.jl)
            syn.add(m, uw_j.cpu().numpy(), dw_j.cpu().numpy())
    return tuple(syn.outs)


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
