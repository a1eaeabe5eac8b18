"""Vegetation-canopy RT: directional cross-section (G) layers.

Port of ``vsmartmom/core/canopy.py``. The reference's experimental canopy
mode (ref: src/CoreRT/rt_run_canopy.jl, CoreKernel/elemental_canopy.jl,
types.jl:613-624 CoreDirectionalScatteringOpticalProperties) attenuates
along each stream with the Ross projection factor G(mu) — the mean
leaf-area cross-section seen from direction mu — and scatters with a
bi-Lambertian leaf phase function (the reference pulls both from
CanopyOptics.jl; here they are implemented directly: Ross-Goudriaan G and
the classic uniform-LAD bi-Lambertian area scattering phase function,
Shultis & Myneni 1988).

Float32 guards of the directional elemental (the JAX package has none of
them; float64 results are unchanged):
  - every e^-b - e^-a is exp_difference's e^-a expm1(a - b), e^-b beyond
    a - b = EXP_DIFF_CUT: a near-black slab (omega ~ 0 doubles 0 times, so
    dtau is the whole slab) seen at a grazing stream overflows expm1
    there, and 0 * inf is NaN;
  - the expm1 argument and the denominator it is divided by are one
    rounded value: at chi = 0.6, mu_i G_j - mu_j G_i = phi1 (mu_i - mu_j)
    with phi1 = 0.0012, so separately rounded they disagree in float32;
  - two distinct nodes at one mu (a view 1 ulp from a quadrature node
    merges with it in float32) take the float64 limit of T^++ between
    them (rt.merged_nodes), as the elastic elemental does; so does a node
    at mu0 outside the solar block in J^+.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from vsmartmom_torch.core.rt import (LayerRT, bmv, doubling,
                                     doubling_number, exp_difference,
                                     interaction, make_added_layer,
                                     make_rsolve, merged_nodes, mix_z,
                                     rsolve_lu, vacuum_layer)
from vsmartmom_torch.core.brdf import brdf_fourier_matrix
from vsmartmom_torch.core.multisensor import (interlayer_flux,
                                              segmented_composites)
from vsmartmom_torch.core.precision import matmul_precision
from vsmartmom_torch.core.rt_run import (Synthesis, geometry,
                                         surface_inputs, surface_layer)
from vsmartmom_torch.scattering.phase import GreekCoefs
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device


def ross_g(mu, chi: float = 0.0):
    """Ross-Goudriaan projection factor G(mu) for a leaf angle
    distribution parameterized by chi (0 = spherical -> G = 0.5;
    chi -> +1 planophile, chi -> -1 erectophile).
    """
    mu = np.asarray(mu, dtype=np.float64)
    chi = float(np.clip(chi, -0.4, 0.6))
    phi1 = 0.5 - 0.633 * chi - 0.33 * chi**2
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    return phi1 + phi2 * mu


def bilambertian_greek(rho_l: float, tau_l: float,
                       n_moments: int = 16) -> tuple:
    """Greek (Legendre-beta) expansion of the bi-Lambertian uniform-LAD
    area scattering phase function

        Gamma(beta) = (rho+tau)/(3 pi) (sin b - b cos b) + tau/3 cos b

    normalized so the 0th moment of p = 4 Gamma / (rho + tau) is 1.
    Returns (GreekCoefs (intensity-only), ssa = rho_l + tau_l).
    """
    from numpy.polynomial.legendre import leggauss, legvander
    if not (rho_l >= 0 and tau_l >= 0 and rho_l + tau_l <= 1.0):
        raise ValueError(f"leaf reflectance {rho_l} and transmittance "
                         f"{tau_l} must be >= 0 with a sum <= 1")
    x, w = leggauss(256)                     # x = cos(beta)
    b = np.arccos(x)
    gamma = ((rho_l + tau_l) / (3.0 * np.pi)
             * (np.sin(b) - b * np.cos(b)) + tau_l / 3.0 * np.cos(b))
    p = 4.0 * gamma / max(rho_l + tau_l, 1e-12)
    ls = np.arange(n_moments)
    beta = (2 * ls + 1) / 2.0 * (legvander(x, n_moments - 1).T @ (w * p))
    beta = beta / beta[0]
    z = np.zeros(n_moments)
    gc = GreekCoefs(alpha=z, beta=beta, gamma=z, delta=beta.copy(),
                    epsilon=z, zeta=z)
    return gc, rho_l + tau_l


def elemental_directional(dtau, omega, z_pp, z_mp, g_proj, qp, wct2, wct02,
                          tau_sum, i0_vec, i_mu0_n, n_stokes, mu0_node):
    """Single-scattering init with per-stream projection factors G(mu).

    G == 1 reduces exactly to rt.elemental. ref: elemental_canopy.jl
    get_canopy_elem_rt!/..._SFI! (:63-160); dtau/omega/tau_sum (nSpec,),
    g_proj/qp/wct2/i0_vec (N,) per Stokes-replicated stream, z_pp/z_mp
    (nSpec|1, N, N); wct02 and mu0_node scalars (tensors or floats).

    ``tau_sum`` is the EFFECTIVE (already projection-weighted) optical
    depth above this layer along the solar beam: plain atmospheric tau
    plus G(mu0)-weighted LAI of any canopy layers above — the caller
    composes mixed scenes (rt_run_canopy) by accumulating it.
    """
    n = qp.shape[0]
    n_sp = dtau.shape[0]
    dt = dtau[:, None, None]
    om = omega[:, None, None]
    mu_i = qp[:, None]
    mu_j = qp[None, :]
    g_i = g_proj[:, None]
    g_j = g_proj[None, :]
    same_mu = mu_i == mu_j
    eye = torch.eye(n, dtype=torch.bool, device=qp.device)
    col_mask = wct2 > 1e-8

    # Scattering carries the incident-direction projection G(Omega_j): the
    # leaf area intercepts ~G(Omega') of the incoming beam and scatters
    # omega_leaf of it; our Z is a beta_0 = 1-normalized phase matrix (the
    # reference's CanopyOptics Gamma absorbs this factor instead). Without
    # it the effective per-path albedo is omega/G > 1 and doubling
    # diverges.
    r_mp = (om * g_j * z_mp * (mu_j / (mu_i * g_j + mu_j * g_i))
            * wct2[None, None, :]
            * (-torch.expm1(-dt * (g_i / mu_i + g_j / mu_j))))
    r_mp = torch.where(col_mask[None, None, :], r_mp, 0.0)

    exp_i = torch.exp(-dt * g_i / mu_i)
    e_diag = exp_i * (om * g_i * z_pp * (dt / mu_i) * wct2[None, None, :])
    t_diag = exp_i + e_diag
    # e^{-dt G_i/mu_i} - e^{-dt G_j/mu_j} over mu_i G_j - mu_j G_i: the
    # expm1 argument is dt * den / (mu_i mu_j) with the same rounded den
    den = mu_i * g_j - mu_j * g_i
    denom = torch.where(same_mu, 1.0, den)
    exp_diff = exp_difference(exp_i, torch.exp(-dt * g_j / mu_j),
                              dt * (den / (mu_i * mu_j)))
    t_off = om * g_j * z_pp * (mu_j / denom) * wct2[None, None, :] * exp_diff
    merged = merged_nodes(same_mu, n_stokes)
    t_pp = torch.where(same_mu[None, :, :],
                       torch.where(eye[None, :, :], t_diag,
                                   torch.where(merged[None, :, :], e_diag,
                                               0.0)),
                       t_off)
    t_pp = torch.where(col_mask[None, None, :], t_pp,
                       torch.where(eye[None, :, :],
                                   exp_i * torch.ones_like(t_pp), 0.0))

    # SFI sources with G-projected solar attenuation
    z_pp_i0 = bmv(z_pp.expand(n_sp, n, n), i0_vec.expand(n_sp, n))
    z_mp_i0 = bmv(z_mp.expand(n_sp, n, n), i0_vec.expand(n_sp, n))
    idx = torch.arange(n, device=qp.device)
    in_block = (idx >= i_mu0_n) & (idx < i_mu0_n + n_stokes)
    g0 = g_proj[i_mu0_n]

    mu_iv = qp[None, :]
    g_iv = g_proj[None, :]
    dt_v = dtau[:, None]
    exp_iv = torch.exp(-dt_v * g_iv / mu_iv)
    # the degenerate limit for the solar block and any node at mu0
    same0 = in_block[None, :] | (mu_iv == mu0_node)
    den0 = mu_iv * g0 - mu0_node * g_iv
    denom0 = torch.where(same0, 1.0, den0)
    exp_diff0 = exp_difference(exp_iv, torch.exp(-dt_v * g0 / mu0_node),
                               dt_v * (den0 / (mu_iv * mu0_node)))
    j_p = torch.where(same0, (dt_v / mu_iv) * exp_iv,
                      (mu0_node / denom0) * exp_diff0)
    j_p = wct02 * omega[:, None] * g0 * z_pp_i0 * j_p
    j_m = (wct02 * omega[:, None] * g0 * z_mp_i0
           * (mu0_node / (mu_iv * g0 + mu0_node * g_iv))
           * (-torch.expm1(-dt_v * (g_iv / mu_iv + g0 / mu0_node))))

    atten = torch.exp(-tau_sum / mu0_node)[:, None]
    return r_mp, t_pp, j_p * atten, j_m * atten


def make_canopy_layer(tau, omega, z_pp, z_mp, g_proj, tau_sum, qp, wct2,
                      wct02, i0_vec, i_mu0_n, n_stokes, mu0_node, mu0,
                      d_vec, min_qp_mu, eye, rsolve=rsolve_lu) -> LayerRT:
    """Canopy slab: directional elemental + doubling (ref:
    rt_kernel.jl:248-267 G-aware dtau/expk)."""
    tau_scat_max = torch.max(tau * omega)
    # Elemental step 0.004*min(mu): single-scatter error O((dtau/mu)^2)
    # stays < ~3e-5 of radiance (measured f64), 2 fewer doublings/layer
    # than the reference's 0.001 factor.
    dtau_max = torch.minimum(tau_scat_max,
                             torch.as_tensor(0.004 * min_qp_mu,
                                             dtype=tau.dtype,
                                             device=tau.device))
    ndoubl = doubling_number(dtau_max, tau_scat_max)
    dtau = tau / 2.0 ** ndoubl
    g0 = g_proj[i_mu0_n]
    expk = torch.exp(-dtau * g0 / mu0)

    r_mp, t_pp, j_p, j_m = elemental_directional(
        dtau, omega, z_pp, z_mp, g_proj, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node)

    r_f = d_vec[None, :, None] * r_mp
    jm_f = d_vec[None, :] * j_m
    r_f, t_pp, j_p, jm_f = doubling(r_f, t_pp, j_p, jm_f, expk, ndoubl,
                                    eye, rsolve=rsolve)
    r_mp = d_vec[None, :, None] * r_f
    j_m = d_vec[None, :] * jm_f
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    return LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t_pp, t_mm=sgn * t_pp,
                   j_p=j_p, j_m=j_m)


@dataclass(frozen=True)
class CanopyRTInputs:
    """A vegetation canopy slab for rt_run_canopy.

    lai: total leaf-area index of the canopy; split uniformly over
    ``n_layers`` slabs (distinct slabs matter only for in-canopy sensor
    levels — the doubling inside one slab is already exact).
    rho_l/tau_l: leaf hemispherical reflectance/transmittance (set the
    bi-Lambertian phase-function shape and the default single-scattering
    albedo rho_l + tau_l). ``ssa``: optional spectral override of the
    leaf albedo, scalar or (nSpec,) (the hyperspectral knob; the phase
    shape stays from rho_l/tau_l). chi: Ross-Goudriaan leaf-angle
    parameter (0 = spherical LAD, G = 0.5). ``g_override``: fix G(mu)
    to a constant (G = 1 reduces the canopy to a plain atmospheric
    layer with the bi-Lambertian phase — the reduction gate).
    """
    lai: float
    rho_l: float
    tau_l: float
    chi: float = 0.0
    n_layers: int = 1
    ssa: Optional[object] = None
    n_moments: int = 16
    g_override: Optional[float] = None


def rt_run_canopy(pol, quad, band, canopy: CanopyRTInputs, vza, vaz,
                  max_m: int, surface, dtype=torch.float64,
                  device=DEFAULT_DEVICE, solver: str = "lu",
                  sensor_levels: Optional[Sequence[int]] = None):
    """Full canopy scene: atmosphere layers above a vegetation canopy over
    a (bi-)Lambertian soil, with HDRF/BHR outputs and optional in-canopy
    sensor levels, on ``device`` ("cuda" unless the caller asks for
    "cpu").

    ref: src/CoreRT/rt_run_canopy.jl:10-487 — the reference appends one
    CoreDirectionalScatteringOpticalProperties canopy slab below the
    atmospheric layers, runs the same Fourier/layer machinery with
    G-projected attenuation, composes the soil BRDF, and synthesizes
    R/T/hdr/bhr. Here the canopy may be split into n_layers slabs and
    interior interfaces can be observed via the multisensor interlayer
    coupling ((I - R_top R_bot)^{-1}, ref: interlayer_flux.jl:7-25).

    band: atmospheric BandRTInputs ABOVE the canopy (nZ may be 0 for a
    bare canopy scene). surface: soil, same dict as rt_run_band
    (bi-Lambertian soil = LambertianSurfaceScalar).
    sensor_levels: canopy interface indices (0 = canopy top ...
    n_layers = soil top) at which to return (uw, dw) radiance fields.
    ``solver``: "lu" (the default on every device, as in the JAX package)
    or "schulz". Float32 matmuls run in full float32 (TF32 off).

    Returns (R, T, hdr, bhr_uw, bhr_dw[, uw, dw]): R/T/hdr shaped
    (n_vza, n_stokes, nSpec); bhr_* (nSpec,); uw/dw
    (n_sensor, n_vza, n_stokes, nSpec).
    """
    device = resolve_device(device)
    rsolve = make_rsolve(solver)
    n_spec = band.tau.shape[1]
    n_z_atm = band.tau.shape[0]
    n_all = n_z_atm + canopy.n_layers
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)
    geom = geometry(pol, quad, dtype, device)
    albedo, spectral_albedo, is_brdf = surface_inputs(surface, n_spec,
                                                      geom.to_dev)
    sensors = sorted(sensor_levels) if sensor_levels else []
    if not all(0 <= s <= canopy.n_layers for s in sensors):
        raise ValueError(f"sensor levels {sensors} are canopy interface "
                         f"indices 0..{canopy.n_layers}")

    # canopy geometry and optics (spectrally uniform phase, optional spectral
    # ssa) — the reference builds these once per moment from CanopyOptics
    if canopy.g_override is not None:
        g_np = np.full(n, float(canopy.g_override))
    else:
        g_np = ross_g(np.asarray(quad.qp_mu_n), canopy.chi)
    gc_can, ssa_default = bilambertian_greek(canopy.rho_l, canopy.tau_l,
                                             canopy.n_moments)
    ssa_np = np.broadcast_to(np.asarray(
        ssa_default if canopy.ssa is None else canopy.ssa, np.float64),
        (n_spec,)).copy()

    syn = Synthesis(geom, vza, vaz, n_spec, 3)
    syn_sensors = Synthesis(geom, vza, vaz, n_spec, 2, n_sensor=len(sensors))

    with matmul_precision("highest"):
        eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
        g_proj = geom.to_dev(g_np)
        g0 = float(g_proj[quad.i_mu0_n])
        ssa_c = geom.to_dev(ssa_np)
        tau_slab = torch.full((n_spec,), canopy.lai / canopy.n_layers,
                              dtype=dtype, device=device)
        tau_d, omega_d, zw_d = (geom.to_dev(band.tau),
                                geom.to_dev(band.omega),
                                geom.to_dev(band.zw))
        albedo_d = geom.to_dev(albedo)

        # effective (projection-weighted) beam path above each interface
        tau_atm_tot = geom.to_dev(np.asarray(band.tau).sum(axis=0))
        tau_sum_atm = geom.to_dev(np.concatenate(
            [np.zeros((1, n_spec)), np.cumsum(np.asarray(band.tau), axis=0)],
            axis=0))
        lai_above = [g0 * canopy.lai / canopy.n_layers * k
                     for k in range(canopy.n_layers + 1)]
        tau_sum_soil = tau_atm_tot + lai_above[-1]

        for m in range(max_m):
            streams = geom.layer_args(m)
            z_pp_c, z_mp_c = geom.z_moments(band.greeks, m)
            zc_pp, zc_mp = geom.z_moments([gc_can], m)

            def atm_layer(iz):
                z_pp = mix_z(zw_d[iz], z_pp_c)
                z_mp = mix_z(zw_d[iz], z_mp_c)
                return make_added_layer(
                    tau_d[iz], omega_d[iz], z_pp, z_mp, tau_sum_atm[iz],
                    *streams, geom.min_qp_mu, eye, rsolve=rsolve)

            def canopy_layer(k):
                return make_canopy_layer(
                    tau_slab, ssa_c, zc_pp, zc_mp, g_proj,
                    tau_atm_tot + lai_above[k], *streams, geom.min_qp_mu_h,
                    eye, rsolve=rsolve)

            def layer(iz):
                # the atmosphere from TOA, then the canopy slabs
                return (atm_layer(iz) if iz < n_z_atm
                        else canopy_layer(iz - n_z_atm))

            # soil
            rho = (geom.to_dev(brdf_fourier_matrix(surface, quad.qp_mu, m,
                                                   n_stokes))
                   if is_brdf else None)
            surf = surface_layer(geom, m, tau_sum_soil, albedo_d,
                                 spectral_albedo, rho)

            # composites at the soil's top and at each canopy sensor
            tops, bots = segmented_composites(
                layer, n_all, [n_z_atm + s for s in sensors] + [n_all],
                surf, vacuum_layer(n_spec, n, dtype, device), eye, rsolve)
            comp = interaction(tops[n_all], surf, eye, rsolve=rsolve)
            hdr_j_m = (bmv(surf.r_mp, comp.j_p) + surf.j_m).cpu().numpy()

            # --- azimuthal synthesis (same as rt_run_band) ---------------
            j_m = comp.j_m.cpu().numpy()
            j_p = comp.j_p.cpu().numpy()
            syn.add(m, j_m, j_p, hdr_j_m)
            if m == 0:
                syn.add_bhr(hdr_j_m, j_p, tau_sum_soil.cpu().numpy())

            # --- in-canopy sensors: interlayer flux coupling -------------
            # (ref: interlayer_flux.jl:7-25; synthesis as rt_run_band_ms)
            if sensors:
                pairs = [interlayer_flux(tops[n_z_atm + s],
                                         bots[n_z_atm + s], eye, rsolve)
                         for s in sensors]
                syn_sensors.add(
                    m, torch.stack([u for u, _ in pairs]).cpu().numpy(),
                    torch.stack([d for _, d in pairs]).cpu().numpy())
            # free this moment's composites before the next moment's scans
            del tops, bots, comp

    out = syn.outs + list(syn.bhr)
    if sensors:
        out += syn_sensors.outs
    return tuple(out)
