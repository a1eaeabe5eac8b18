"""User-facing rt_run on an RTModel (mirrors the reference's entry point).

ref: src/CoreRT/rt_run.jl:19-230 and
     src/CoreRT/LayerOpticalProperties/compEffectiveLayerProperties.jl
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from vsmartmom_torch.core.brdf import legendre_spectral_albedo
from vsmartmom_torch.core.model import RTModel
from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.inelastic import make_rrs_profile, make_vs
from vsmartmom_torch.util.device import DEFAULT_DEVICE
from vsmartmom_torch.util.timing import timeit


def build_band_inputs(model: RTModel, i_band: int,
                      omega_cabannes: float = 1.0) -> BandRTInputs:
    """Mix Rayleigh + aerosols + gas absorption into core layer optical
    properties (tau, omega, component mixing weights).

    ref: compEffectiveLayerProperties.jl:1-85 (constructCoreOpticalProperties
    + createAero). The delta-BGE-truncated aerosols enter with
    tau' = (1 - f_t * ssa) tau and ssa' = (1 - f_t) ssa / (1 - f_t * ssa).
    """
    tau_rayl = model.tau_rayl[i_band]          # (nSpec, nZ)
    tau_abs = model.tau_abs[i_band]            # (nSpec, nZ)
    tau_aer = model.tau_aer[i_band]            # (nAer, nZ)
    n_spec, n_z = tau_rayl.shape
    n_aer = tau_aer.shape[0]

    # scattering components: Rayleigh first, then aerosols
    scat = np.zeros((n_z, 1 + n_aer, n_spec))
    scat[:, 0, :] = (tau_rayl * omega_cabannes).T
    tau_total = tau_rayl.T.copy()              # (nZ, nSpec)
    greeks = [model.greek_rayleigh]
    for i in range(n_aer):
        optics = model.aerosol_optics[i_band][i]
        f_t, ssa = optics.f_t, optics.ssa
        tau_mod = (1.0 - f_t * ssa) * tau_aer[i]        # (nZ,)
        ssa_mod = (1.0 - f_t) * ssa / (1.0 - f_t * ssa)
        tau_total += tau_mod[:, None]
        scat[:, 1 + i, :] = (tau_mod * ssa_mod)[:, None]
        greeks.append(optics.greek_coefs)
    tau_total += tau_abs.T

    scat_sum = scat.sum(axis=1)                          # (nZ, nSpec)
    omega = scat_sum / tau_total
    with np.errstate(invalid="ignore", divide="ignore"):
        zw = np.where(scat_sum[:, None, :] > 0,
                      scat / np.maximum(scat_sum[:, None, :], 1e-300), 0.0)
    return BandRTInputs(tau=tau_total, omega=omega, zw=zw, greeks=greeks)


def band_spec_lim(model: RTModel, bands: Sequence[int]):
    """Index ranges of each band on the concatenated spectral axis.

    ref: the reference's bandSpecLim bookkeeping (rt_run.jl:66-74,
    types.jl:665-670). Returns a list of ``slice`` objects.
    """
    lims, lo = [], 0
    for ib in bands:
        n = len(model.params.spec_bands[ib])
        lims.append(slice(lo, lo + n))
        lo += n
    return lims


def concat_band_inputs(model: RTModel, bands: Sequence[int]) -> BandRTInputs:
    """Concatenate several bands onto ONE spectral axis.

    ref: the reference's ``*`` band-concatenation operator on
    CoreScatteringOpticalProperties (types.jl:665-687) + bandSpecLim.
    Aerosol optics are wavelength-dependent, so each band contributes its
    own Z components (K = 1 Rayleigh + the aerosols of every band); their
    mixing-weight rows are zero outside the band's spectral range, which
    keeps the on-device Z assembly exact.
    """
    parts = [build_band_inputs(model, ib) for ib in bands]
    n_z = parts[0].tau.shape[0]
    n_specs = [p.tau.shape[1] for p in parts]

    tau = np.concatenate([p.tau for p in parts], axis=1)
    omega = np.concatenate([p.omega for p in parts], axis=1)

    # shared Rayleigh row + per-band aerosol component rows
    greeks = [parts[0].greeks[0]]
    k_tot = 1 + sum(len(p.greeks) - 1 for p in parts)
    zw = np.zeros((n_z, k_tot, sum(n_specs)))
    k = 1
    lo = 0
    for p, n_s in zip(parts, n_specs):
        zw[:, 0, lo:lo + n_s] = p.zw[:, 0, :]
        n_aer = len(p.greeks) - 1
        zw[:, k:k + n_aer, lo:lo + n_s] = p.zw[:, 1:, :]
        greeks.extend(p.greeks[1:])
        k += n_aer
        lo += n_s
    return BandRTInputs(tau=tau, omega=omega, zw=zw, greeks=greeks)


def _band_surface(model: RTModel, ib: int):
    """Band ``ib``'s surface; the last one is reused when fewer surfaces
    are given than bands (the reference's VS configurations do this)."""
    surfaces = model.params.surfaces
    return surfaces[min(ib, len(surfaces) - 1)]


def _concat_surface(model: RTModel, bands: Sequence[int]):
    """Surface for the band-concatenated run: per-band Lambertian surfaces
    merge into one spectral-albedo vector; identical BRDF surfaces across
    every band pass through unchanged (their Fourier rho matrices are
    spectrally constant, so the concatenated axis is transparent to them).
    Returns None when bands mix BRDF types or parameters (per-band runs).
    """
    per_band = [_band_surface(model, ib) for ib in bands]
    if any(s["type"] in ("rpvSurfaceScalar", "RossLiSurfaceScalar")
           for s in per_band):
        if all(s == per_band[0] for s in per_band[1:]):
            return per_band[0]
        return None
    chunks = []
    for ib, s in zip(bands, per_band):
        n_s = len(model.params.spec_bands[ib])
        if s["type"] == "LambertianSurfaceScalar":
            chunks.append(np.full(n_s, float(s["albedo"])))
        elif s["type"] == "LambertianSurfaceSpectrum":
            chunks.append(np.asarray(s["albedo"], np.float64))
        elif s["type"] == "LambertianSurfaceLegendre":
            chunks.append(legendre_spectral_albedo(s["legendre_coeff"], n_s))
        else:
            return None
    return {"type": "LambertianSurfaceSpectrum",
            "albedo": np.concatenate(chunks)}


#: string rs_type values of rt_run besides None / "noRS" (elastic)
RS_TYPES = ("RRS", "VS_0to1", "VS_1to0")


def _raman_specs(model: RTModel, ib: int, rs_type):
    """Inelastic coupling specs of band ``ib`` for ``rs_type``."""
    if not isinstance(rs_type, str):
        return list(rs_type) if isinstance(rs_type, (list, tuple)) \
            else [rs_type]
    grid = np.asarray(model.params.spec_bands[ib], np.float64)
    if rs_type == "RRS":
        # per-layer temperature weights (ref: raman_atmo_prop.jl builds
        # Raman properties from each layer's T)
        return [make_rrs_profile(grid, model.profile.T)]
    return make_vs(grid, T=float(np.mean(model.profile.T)),
                   direction=rs_type[3:])


def rt_run(model: RTModel, i_band: Union[int, Sequence[int]] = 0,
           dtype=None, rs_type=None, device=DEFAULT_DEVICE,
           engine: str = "auto", matmul_precision: str = "highest",
           dd_precision=None, ie_precision: str = "highest"):
    """Run the forward RT simulation for band(s) ``i_band`` on ``device``
    ("cuda" unless the caller asks for "cpu").

    ``rs_type`` selects inelastic (Raman) coupling, mirroring the
    reference's rt_run(RS_type, model, iBand) dispatch (ref:
    rt_run.jl:19-41):
      None or "noRS"         — elastic only; returns (R_SFI, T_SFI)
      "RRS"                  — rotational Raman with each layer's
                               temperature, built for each band's grid
      "VS_0to1" / "VS_1to0"  — vibrational Raman groups on each band's grid
                               at the profile's mean temperature
      an inelastic spec / list of specs (RRS / AbsoluteRaman) — used as-is
    With Raman, returns (R_SFI, T_SFI, ieR_SFI, ieT_SFI): the elastic
    (Cabannes) radiances plus first-order Raman corrections
    (core/rt_raman.py), one run per band.

    Shapes (n_vza, n_stokes, nSpec). Several elastic bands are concatenated
    along the spectral axis (ref: bandSpecLim bookkeeping in
    rt_run.jl:66-74; band_spec_lim gives each band's slice): when every
    band's surface merges (_concat_surface), one rt_run_band runs over the
    concatenated axis, otherwise one per band; Raman outputs are
    concatenated per band. ``dtype`` defaults to the parameters'
    float_type. ``engine`` is passed to rt_run_band ("auto" or one of
    core.rt_run.ENGINES); the Raman path has one engine, torch ops, and
    raises ValueError for any other than "auto". ``matmul_precision`` and
    ``dd_precision`` go to rt_run_band (core/precision.py); the Raman path
    keeps its elastic products in full precision, as the JAX package pins
    them, and raises ValueError for any other matmul_precision.
    ``ie_precision``: the Raman ie products' mode (core/rt_raman.py:
    bmm_ie).
    """
    elastic_only = rs_type is None or rs_type == "noRS"
    if not elastic_only:
        if isinstance(rs_type, str) and rs_type not in RS_TYPES:
            raise ValueError(f"unknown rs_type {rs_type!r}: expected "
                             f"None, 'noRS', one of {RS_TYPES} or "
                             f"coupling specs")
        if engine != "auto":
            raise ValueError(f"engine {engine!r} with rs_type {rs_type!r}: "
                             f"the Raman path runs torch ops only (engine "
                             f"'auto')")
        if matmul_precision != "highest" or dd_precision is not None:
            raise ValueError("the Raman path's elastic products run in full "
                             "precision: set ie_precision")
    if dtype is None:
        dtype = (torch.float32 if model.params.float_type == "Float32"
                 else torch.float64)
    bands = [i_band] if isinstance(i_band, int) else list(i_band)

    def run(band, surface):
        return rt_run_band(model.pol, model.quad_points, band,
                           model.obs_geom.vza, model.obs_geom.vaz,
                           model.params.max_m, surface, dtype=dtype,
                           device=device, engine=engine,
                           matmul_precision=matmul_precision,
                           dd_precision=dd_precision)

    def run_raman(ib):
        specs = _raman_specs(model, ib, rs_type)
        cab = min((getattr(s, "omega_cabannes", 1.0) for s in specs),
                  default=1.0)
        with timeit("band_inputs"):
            band = build_band_inputs(model, ib, omega_cabannes=cab)
        # Raman source strength: full Rayleigh fraction of the layer
        f_rayl = model.tau_rayl[ib].T / np.maximum(band.tau, 1e-300)
        return rt_run_band_rrs(
            model.pol, model.quad_points, band, specs, f_rayl,
            model.obs_geom.vza, model.obs_geom.vaz, model.params.max_m,
            _band_surface(model, ib), dtype=dtype, device=device,
            ie_precision=ie_precision)

    with timeit("rt_run"):
        if not elastic_only:
            outs = [run_raman(ib) for ib in bands]
        else:
            if len(bands) > 1:
                surface = _concat_surface(model, bands)
                if surface is not None:
                    with timeit("band_inputs"):
                        band = concat_band_inputs(model, bands)
                    return run(band, surface)
            outs = []
            for ib in bands:
                with timeit("band_inputs"):
                    band = build_band_inputs(model, ib)
                outs.append(run(band, _band_surface(model, ib)))
        return tuple(np.concatenate([o[i] for o in outs], axis=-1)
                     for i in range(len(outs[0])))
