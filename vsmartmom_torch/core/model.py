"""model_from_parameters: derive all simulation state from RTParameters.

ref: src/CoreRT/tools/model_from_parameters.jl:12-194

The model is host data (numpy). ``device`` only chooses where the
line-by-line absorption is computed (the Voigt kernel on CUDA, the dense
f64 engine on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from vsmartmom_torch.config.params import (AbsorptionParameters, AerosolSpec,
                                           RTParameters,
                                           ScatteringParameters)
from vsmartmom_torch.core.atmosphere import (AtmosphericProfile,
                                             aerosol_layer_tau_gaussian,
                                             aerosol_layer_tau_uniform,
                                             compute_atmos_profile_fields,
                                             rayleigh_layer_tau,
                                             reduce_profile)
from vsmartmom_torch.scattering.nai2 import AerosolOptics
from vsmartmom_torch.scattering.phase import (GreekCoefs, Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device
from vsmartmom_torch.util.logging import logger
from vsmartmom_torch.util.quadrature import QuadPoints, rt_set_streams


@dataclasses.dataclass
class ObsGeometry:
    sza: float
    vza: np.ndarray
    vaz: np.ndarray
    obs_alt: float


@dataclasses.dataclass
class RTModel:
    """Derived model state (ref: vSmartMOM_Model, types.jl:478-...).

    tau_abs[i_band]:  (nSpec, nZ) gas absorption optical depth
    tau_rayl[i_band]: (nSpec, nZ) Rayleigh scattering optical depth
    tau_aer[i_band]:  (nAer, nZ) aerosol extinction optical depth
    aerosol_optics[i_band][i_aer]: AerosolOptics (Greek coefs, ssa, k, f_t)
    """
    params: RTParameters
    aerosol_optics: List[list]
    greek_rayleigh: GreekCoefs
    quad_points: QuadPoints
    tau_abs: List[np.ndarray]
    tau_rayl: List[np.ndarray]
    tau_aer: List[np.ndarray]
    obs_geom: ObsGeometry
    profile: AtmosphericProfile
    pol: Polarization

    def __repr__(self):          # ref: show_utils.jl Base.show overload
        from vsmartmom_torch.util.show import describe_model
        return describe_model(self)


def model_from_parameters(params: RTParameters,
                          device=DEFAULT_DEVICE) -> RTModel:
    """Build the model: streams, profile, Rayleigh, line-by-line
    absorption (on ``device``: "cuda" unless the caller asks for "cpu") and
    the δ-BGE-truncated NAI2 aerosols.

    YAML ``LUTfiles`` are parsed and not used, as in the JAX package
    (vsmartmom/core/model.py:80-87): absorption is line by line, and one
    warning names the ignored files."""
    device = resolve_device(device)
    n_bands = len(params.spec_bands)
    n_aer = (0 if params.scattering_params is None
             else len(params.scattering_params.rt_aerosols))

    obs_geom = ObsGeometry(params.sza, params.vza, params.vaz, params.obs_alt)
    pol = Polarization.from_name(params.polarization_type)
    quad_points = rt_set_streams(params.quadrature_type, params.l_trunc,
                                 params.sza, params.vza, pol.n)

    vmr = ({} if params.absorption_params is None
           else params.absorption_params.vmr)
    profile = compute_atmos_profile_fields(params.T, params.p, params.q, vmr)
    if params.profile_reduction != -1:
        profile = reduce_profile(params.profile_reduction, profile)

    greek_rayleigh = get_greek_rayleigh(params.depol)

    if params.absorption_params is not None \
            and params.absorption_params.luts:
        logger.warning(
            "absorption LUTfiles are ignored (line-by-line absorption "
            "instead): %s", params.absorption_params.luts)

    tau_rayl = []
    tau_abs = []
    for i_band, band in enumerate(params.spec_bands):
        lam_um = 1e4 / band
        tau_rayl.append(rayleigh_layer_tau(
            float(profile.p_half[-1]), lam_um, params.depol, profile.vcd_dry))
        ta = np.zeros((len(band), profile.n_layers))
        if params.absorption_params is not None:
            from vsmartmom_torch.spectroscopy.profiles import \
                compute_absorption_profile
            ap = params.absorption_params
            for mol in ap.molecules[i_band]:
                compute_absorption_profile(
                    ta, mol, ap, band, profile.vmr[mol], profile,
                    device=device)
        tau_abs.append(ta)

    aerosol_optics = [[None] * n_aer for _ in range(n_bands)]
    tau_aer = [np.zeros((n_aer, profile.n_layers)) for _ in range(n_bands)]
    if n_aer > 0:
        from vsmartmom_torch.scattering.nai2 import (
            compute_aerosol_optical_properties, compute_ref_aerosol_extinction)
        from vsmartmom_torch.scattering.truncation import truncate_phase
        sp = params.scattering_params
        for i_aer, aero in enumerate(sp.rt_aerosols):
            k_ref = compute_ref_aerosol_extinction(
                aero, sp.lambda_ref, sp.n_ref, sp.r_max, sp.nquad_radius)
            for i_band, band in enumerate(params.spec_bands):
                lam_um = 1e4 / band
                lam_c = 0.5 * (lam_um.max() + lam_um.min())
                optics_raw = compute_aerosol_optical_properties(
                    aero, lam_c, sp.r_max, sp.nquad_radius, pol)
                optics = truncate_phase(optics_raw, params.l_trunc,
                                        params.delta_angle)
                aerosol_optics[i_band][i_aer] = optics
                if getattr(aero, "profile_type", "gaussian") == "uniform":
                    vert = aerosol_layer_tau_uniform(1.0, aero.p0, aero.p_hi,
                                                     profile)
                else:
                    vert = aerosol_layer_tau_gaussian(1.0, aero.p0,
                                                      aero.sigma_p, profile)
                tau_aer[i_band][i_aer, :] = (
                    aero.tau_ref * (optics.k / k_ref) * vert)

        # AOD report (ref: model_from_parameters.jl:164 @info)
        from vsmartmom_torch.util.logging import aod_report
        for i_band in range(n_bands):
            aod_report([f"aerosol[{i}]" for i in range(n_aer)],
                       tau_aer[i_band], band_label=f"band {i_band}")

    return RTModel(params=params, aerosol_optics=aerosol_optics,
                   greek_rayleigh=greek_rayleigh, quad_points=quad_points,
                   tau_abs=tau_abs, tau_rayl=tau_rayl, tau_aer=tau_aer,
                   obs_geom=obs_geom, profile=profile, pol=pol)


def _fields(obj, cls, **override):
    """Instance of dataclass ``cls`` from ``obj``'s same-named attributes."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if f.name not in override}
    return cls(**kw, **override)


def _arr(x):
    return np.array(x, dtype=np.float64)


def _greek(gc) -> GreekCoefs:
    return GreekCoefs(*(_arr(getattr(gc, f)) for f in
                        ("alpha", "beta", "gamma", "delta", "epsilon",
                         "zeta")))


def model_from_arrays(m) -> RTModel:
    """The port's RTModel from another RTModel-shaped object (the JAX
    package's, read by attribute only): parameters, optical depths, aerosol
    optics, streams, profile, polarization and geometry, as numpy copies.
    Lets the port's RT run on exactly another build's model."""
    p = m.params
    ap = p.absorption_params
    sp = p.scattering_params
    params = _fields(
        p, RTParameters,
        absorption_params=(None if ap is None else _fields(
            ap, AbsorptionParameters)),
        scattering_params=(None if sp is None else _fields(
            sp, ScatteringParameters,
            rt_aerosols=[_fields(a, AerosolSpec) for a in sp.rt_aerosols])))
    optics = [[None if o is None else AerosolOptics(
        greek_coefs=_greek(o.greek_coefs), ssa=float(o.ssa), k=float(o.k),
        f_t=float(o.f_t)) for o in band] for band in m.aerosol_optics]
    q = m.quad_points
    quad = QuadPoints(mu0=float(q.mu0), i_mu0=int(q.i_mu0),
                      i_mu0_n=int(q.i_mu0_n), qp_mu=_arr(q.qp_mu),
                      wt_mu=_arr(q.wt_mu), qp_mu_n=_arr(q.qp_mu_n),
                      wt_mu_n=_arr(q.wt_mu_n), n_quad=int(q.n_quad))
    pol = Polarization(int(m.pol.n), _arr(m.pol.d), _arr(m.pol.i0),
                       str(m.pol.name))
    return RTModel(
        params=params, aerosol_optics=optics,
        greek_rayleigh=_greek(m.greek_rayleigh), quad_points=quad,
        tau_abs=[_arr(t) for t in m.tau_abs],
        tau_rayl=[_arr(t) for t in m.tau_rayl],
        tau_aer=[_arr(t) for t in m.tau_aer],
        obs_geom=_fields(m.obs_geom, ObsGeometry),
        profile=_fields(m.profile, AtmosphericProfile), pol=pol)
