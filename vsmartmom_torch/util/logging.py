"""Run observability: the run banner and the aerosol AOD report.

ref: the reference's Julia @info run banner (rt_run.jl:99-106: geometry +
array dims) and the per-aerosol AOD report (model_from_parameters.jl:164).
Messages go to the ``vsmartmom_torch`` logger (stderr, INFO); silence them
with the standard ``logging`` configuration.
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("vsmartmom_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[vsmartmom_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def run_banner(pol, quad, n_spec: int, n_z: int, max_m: int, surface,
               engine: str, solver: str, dtype, device):
    """One-line run description (ref: rt_run.jl:99-106 @info banner)."""
    logger.info(
        "rt_run: %s, Nquad=%d (N=%d), nSpec=%d, nZ=%d, max_m=%d, "
        "sza=%.2f deg, surface=%s, engine=%s/%s, %s on %s",
        getattr(pol, "name", pol), quad.n_quad, len(quad.qp_mu_n), n_spec,
        n_z, max_m, float(np.degrees(np.arccos(quad.mu0))),
        surface.get("type", "?"), engine, solver,
        str(dtype).replace("torch.", ""), device)


def aod_report(aerosol_names, tau_aer, band_label=""):
    """Per-aerosol column optical depth (ref: model_from_parameters.jl:164
    '@info AOD at reference wavelength')."""
    for name, tau in zip(aerosol_names, tau_aer):
        logger.info("aerosol %s%s: column AOD = %.4f", name,
                    f" ({band_label})" if band_label else "",
                    float(np.sum(tau)))

