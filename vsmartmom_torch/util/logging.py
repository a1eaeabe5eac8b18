"""Run observability: the run banner, the aerosol AOD report, progress.

ref: the reference's Julia @info run banner (rt_run.jl:99-106: geometry +
array dims), the per-aerosol AOD report (model_from_parameters.jl:164) and
ProgressMeter.@showprogress on host loops (rt_run.jl:142). Messages go to
the ``vsmartmom_torch`` logger (stderr, INFO); silence them with the
standard ``logging`` configuration. Progress bars are drawn on an
interactive stream only, so batch logs stay clean.
"""
from __future__ import annotations

import logging
import sys
import time

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


class progress:
    """Minimal @showprogress for host loops: ``for iz in progress(range(
    n_z), "layers"): ...`` yields the items of ``iterable`` and draws a
    carriage-return bar on ``stream`` (default stderr) when it is a
    terminal and the iterable has a length."""

    def __init__(self, iterable, label: str = "", stream=None):
        self.it = iterable
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.n = len(iterable) if hasattr(iterable, "__len__") else None

    def __iter__(self):
        interactive = bool(self.n) and hasattr(self.stream, "isatty") \
            and self.stream.isatty()
        t0 = time.perf_counter()
        for i, x in enumerate(self.it):
            yield x
            if interactive:
                bar = "=" * int(40 * (i + 1) / self.n)
                self.stream.write(
                    f"\r{self.label} [{bar:<40}] {i + 1}/{self.n} "
                    f"({time.perf_counter() - t0:.1f}s)")
                self.stream.flush()
        if interactive:
            self.stream.write("\n")
