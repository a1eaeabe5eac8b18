"""Cross-section look-up tables: build, save/load, interpolate.

Port of ``vsmartmom/spectroscopy/lut.py`` (ref:
src/Absorption/make_model_helpers.jl:55-110, make_interpolation_model and
its save/load, here as npz; compute_absorption_cross_section.jl's
InterpolationModel path).

The sigma(nu, p, T) cube is interpolated with cubic B-splines on the
(uniform) build grids, as the reference's
``BSpline(Cubic(Line(OnGrid())))``: prefiltered coefficients at build time,
order-3 evaluation by scipy.ndimage in index space. Trilinear
interpolation remains for grids of fewer than four points and for files
saved without a method. Host numpy throughout; the npz format is the JAX
package's, so a table saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy import ndimage
from scipy.interpolate import RegularGridInterpolator

from vsmartmom_torch.spectroscopy.voigt import (
    HitranModel, compute_absorption_cross_section)
from vsmartmom_torch.util.device import DEFAULT_DEVICE


@dataclasses.dataclass
class InterpolationModel:
    """sigma(nu, p, T) cube with cubic-B-spline (default) or trilinear
    interpolation. ref: Absorption/types.jl:193-211."""
    sigma: np.ndarray          # (n_nu, n_p, n_t)
    nu_grid: np.ndarray
    p_grid: np.ndarray
    t_grid: np.ndarray
    mol: int = -1
    iso: int = -1
    method: str = "cubic"      # "cubic" | "linear"

    def __post_init__(self):
        grids = (self.nu_grid, self.p_grid, self.t_grid)
        if self.method == "cubic" and all(len(g) >= 4 for g in grids):
            self._coef = ndimage.spline_filter(self.sigma, order=3,
                                               mode="nearest")
            self._itp = None
        else:
            self.method = "linear"
            self._itp = RegularGridInterpolator(
                grids, self.sigma, bounds_error=False, fill_value=None)

    @staticmethod
    def _frac_index(x, grid):
        """Physical coordinate -> fractional grid index (clamped)."""
        x = np.clip(np.asarray(x, np.float64), grid[0], grid[-1])
        return np.interp(x, grid, np.arange(len(grid), dtype=np.float64))

    def __call__(self, grid, pressure, temperature):
        grid = np.asarray(grid, dtype=np.float64)
        if self.method == "cubic":
            coords = np.stack([
                self._frac_index(grid, self.nu_grid),
                np.full(len(grid), self._frac_index(pressure, self.p_grid)),
                np.full(len(grid),
                        self._frac_index(temperature, self.t_grid))])
            return ndimage.map_coordinates(self._coef, coords, order=3,
                                           prefilter=False, mode="nearest")
        pts = np.stack([grid, np.full(len(grid), pressure),
                        np.full(len(grid), temperature)], axis=-1)
        return self._itp(pts)


def make_interpolation_model(hitran_model: HitranModel, nu_grid, p_grid,
                             t_grid, method: str = "cubic",
                             device=DEFAULT_DEVICE) -> InterpolationModel:
    """Precompute the sigma(nu, p, T) cube from a HitranModel with the
    dense f64 engine on ``device`` ("cuda" unless the caller asks for
    "cpu"). ref: make_model_helpers.jl:55-99"""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    p_grid = np.asarray(p_grid, dtype=np.float64)
    t_grid = np.asarray(t_grid, dtype=np.float64)
    cube = np.zeros((len(nu_grid), len(p_grid), len(t_grid)))
    for ip, p in enumerate(p_grid):
        for it, t in enumerate(t_grid):
            cube[:, ip, it] = compute_absorption_cross_section(
                hitran_model, nu_grid, p, t, device=device).cpu().numpy()
    ht = hitran_model.hitran
    return InterpolationModel(sigma=cube, nu_grid=nu_grid, p_grid=p_grid,
                              t_grid=t_grid, mol=int(ht.mol[0]),
                              iso=int(ht.iso[0]), method=method)


def save_interpolation_model(model: InterpolationModel, path: str):
    """ref: make_model_helpers.jl:101-105 (JLD2 -> npz)"""
    np.savez_compressed(path, sigma=model.sigma, nu_grid=model.nu_grid,
                        p_grid=model.p_grid, t_grid=model.t_grid,
                        mol=model.mol, iso=model.iso,
                        method=np.asarray(model.method))


def load_interpolation_model(path: str) -> InterpolationModel:
    """ref: make_model_helpers.jl:107-110"""
    d = np.load(path)
    method = str(d["method"]) if "method" in d.files else "linear"
    return InterpolationModel(sigma=d["sigma"], nu_grid=d["nu_grid"],
                              p_grid=d["p_grid"], t_grid=d["t_grid"],
                              mol=int(d["mol"]), iso=int(d["iso"]),
                              method=method)
