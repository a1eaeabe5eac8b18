"""Line-by-line absorption cross-section synthesis, float64 torch sweep
over line chunks (ref: src/Absorption/compute_absorption_cross_section.jl:
19-130), with the wing-cutoff mask around the unshifted line centre.

Physics (HITRAN standard):
  nu* = nu + (p/p_ref) delta_air                      pressure shift
  gamma_L = (g_air (1-vmr) + g_self vmr) p/p_ref (T_ref/T)^n_air
  gamma_D = (sqrt(2 ln2 kB/c^2) ) sqrt(T/m) nu        Doppler HWHM
  S(T) = S_ref Q(T_ref)/Q(T) exp(c2 E''(1/T_ref-1/T))
         (1-exp(-c2 nu/T))/(1-exp(-c2 nu/T_ref))
  sigma(g) += S(T) sqrt(ln2/pi)/gamma_D Re w((sqrt(ln2)/gamma_D)(g-nu*) + i y)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rtbench.reference import tips
from rtbench.reference.cef import CEF_REGISTRY
from rtbench.reference.hitran import HitranTable

# Physical constants (ref: Absorption/constants/constants.jl)
C2 = 1.4387769                 # second radiation constant [cm K]
MASS_MOL = 1.66053873e-27      # amu [kg]
SQRT_LN2_DIV_SQRT_PI = 0.469718639319144059835
LN2 = 0.6931471805599
SQRT_LN2 = 0.8325546111577
SQRT_2LN2 = 1.1774100225
C_LIGHT = 2.99792458e8
K_BOLTZ = 1.3806503e-23
P_REF = 1013.25                # [hPa]
T_REF = 296.0                  # [K]


@dataclasses.dataclass
class HitranModel:
    """Cross-section model computed from HITRAN line data.

    ref: Absorption/types.jl:168-182
    """
    hitran: HitranTable
    broadening: str = "Voigt"          # 'Voigt' | 'Lorentz' | 'Doppler'
    wing_cutoff: float = 40.0          # [cm^-1]
    vmr: float = 0.0                   # used for self-broadening mix
    cef: str = "HumlicekWeidemann32SDErrorFunction"
    # Precomputed per-line static data:
    _weights: Optional[np.ndarray] = None
    _spline_c: Optional[np.ndarray] = None   # (nP, 4, nseg) cubic coeffs
    _spline_x: Optional[np.ndarray] = None   # (nP, nseg+1) breakpoints

    def __post_init__(self):
        ht = self.hitran
        self._weights = np.array([tips.mol_weight(m, i)
                                  for m, i in zip(ht.mol, ht.iso)])
        # TIPS Q(T) cubic-spline coefficients per unique isotopologue,
        # gathered per line so the device evaluation is a gather + poly.
        pairs = sorted({(int(m), int(i)) for m, i in zip(ht.mol, ht.iso)})
        splines = {}
        max_seg = 0
        for (m, i) in pairs:
            sp = tips._tq_spline(m, i)
            splines[(m, i)] = sp
            max_seg = max(max_seg, sp.c.shape[1])
        self._spline_c = np.zeros((len(pairs), 4, max_seg))
        self._spline_x = np.full((len(pairs), max_seg + 1), np.inf)
        for k, (m, i) in enumerate(pairs):
            sp = splines[(m, i)]
            ns = sp.c.shape[1]
            self._spline_c[k, :, :ns] = sp.c
            self._spline_x[k, :ns + 1] = sp.x
            # pad trailing segments with the last breakpoint (T range is
            # validated at call time)
            self._spline_x[k, ns + 1:] = sp.x[-1]
        self._pair_idx = np.array(
            [pairs.index((int(m), int(i)))
             for m, i in zip(ht.mol, ht.iso)])


def make_hitran_model(hitran: HitranTable, broadening: str = "Voigt",
                      wing_cutoff: float = 40.0, vmr: float = 0.0,
                      cef: str = "HumlicekWeidemann32SDErrorFunction"
                      ) -> HitranModel:
    """ref: Absorption/make_model_helpers.jl:25-37"""
    return HitranModel(hitran=hitran, broadening=broadening,
                       wing_cutoff=wing_cutoff, vmr=vmr, cef=cef)


def _eval_spline(c, x, t):
    """Evaluate cubic splines: c (P,4,S), x (P,S+1), t 0-dim tensor.
    Returns (P,) values."""
    n_p, _, n_seg = c.shape
    tt = t.reshape(1, 1).expand(n_p, 1).contiguous()
    i = torch.clamp(torch.searchsorted(x, tt, right=True) - 1, 0, n_seg - 1)
    dt = (t - torch.gather(x, 1, i))[:, 0]
    ck = [torch.gather(c[:, q, :], 1, i)[:, 0] for q in range(4)]
    return ((ck[0] * dt + ck[1]) * dt + ck[2]) * dt + ck[3]


def _xsec_dense(grid, nu, sw, elower, gamma_air, gamma_self, n_air,
                delta_air, weight, pair_idx, spline_c, spline_x, pressure,
                temperature, vmr, wing_cutoff, *, cef_name, broadening,
                chunk=512):
    """Accumulate all line contributions onto the grid (dense engine)."""
    w_fn = CEF_REGISTRY[cef_name]
    dtype = grid.dtype

    # --- per-line parameters (ref lines :73-102) ---
    nu_s = nu + pressure / P_REF * delta_air
    gamma_l = ((gamma_air * (1.0 - vmr) + gamma_self * vmr)
               * pressure / P_REF * (T_REF / temperature) ** n_air)
    gamma_d = ((SQRT_2LN2 / C_LIGHT) * math.sqrt(K_BOLTZ / MASS_MOL)
               * torch.sqrt(temperature) * nu / torch.sqrt(weight))
    y = SQRT_LN2 * gamma_l / gamma_d

    # line strength T-correction with the TIPS partition-sum ratio
    q_t = _eval_spline(spline_c, spline_x, temperature)          # (P,)
    q_ref = _eval_spline(spline_c, spline_x,
                         torch.tensor(T_REF, dtype=dtype, device=grid.device))
    qratio = (q_ref / q_t)[pair_idx]
    s_corr = (qratio
              * torch.exp(C2 * elower * (1.0 / T_REF - 1.0 / temperature))
              * (-torch.expm1(-C2 * nu / temperature))
              / (-torch.expm1(-C2 * nu / T_REF)))
    s = sw * torch.where(elower != -1.0, s_corr, 1.0)

    acc = torch.zeros(grid.shape[0], dtype=dtype, device=grid.device)
    for lo in range(0, nu.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        nu_c, nu0_c, s_c = nu_s[sl], nu[sl], s[sl]
        y_c, gd_c, gl_c = y[sl], gamma_d[sl], gamma_l[sl]
        dx = grid[None, :] - nu_c[:, None]                  # (chunk, nGrid)
        # wing-cutoff window around the UNSHIFTED line center — matches
        # the reference (compute_absorption_cross_section.jl:106-107) and
        # HAPI's bisect bounds; the profile itself is at the shifted center
        mask = torch.abs(grid[None, :] - nu0_c[:, None]) <= wing_cutoff
        if broadening == "Voigt":
            z = torch.complex((SQRT_LN2 / gd_c[:, None]) * dx,
                              y_c[:, None].expand_as(dx))
            prof = (SQRT_LN2_DIV_SQRT_PI / gd_c[:, None]
                    * w_fn(z).real)
        elif broadening == "Lorentz":
            prof = gl_c[:, None] / (math.pi * (gl_c[:, None] ** 2 + dx ** 2))
        else:  # Doppler
            prof = (SQRT_LN2_DIV_SQRT_PI / gd_c[:, None]
                    * torch.exp(-LN2 * (dx / gd_c[:, None]) ** 2))
        acc = acc + torch.where(mask, s_c[:, None] * prof, 0.0).sum(dim=0)
    return acc


def compute_absorption_cross_section(model: HitranModel, grid, pressure,
                                     temperature, device):
    """Cross-section [cm^2/molec] on the wavenumber grid (cm^-1), float64
    on ``device``: the dense sweep, with the wing cutoff around the unshifted
    line centre. ref: compute_absorption_cross_section.jl:19-130"""
    dtype = torch.float64
    grid = np.asarray(grid, dtype=np.float64)
    ht = model.hitran

    # restrict to lines within (grid_min - cutoff, grid_max + cutoff)
    lo = grid.min() - model.wing_cutoff
    hi = grid.max() + model.wing_cutoff
    sel = (ht.nu > lo) & (ht.nu < hi)
    if not np.any(sel):
        return torch.zeros(len(grid), dtype=dtype, device=device)

    # validate the TIPS T range (mirrors the reference assertion)
    for m, i in {(int(a), int(b)) for a, b in zip(ht.mol[sel], ht.iso[sel])}:
        tmin, tmax = tips.tips_t_range(m, i)
        if not (tmin < float(temperature) < tmax):
            raise ValueError(
                f"TIPS2017: T ({float(temperature)}) must be between {tmin} "
                f"K and {tmax} K.")

    def to(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    res = _xsec_dense(
        to(grid), to(ht.nu[sel]), to(ht.sw[sel]), to(ht.elower[sel]),
        to(ht.gamma_air[sel]), to(ht.gamma_self[sel]), to(ht.n_air[sel]),
        to(ht.delta_air[sel]), to(model._weights[sel]),
        torch.as_tensor(model._pair_idx[sel], device=device),
        to(model._spline_c), to(model._spline_x),
        to(pressure), to(temperature), to(model.vmr), to(model.wing_cutoff),
        cef_name=model.cef, broadening=model.broadening)
    return res


