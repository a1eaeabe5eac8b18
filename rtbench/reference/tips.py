"""TIPS-2017 partition sums and isotopologue metadata.

Data: Gamache et al. (2017) total internal partition sums, bundled as npz
(extracted by tools/extract_spectro_data.py).
ref: src/Absorption/constants/TIPS_2017.jl and iso_info helpers.
"""
from __future__ import annotations

import functools
import os

import numpy as np
from scipy.interpolate import CubicSpline

from rtbench.reference import TIPS_DIR as _DATA


@functools.lru_cache(maxsize=1)
def _tips():
    d = np.load(os.path.join(_DATA, "tips2017.npz"))
    return d["tips_t"], d["tips_q"]


@functools.lru_cache(maxsize=1)
def _iso_info():
    return dict(np.load(os.path.join(_DATA, "iso_info.npz")))


@functools.lru_cache(maxsize=512)
def _tq_spline(mol: int, iso: int) -> CubicSpline:
    """Natural cubic spline Q(T) for one isotopologue (mol/iso are 1-based,
    matching HITRAN numbering). Matches the reference's DataInterpolations
    CubicSpline (ref: compute_absorption_cross_section.jl:197-214)."""
    tips_t, tips_q = _tips()
    tt = tips_t[mol - 1, iso - 1]
    qq = tips_q[mol - 1, iso - 1]
    end = np.argmax(tt == -1) if (tt == -1).any() else len(tt)
    if end < 2:
        raise ValueError(f"No TIPS data for mol={mol}, iso={iso}")
    return CubicSpline(tt[:end], qq[:end], bc_type="natural")


def tips_t_range(mol: int, iso: int):
    tips_t, _ = _tips()
    tt = tips_t[mol - 1, iso - 1]
    end = np.argmax(tt == -1) if (tt == -1).any() else len(tt)
    return float(tt[0]), float(tt[end - 1])


def mol_weight(mol: int, iso: int) -> float:
    """Isotopologue molecular weight [g/mol] (1-based HITRAN numbering)."""
    w = float(_iso_info()["mol_weight"][mol - 1, iso - 1])
    if w == -1:
        raise ValueError(f"No matching (mol={mol}, iso={iso}) pair")
    return w
