"""ctypes binding for the native (C++) HITRAN .par parser (port of
``vsmartmom/spectroscopy/hitran_native.py``).

Fills preallocated numpy columns in one C pass (no per-line Python
objects); field-exact against the pure-Python parser of hitran.py.
read_hitran(engine="auto") falls back to that parser if the toolchain is
unavailable. ref: src/Absorption/read_hitran.jl:14-68.
"""
from __future__ import annotations

import ctypes

import numpy as np

from vsmartmom_torch.native import load_native

# (string-field name, width) in record order; contiguous chars 67..146
_STR_FIELDS = [("global_upper_quanta", 15), ("global_lower_quanta", 15),
               ("local_upper_quanta", 15), ("local_lower_quanta", 15),
               ("ierr", 6), ("iref", 12), ("line_mixing_flag", 1)]
_STRW = sum(w for _, w in _STR_FIELDS)

_SIG = None


def _lib():
    global _SIG
    lib = load_native("hitran_parser")
    if _SIG is None:
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.hitran_parse.restype = ctypes.c_int64
        lib.hitran_parse.argtypes = (
            [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_double, ctypes.c_double, ctypes.c_double]
            + [i32p, i32p] + [f64p] * 10 + [ctypes.c_char_p])
        _SIG = True
    return lib


def read_hitran_native(filepath: str, mol: int = -1, iso: int = -1,
                       nu_min: float = 0.0, nu_max: float = np.inf,
                       min_strength: float = 0.0):
    """Native-parser equivalent of hitran.read_hitran (same HitranTable)."""
    from vsmartmom_torch.spectroscopy.hitran import (HitranEmptyError,
                                                     HitranTable)

    lib = _lib()
    with open(filepath, "rb") as f:
        data = f.read()
    cap = data.count(b"\n") + 1

    mol_a = np.empty(cap, np.int32)
    iso_a = np.empty(cap, np.int32)
    f64 = [np.empty(cap, np.float64) for _ in range(10)]
    str_buf = ctypes.create_string_buffer(cap * _STRW)

    f64p = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in f64]
    n = lib.hitran_parse(
        data, len(data), int(mol), int(iso),
        float(nu_min), float(min(nu_max, np.finfo(np.float64).max)),
        float(min_strength),
        mol_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        iso_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        *f64p, str_buf)
    if n == 0:
        raise HitranEmptyError(
            f"No matching HITRAN records in {filepath} "
            f"(mol={mol}, iso={iso}, nu=[{nu_min}, {nu_max}])")

    raw = np.frombuffer(str_buf, dtype="S1",
                        count=n * _STRW).reshape(n, _STRW)
    strs = {}
    off = 0
    for name, w in _STR_FIELDS:
        col = raw[:, off:off + w].copy().view(f"S{w}").ravel()
        strs[name] = col.astype(f"U{w}").tolist()  # bulk decode, no py loop
        off += w

    (nu, sw, a, gair, gself, el, nair, dair, gp, gpp) = \
        (arr[:n].copy() for arr in f64)
    return HitranTable(
        mol=mol_a[:n].astype(np.int64), iso=iso_a[:n].astype(np.int64),
        nu=nu, sw=sw, a=a, gamma_air=gair, gamma_self=gself, elower=el,
        n_air=nair, delta_air=dair,
        global_upper_quanta=strs["global_upper_quanta"],
        global_lower_quanta=strs["global_lower_quanta"],
        local_upper_quanta=strs["local_upper_quanta"],
        local_lower_quanta=strs["local_lower_quanta"],
        ierr=strs["ierr"], iref=strs["iref"],
        line_mixing_flag=strs["line_mixing_flag"], gp=gp, gpp=gpp)
