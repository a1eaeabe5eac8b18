"""The port's native HITRAN scanner (vsmartmom_torch/native,
spectroscopy/hitran_native.py), mirroring tests/test_absorption.py:68:
field-exact (no tolerance) against the port's Python parser and against
JAX's read_hitran, under every filter combination, and read_hitran's
engine semantics.
"""
import os

import numpy as np
import pytest

from vsmartmom.spectroscopy.hitran import read_hitran as jax_read_hitran

import vsmartmom_torch.native as native
from vsmartmom_torch.spectroscopy import hitran_native
from vsmartmom_torch.spectroscopy.hitran import (HitranEmptyError,
                                                 read_hitran)

DATA = os.path.join(os.path.dirname(__file__), "data")
CO2_FILE = os.path.join(DATA, "testCO2.par")
HITRAN = os.path.join(os.path.dirname(DATA), "..", "data", "hitran")
NUMERIC = ("mol", "iso", "nu", "sw", "a", "gamma_air", "gamma_self",
           "elower", "n_air", "delta_air", "gp", "gpp")
STRINGS = ("global_upper_quanta", "global_lower_quanta",
           "local_upper_quanta", "local_lower_quanta", "ierr", "iref",
           "line_mixing_flag")


def _same(a, b, what):
    for f in NUMERIC:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      f"{what}: {f}")
    for f in STRINGS:
        assert getattr(a, f) == getattr(b, f), (what, f)


@pytest.mark.parametrize("path,kw", [
    (CO2_FILE, {}), (CO2_FILE, dict(mol=2)), (CO2_FILE, dict(mol=2, iso=1)),
    (CO2_FILE, dict(nu_min=6000, nu_max=6400)),
    (CO2_FILE, dict(mol=2, iso=1, nu_min=6000, nu_max=6400)),
    (CO2_FILE, dict(min_strength=1e-28)),
    (os.path.join(HITRAN, "O2.par"), dict(nu_min=12900, nu_max=13300)),
    (os.path.join(HITRAN, "H2O.par"), {})],
    ids=lambda v: os.path.basename(v) if isinstance(v, str) else str(v))
def test_native_matches_python_and_jax(path, kw):
    nat = read_hitran(path, engine="native", **kw)
    _same(nat, read_hitran(path, engine="python", **kw), "port python")
    _same(nat, jax_read_hitran(path, engine="python", **kw), "JAX")
    _same(read_hitran(path, **kw), nat, "auto")
    assert len(nat) > 0


def test_empty_filter_raises():
    for engine in ("native", "auto", "python"):
        with pytest.raises(HitranEmptyError):
            read_hitran(CO2_FILE, mol=99, engine=engine)


def test_engine_semantics(monkeypatch):
    """The shared object lands in the port's build directory; without a
    working scanner "native" raises and "auto" falls back to Python; an
    unknown engine raises."""
    lib = native.load_native("hitran_parser")
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert os.path.basename(lib._name).startswith("hitran_parser-")

    def broken(name):
        raise OSError("no toolchain")

    monkeypatch.setattr(hitran_native, "load_native", broken)
    with pytest.raises(OSError, match="no toolchain"):
        read_hitran(CO2_FILE, engine="native")
    _same(read_hitran(CO2_FILE), read_hitran(CO2_FILE, engine="python"),
          "auto fallback")
    with pytest.raises(ValueError, match="engine"):
        read_hitran(CO2_FILE, engine="fortran")
