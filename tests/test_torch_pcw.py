"""The port's Wigner tables and PCW decomposition (CPU, float64).

1. The gates of tests/test_scattering.py on the port: Wigner 3j against
   sympy's exact values (rel 1e-9), the table cache round trip, PCW = NAI2
   (ssa and k rel 1e-9, every Greek coefficient series within 1e-8).
2. The port against JAX: the Wigner tables bit for bit, PCW within 1e-12
   of max per Greek series (with tables built on demand and given).
3. The port's NAI2 and PCW each against the reference's PCW fixture
   tests/data/pcw_gold_optics.npz within 1e-6 (no JAX call).
"""
import os

import numpy as np
import pytest

from vsmartmom.scattering.mie import Aerosol as JaxAerosol
from vsmartmom.scattering.pcw import \
    compute_aerosol_optical_properties_pcw as jax_pcw
from vsmartmom.scattering.wigner import \
    compute_wigner_values as jax_wigner_values

from vsmartmom_torch.scattering.mie import Aerosol
from vsmartmom_torch.scattering.nai2 import \
    compute_aerosol_optical_properties
from vsmartmom_torch.scattering.pcw import \
    compute_aerosol_optical_properties_pcw
from vsmartmom_torch.scattering.wigner import (compute_wigner_values,
                                               load_wigner_values,
                                               save_wigner_values, wigner3j)

DATA = os.path.join(os.path.dirname(__file__), "data")
NAMES = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")
SMALL = dict(mu=0.2, sigma=1.8, n_r=1.4, n_i=0.003)


def test_wigner3j_vs_sympy():
    """Wigner 3j (all three PCW configurations) vs sympy's exact values,
    random (m, n, l) up to j = 120."""
    from sympy.physics.wigner import wigner_3j

    rng = np.random.default_rng(7)
    configs = [(-1, 1, 0), (-1, -1, 2), (0, 0, 0)]
    for _ in range(60):
        j2 = int(rng.integers(1, 120))
        j3 = int(rng.integers(0, 120))
        j1 = int(rng.integers(0, j2 + j3 + 2))
        m1, m2, m3 = configs[rng.integers(0, 3)]
        if abs(m3) > j3:
            continue
        truth = float(wigner_3j(j1, j2, j3, m1, m2, m3))
        assert wigner3j(j1, j2, j3, m1, m2, m3) == pytest.approx(
            truth, rel=1e-9, abs=1e-12)


def test_wigner_table_save_load(tmp_path):
    A, B = compute_wigner_values(6)
    path = str(tmp_path / "wigner.npz")
    save_wigner_values(path, A, B)
    A2, B2 = load_wigner_values(path)
    np.testing.assert_array_equal(A, A2)
    np.testing.assert_array_equal(B, B2)


@pytest.mark.parametrize("args", [(6,), (30, 25, 61), (90, 90, 179)])
def test_wigner_tables_match_jax(args):
    for got, want in zip(compute_wigner_values(*args),
                         jax_wigner_values(*args)):
        np.testing.assert_array_equal(got, want)


def test_pcw_matches_nai2():
    """The two independent Mie decompositions agree."""
    aero = Aerosol(**SMALL)
    o_nai2 = compute_aerosol_optical_properties(aero, 0.55, 5.0, 500)
    o_pcw = compute_aerosol_optical_properties_pcw(aero, 0.55, 5.0, 500)
    assert o_pcw.ssa == pytest.approx(o_nai2.ssa, rel=1e-9)
    assert o_pcw.k == pytest.approx(o_nai2.k, rel=1e-9)
    for name in NAMES:
        a = getattr(o_nai2.greek_coefs, name)
        b = getattr(o_pcw.greek_coefs, name)
        n = min(len(a), len(b))
        num = np.linalg.norm(a[:n] - b[:n])
        den = max(np.linalg.norm(b[:n]), 1e-30)
        assert num / den < 1e-8, (name, num / den)


@pytest.fixture(scope="module")
def jax_small():
    return jax_pcw(JaxAerosol(**SMALL), 0.55, 5.0, 500)


@pytest.mark.parametrize("tables", ["built", "given"])
def test_pcw_matches_jax(jax_small, tables):
    kw = {}
    if tables == "given":
        # larger than needed (N_max = 82): the port slices them in blocks
        kw = dict(zip(("wigner_A", "wigner_B"),
                      compute_wigner_values(90, 90, 200)))
    got = compute_aerosol_optical_properties_pcw(Aerosol(**SMALL), 0.55, 5.0,
                                                 500, **kw)
    assert got.ssa == pytest.approx(jax_small.ssa, rel=1e-12)
    assert got.k == pytest.approx(jax_small.k, rel=1e-12)
    for name in NAMES:
        a = getattr(got.greek_coefs, name)
        b = getattr(jax_small.greek_coefs, name)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name


@pytest.mark.parametrize("route", ["nai2", "pcw"])
def test_matches_pcw_gold(route):
    """The reference's stored PCW_AerosolOptics (ref:
    test_Scattering.jl:68-124) at N_max = 381 (761 Greek terms); the PCW
    route builds its Wigner tables a block of degrees at a time."""
    gold = np.load(f"{DATA}/pcw_gold_optics.npz")
    aero = Aerosol(mu=0.3, sigma=6.82, n_r=1.3, n_i=0.001)
    fn = (compute_aerosol_optical_properties if route == "nai2"
          else compute_aerosol_optical_properties_pcw)
    optics = fn(aero, 0.55, 30.0, 2500)
    assert optics.ssa == pytest.approx(float(gold["ssa"]), rel=1e-6)
    assert optics.k == pytest.approx(float(gold["k"]), rel=1e-6)
    for name in NAMES:
        ours = getattr(optics.greek_coefs, name)
        ref = gold[name]
        n = min(len(ours), len(ref))
        num = np.linalg.norm(ours[:n] - ref[:n])
        den = max(np.linalg.norm(ref[:n]), 1e-30)
        assert num / den < 1e-6, (name, num / den)
