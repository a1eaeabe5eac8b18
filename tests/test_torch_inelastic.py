"""The port's inelastic (Raman) builders against the JAX package's, and the
reference's Raman physics gates on the port alone.

The builders are host numpy in both packages: the same inputs give the same
line sets, shift rows, weights and Cabannes fractions to rtol 1e-12.
"""
import dataclasses
import types

import numpy as np
import pytest

import vsmartmom.inelastic
from vsmartmom.core.rt_raman import build_coupling as jax_build_coupling
from vsmartmom.inelastic.constants import g_nuclear as jax_g_nuclear
from vsmartmom.inelastic.rrs import make_rrs_profile as jax_make_rrs_profile

import vsmartmom_torch.inelastic as tin
from vsmartmom_torch.core.rt_raman import build_coupling
from vsmartmom_torch.inelastic.constants import g_nuclear

# the JAX package exports make_rrs_profile from inelastic.rrs only
jin = types.SimpleNamespace(**vars(vsmartmom.inelastic),
                            make_rrs_profile=jax_make_rrs_profile)
RTOL = 1e-12
O2_BAND = np.arange(12903.2, 13245.0, 2.0)   # O2Parameters.yaml, 2 cm^-1
UV_GRID = np.arange(20500.0, 20530.0, 1.0)
RRS_GRID = np.arange(12740.0, 13268.0, 6.0)
VS_GRID = np.arange(10500.0, 13300.0, 20.0)


def _same(a, b, path="spec"):
    """Recursive equality of builder outputs (dataclasses, lists, arrays,
    numbers), floats to RTOL."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, str) or a is None:
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=path)


@pytest.mark.parametrize("species", ["N2", "O2", "H2"])
def test_molecular_constants_match(species):
    mol = tin.molecular_constants(species, 0.2)
    jmol = jin.molecular_constants(species, 0.2)
    _same(mol, jmol)
    _same(tin.energy_levels(mol, 2, 30), jin.energy_levels(jmol, 2, 30))
    j = np.arange(31)
    _same(g_nuclear(mol, j), jax_g_nuclear(jmol, j))
    with pytest.raises(ValueError):
        tin.molecular_constants(species, 1.5)


@pytest.mark.parametrize("T", [210.0, 250.0, 295.0])
@pytest.mark.parametrize("species", ["N2", "O2"])
def test_raman_lines_match(species, T):
    mol = tin.molecular_constants(species, 0.5)
    jmol = jin.molecular_constants(species, 0.5)
    _same(tin.rotational_raman_lines(mol, 13000.0, T, 30),
          jin.rotational_raman_lines(jmol, 13000.0, T, 30))
    for direction in ("0to1", "1to0"):
        _same(tin.vibrational_raman_lines(mol, 25000.0, T, direction, 20),
              jin.vibrational_raman_lines(jmol, 25000.0, T, direction, 20))
    lines = [tin.rotational_raman_lines(tin.molecular_constants(s, v),
                                        13000.0, T) for s, v in
             (("N2", 0.79), ("O2", 0.21))]
    jlines = [jin.rotational_raman_lines(jin.molecular_constants(s, v),
                                         13000.0, T) for s, v in
              (("N2", 0.79), ("O2", 0.21))]
    _same(tin.cabannes_fraction(lines, [0.79, 0.21], 13000.0),
          jin.cabannes_fraction(jlines, [0.79, 0.21], 13000.0))
    _same(tin.rayleigh_depol(lines, [0.79, 0.21]),
          jin.rayleigh_depol(jlines, [0.79, 0.21]))


@pytest.mark.parametrize("grid", [O2_BAND, UV_GRID, RRS_GRID],
                         ids=["o2", "uv", "rrs"])
def test_make_rrs_matches(grid):
    _same(tin.make_rrs(grid, T=250.0), jin.make_rrs(grid, T=250.0))
    _same(tin.make_rrs(grid, T=231.0, vmr_n2=0.8, vmr_o2=0.2, j_max=20),
          jin.make_rrs(grid, T=231.0, vmr_n2=0.8, vmr_o2=0.2, j_max=20))
    _same(tin.greek_raman_coefs(0.3), jin.greek_raman_coefs(0.3))


def test_make_rrs_profile_matches():
    t_layers = [231.6, 258.1, 272.6, 239.2, 221.1]
    _same(tin.make_rrs_profile(O2_BAND, t_layers),
          jin.make_rrs_profile(O2_BAND, t_layers))


@pytest.mark.parametrize("direction", ["0to1", "1to0"])
def test_make_vs_matches(direction):
    specs = tin.make_vs(VS_GRID, T=250.0, direction=direction)
    _same(specs, jin.make_vs(VS_GRID, T=250.0, direction=direction))
    assert specs


def test_make_plus_matches():
    grids = [np.arange(12740.0, 13180.0, 8.0),
             np.arange(14300.0, 14740.0, 8.0)]
    _same(tin.make_rrs_plus(grids, T=250.0, j_max=16),
          jin.make_rrs_plus(grids, T=250.0, j_max=16))
    for direction in ("0to1", "1to0"):
        _same(tin.make_vs_plus(25000.0, T=250.0, direction=direction,
                               dnu=4.0, margin=4.0, j_max=12),
              jin.make_vs_plus(25000.0, T=250.0, direction=direction,
                               dnu=4.0, margin=4.0, j_max=12))
    _same(tin.make_rvrs_plus(25000.0, T=250.0, dnu=4.0, margin=4.0,
                             j_max=12, rrs_dnu=2.0),
          jin.make_rvrs_plus(25000.0, T=250.0, dnu=4.0, margin=4.0,
                             j_max=12, rrs_dnu=2.0))


def _coupling_cases():
    grids = [np.arange(12740.0, 13180.0, 8.0),
             np.arange(14300.0, 14740.0, 8.0)]
    return {
        "rrs": (lambda m: [m.make_rrs(RRS_GRID, T=250.0)], len(RRS_GRID)),
        "rrs_profile": (lambda m: [m.make_rrs_profile(
            O2_BAND, [231.6, 258.1, 272.6])], len(O2_BAND)),
        "vs": (lambda m: m.make_vs(VS_GRID, T=250.0), len(VS_GRID)),
        "rrs_plus": (lambda m: m.make_rrs_plus(grids, j_max=16).specs,
                     sum(len(g) for g in grids)),
        "rvrs_plus": (lambda m: m.make_rvrs_plus(
            25000.0, dnu=4.0, margin=4.0, j_max=12).specs, None),
    }


@pytest.mark.parametrize("case", list(_coupling_cases()))
def test_build_coupling_matches(case):
    make, n_spec = _coupling_cases()[case]
    if n_spec is None:
        n_spec = tin.make_rvrs_plus(25000.0, dnu=4.0, margin=4.0,
                                    j_max=12).n_spec
    got = build_coupling(make(tin), n_spec)
    want = jax_build_coupling(make(jin), n_spec)
    _same(list(got), list(want))
    assert got[0].shape[1] == n_spec


def test_build_coupling_raises_without_rows():
    """make_vs on a band narrower than every vibrational shift (band 0 of
    O2ParametersVS.yaml) gives no coupling row: the port raises a
    ValueError that says so; the JAX package fails in np.stack."""
    grid = np.arange(1e7 / 750, 1e7 / 745, 0.05)
    assert tin.make_vs(grid, T=250.0) == []
    with pytest.raises(ValueError, match="no Raman shift row"):
        build_coupling(tin.make_vs(grid, T=250.0), len(grid))
    with pytest.raises(ValueError):
        jax_build_coupling(jin.make_vs(grid, T=250.0), len(grid))


def test_apply_lineshape_matches():
    mol = tin.molecular_constants("N2", 0.79)
    ln = tin.rotational_raman_lines(mol, 13000.0, 250.0, 20)
    grid = np.arange(-250.0, 250.0, 0.01)
    _same(tin.apply_lineshape(ln.shifts, ln.coeffs, 13000.0, grid, 250.0,
                              28.0),
          jin.apply_lineshape(ln.shifts, ln.coeffs, 13000.0, grid, 250.0,
                              28.0))


# --- the reference's physics gates on the port alone -------------------------

def test_rrs_mapping_physics():
    grid = np.arange(12800.0, 13200.0, 0.5)
    rrs = tin.make_rrs(grid, T=250.0)
    # Cabannes fraction in the O2 A-band region: ~0.96-0.97
    assert 0.95 < rrs.omega_cabannes < 0.98
    # energy closure: sum of coupling weights == (1-c)/c of total Rayleigh
    expect = (1 - rrs.omega_cabannes) / rrs.omega_cabannes
    assert rrs.w_shift.sum() == pytest.approx(expect, rel=2e-3)
    # shifts within +-~200 cm^-1 (400 grid steps)
    assert rrs.i_shift.min() > -800 and rrs.i_shift.max() < 800
    assert np.all(rrs.w_shift > 0)


def test_profile_spec_shapes_and_t_sensitivity():
    rrs = tin.make_rrs_profile(UV_GRID, [210.0, 285.0])
    assert rrs.w_shift.shape == (2, rrs.n_raman)
    assert rrs.omega_cabannes.shape == (2,)
    # warmer layer populates higher J: weight distribution must differ
    dw = np.abs(rrs.w_shift[0] - rrs.w_shift[1]) / rrs.w_shift.max()
    assert dw.max() > 0.02


def test_vs_anti_stokes_negligible_cold():
    s01 = tin.make_vs(VS_GRID, T=250.0, direction="0to1")
    s10 = tin.make_vs(VS_GRID, T=250.0, direction="1to0")
    assert len(s01) == 3          # rovib O/S + Q(N2) + Q(O2)
    w01 = sum(s.w_shift.sum() for s in s01)
    w10 = sum(s.w_shift.sum() for s in s10) if s10 else 0.0
    assert w10 < w01 * 1e-3
    # anti-Stokes shifts are blueward (negative source offsets)
    assert all(s.i_shift.max() < 0 for s in s10)
    with pytest.raises(ValueError):
        tin.make_vs(VS_GRID, direction="2to1")


def test_vs_plus_deposit_conserves_strength():
    nu_inc = 25000.0
    cb = tin.make_vs_plus(nu_inc, T=250.0, direction="0to1", dnu=4.0,
                          margin=4.0, j_max=12)
    assert len(cb.grids) == 3 and len(cb.grids[0]) == 1
    assert 0.94 < cb.omega_cabannes[0] < 0.99
    assert np.all(cb.omega_cabannes[1:] == 1.0)
    mols = [tin.molecular_constants("N2", 0.79),
            tin.molecular_constants("O2", 0.21)]
    rot = [tin.rotational_raman_lines(m, nu_inc, 250.0, 12) for m in mols]
    sigma_rayl = sum(v * ln.sigma_rayl_coeff
                     for ln, v in zip(rot, [0.79, 0.21])) * nu_inc**4
    expect = sum(v * np.sum(co * (nu_inc + sh) ** 4)
                 for v, (sh, co, _r) in zip(
                     [0.79, 0.21],
                     [tin.vibrational_raman_lines(m, nu_inc, 250.0, "0to1",
                                                  12) for m in mols])
                 ) / sigma_rayl
    assert sum(s.w.sum() for s in cb.specs) == pytest.approx(expect,
                                                             rel=1e-10)


def test_rvrs_plus_adds_rotational_window():
    cb = tin.make_rvrs_plus(25000.0, T=250.0, dnu=4.0, margin=4.0, j_max=12,
                            rrs_dnu=2.0)
    vs = tin.make_vs_plus(25000.0, T=250.0, dnu=4.0, margin=4.0, j_max=12)
    assert len(cb.grids) == len(vs.grids) + 1
    rot_lo, rot_hi = cb.band_spec_lim[-1]
    rot_w = np.zeros(cb.n_spec)
    for s in cb.specs:
        np.add.at(rot_w, s.i_out, s.w)
    cab = cb.omega_cabannes[0]
    assert rot_w[rot_lo:rot_hi].sum() == pytest.approx((1 - cab) / cab,
                                                       rel=2e-2)


def test_apply_lineshape_conserves_line_strength():
    mol = tin.molecular_constants("N2", 0.79)
    ln = tin.rotational_raman_lines(mol, 13000.0, 250.0, 20)
    grid = np.arange(-250.0, 250.0, 0.002)
    sig = tin.apply_lineshape(ln.shifts, ln.coeffs, 13000.0, grid, 250.0,
                              28.0)
    keep = (ln.shifts > grid.min()) & (ln.shifts < grid.max())
    expect = np.sum(ln.coeffs[keep] * (13000.0 + ln.shifts[keep]) ** 4)
    assert np.trapezoid(sig, grid) == pytest.approx(expect, rel=2e-3)
    i = np.argmax(sig)
    j = np.argmax(ln.coeffs * (13000.0 + ln.shifts) ** 4)
    assert abs(grid[i] - ln.shifts[j]) < 0.01
