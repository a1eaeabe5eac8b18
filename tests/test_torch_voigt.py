"""Port's Voigt kernel (kernel 2, plain version on the CPU) and dense
cross-section engine against the JAX package.

Tolerances: Re w in float64 to rounding (1e-12); the tiled f32 sum to
2e-5 x max sigma, the bound of tests/test_pallas_voigt.py (the port sums
each tile's lines in another order); the dense f64 engine to rtol 1e-10.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.pallas.voigt_kernel import VoigtPlan as JaxVoigtPlan
from vsmartmom.pallas.voigt_kernel import rew_hw32sd as jax_rew
from vsmartmom.spectroscopy import voigt as jvoigt
from vsmartmom.spectroscopy.hitran import read_hitran as jax_read_hitran

from vsmartmom_torch.cuda import voigt_kernel as vk
from vsmartmom_torch.cuda.voigt_kernel import VoigtPlan, rew_hw32sd
from vsmartmom_torch.spectroscopy import voigt as tvoigt
from vsmartmom_torch.spectroscopy.cef import w_humlicek_weideman32_sd
from vsmartmom_torch.spectroscopy.hitran import read_hitran

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _rand_problem(n_l=400, n_g=2100, seed=3):
    """The random line problem of tests/test_pallas_voigt.py."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(13000.0, 13080.0, n_g)
    nu = rng.uniform(12995.0, 13085.0, n_l)
    S = 10 ** rng.uniform(-3, 0, n_l)
    gd = rng.uniform(0.01, 0.03, n_l)
    yv = rng.uniform(0.05, 4.0, n_l)
    return grid, nu, S, gd, yv


def test_rew_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-30, 30, 1000)
    y = 10 ** rng.uniform(-4, 1.2, 1000)
    ref = np.asarray(jax_rew(jnp.asarray(x), jnp.asarray(y)))
    got = rew_hw32sd(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_complex_cef_matches_real_form():
    rng = np.random.default_rng(1)
    x = rng.uniform(-30, 30, 500)
    y = 10 ** rng.uniform(-4, 1.2, 500)
    w = w_humlicek_weideman32_sd(torch.complex(torch.as_tensor(x),
                                               torch.as_tensor(y)))
    real = rew_hw32sd(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(w.real.numpy(), real.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("seed,cut", [(3, 10.0), (5, 8.0), (9, 40.0)])
def test_plan_matches_jax_interpret(seed, cut):
    grid, nu, S, gd, yv = _rand_problem(seed=seed)
    ref = np.asarray(JaxVoigtPlan(grid, nu, cut, interpret=True)
                     .run(nu, S, gd, yv))
    plan = VoigtPlan(grid, nu, cut, device="cpu")
    got = plan.run(nu, S, gd, yv)
    assert got.dtype == torch.float32 and got.shape == (len(grid),)
    assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("p,T,broadening", [
    (1000.0, 296.0, "Voigt"), (300.0, 220.0, "Voigt"),
    (1000.0, 296.0, "Lorentz"), (500.0, 250.0, "Doppler")])
def test_dense_engine_matches_jax(p, T, broadening):
    path = os.path.join(DATA, "testCO2.par")
    grid = np.arange(6316.0, 6319.0, 0.002)   # testCO2.par's strongest line
    ref = np.asarray(jvoigt.compute_absorption_cross_section(
        jvoigt.make_hitran_model(jax_read_hitran(path, engine="python"),
                                 broadening, wing_cutoff=40.0), grid, p, T))
    assert ref.max() > 0
    got = tvoigt.compute_absorption_cross_section(
        tvoigt.make_hitran_model(read_hitran(path), broadening,
                                 wing_cutoff=40.0), grid, p, T, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * ref.max())


def test_kernel_engine_matches_dense():
    """engine='kernel' (tiled f32 sum, plain version on the CPU) against
    the dense f64 engine, at the bound of tests/test_pallas_voigt.py:80."""
    ht = read_hitran(os.path.join(DATA, "testCO2.par"))
    model = tvoigt.make_hitran_model(ht, wing_cutoff=40.0)
    grid = np.arange(6316.0, 6319.0, 0.002)   # testCO2.par's strongest line
    ref = tvoigt.compute_absorption_cross_section(model, grid, 1000.0,
                                                  296.0, device="cpu").numpy()
    assert ref.max() > 0
    got = tvoigt.compute_absorption_cross_section(
        model, grid, 1000.0, 296.0, engine="kernel", device="cpu").numpy()
    assert np.abs(got - ref).max() < 1e-3 * ref.max() + 1e-30


def test_line_parameters_match_jax():
    path = os.path.join(DATA, "testCO2.par")
    jm = jvoigt.make_hitran_model(jax_read_hitran(path, engine="python"))
    tm = tvoigt.make_hitran_model(read_hitran(path))
    for a, b in zip(jvoigt.line_parameters(jm, 800.0, 250.0),
                    tvoigt.line_parameters(tm, 800.0, 250.0)):
        np.testing.assert_allclose(b, a, rtol=1e-14)


def _layers(nu, S, gd, yv, n_layers=3, seed=0):
    """n_layers (p, T)-like variants of one line list: shifted positions
    (inside the plan's 0.5 cm^-1 shift margin), scaled strengths, Doppler
    widths and y, each (n_layers, n_lines)."""
    rng = np.random.default_rng(seed)
    shape = (n_layers, len(nu))
    return (nu + rng.uniform(-0.4, 0.4, shape), S * rng.uniform(0.5, 2, shape),
            gd * rng.uniform(0.8, 1.2, shape), yv * rng.uniform(0.1, 2, shape))


@pytest.mark.parametrize("seed,cut", [(3, 10.0), (5, 8.0), (9, 40.0)])
def test_layered_plan_matches_jax_loop(seed, cut):
    """One layered call (the plain version, three layers) equals a loop of
    the JAX plan over the layers, each within 2e-5 x its max sigma."""
    grid, nu, S, gd, yv = _rand_problem(seed=seed)
    layers = _layers(nu, S, gd, yv, seed=seed)
    got = VoigtPlan(grid, nu, cut, device="cpu").run(*layers)
    assert got.dtype == torch.float32 and got.shape == (3, len(grid))
    jplan = JaxVoigtPlan(grid, nu, cut, interpret=True)
    for k in range(3):
        ref = np.asarray(jplan.run(*(v[k] for v in layers)))
        assert np.abs(got[k].numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("seed", range(4))
def test_plan_blocks_cover_every_window(seed):
    """For random grids, lines and cutoffs: every (line, grid point) pair
    within cutoff + shift margin lies in its point block's line range; each
    block's items cover that range exactly once, in order, with at most
    SPLIT lines each; offsets rebuild the grid to f32 precision."""
    rng = np.random.default_rng(seed)
    n_g = int(rng.integers(1, 3000))
    grid = np.sort(rng.uniform(6000.0, 6000.0 + rng.uniform(0.5, 60.0), n_g))
    cut, margin = rng.uniform(0.2, 40.0), 0.5
    nu = rng.uniform(grid[0] - 45.0, grid[-1] + 45.0,
                     int(rng.integers(0, 6000)))
    plan = VoigtPlan(grid, nu, cut, shift_margin=margin, device="cpu")
    blk, lo, hi, item0 = (v.numpy() for v in (plan.item_block, plan.item_lo,
                                              plan.item_hi, plan.block_item0))
    assert plan.n_blocks == -(-n_g // vk.BLOCK) == len(item0) - 1
    assert item0[0] == 0 and item0[-1] == plan.n_items == len(blk)
    nu_sorted = np.sort(nu)
    for b in range(plan.n_blocks):
        g = grid[b * vk.BLOCK:(b + 1) * vk.BLOCK]
        near = np.flatnonzero((np.abs(g[:, None] - nu_sorted[None, :])
                               <= cut + margin).any(axis=0))
        first, last = plan.first[b], plan.last[b]
        if len(near):
            assert first <= near.min() and near.max() < last
        items = slice(item0[b], item0[b + 1])
        assert item0[b + 1] > item0[b] and (blk[items] == b).all()
        assert lo[items][0] == first and hi[items][-1] == last
        assert (lo[items][1:] == hi[items][:-1]).all()
        assert ((hi[items] - lo[items]) <= vk.SPLIT).all()
        assert (hi[items] >= lo[items]).all()
    rebuilt = (plan.grid_b.double()
               + plan.centers.double()[:, None]).reshape(-1)[:n_g]
    np.testing.assert_allclose(rebuilt.numpy(), grid - plan.nu0, rtol=0,
                               atol=1e-5 * max(1.0, np.ptp(grid)))


def test_absorption_profile_kernel_matches_jax_pallas(monkeypatch):
    """The kernel engine of compute_absorption_profile on a cut O2 A-band
    grid (2 000 points) and three layers of the flagship profile: one call
    of the Voigt entry point for all layers, within 2e-5 x max tau of the
    JAX package's pallas engine (interpret mode)."""
    import vsmartmom as jax_pkg
    from vsmartmom.spectroscopy.profiles import \
        compute_absorption_profile as jax_profile
    import vsmartmom_torch as port
    from vsmartmom_torch.core.atmosphere import compute_atmos_profile_fields
    from vsmartmom_torch.spectroscopy.profiles import \
        compute_absorption_profile

    params = port.default_parameters()
    full = compute_atmos_profile_fields(params.T, params.p, params.q,
                                        params.absorption_params.vmr)
    rows = [0, full.n_layers // 2, full.n_layers - 1]
    profile = types.SimpleNamespace(
        n_layers=3, p_full=np.asarray(full.p_full)[rows],
        T=np.asarray(full.T)[rows], vcd_dry=np.asarray(full.vcd_dry)[rows])
    grid = 13150.0 + 0.015 * np.arange(2000)
    calls = []
    real = vk.voigt_tiles

    def counting(*args):
        calls.append(args[6].shape)
        return real(*args)

    monkeypatch.setattr(vk, "voigt_tiles", counting)
    got = compute_absorption_profile(
        np.zeros((len(grid), 3)), "O2", params.absorption_params, grid, 0.21,
        profile, engine="kernel", device="cpu")
    assert calls == [(3, calls[0][1])]
    ref = jax_profile(np.zeros((len(grid), 3)), "O2",
                      jax_pkg.default_parameters().absorption_params, grid,
                      0.21, profile, engine="pallas")
    assert ref.max() > 1.0, "strong O2 lines must be present"
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


class _FakeLib:
    """Stands in for the kernel library: records each entry called and its
    arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name != "vsm_voigt":
            raise AttributeError(name)
        return lambda *args: self.calls.append(args) or 0


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper's launch
    path without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_layered_launch_passes_plan_geometry(monkeypatch):
    """On CUDA tensors the entry point hands vsm_voigt, once, the layer
    count, the plan's point blocks and line items and a (layers, items,
    BLOCK) workspace, counts the launch, and never reaches the plain
    version."""
    from vsmartmom_torch.cuda import build
    grid, nu, S, gd, yv = _rand_problem(n_l=3000, n_g=2100, seed=4)
    plan = VoigtPlan(grid, nu, 40.0, device="cpu")
    assert plan.n_items > plan.n_blocks          # some blocks are split
    fake = _FakeLib()
    monkeypatch.setattr(build, "lib", lambda: fake)

    def no_plain(*args):
        raise AssertionError("the plain version ran on the launch path")

    monkeypatch.setattr(vk, "voigt_tiles_plain", no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    allocs = []
    real_empty = torch.empty

    def cpu_empty(size, dtype=None, device=None):
        allocs.append((tuple(size), device))
        return real_empty(size, dtype=dtype)

    monkeypatch.setattr(torch, "empty", cpu_empty)
    args = tuple(v.as_subclass(_CudaLooking) if torch.is_tensor(v) else v
                 for v in plan.call_args(*plan.line_inputs(
                     *_layers(nu, S, gd, yv))))
    monkeypatch.setattr(vk, "launches", 0)
    out = vk.voigt_tiles(*args)
    assert out.shape == (3, len(grid)) and vk.launches == 1
    (call,) = fake.calls
    assert list(call[:10]) == [v.data_ptr() for v in args[:10]]
    assert call[10:14] == (3, len(nu), plan.n_items, len(grid))
    assert call[14] == pytest.approx(40.0) and call[17] == 7
    cuda = torch.device("cuda", 0)
    assert allocs == [((3, plan.n_items, vk.BLOCK), cuda),
                      ((3, len(grid)), cuda)]


@pytest.mark.parametrize("n_layers", [0, 1])
def test_layer_counts_zero_and_one(n_layers):
    """A stack of 0 or 1 layers gives (layers, n_grid); one layer equals the
    single (p, T) call; a plan without lines gives zeros."""
    grid, nu, S, gd, yv = _rand_problem(n_l=50, n_g=600, seed=2)
    plan = VoigtPlan(grid, nu, 10.0, device="cpu")
    layers = tuple(v[:n_layers] for v in _layers(nu, S, gd, yv))
    got = plan.run(*layers)
    assert got.shape == (n_layers, len(grid))
    if n_layers:
        one = plan.run(*(v[0] for v in layers))
        assert torch.equal(got[0], one) and float(one.max()) > 0
    empty = VoigtPlan(grid, [], 10.0, device="cpu")
    assert torch.equal(empty.run(*(np.zeros((n_layers, 0)),) * 4),
                       torch.zeros(n_layers, len(grid)))


@pytest.mark.parametrize("band", ["o2_flagship", "co2_hapi"])
def test_plan_geometry_at_real_bands(band):
    """The plans of the O2 flagship band and the HAPI gate's CO2 grid (with
    the flagship's 40 cm^-1 cutoff): every point block has an item, and each
    real point's block sweeps every line of its window."""
    from vsmartmom_torch.spectroscopy.profiles import (hitran_artifact,
                                                       read_linelist)
    mol, grid = {"o2_flagship": ("O2", 12870.0 + 0.015 * np.arange(22669)),
                 "co2_hapi": ("CO2", 6000.0 + 0.01 * np.arange(40001))}[band]
    cut = 40.0
    nu = np.sort(read_linelist(hitran_artifact(mol), mol, grid[0] - cut,
                               grid[-1] + cut).nu)
    plan = VoigtPlan(grid, nu, cut, device="cpu")
    assert plan.n_blocks == -(-len(grid) // vk.BLOCK) <= plan.n_items
    blk = np.arange(len(grid)) // vk.BLOCK
    assert (plan.first[blk]
            <= np.searchsorted(nu, grid - cut, side="left")).all()
    assert (plan.last[blk]
            >= np.searchsorted(nu, grid + cut, side="right")).all()
