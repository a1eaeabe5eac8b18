"""Row 1's tangent kernel (csrc/layer_step_tangent.cu) on the CPU: its plain
torch twin against torch.func.jvp of the plain version, the route of the
fused step's forward rule under jacfwd and jvp, the choice by width and the
counters.

The twin (``layer_step_tangent_body``) linearises the plain version's
iteration term by term, every Newton-Schulz iterate included; CPU tensors
take it wherever the card takes the kernel. Inputs: passive slabs as in
tests/test_torch_kernel_jvp.py, float64 at small S, from numpy seeds.
"""
import re

import numpy as np
import pytest
import torch

from vsmartmom_torch.core.precision import batch_mm, batch_mm_tangent
from vsmartmom_torch.core.rt import LayerRT, vacuum_layer
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
from vsmartmom_torch.cuda import layer_step_kernel as lsk

torch.set_num_threads(2)

S = 4
SCHED, NI = (1, 2, 3), 3
BOUND = 1e-10


def _case(n, dtype=torch.float64, seed=0):
    """The 12 primals of one step: a composite two plain steps from vacuum,
    then an elemental slab, ek and d."""
    rng = np.random.default_rng(seed)
    dtau, mqm = 0.2 / 2 ** len(SCHED), 0.2

    def slab(scale):
        r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
        t = (np.eye(n) * np.exp(-dtau / mqm)
             + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
        return [torch.tensor(x, dtype=dtype) for x in
                (r, t, rng.uniform(0, dtau, (S, n)),
                 rng.uniform(0, dtau, (S, n)))]

    d = torch.tensor(np.resize([1.0, 1.0, -1.0], n), dtype=dtype)
    ek = torch.full((S,), float(np.exp(-dtau / 0.7)), dtype=dtype)
    comp = vacuum_layer(S, n, dtype, "cpu")
    for scale in (1.0, 0.6):
        comp = lsk.fused_layer_step_plain(comp, *slab(scale), ek, d,
                                          ns_schedule=SCHED, ni=4)
    return [*comp, *slab(0.8), ek, d]


def _tangents(prim, k, seed=1):
    """K random tangent columns of every primal, d's included, each
    (K, *shape)."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((k, *p.shape)),
                         dtype=p.dtype) * p.abs().max() for p in prim]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("n", [12, 15])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tangent_body_matches_jvp_of_plain(precision, k, n):
    """The twin's K columns equal torch.func.jvp of the plain version taken
    column by column, every field to 1e-10 of its max, in each mode."""
    prim = _case(n)
    tan = _tangents(prim, k)
    got = lsk.layer_step_tangent_body(
        LayerRT(*prim[:6]), LayerRT(*tan[:6]), *prim[6:], *tan[6:], SCHED,
        NI, batch_mm(precision), batch_mm_tangent(precision))
    cols = [torch.func.jvp(
        lambda *xs: lsk._plain_flat(*xs, SCHED, NI, precision), tuple(prim),
        tuple(t[c] for t in tan))[1] for c in range(k)]
    for name, a, ref in zip(LayerRT._fields, got, zip(*cols)):
        ref = torch.stack(ref)
        assert a.shape == ref.shape == (k, *prim[LayerRT._fields.index(
            name)].shape), name
        assert ref.abs().max() > 0, name
        assert _rel(a, ref) < BOUND, (name, _rel(a, ref))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_batch_mm_tangent_is_the_jvp_of_batch_mm(precision):
    """batch_mm_tangent is torch.func.jvp of batch_mm, bit for bit, in
    float32 (where each bf16 pass sums in the operands' float32)."""
    g = torch.Generator().manual_seed(3)
    a, da, b, db = (torch.randn(5, 7, 7, generator=g) for _ in range(4))
    ref = torch.func.jvp(batch_mm(precision), (a, b), (da, db))[1]
    assert torch.equal(batch_mm_tangent(precision)(a, da, b, db), ref)


def _spy(monkeypatch):
    """Record the tangent columns (K) of every call of the tangent
    Function's forward."""
    calls = []
    fwd = lsk._StepTangent.forward

    def spy(*args):
        calls.append(args[18].shape[0])
        return fwd(*args)
    monkeypatch.setattr(lsk._StepTangent, "forward", staticmethod(spy))
    return calls


def _run(step, prim, x):
    """The step's outputs, flat, as a function of three scales: of r_f,
    of the composite's j_m and of ek."""
    e = [prim[6] * x[0]] + prim[7:10]
    c = prim[:5] + [prim[5] * x[1]]
    return torch.cat([f.reshape(-1) for f in step(
        LayerRT(*c), *e, prim[10] * x[2], prim[11], ns_schedule=SCHED,
        ni=NI)])


@pytest.mark.parametrize("transform", ["jacfwd", "jvp", "vmap_jacfwd"])
def test_forward_rule_takes_one_tangent_call(transform, monkeypatch):
    """Under jacfwd the fused step's forward rule reaches the tangent
    Function once, with jacfwd's three columns stacked (K = 3), not once a
    column; under jvp once with K = 1; a vmap over two states once a state.
    Each equals the plain version's transform."""
    prim = _case(12, torch.float32)
    calls = _spy(monkeypatch)
    x0 = torch.tensor([1.1, 0.9, 1.0])
    v = torch.tensor([0.3, -0.2, 0.5])

    def of(step):
        f = lambda x: _run(step, prim, x)   # noqa: E731
        if transform == "jacfwd":
            return torch.func.jacfwd(f)(x0)
        if transform == "jvp":
            return torch.func.jvp(f, (x0,), (v,))[1]
        return torch.func.vmap(torch.func.jacfwd(f))(
            torch.stack([x0, 1.05 * x0]))
    got = of(lsk.fused_layer_step)
    expected = {"jacfwd": [3], "jvp": [1], "vmap_jacfwd": [3, 3]}
    assert calls == expected[transform]
    ref = of(lsk.fused_layer_step_plain)
    assert _rel(got, ref) < 1e-6


def test_tangent_on_kernel_routes_by_width():
    """The kernel takes every width whose two arenas (the primal's and the
    tangent's) fit a block of the team launch, N = 1 .. 44; the wider
    widths keep torch.func.jvp of the plain version."""
    on = [n for n in range(1, 64) if lsk.tangent_on_kernel(n)]
    assert on == list(range(1, 45))
    for n in (1, 15, 16, 17, 32, 33, 44):
        cfg = lsk.tangent_launch_config(n)
        assert cfg.smem_bytes <= build.MAX_SHARED_BYTES
        assert cfg.smem_bytes == 4 * (build.round4(n) + cfg.points
                                      * 2 * lsk.arena_floats(n, cfg.ld))
    for n in (45, 48, 63):
        assert lsk.tangent_launch_config(n).smem_bytes \
            > build.MAX_SHARED_BYTES
    # the flagship width: three (point, column) teams of one warp a block
    assert lsk.tangent_launch_config(15) == build.TeamLaunch(3, 92992, 20,
                                                             32)


def test_counters_and_fallback(monkeypatch):
    """On CPU tensors nothing launches: ``tangent_launches`` stays 0, and a
    tangent within the kernel's widths is not a fallback. A width beyond
    them takes build.tangent_of_plain, counted in ``plain_tangents``, and
    still equals the plain version's jvp; row 3 keeps the plain tangent."""
    calls = _spy(monkeypatch)
    lsk.tangent_launches = lsk.plain_tangents = lsk.launches = 0
    x0, v = torch.tensor([1.1, 0.9, 1.0]), torch.tensor([0.3, -0.2, 0.5])
    prim = _case(12, torch.float32)
    torch.func.jacfwd(lambda x: _run(lsk.fused_layer_step, prim, x))(x0)
    assert (lsk.tangent_launches, lsk.plain_tangents, lsk.launches) \
        == (0, 0, 0)
    assert calls == [3]
    wide = _case(48, torch.float64)
    got = torch.func.jvp(lambda x: _run(lsk.fused_layer_step, wide, x),
                         (x0.double(),), (v.double(),))[1]
    ref = torch.func.jvp(lambda x: _run(lsk.fused_layer_step_plain, wide, x),
                         (x0.double(),), (v.double(),))[1]
    assert (lsk.tangent_launches, lsk.plain_tangents) == (0, 1)
    assert calls == [3]
    assert _rel(got, ref) < BOUND
    assert "tangent_of_plain" in \
        ldk._FusedLayerStepDev.jvp.__code__.co_names


def _source(name):
    with open(f"{build.CSRC}/{name}") as f:
        return f.read()


def test_kernel_source_mirrors():
    """The wrapper's mirrors of csrc/layer_step_tangent.cu: the widest tile
    class built, the entry's pointer count and the library's sources."""
    src = _source("layer_step_tangent.cu")
    np_max = int(re.search(r"constexpr int kMaxTangentNP = (\d+);",
                           src).group(1))
    assert np_max == lsk.TANGENT_MAX_NP
    entry = src[src.index("#define TANGENT_ENTRY_PARAMS"):]
    entry = entry[:entry.index("void *stream")]
    assert entry.count("float *") == 30
    sig = build._SIGNATURES["vsm_layer_step_tangent"]
    assert sig.count(build._P) == 31          # 30 pointers and the stream
    assert "layer_step_tangent.cu" in build.SOURCES
    assert "__global__ void __launch_bounds__(kMaxBlock, 1)\n" \
           "layer_step_tangent_kernel(" in src
