"""The plain-form layer step's and the doubling's tensor-core bodies (rows 1
and 4 at "high") without a card: their routing, their launch plan, the
operands every product reads in the arena, and how far the plain form
moves when its sums change order.

The CUDA kernels cannot run here. ``tc_products`` below is a transcription
of csrc/layer_step.cu's products in its arena (offsets, strides, column
counts, the slots each epilogue stores, the products between two
synchronisations); test_products_follow_the_source holds it to the order,
column counts and strides of the source's calls, and the tests hold it to
mm_tc's assumptions (csrc/rt_device.cuh) at every N the kernels take. The
lane-by-lane mirror of mm_tc's gathers on these layouts is
tests/test_torch_dev_tc.py's test_tc_fragments_pad_k_with_zeros; the plain
versions at "high" against JAX's kernels in interpret mode are
tests/test_torch_precision.py's.
"""
import inspect
import os
import re
from typing import NamedTuple

import pytest
import torch

from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import doubling_kernel as dk
from vsmartmom_torch.cuda import layer_step_kernel as lsk

ROWS = {"step": (lsk, lsk.arena_floats, True),
        "doubling": (dk, dk.arena_floats, False)}


# ---- a transcription of csrc/layer_step.cu's arena and its products -------

class Arena(NamedTuple):
    """Offsets (floats) of the doubling phase's arena (``Arena`` in
    csrc/rt_device.cuh) at width n and row stride ld: six n x ld squares
    R, T, A, M0, M1, TMP, then JP and JM (round4(n) each), then W1 and W2
    (n x w2, w2 = round4(2n + 2))."""
    n: int
    ld: int
    w2: int
    r: int
    t: int
    a: int
    m0: int
    m1: int
    tmp: int
    jp: int
    jm: int
    w1: int
    w2_slot: int


def arena(n: int, ld: int) -> Arena:
    """The doubling arena's offsets at width n and row stride ld."""
    sq, w2 = n * ld, build.round4(2 * n + 2)
    jp = 6 * sq
    w1 = jp + 2 * build.round4(n)
    return Arena(n, ld, w2, 0, sq, 2 * sq, 3 * sq, 4 * sq, 5 * sq, jp,
                 jp + build.round4(n), w1, w1 + n * w2)


class Product(NamedTuple):
    """One product of the step's arena (floats from the point's arena):
    A (n x n at row stride lda) at ``a`` times B (n x k at ldb) at ``b``,
    or with ``mv`` A times the vector at ``b``; ``writes``: the regions its
    epilogue stores, each (offset, rows, columns, row stride); ``group``:
    the products between two synchronisations; ``inplace``: it writes its
    own B (in rounds, csrc/rt_device.cuh:mm_tc)."""
    name: str
    a: int
    lda: int
    b: int
    ldb: int
    k: int
    writes: tuple
    group: int
    mv: bool = False
    inplace: bool = False


def tc_products(n: int, ld: int, step: bool = True,
                every_slot: bool = True) -> list:
    """Every product of csrc/layer_step.cu's arena at width n and row
    stride ld, in order, for each of the two slots T may be in (the
    doubling swaps T and TMP each step) and, in the Newton-Schulz solves,
    each parity of the iterates M0, M1 (with ``every_slot`` False the first
    of each alone: the calls of the source in its order): the doubling
    phase (csrc/rt_device.cuh:doubling_phase), then with ``step`` the
    interaction (X at W1, X2 after it, the composite's CRPM and CTMM at
    step_composite_offset). Outputs to device memory are left out."""
    o = arena(n, ld)
    wx2 = lsk.x2_stride(n)
    wx = 2 * wx2
    x, x2 = o.w1, o.w1 + n * wx
    crpm = o.w1 + max(2 * n * o.w2, 3 * n * wx2)
    ctmm = crpm + n * ld
    sq, col = (n, n, ld), (n, 1, 1)
    out, group, slots = [], [0], 2 if every_slot else 1

    def add(*products):
        out.extend(Product(*p[:7], group[0], *p[7:]) for p in products)
        group[0] += 1

    def ns_then(last):
        """Newton-Schulz from either iterate, then ``last(result)``."""
        for cur, oth in ((o.m0, o.m1), (o.m1, o.m0))[:slots]:
            add(("A M", o.a, ld, cur, ld, n, ((o.tmp, *sq),)))
            add(("M S", cur, ld, o.tmp, ld, n, ((oth, *sq),)))
            last(oth)

    for t, tmp in ((o.t, o.tmp), (o.tmp, o.t))[:slots]:
        o = o._replace(t=t, tmp=tmp)
        add(("R R", o.r, ld, o.r, ld, n, ((o.a, *sq), (o.m0, *sq))))
        ns_then(lambda m: (
            add(("R T", o.r, ld, t, ld, n, ((o.w1, n, 2 * n, o.w2),)),
                ("R JP", o.r, ld, o.jp, 1, 1,
                 ((o.w1 + 2 * n, n, 1, o.w2),), True),
                ("R J1M", o.r, ld, o.jm, 1, 1,
                 ((o.w1 + 2 * n + 1, n, 1, o.w2),), True)),
            add(("M W1", m, ld, o.w1, o.w2, 2 * n + 2,
                 ((o.w2_slot, n, 2 * n + 2, o.w2),))),
            add(("T W2", t, ld, o.w2_slot, o.w2, 2 * n + 2,
                 ((o.r, *sq), (tmp, *sq), (o.jm, *col), (o.jp, *col))))))
        if not step:
            continue
        # t2mm in TMP and c_jp in M1 until the solve takes their slots
        add(("R X2", o.r, ld, x2, wx2, n, ((x, n, n, wx),)),
            ("R CJP", o.r, ld, o.m1, 1, 1, ((x + 2 * n, n, 1, wx),), True),
            ("CRPM T2", crpm, ld, tmp, ld, n, ((x2 + n, n, n, wx2),)),
            ("CRPM JM", crpm, ld, o.jm, 1, 1, ((x2 + 2 * n, n, 1, wx2),),
             True),
            ("R CRPM", o.r, ld, crpm, ld, n, ((o.a, *sq), (o.m0, *sq))))
        add(("R X2 wide", o.r, ld, x2, wx2, 2 * n + 1,
             ((x + wx2, n, 2 * n + 1, wx),)))
        ns_then(lambda m: (
            add(("M X", m, ld, x, wx, wx2 + 2 * n + 1,
                 ((x, n, wx2 + 2 * n + 1, wx),), False, True)),
            add(("CTMM X", ctmm, ld, x, wx, 2 * n + 1, ()),
                ("CRPM X", crpm, ld, x + wx2, wx, 2 * n + 1,
                 ((x2, n, 2 * n + 1, wx2),))),
            add(("T X2", t, ld, x2, wx2, 2 * n + 1, ()))))
    return out


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("n", range(1, 64))
def test_high_routes_by_class(row, n):
    """"high" launches the tensor-core entry in the N <= 16 class and the
    CUDA-core entry beyond it, where the tensor-core body would need more
    than kTcDiag's one k tile (has_tc_body in csrc/layer_step.cu);
    "highest" and "default" the CUDA-core entry at every N; the modes
    outside MATMUL_MODES raise."""
    mod = ROWS[row][0]
    base = "vsm_layer_step" if row == "step" else "vsm_doubling"
    assert mod.entry_point("high", n) == (base + "_tc" if n <= 16 else base)
    assert lsk.on_tensor_cores("high", n) == (mod.tc_plan(n).m_tiles == 1)
    assert mod.entry_point("highest", n) == base
    assert mod.entry_point("default", n) == base
    with pytest.raises(ValueError):
        mod.entry_point("bf16x3", n)


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("n", range(1, 17))
def test_tc_plan_fits_hopper(row, n):
    """At every N of the tensor-core class: M and K pad to one 16-row tile
    (kTcDiag takes one k tile), the team is one warp owning every column
    tile, the column tiles cover every product width, the K masks read
    exactly l < N, the diagonal terms go to the epilogue, and the launch
    fits the kernels' (512, 1) bound and one block's shared memory."""
    mod = ROWS[row][0]
    plan = mod.tc_plan(n)
    assert plan.launch == mod.launch_config(n)
    assert build.tile_class(n)[0] in lsk.TC_CLASSES
    assert (plan.m_tiles, plan.padded, plan.warps,
            plan.warps_per_m_tile) == (1, 16, 1, 1)
    assert plan.launch.team_threads == 32
    assert plan.launch.points * 32 <= build.MAX_BLOCK_THREADS
    assert plan.launch.smem_bytes <= build.MAX_SHARED_BYTES
    assert set(plan.col_tiles) == set(mod.product_widths(n))
    for k, tiles in plan.col_tiles.items():
        assert 8 * (tiles - 1) < k <= 8 * tiles == 8 * plan.rounds[k]
    assert plan.k_read == tuple(l < n for l in range(16))
    assert plan.diag


def _cells(off, rows, cols, stride):
    return {off + i * stride + j for i in range(rows) for j in range(cols)}


def _reads(p, n):
    """The floats a product reads: A's rows (mm_tc reads A as float2 up
    to l + 1 = N for odd N) and B's n x k block (the vector of an mv)."""
    a_cols = n if p.mv else ((n - 1) & ~1) + 2
    return _cells(p.a, n, a_cols, p.lda), _cells(p.b, n, p.k, p.ldb)


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("n", range(1, 64))
def test_products_meet_mm_tc_assumptions(row, n):
    """Every product of the step's (the doubling's) arena at the launch's
    row stride: A and its row stride on 16 bytes (float4 on the CUDA
    cores, float2 on the tensor cores), lda > N for odd N, B's row stride
    at least its column count, every read and store inside the point's
    arena; within each run of products between two synchronisations no
    store lands on a float another product (or its own operands) reads,
    but in the one in-place product, M [x1 | r2mp x2], which stores into
    its own B in rounds."""
    mod, floats, step = ROWS[row]
    ld = mod.launch_config(n).ld
    size = floats(n, ld)
    products = tc_products(n, ld, step)
    groups = {}
    for p in products:
        assert p.a % 4 == 0 and p.lda % 4 == 0 and p.lda >= n, p
        assert p.lda > n or n % 2 == 0, p
        assert p.ldb >= p.k if not p.mv else p.k == 1, p
        reads_a, reads_b = _reads(p, n)
        writes = set().union(*(_cells(*w) for w in p.writes))
        assert max(reads_a | reads_b | writes) < size, p
        groups.setdefault(p.group, []).append((p, reads_a | reads_b, writes))
    for members in groups.values():
        for p, _, writes in members:
            for q, reads, _ in members:
                clash = writes & reads
                if p is q and p.inplace:
                    assert clash == writes, p
                    continue
                assert not clash, (p.name, q.name)
    inplace = {p.name for p in products if p.inplace}
    assert inplace == ({"M X"} if step else set())


def _body(src, head):
    """The body of the device function whose definition starts ``head``."""
    start = src.index("{", src.index(head))
    return src[start:src.index("\n}\n", start)]


def _source_products(body, callees):
    """The products a device function's body issues, in order, as
    (call, column count, A's row stride, B's) expressions (mv: "1" for
    both); the calls of ``callees`` expand into their own."""
    out = []
    for m in re.finditer(r"\b(mm<C, true>|mm|mv|ns|doubling_phase)\(", body):
        call = m.group(1)
        if call in callees:
            out += _source_products(callees[call], callees)
            continue
        args = [a.strip() for a in
                body[m.end():body.index("[", m.end())].split(",")]
        out.append(("mv", "1", args[3], "1") if call == "mv"
                   else (call, args[2], args[4], args[6]))
    return out


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("n", (1, 2, 13, 16, 17, 44, 63))
def test_products_follow_the_source(row, n):
    """tc_products (one T slot, one Newton-Schulz parity) lists the calls
    of csrc/layer_step.cu's layer_step (doubling) with the doubling phase's
    and the solve's calls of csrc/rt_device.cuh in place, in the source's
    order, with their column counts, row strides and the one in-place
    product."""
    with open(os.path.join(build.CSRC, "rt_device.cuh")) as f:
        dev = f.read()
    with open(os.path.join(build.CSRC, "layer_step.cu")) as f:
        cu = f.read()
    callees = {"ns": _body(dev, "\nns(const Team<C>& tm"),
               "doubling_phase": _body(dev, "\ndoubling_phase(const Team")}
    head = ("void layer_step(LAYER_STEP_PARAMS)" if row == "step"
            else "void doubling(DOUBLING_PARAMS)")
    ld = ROWS[row][0].launch_config(n).ld
    env = dict(n=n, ld=ld, w2=build.round4(2 * n + 2),
               wx2=lsk.x2_stride(n), wx=2 * lsk.x2_stride(n))
    got = [(call, *(eval(e, {}, env) for e in exprs))
           for call, *exprs in _source_products(_body(cu, head), callees)]
    want = [("mv" if p.mv else "mm<C, true>" if p.inplace else "mm",
             p.k, p.lda, p.ldb)
            for p in tc_products(n, ld, ROWS[row][2], every_slot=False)]
    assert len(got) == (20 if row == "step" else 8)
    assert got == want


def test_wrappers_launch_the_routed_entry():
    """Each tensor-core entry takes its row's CUDA-core entry's arguments
    and is defined in csrc/layer_step.cu, and the wrappers launch the
    entry of entry_point."""
    with open(os.path.join(build.CSRC, "layer_step.cu")) as f:
        src = f.read()
    for base in ("vsm_layer_step", "vsm_doubling"):
        assert build._SIGNATURES[base + "_tc"] == build._SIGNATURES[base]
        for entry in (base, base + "_tc"):
            assert f'extern "C" int {entry}(' in src
    assert "entry_point(precision, n)" in inspect.getsource(lsk._launch)
    assert "entry_point(precision, n)" in inspect.getsource(
        dk.fused_doubling)


def test_order_sensitivity_of_the_plain_form():
    """vsmartmom_torch.order_sensitivity --form plain at a small width of
    the tensor-core class: summed in another order, the step and the
    doubling at "high" move (the plain form carries T's ~1.0 diagonal
    through every product and flips bf16 roundings of its low parts), but
    stay nearer their plain versions at "high" than those lie from
    "highest", the bound rows 1 and 4 at "high" are held to."""
    from vsmartmom_torch.order_sensitivity import plain_sensitivity
    rec = plain_sensitivity(15, 32)
    assert set(rec["fields"]) == set(lsk.LayerRT._fields)
    assert set(rec["doubling"]) == {"r", "t", "jp", "jm"}
    step, dbl = max(rec["fields"].values()), max(rec["doubling"].values())
    assert 0.0 < step < min(rec["from_highest"], rec["alt_from_highest"])
    assert 0.0 < dbl < min(rec["doubling_from_highest"],
                           rec["doubling_alt_from_highest"])


#: the bits a tensor core keeps of each product below float32's 24 when it
#: aligns a tile's products to the largest: an assumption of the model
#: below, not a measured property of the card
GUARD_BITS = 1


def _toward_zero(x):
    """float64 x rounded toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core_sum(a, b, diag):
    """a @ b of bf16 values (K <= 16: one mma tile) as a model of the
    tensor cores' sum: the exact products aligned to the largest one's
    exponent and each cut toward zero to 24 + GUARD_BITS bits, summed, the
    sum cut toward zero to float32; with ``diag`` (kTcDiag's a_hi b_hi
    pass) the terms l = i and l = j mod n left out of that sum and added
    to it after, each rounded to nearest."""
    n, k = a.shape[-1], b.shape[-1]
    if n > 16:
        raise ValueError("the tensor-core model takes K <= 16")
    i, l, j = (torch.arange(n)[:, None, None], torch.arange(n)[None, :, None],
               torch.arange(k)[None, None, :])
    first = (l == i) & diag
    second = (l == j % n) & (l != i) & diag
    p = a.double()[..., :, :, None] * b.double()[..., None, :, :]
    rest = torch.where(first | second, torch.zeros_like(p), p)
    _, e = torch.frexp(rest.abs().amax(dim=-2, keepdim=True))
    q = torch.ldexp(torch.ones_like(e, dtype=p.dtype), e - 24 - GUARD_BITS)
    acc = _toward_zero((torch.trunc(rest / q) * q).sum(dim=-2))
    for term in (first, second):
        acc = (acc.double()
               + torch.where(term, p, torch.zeros_like(p)).sum(-2)).float()
    return acc


def test_tensor_core_sum_model():
    """Why the a_hi b_hi pass of rows 1 and 4 sums its diagonal terms
    apart (kTcDiag), in a model of the tensor cores' sum on bf16 operands
    with a ~1.0 diagonal: with every term in the tile the small products
    are cut toward zero after aligning to the diagonal one, so the sums
    fall short of the exact ones; with the diagonal terms added after they
    land within an ulp and unbiased, near an exact sum rounded once."""
    gen = torch.Generator().manual_seed(0)
    a = (torch.eye(16) * 0.99 + 1e-3 * torch.rand(8, 16, 16, generator=gen))
    b = (torch.eye(16) * 0.97 + 1e-3 * torch.rand(8, 16, 16, generator=gen))
    a, b = a.bfloat16().float(), b.bfloat16().float()
    exact = torch.matmul(a.double(), b.double())
    ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact)[1] - 24)
    whole = (_tensor_core_sum(a, b, False).double() - exact) / ulp
    split = (_tensor_core_sum(a, b, True).double() - exact) / ulp
    assert split.abs().max() <= 1.0 and split.abs().mean() < 0.35
    assert whole.mean() < -1.0 and whole.max() <= 0.0
    with pytest.raises(ValueError):
        _tensor_core_sum(torch.ones(1, 17, 17), torch.ones(1, 17, 17), True)
