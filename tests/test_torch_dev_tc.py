"""The split-form step's tensor-core body (row 3 at "bf16x3") without a
card: its launch plan, its fragment gathers and its routing.

The CUDA kernel cannot run here. What surrounds its products is pure
Python and is checked here: ``layer_step_dev_kernel.tc_plan`` (padded M, K
and N, warps a point, shared bytes) for every N the kernel takes, and a
lane-by-lane numpy mirror of ``mm_tc``'s gathers (csrc/rt_device.cuh: the
PTX m16n8k16 fragment layouts, the clamps at the M and N edges, the plan's
K masks) on operands whose padding holds NaN: every output is stored once
and equals A @ B, so the padded K terms read zeros; the same mirror covers
the plain form's arena (rows 1 and 4 at "high", tests/test_torch_step_tc.py
for the rest of their tensor-core body). The plain version at
"bf16x3" against JAX's kernel in interpret mode is
tests/test_torch_precision.py's test_twins_at_bf16x3_match_jax_interpret.
"""
import inspect
import os

import numpy as np
import pytest

from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
from vsmartmom_torch.cuda import layer_step_kernel as lsk

from test_torch_step_tc import tc_products


@pytest.mark.parametrize("n", range(1, 76))
def test_tc_plan_fits_hopper(n):
    """At every N the tensor-core body takes: M and K pad to whole 16-row
    tiles of the tile class, a point's team is whole warps that split
    evenly over the m tiles, the column tiles cover every product width in
    the plan's rounds, the K masks read exactly l < N, A's float2 reads of
    l, l + 1 stay inside the row stride, and the arena (launch_config's)
    fits one block's 227 KB in a block the kernel's bound takes."""
    plan = ldk.tc_plan(n)
    np_, tt = build.tile_class(n, build.DEV_TILE_CLASSES)[:2]
    assert plan.launch == ldk.launch_config(n)
    assert plan.padded == 16 * plan.m_tiles == np_
    assert plan.padded - 16 < n <= plan.padded
    assert plan.warps * 32 == tt == plan.launch.team_threads
    assert plan.warps_per_m_tile * plan.m_tiles == plan.warps
    assert plan.launch.smem_bytes <= build.MAX_SHARED_BYTES
    assert plan.launch.points * tt <= ldk.TC_BLOCK_BOUND[np_] \
        <= build.MAX_BLOCK_THREADS
    assert set(plan.col_tiles) == set(ldk.product_widths(n))
    for k, tiles in plan.col_tiles.items():
        assert 8 * (tiles - 1) < k <= 8 * tiles
        assert plan.rounds[k] * plan.warps_per_m_tile >= tiles
        assert (plan.rounds[k] - 1) * plan.warps_per_m_tile < tiles
    assert plan.k_read == tuple(l < n for l in range(plan.padded))
    assert ((n - 1) & ~1) + 1 < plan.launch.ld


def _mm_tc_mirror(a_buf, lda, b_buf, ldb, n, k, plan):
    """mm_tc's gathers, tiles and stores, lane by lane, with float64 sums:
    {(i, j): value} of every store. With plan.diag (kTcDiag's a_hi b_hi
    pass) A reads 0 at l = i and B at l = j mod n, and each output adds
    those terms after the tile, as the kernel's epilogue does."""
    mt_n, g_n = plan.m_tiles, plan.warps_per_m_tile
    k_read = plan.k_read
    out = {}
    for warp in range(plan.warps):
        mt = warp % mt_n
        a_tiles = np.zeros((mt_n, 16, 16))
        for lane in range(32):
            g, t2 = lane >> 2, 2 * (lane & 3)
            i0 = 16 * mt + g
            for kt in range(mt_n):
                for h in range(2):
                    l = 16 * kt + 8 * h + t2
                    lc = min(l, (n - 1) & ~1)
                    for r, row in ((g, i0), (g + 8, i0 + 8)):
                        base = min(row, n - 1) * lda + lc
                        for c in range(2):
                            keep = k_read[l + c] and not (
                                plan.diag and l + c == row)
                            v = a_buf[base + c] if keep else 0.0
                            a_tiles[kt, r, 8 * h + t2 + c] = v
        tiles = -(-k // 8)
        for q0 in range(0, tiles, g_n):
            j0 = 8 * (q0 + warp // mt_n)
            if j0 >= k:
                continue
            d = np.zeros((16, 8))
            for kt in range(mt_n):
                b_tile = np.zeros((16, 8))
                for lane in range(32):
                    g, t2 = lane >> 2, 2 * (lane & 3)
                    col = min(j0 + g, k - 1)
                    jd = col % n if plan.diag else -1
                    for e in range(4):
                        r = t2 + (e & 1) + 8 * (e >> 1)
                        l = 16 * kt + r
                        b_tile[r, g] = (b_buf[min(l, n - 1) * ldb + col]
                                        if k_read[l] and l != jd else 0.0)
                d += a_tiles[kt] @ b_tile
            for lane in range(32):
                g, t2 = lane >> 2, 2 * (lane & 3)
                for c in range(2):
                    j = j0 + t2 + c
                    for r in (g, g + 8):
                        i = 16 * mt + r
                        if j < k and i < n:
                            assert (i, j) not in out, (i, j)
                            v = d[r, t2 + c]
                            if plan.diag:
                                jn = j % n
                                v += a_buf[i * lda + i] * b_buf[i * ldb + j]
                                if jn != i:
                                    v += (a_buf[i * lda + jn]
                                          * b_buf[jn * ldb + j])
                            out[i, j] = v
    return out


def _products(form, n):
    """(tensor-core plan, [(A offset, lda, B offset, ldb, k)]) of the
    products of one arena layout at width n: the split form's (A at row
    stride ld, B at ld or the two-square slots' 2 ld, from offset 0), or
    every distinct operand layout of the plain form's step and doubling
    (tests/test_torch_step_tc.py:tc_products: X, X2, W1, W2 and their
    offsets in the step's arena)."""
    if form == "dev":
        plan = ldk.tc_plan(n)
        ld = plan.launch.ld
        return plan, [(0, ld, 0, ldb, k)
                      for k, ldb in ((n, ld), (n + 2, ld),
                                     (2 * n + 2, 2 * ld))]
    plan = lsk.tc_plan(n)
    seen = {}
    for p in tc_products(n, plan.launch.ld):
        if not p.mv:
            seen.setdefault((p.name, p.lda, p.ldb, p.k),
                            (p.a, p.lda, p.b, p.ldb, p.k))
    return plan, list(seen.values())


@pytest.mark.parametrize(
    "form,n", [("dev", n) for n in (1, 15, 16, 17, 30, 44, 64, 65, 75)]
    + [("plain", n) for n in (1, 5, 13, 15, 16)],
    ids=lambda v: v if isinstance(v, str) else str(v))
def test_tc_fragments_pad_k_with_zeros(form, n):
    """mm_tc's mirror on operands laid out as the arena lays them, every
    float outside the n x n and n x k blocks NaN: each output is stored
    once and equals A @ B, so no padded or clamped value reaches a stored
    sum. The split form (row 3) at each of its tile classes; the plain
    form (rows 1 and 4 at "high", the N <= 16 class, its diagonal terms
    added after the tile) at every product's offsets and strides in the
    step's arena."""
    plan, products = _products(form, n)
    rng = np.random.default_rng(n)
    size = max(max(a + n * lda, b + n * ldb)
               for a, lda, b, ldb, _ in products) + 64
    for a_off, lda, b_off, ldb, k in products:
        buf = np.full(size, np.nan)
        for i in range(n):
            buf[a_off + i * lda:a_off + i * lda + n] = rng.uniform(-1, 1, n)
        for i in range(n):
            buf[b_off + i * ldb:b_off + i * ldb + k] = rng.uniform(-1, 1, k)
        a = np.array([buf[a_off + i * lda:a_off + i * lda + n]
                      for i in range(n)])
        b = np.array([buf[b_off + i * ldb:b_off + i * ldb + k]
                      for i in range(n)])
        out = _mm_tc_mirror(buf[a_off:], lda, buf[b_off:], ldb, n, k, plan)
        assert len(out) == n * k
        got = np.array([[out[i, j] for j in range(k)] for i in range(n)])
        np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)


def test_modes_route_to_their_bodies():
    """"bf16x3" launches the tensor-core body's entry, "highest" and
    "default" the entry of the body on the CUDA cores; both entries take
    the same arguments, and the source instantiates the tensor-core kernel
    at bf16x3 alone."""
    assert ldk.entry_point("bf16x3") == "vsm_layer_step_dev_tc"
    assert ldk.entry_point("highest") == "vsm_layer_step_dev"
    assert ldk.entry_point("default") == "vsm_layer_step_dev"
    with pytest.raises(ValueError):
        ldk.entry_point("high")
    sig = build._SIGNATURES
    assert sig["vsm_layer_step_dev_tc"] == sig["vsm_layer_step_dev"]
    assert "entry_point(precision)" in inspect.getsource(ldk._launch)
    with open(os.path.join(build.CSRC, "layer_step_dev.cu")) as f:
        src = f.read()
    for entry in ("vsm_layer_step_dev", "vsm_layer_step_dev_tc"):
        assert f'extern "C" int {entry}(' in src
    tc = src.index('extern "C" int vsm_layer_step_dev_tc(')
    assert src.count("layer_step_dev_tc_kernel<") == 1
    assert src.index("layer_step_dev_tc_kernel<") > tc
    assert "WithTensorCores" in src[tc:]
    assert "vsm::kBf16x3" in src[tc:]


def test_order_sensitivity_at_bf16x3():
    """vsmartmom_torch.order_sensitivity at a small width: summed in
    another order, the step at bf16x3 stays within 1e-5 of max per field
    of its plain version, which itself is not the plain version at
    "highest"."""
    from vsmartmom_torch.order_sensitivity import sensitivity
    rec = sensitivity(15, 32, "bf16x3")
    assert set(rec["fields"]) == set(ldk.LayerRTDev._fields)
    assert all(0.0 <= e < 1e-5 for e in rec["fields"].values())
    assert rec["from_highest"] > 0.0
