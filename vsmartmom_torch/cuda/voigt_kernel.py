"""Layered line-by-line Voigt cross section — CUDA kernel and plain version.

Replaces the TPU kernel ``vsmartmom/pallas/voigt_kernel.py:_voigt_kernel``
(reached through ``_voigt_pallas_call`` from ``VoigtPlan.run``):
sigma(nu) = sum_l amp_l Re w(igd_l (nu - nu_l) + i y_l) over the lines with
|nu - nu_l| <= cutoff (around the SHIFTED centre) and amp_l > 0; Re w from
Humlicek II where |x| + y >= 8 and Weideman-32 elsewhere.

What bounds it on Hopper: a few dozen f32 operations per in-window
(line, grid point) pair against a few bytes per grid point, so arithmetic.
Design: the host (f64 numpy, once per grid and line list) sorts the lines,
cuts the grid into point blocks of BLOCK points, finds each block's line
range at line granularity and splits it into items of at most SPLIT lines.
Offsets are taken from the centre of the real points of the block's
TILE-point tile, as the TPU kernel takes them: centred on their own 256
points, blocks put the port 3.2e-5 of max sigma from the JAX plan, over the
2e-5 that the tests allow. One launch covers every layer of a band:
a block of the kernel per (item, layer) sweeps the item's lines for its
point block, a thread four grid points at a time, into a workspace of
partial sums, and a second pass adds each block's items in order (no float
atomics: the result is deterministic). See csrc/voigt.cu.

The dense f64 engine (spectroscopy/voigt.py) masks around the UNSHIFTED
centre; it is a different function from this one.
"""
from __future__ import annotations

import numpy as np
import torch

from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device

BLOCK = 256                        # grid points of a point block (kBlock)
TILE = 1024                        # grid points sharing one offset centre
SPLIT = 128                        # most lines an item sweeps (kSplit)
#: most layers one launch takes (the grid's y dimension)
MAX_LAYERS = 65535
#: most (line, grid point) pairs the plain version holds at once
PAIRS_PER_CHUNK = 1 << 22

_ISQRTPI = 0.5641895835477563
_SQRT_LN2 = 0.8325546111576977
_SQRT_LN2_DIV_SQRT_PI = 0.46971863934982566
_L32 = float(np.sqrt(32.0 / np.sqrt(2.0)))

#: kernel launches since the count was last reset (set it to 0 to reset)
launches = 0


def _rew_humlicek2(x, y):
    """Re w(z), Humlicek (1982) region II, real arithmetic.
    t = y - i x; w = t (1.410474 + u/sqrt(pi)) / (0.75 + u (3 + u))."""
    u_re = y * y - x * x
    u_im = -2.0 * x * y
    a = 1.410474 + _ISQRTPI * u_re
    b = _ISQRTPI * u_im
    num_re = y * a + x * b
    num_im = y * b - x * a
    d3 = 3.0 + u_re
    den_re = 0.75 + u_re * d3 - u_im * u_im
    den_im = u_im * d3 + u_re * u_im
    return ((num_re * den_re + num_im * den_im)
            / (den_re * den_re + den_im * den_im))


def _rew_weideman32(x, y):
    """Re w(z), Weideman-32 rational approximation, real arithmetic.
    iz = (-y, x); Z = (L + iz)/(L - iz); w = (1/sqrt(pi) + 2 poly(Z) R) R
    with R = 1/(L - iz)."""
    from vsmartmom_torch.spectroscopy.cef import _W32
    lr, li = _L32 + y, -x
    inv = 1.0 / (lr * lr + li * li)
    r_re, r_im = lr * inv, -li * inv            # R = 1/(L - iz)
    n_re, n_im = _L32 - y, x                    # L + iz
    z_re = n_re * r_re - n_im * r_im
    z_im = n_re * r_im + n_im * r_re
    p_re = torch.full_like(x, float(_W32[-1]))
    p_im = torch.zeros_like(x)
    for c in [float(v) for v in _W32[-2::-1]]:
        t_re = p_re * z_re - p_im * z_im + c
        p_im = p_re * z_im + p_im * z_re
        p_re = t_re
    q_re = 2.0 * (p_re * r_re - p_im * r_im) + _ISQRTPI
    q_im = 2.0 * (p_re * r_im + p_im * r_re)
    return q_re * r_re - q_im * r_im


def rew_hw32sd(x, y):
    """Re w(x + iy): |x| + y >= 8 -> Humlicek II, else Weideman-32 (the
    reference's default CEF, spectroscopy.cef.w_humlicek_weideman32_sd)."""
    s = torch.abs(x) + y
    return torch.where(s >= 8.0, _rew_humlicek2(x, y), _rew_weideman32(x, y))


def _item_pairs(grid_b, centers, item_block, item_lo, item_hi, nu, amp, igd,
                y, cutoff: float):
    """The (line, grid point) pairs of every (layer, item), in chunks of at
    most PAIRS_PER_CHUNK pairs: yields each chunk's rows of the (layers x
    blocks, BLOCK) output, and its scaled offsets x, y and amp as (units,
    lines, BLOCK) or broadcastable, with the mask of the pairs the kernel keeps
    (the item's lines, in window, amp > 0)."""
    n_layers, n_lines = nu.shape
    n_items, n_blocks = item_block.shape[0], grid_b.shape[0]
    count = (item_hi - item_lo).long()
    r = int(count.max()) if n_items else 0
    if r == 0 or n_layers == 0:
        return
    dev = nu.device
    blk_of, lo_of = item_block.long(), item_lo.long()
    j = torch.arange(r, device=dev)
    flat = [v.reshape(-1) for v in (nu, amp, igd, y)]
    per = max(1, PAIRS_PER_CHUNK // (r * grid_b.shape[1]))
    for u0 in range(0, n_layers * n_items, per):
        u = torch.arange(u0, min(u0 + per, n_layers * n_items), device=dev)
        layer, item = u // n_items, u % n_items
        blk = blk_of[item]
        valid = j[None, :] < count[item][:, None]
        idx = (layer[:, None] * n_lines
               + torch.clamp(lo_of[item][:, None] + j[None, :],
                             max=n_lines - 1))
        nu_g, amp_g, igd_g, y_g = (v[idx][:, :, None] for v in flat)
        dx = grid_b[blk][:, None, :] - (nu_g - centers[blk][:, None, None])
        keep = valid[:, :, None] & (torch.abs(dx) <= cutoff) & (amp_g > 0.0)
        yield layer * n_blocks + blk, igd_g * dx, y_g, amp_g, keep


def voigt_tiles_plain(grid_b, centers, item_block, item_lo, item_hi,
                      block_item0, nu, amp, igd, y, cutoff: float,
                      n_grid: int):
    """Plain torch version of the kernel: for each layer and item, the
    masked sum of the item's lines over its point block, added per block.
    Shapes as voigt_tiles."""
    n_layers, n_blocks = nu.shape[0], grid_b.shape[0]
    out = torch.zeros((n_layers * n_blocks, grid_b.shape[1]),
                      dtype=grid_b.dtype, device=grid_b.device)
    for rows, x, yv, a, keep in _item_pairs(
            grid_b, centers, item_block, item_lo, item_hi, nu, amp, igd, y,
            cutoff):
        part = torch.where(keep, a * rew_hw32sd(x, yv.expand_as(x)), 0.0)
        out.index_add_(0, rows, part.sum(dim=1))
    return out.reshape(n_layers, n_blocks * grid_b.shape[1])[:, :n_grid]


#: f32 operations of one in-window (line, grid point) pair: the shift, the
#: scaled offset, the branch test and the weighted sum, plus Re w's branch
#: (counted from the expressions of csrc/voigt.cu)
FLOPS_PAIR = 5
FLOPS_HUMLICEK = 29
FLOPS_WEIDEMAN = 243


def voigt_work(grid_b, centers, item_block, item_lo, item_hi, block_item0,
               nu, amp, igd, y, cutoff: float, n_grid: int):
    """(operations, device-memory bytes) that one call needs on these
    inputs, summed over its layers: only the in-window pairs with amp > 0
    are evaluated, each by the branch of Re w its (x, y) selects; every
    input is read once and the (layers, n_grid) output written once."""
    ops = 0
    for _, x, yv, _, keep in _item_pairs(
            grid_b, centers, item_block, item_lo, item_hi, nu, amp, igd, y,
            cutoff):
        n_h = int((keep & (torch.abs(x) + yv >= 8.0)).sum())
        n_w = int(keep.sum()) - n_h
        ops += (n_h * (FLOPS_PAIR + FLOPS_HUMLICEK)
                + n_w * (FLOPS_PAIR + FLOPS_WEIDEMAN))
    nbytes = sum(v.numel() * v.element_size()
                 for v in (grid_b, centers, item_block, item_lo, item_hi,
                           block_item0, nu, amp, igd, y)) \
        + nu.shape[0] * n_grid * 4
    return ops, nbytes


def _launch(grid_b, centers, item_block, item_lo, item_hi, block_item0, nu,
            amp, igd, y, cutoff: float, n_grid: int, stream):
    """Launch the kernel and its reduction on checked operands, with the
    (layers, items, BLOCK) workspace of partial sums; returns the launch's
    cudaError_t and the (layers, n_grid) output."""
    from vsmartmom_torch.cuda import build
    n_layers, n_lines = nu.shape
    n_items = item_block.shape[0]
    ws = torch.empty((n_layers, n_items, BLOCK), dtype=torch.float32,
                     device=nu.device)
    out = torch.empty((n_layers, n_grid), dtype=torch.float32,
                      device=nu.device)
    err = build.lib().vsm_voigt(
        *(v.data_ptr() for v in (grid_b, centers, item_block, item_lo,
                                 item_hi, block_item0, nu, amp, igd, y)),
        n_layers, n_lines, n_items, n_grid, float(cutoff), ws.data_ptr(),
        out.data_ptr(), stream)
    return err, out


def voigt_tiles(grid_b, centers, item_block, item_lo, item_hi, block_item0,
                nu, amp, igd, y, cutoff: float, n_grid: int):
    """Layered Voigt sum. grid_b: (n_blocks, BLOCK) grid offsets from the
    centre of each block's tile (f32); centers: (n_blocks,) f32 those
    centres; item_block, item_lo, item_hi:
    (n_items,) int32 point block and [first, end) sorted-line indices of
    each item (a block's items adjacent, in line order); block_item0:
    (n_blocks + 1,) int32 first item of each block; nu (band-centred), amp,
    igd, y: (layers, n_lines) f32, sorted by wavenumber along the lines.
    Returns (layers, n_grid).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (NotImplementedError under a torch.func transform: no forward
    rule).
    """
    args = (grid_b, centers, item_block, item_lo, item_hi, block_item0, nu,
            amp, igd, y)
    if grid_b.device.type == "cpu":
        return voigt_tiles_plain(*args, cutoff, n_grid)
    if grid_b.device.type != "cuda":
        raise ValueError(f"unsupported device {grid_b.device}")
    from vsmartmom_torch.cuda import build
    build.check_unwrapped("voigt_tiles", args)
    for v, dt in zip(args, (torch.float32,) * 2 + (torch.int32,) * 4
                     + (torch.float32,) * 4):
        if v.device != grid_b.device or v.dtype != dt \
                or not v.is_contiguous():
            raise ValueError(f"voigt_tiles: expected contiguous {dt} on "
                             f"{grid_b.device}, got {v.dtype} on {v.device}")
    n_blocks, n_items = grid_b.shape[0], item_block.shape[0]
    n_layers = nu.shape[0]
    if grid_b.shape != (n_blocks, BLOCK) or centers.shape != (n_blocks,) \
            or block_item0.shape != (n_blocks + 1,) \
            or any(v.shape != (n_items,) for v in (item_lo, item_hi)) \
            or nu.dim() != 2 \
            or any(v.shape != nu.shape for v in (amp, igd, y)) \
            or not 0 <= n_grid <= n_blocks * BLOCK:
        raise ValueError("voigt_tiles: inconsistent shapes")
    if n_layers > MAX_LAYERS:
        raise ValueError(f"voigt_tiles takes at most {MAX_LAYERS} layers")
    if n_layers == 0 or n_grid == 0:
        return torch.zeros((n_layers, n_grid), device=grid_b.device)
    err, out = _launch(*args, cutoff, n_grid,
                       torch.cuda.current_stream(grid_b.device).cuda_stream)
    build.check(err, "voigt launch")
    global launches
    launches += 1
    return out


class VoigtPlan:
    """Reusable blocking plan for one (grid, line-list) pair.

    Host work (sorting, point blocks, per-block line ranges and their items)
    happens once in f64; each ``run`` ships the line-parameter vectors of
    one (p, T) or of a stack of layers and calls ``voigt_tiles`` once. Line
    ranges come from the unshifted line positions with a ``shift_margin``
    [cm^-1] slack for pressure shifts.
    """

    def __init__(self, grid, nu_lines, wing_cutoff, shift_margin=0.5,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        grid64 = np.asarray(grid, np.float64)
        self.nu0 = 0.5 * (grid64[0] + grid64[-1])
        self.n_grid = len(grid64)
        order = np.argsort(nu_lines, kind="stable")
        nu64 = np.asarray(nu_lines, np.float64)[order] - self.nu0
        self.order = torch.as_tensor(order.astype(np.int64),
                                     device=self.device)
        self.wing_cutoff = float(wing_cutoff)
        self.n_l = len(nu64)

        self.n_blocks = -(-self.n_grid // BLOCK)
        g_rel = grid64 - self.nu0
        pad_g = self.n_blocks * BLOCK - self.n_grid
        blocks = np.concatenate([g_rel, np.full(pad_g, g_rel[-1] + 1e6)]) \
            .reshape(self.n_blocks, BLOCK)
        # offsets from the centre of the block's TILE-point tile, as the
        # TPU kernel rounds them, on its REAL points only (a padded last
        # tile would otherwise shift the centre by ~1e6 and destroy f32
        # precision for its real points)
        ends = np.minimum(BLOCK * np.arange(1, self.n_blocks + 1),
                          self.n_grid)
        hi_real = g_rel[ends - 1]
        t0 = np.arange(self.n_blocks) * BLOCK // TILE * TILE
        centers = 0.5 * (g_rel[t0] + g_rel[np.minimum(t0 + TILE,
                                                      self.n_grid) - 1])
        self.grid_b = torch.as_tensor(
            (blocks - centers[:, None]).astype(np.float32),
            device=self.device)
        self.centers = torch.as_tensor(centers.astype(np.float32),
                                       device=self.device)

        # each block's [first, last) sorted lines, split into items of at
        # most SPLIT lines (at least one item a block, so every block is
        # written)
        pad = wing_cutoff + shift_margin
        self.first = np.searchsorted(nu64, blocks[:, 0] - pad, side="left")
        self.last = np.maximum(
            np.searchsorted(nu64, hi_real + pad, side="right"), self.first)
        length = self.last - self.first
        n_split = np.maximum(1, -(-length // SPLIT))
        item0 = np.concatenate([[0], np.cumsum(n_split)])
        blk = np.repeat(np.arange(self.n_blocks), n_split)
        k = np.arange(len(blk)) - item0[blk]
        lo = self.first[blk] + k * length[blk] // n_split[blk]
        hi = self.first[blk] + (k + 1) * length[blk] // n_split[blk]
        self.n_items = len(blk)

        def i32(v):
            return torch.as_tensor(np.asarray(v, np.int32),
                                   device=self.device)
        self.item_block, self.item_lo, self.item_hi = i32(blk), i32(lo), \
            i32(hi)
        self.block_item0 = i32(item0)

    def line_inputs(self, nu_s, strength, gamma_d, y):
        """Sorted f32 kernel inputs (nu band-centred, amp, igd, y), each
        (layers, n_lines), for pressure-shifted positions nu_s (host f64:
        the band-centring subtraction happens in f64 before the f32 cast)
        and per-line strength / Doppler HWHM / y in the original line order,
        each (n_lines,) for one (p, T) or (layers, n_lines)."""
        dev = self.device

        def sort(v):
            v = torch.as_tensor(np.atleast_2d(v), dtype=torch.float32,
                                device=dev)
            return torch.index_select(v, 1, self.order)
        nu_rel = sort((np.asarray(nu_s, np.float64) - self.nu0)
                      .astype(np.float32))
        gd = sort(gamma_d)
        amp = torch.clamp_min(sort(strength) * _SQRT_LN2_DIV_SQRT_PI / gd,
                              1e-45)
        return nu_rel, amp, _SQRT_LN2 / gd, sort(y)

    def call_args(self, nu, amp, igd, y):
        """The arguments of ``voigt_tiles`` for these line inputs."""
        return (self.grid_b, self.centers, self.item_block, self.item_lo,
                self.item_hi, self.block_item0, nu, amp, igd, y,
                self.wing_cutoff, self.n_grid)

    def run(self, nu_s, strength, gamma_d, y):
        """sigma(grid) as an f32 tensor on the plan's device: (n_grid,) for
        line parameters of one (p, T), each (n_lines,); (layers, n_grid)
        for a stack of layers, each (layers, n_lines), in one launch."""
        out = voigt_tiles(*self.call_args(
            *self.line_inputs(nu_s, strength, gamma_d, y)))
        return out[0] if np.ndim(nu_s) == 1 else out
