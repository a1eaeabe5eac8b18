"""Tiled line-by-line Voigt cross section — CUDA kernel and plain version.

Replaces the TPU kernel ``vsmartmom/pallas/voigt_kernel.py:_voigt_kernel``
(reached through ``_voigt_pallas_call`` from ``VoigtPlan.run``):
sigma(nu) = sum_l amp_l Re w(igd_l (nu - nu_l) + i y_l) over the lines with
|nu - nu_l| <= cutoff (around the SHIFTED centre) and amp_l > 0; Re w from
Humlicek II where |x| + y >= 8 and Weideman-32 elsewhere.

What bounds it on Hopper: a few hundred f32 operations per in-window
(line, grid point) pair against a few bytes per grid point, so arithmetic.
Design: the host (f64 numpy, once per grid and line list) sorts the lines,
cuts the grid into 1024-point tiles centred on their real points and
finds each tile's line range; the kernel runs one block per tile and one
thread per grid point, sweeps only the tile's lines, staged through shared
memory, and evaluates only the branch of Re w each pair selects.

The dense f64 engine (spectroscopy/voigt.py) masks around the UNSHIFTED
centre; it is a different function from this one.
"""
from __future__ import annotations

import numpy as np
import torch

from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device

TILE = 1024                        # grid points per tile (one per thread)
CHUNK = 64                         # lines per row of the tile line ranges

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


def _line_range(starts, n_chunks, t, n_lines):
    lo = int(starts[t]) * CHUNK
    return lo, min((int(starts[t]) + int(n_chunks[t])) * CHUNK, n_lines)


def voigt_tiles_plain(grid_t, centers, starts, n_chunks, nu, amp, igd, y,
                      cutoff: float):
    """Plain torch version of the kernel: per tile, the (lines x 1024)
    masked sum over the tile's line range. Shapes as voigt_tiles."""
    n_tiles = grid_t.shape[0]
    out = torch.zeros_like(grid_t)
    starts, n_chunks = starts.tolist(), n_chunks.tolist()
    for t in range(n_tiles):
        lo, hi = _line_range(starts, n_chunks, t, nu.shape[0])
        if hi <= lo:
            continue
        dx = grid_t[t][None, :] - (nu[lo:hi] - centers[t])[:, None]
        x = igd[lo:hi, None] * dx
        re_w = rew_hw32sd(x, y[lo:hi, None].expand_as(x))
        keep = (torch.abs(dx) <= cutoff) & (amp[lo:hi, None] > 0.0)
        out[t] = torch.where(keep, amp[lo:hi, None] * re_w, 0.0).sum(dim=0)
    return out


#: f32 operations of one in-window (line, grid point) pair: the shift, the
#: scaled offset, the branch test and the weighted sum, plus Re w's branch
#: (counted from the expressions of csrc/voigt.cu)
FLOPS_PAIR = 5
FLOPS_HUMLICEK = 29
FLOPS_WEIDEMAN = 243


def voigt_work(grid_t, centers, starts, n_chunks, nu, amp, igd, y,
               cutoff: float):
    """(operations, device-memory bytes) that one call needs on these
    inputs: only the in-window pairs with amp > 0 are evaluated, each by
    the branch of Re w its (x, y) selects; every input is read once and
    the (n_tiles, 1024) output written once."""
    n_tiles = grid_t.shape[0]
    ops = 0
    st, nc = starts.tolist(), n_chunks.tolist()
    for t in range(n_tiles):
        lo, hi = _line_range(st, nc, t, nu.shape[0])
        if hi <= lo:
            continue
        dx = grid_t[t][None, :] - (nu[lo:hi] - centers[t])[:, None]
        keep = (torch.abs(dx) <= cutoff) & (amp[lo:hi, None] > 0.0)
        far = (torch.abs(igd[lo:hi, None] * dx) + y[lo:hi, None]) >= 8.0
        n_h = int((keep & far).sum())
        n_w = int(keep.sum()) - n_h
        ops += (n_h * (FLOPS_PAIR + FLOPS_HUMLICEK)
                + n_w * (FLOPS_PAIR + FLOPS_WEIDEMAN))
    nbytes = sum(x.numel() * x.element_size()
                 for x in (grid_t, centers, starts, n_chunks, nu, amp, igd,
                           y)) + grid_t.numel() * 4
    return ops, nbytes


def voigt_tiles(grid_t, centers, starts, n_chunks, nu, amp, igd, y,
                cutoff: float):
    """Tiled Voigt sum. grid_t: (n_tiles, 1024) tile-centred grid (f32);
    centers: (n_tiles,) f32; starts, n_chunks: (n_tiles,) int32 line rows of
    CHUNK lines; nu (band-centred), amp, igd, y: (n_lines,) f32, sorted by
    wavenumber. Returns (n_tiles, 1024).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if grid_t.device.type == "cpu":
        return voigt_tiles_plain(grid_t, centers, starts, n_chunks, nu, amp,
                                 igd, y, cutoff)
    if grid_t.device.type != "cuda":
        raise ValueError(f"unsupported device {grid_t.device}")
    n_tiles = grid_t.shape[0]
    n_lines = nu.shape[0]
    for x, dt in ((grid_t, torch.float32), (centers, torch.float32),
                  (starts, torch.int32), (n_chunks, torch.int32),
                  (nu, torch.float32), (amp, torch.float32),
                  (igd, torch.float32), (y, torch.float32)):
        if x.device != grid_t.device or x.dtype != dt \
                or not x.is_contiguous():
            raise ValueError(f"voigt_tiles: expected contiguous {dt} on "
                             f"{grid_t.device}, got {x.dtype} on {x.device}")
    if grid_t.shape != (n_tiles, TILE) or centers.shape != (n_tiles,) \
            or starts.shape != (n_tiles,) or n_chunks.shape != (n_tiles,) \
            or any(v.shape != (n_lines,) for v in (amp, igd, y)):
        raise ValueError("voigt_tiles: inconsistent shapes")
    out = torch.empty_like(grid_t)
    from vsmartmom_torch.cuda import build
    err = build.lib().vsm_voigt(
        grid_t.data_ptr(), centers.data_ptr(), starts.data_ptr(),
        n_chunks.data_ptr(), nu.data_ptr(), amp.data_ptr(), igd.data_ptr(),
        y.data_ptr(), n_lines, float(cutoff), out.data_ptr(), n_tiles,
        torch.cuda.current_stream(grid_t.device).cuda_stream)
    build.check(err, "voigt launch")
    global launches
    launches += 1
    return out


class VoigtPlan:
    """Reusable tiling/bucketing plan for one (grid, line-list) pair.

    Host work (sorting, tiling, per-tile line ranges) happens once in f64;
    each ``run`` ships the per-(p, T) line-parameter vectors and calls
    ``voigt_tiles`` once. Line ranges come from the unshifted line
    positions with a ``shift_margin`` [cm^-1] slack for pressure shifts.
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

        self.n_tiles = (self.n_grid + TILE - 1) // TILE
        pad_g = self.n_tiles * TILE - self.n_grid
        g_rel = grid64 - self.nu0
        grid_p = np.concatenate([g_rel, np.full(pad_g, g_rel[-1] + 1e6)])
        tiles = grid_p.reshape(self.n_tiles, TILE)
        # centre each tile on its REAL points only (a padded last tile
        # would otherwise shift the centre by ~1e6 and destroy f32
        # precision for its real points)
        hi_real = np.array([grid_p[min((t + 1) * TILE, self.n_grid) - 1]
                            for t in range(self.n_tiles)])
        centers = 0.5 * (tiles[:, 0] + hi_real)
        self.grid_t = torch.as_tensor(
            (tiles - centers[:, None]).astype(np.float32), device=self.device)
        self.centers = torch.as_tensor(centers.astype(np.float32),
                                       device=self.device)

        pad = wing_cutoff + shift_margin
        lo = tiles.min(axis=1) - pad
        hi = hi_real + pad
        first = np.searchsorted(nu64, lo, side="left")
        last = np.searchsorted(nu64, hi, side="right")
        start_row = (first // CHUNK).astype(np.int32)
        n_ck = np.maximum(
            -(-(last - start_row * CHUNK) // CHUNK), 0).astype(np.int32)
        self.n_l = len(nu64)
        self.starts = torch.as_tensor(start_row, device=self.device)
        self.n_chunks = torch.as_tensor(n_ck, device=self.device)

    def line_inputs(self, nu_s, strength, gamma_d, y):
        """Sorted f32 kernel inputs (nu band-centred, amp, igd, y) for
        pressure-shifted positions nu_s (host f64: the band-centring
        subtraction happens in f64 before the f32 cast) and per-line
        strength / Doppler HWHM / y in the original line order."""
        dev = self.device
        nu_rel = torch.as_tensor(
            (np.asarray(nu_s, np.float64) - self.nu0).astype(np.float32),
            device=dev)
        s = torch.as_tensor(np.asarray(strength), dtype=torch.float32,
                            device=dev)[self.order]
        gd = torch.as_tensor(np.asarray(gamma_d), dtype=torch.float32,
                             device=dev)[self.order]
        amp = torch.clamp_min(s * _SQRT_LN2_DIV_SQRT_PI / gd, 1e-45)
        igd = _SQRT_LN2 / gd
        yv = torch.as_tensor(np.asarray(y), dtype=torch.float32,
                             device=dev)[self.order]
        return nu_rel[self.order], amp, igd, yv

    def run(self, nu_s, strength, gamma_d, y):
        """sigma(grid) (n_grid,) f32 tensor on the plan's device."""
        nu, amp, igd, yv = self.line_inputs(nu_s, strength, gamma_d, y)
        out = voigt_tiles(self.grid_t, self.centers, self.starts,
                          self.n_chunks, nu, amp, igd, yv, self.wing_cutoff)
        return out.reshape(-1)[:self.n_grid]
