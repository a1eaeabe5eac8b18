"""Build and load the port's CUDA kernels (``vsmartmom_torch/csrc/``).

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles them in seconds into one shared library for Hopper (``sm_90a``),
which is loaded with ctypes. Each source is compiled by its own ``nvcc``,
all started together, then linked once. The library lands in ``build/`` at
the repository root, named by a hash of every file under ``csrc/`` (headers
included) and the flags, and is built at the first kernel launch of a
process (never at import). There is no fallback: a missing ``nvcc`` or a
failed build raises.

The launch helpers shared by the kernel wrappers (operand checks, points
per block) live here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

from vsmartmom_torch._paths import BUILD_DIR
from vsmartmom_torch.util.timing import timeit

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("layer_step.cu", "layer_step_tangent.cu", "layer_step_dev.cu",
           "layer_scan.cu", "lanes.cu", "voigt.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: shared memory a block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
#: longest doubling schedule the kernels' launch parameters hold (kMaxSched
#: in csrc/rt_device.cuh)
MAX_SCHEDULE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # 6 composite + 4 elemental + ek + d inputs, 6 outputs; S, n, row stride,
    # schedule (host int*), nd, ni, product mode (mode_code), points per
    # block, shared bytes, stream
    "vsm_layer_step": [_P] * 18 + [_I, _I, _I, ctypes.POINTER(_I), _I, _I,
                                   _I, _I, _I, _P],
    # the 12 inputs of vsm_layer_step, their tangents over K columns, 6
    # output tangents; S, K, n, row stride, schedule, nd, ni, product mode,
    # teams per block, shared bytes, stream
    "vsm_layer_step_tangent": [_P] * 30 + [_I, _I, _I, _I,
                                           ctypes.POINTER(_I), _I, _I, _I,
                                           _I, _I, _P],
    # 7 composite + 5 elemental + ek + d inputs, 7 outputs; S, n, row
    # stride, schedule, nd, ni, product mode, points per block, shared
    # bytes, stream
    "vsm_layer_step_dev": [_P] * 21 + [_I, _I, _I, ctypes.POINTER(_I), _I,
                                       _I, _I, _I, _I, _P],
    # the same at bf16x3, on the tensor cores
    "vsm_layer_step_dev_tc": [_P] * 21 + [_I, _I, _I, ctypes.POINTER(_I),
                                          _I, _I, _I, _I, _I, _P],
    # r, t, jp, jm, ek inputs, 4 outputs; S, n, row stride, schedule, nd,
    # product mode, points per block, shared bytes, stream
    "vsm_doubling": [_P] * 9 + [_I, _I, _I, ctypes.POINTER(_I), _I, _I, _I,
                                _I, _P],
    # tau, omega, tau_sum, zw, zpp_c, zmp_c, qp, wct2, i0, d, 6 composite
    # inputs, 6 outputs; S, n, row stride, nz, K, schedule, nd, ni, i_mu0_n,
    # n_stokes, mu0, mu0_node, wct02, points per block, shared bytes, stream
    "vsm_layer_scan": [_P] * 22 + [_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float, _I, _I,
                                   _P],
    # the team path: the arguments of vsm_layer_step
    "vsm_lanes": [_P] * 18 + [_I, _I, _I, ctypes.POINTER(_I), _I, _I, _I,
                              _I, _P],
    # the wide path: 6 composite + 4 elemental + ek + d inputs, 6 outputs;
    # S, n, CTAs a point, rows a CTA, row stride, threads a CTA, schedule,
    # nd, ni, shared bytes a CTA, stream
    "vsm_lanes_wide": [_P] * 18 + [_I] * 6 + [ctypes.POINTER(_I), _I, _I,
                                              _I, _P],
    # grid_b, centers, item_block, item_lo, item_hi, block_item0, nu, amp,
    # igd, y; n_layers, n_lines, n_items, n_grid, cutoff, workspace, out,
    # stream
    "vsm_voigt": [_P] * 10 + [_I] * 4 + [ctypes.c_float, _P, _P, _P],
}
# rows 1 and 4 at "high" on the tensor cores: the arguments of their
# CUDA-core entries
_SIGNATURES.update({name + "_tc": _SIGNATURES[name]
                    for name in ("vsm_layer_step", "vsm_doubling")})

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_digest() -> str:
    """Hash of every file under csrc/ (sources and headers) and the
    flags: any edit there names a new library."""
    digest = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        digest.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p, p.communicate()[0]) for p in procs]
    for (p, out), cmd in zip(outs, cmds):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile the kernels if this source set has no library yet. Returns
    the library path."""
    out = os.path.join(BUILD_DIR, f"libvsm_kernels_{source_digest()}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                  for s, o in zip(SOURCES, objs)])
        lib_tmp = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, out)
    return out


def resource_usage(path: str) -> str:
    """Each kernel's registers, shared memory and local (spill) memory in
    the built library, as ``cuobjdump --dump-resource-usage`` lists them."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "--dump-resource-usage", path],
                         capture_output=True, text=True, check=True)
    return res.stdout


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


#: tile classes of the team kernels (``Cfg<NP, TT, TM, TN>`` in
#: csrc/rt_device.cuh): padded width NP, team threads TT, tile rows TM and
#: columns TN
TILE_CLASSES = ((16, 32, 2, 4), (32, 64, 4, 4), (48, 192, 3, 4),
                (64, 256, 4, 4))
#: the split-form step's tile classes: the four above and ``C80`` of
#: csrc/rt_device.cuh for N = 65 .. 80, which only that kernel instantiates
DEV_TILE_CLASSES = TILE_CLASSES + ((80, 320, 4, 4),)
#: threads a team kernel's block may have (kMaxBlock in csrc/rt_device.cuh)
MAX_BLOCK_THREADS = 512


class TeamLaunch(NamedTuple):
    """A team kernel's launch: teams (points) per block, dynamic
    shared-memory bytes, the arena's row stride and the threads a team."""
    points: int
    smem_bytes: int
    ld: int
    team_threads: int


def tile_class(n: int, classes=TILE_CLASSES):
    """(NP, TT, TM, TN) of the tile class for width n among ``classes``."""
    for cls in classes:
        if n <= cls[0]:
            return cls
    raise ValueError(f"N = {n}: the team kernels take N <= "
                     f"{classes[-1][0]}")


def round4(n: int) -> int:
    """n rounded up to a multiple of 4 floats (16 bytes)."""
    return (n + 3) & ~3


def team_launch_config(n: int, arena_floats, shared_floats: int = 0,
                       min_ld: int | None = None, classes=TILE_CLASSES):
    """The launch of a team kernel at width n whose points each use
    ``arena_floats(n, ld)`` floats of shared memory, beside
    ``shared_floats`` the block shares, on the tile class of n among
    ``classes``. The row stride ld is the least ld >= min_ld (default n)
    with ld = 4 mod 8 (float4 rows on distinct banks) unless that arena no
    longer fits a block, then round4(min_ld). A block takes as many teams as
    half an SM's shared memory holds (two blocks an SM), at least one and at
    most MAX_BLOCK_THREADS threads."""
    tt = tile_class(n, classes)[1]
    min_ld = n if min_ld is None else min_ld
    ld = min_ld + (4 - min_ld) % 8
    if 4 * (shared_floats + arena_floats(n, ld)) > MAX_SHARED_BYTES:
        ld = round4(min_ld)
    per_point = 4 * arena_floats(n, ld)
    pts = max(1, min(MAX_BLOCK_THREADS // tt,
                     (MAX_SHARED_BYTES // 2 - 4 * shared_floats)
                     // per_point))
    return TeamLaunch(pts, 4 * (shared_floats + pts * arena_floats(n, ld)),
                      ld, tt)


class TensorCorePlan(NamedTuple):
    """A team kernel's tiling on the tensor cores at width n (``mm_tc`` in
    csrc/rt_device.cuh): M and K pad to ``m_tiles`` tiles of 16 (the tile
    class's NP / 16); warp w of a point's ``warps`` owns m tile w % m_tiles
    and every ``warps_per_m_tile``-th 8-column tile from w // m_tiles;
    ``col_tiles[k]`` 8-column tiles cover a product of k columns in
    ``rounds[k]`` rounds (a warp's column tiles at most); ``k_read[l]``
    says whether padded K index l reads the operands (l < n) or zeros.
    ``launch`` is the kernel's launch at n. ``diag`` (``kTcDiag``): the
    terms l = i and l = j mod n of output (i, j) leave the a_hi b_hi
    pass's sum and are added to it after."""
    m_tiles: int
    padded: int
    warps: int
    warps_per_m_tile: int
    col_tiles: dict
    rounds: dict
    k_read: tuple
    launch: TeamLaunch
    diag: bool = False


def tensor_core_plan(n: int, launch: TeamLaunch, widths,
                     classes=TILE_CLASSES, diag=False) -> TensorCorePlan:
    """The tensor-core plan at width n of a kernel launched as ``launch``
    whose (n x n) @ (n x k) products have the column counts ``widths``."""
    np_ = tile_class(n, classes)[0]
    m_tiles, warps = np_ // 16, launch.team_threads // 32
    per_tile = warps // m_tiles
    col_tiles = {k: -(-k // 8) for k in widths}
    return TensorCorePlan(
        m_tiles, 16 * m_tiles, warps, per_tile, col_tiles,
        {k: -(-t // per_tile) for k, t in col_tiles.items()},
        tuple(l < n for l in range(16 * m_tiles)), launch, diag)


def doubling_arena_floats(n: int, ld: int) -> int:
    """Floats of the doubling phase's arena (``Arena`` in
    csrc/rt_device.cuh): six n x ld slots, jp and jm (round4(n) each), and
    W1, W2 of n x round4(2n + 2)."""
    return 6 * n * ld + 2 * round4(n) + 2 * n * round4(2 * n + 2)


#: the kernels with a forward-mode rule, as the JAX package gives its two
#: fused layer steps a custom_jvp; every other kernel raises under a
#: torch.func transform. The primal is the kernel. Row 1's tangent is the
#: tangent kernel (csrc/layer_step_tangent.cu) at the widths it takes
#: (layer_step_kernel.tangent_on_kernel), tangent_of_plain beyond them; row
#: 3's (engine kernel_dev, which no benchmark cell runs) is
#: tangent_of_plain at every width
DIFFERENTIABLE = ("fused_layer_step (engine kernel)",
                  "fused_layer_step_dev (engine kernel_dev)")


def check_unwrapped(name: str, xs):
    """Raise NotImplementedError where an operand is a tensor wrapped by a
    torch.func transform (jvp, jacfwd, vmap, grad): such a tensor has no
    storage of its own for a launch to read, and only the kernels of
    DIFFERENTIABLE have a forward rule."""
    for x in xs:
        if torch._C._functorch.is_functorch_wrapped_tensor(x):
            raise NotImplementedError(
                f"{name} has no forward rule under a torch.func transform: "
                f"only {' and '.join(DIFFERENTIABLE)} are differentiable, "
                f"as in the JAX package")


def tangent_of_plain(plain, ctx, tangents):
    """The ``jvp`` of a kernel's torch.autograd.Function: torch.func.jvp of
    its plain version at the primals saved by ``setup_context``
    (``ctx.saved_tensors``, then the static ``ctx.statics``). Tangents
    that arrive as None are zeros. The JAX package's custom_jvp of its
    layer steps does the same with their jnp twins."""
    with timeit("tangent"):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents))
        return torch.func.jvp(lambda *xs: plain(*xs, *ctx.statics),
                              primals, tangents)[1]


def check_operands(name: str, xs, device):
    """Every operand float32, contiguous, on ``device``, without autograd,
    and none wrapped by a torch.func transform (check_unwrapped)."""
    check_unwrapped(name, xs)
    for x in xs:
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"{name} takes float32 tensors on one device, "
                             f"got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if x.requires_grad:
            raise RuntimeError(f"{name} is forward-only")


#: the product modes of rows 1, 3 and 4 as their launch entries take them
#: (``Mode`` in csrc/rt_device.cuh): full fp32, three bf16 passes, one
MODE_CODES = {"highest": 0, "high": 1, "bf16x3": 1, "default": 2}


def mode_code(precision: str) -> int:
    """The launch entries' code of a product mode (core/precision.py)."""
    if precision not in MODE_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    return MODE_CODES[precision]


def schedule_array(ns_schedule):
    """The NS schedule as a host int array for a launch entry."""
    if len(ns_schedule) > MAX_SCHEDULE:
        raise ValueError(f"doubling schedule longer than {MAX_SCHEDULE}")
    return (ctypes.c_int * max(1, len(ns_schedule)))(*ns_schedule)
