"""Build and load the port's CUDA kernels (``vsmartmom_torch/csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles them in seconds into one shared library for Hopper (``sm_90a``),
which is loaded with ctypes. The library lands in ``build/`` at the
repository root, named by a hash of the sources, and is built at the first
kernel launch of a process (never at import). There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

from vsmartmom_torch._paths import REPO_ROOT

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build")
SOURCES = ("layer_step.cu", "voigt.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # 6 composite + 4 elemental + ek + d inputs, 6 outputs; S, n, schedule
    # (host int*), nd, ni, points per block, shared bytes, stream
    "vsm_layer_step": [_P] * 18 + [_I, _I, ctypes.POINTER(_I), _I, _I, _I,
                                   _I, _P],
    # grid_t, centers, starts, n_chunks, nu, amp, igd, y, n_lines, cutoff,
    # out, n_tiles, stream
    "vsm_voigt": [_P] * 8 + [_I, ctypes.c_float, _P, _I, _P],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the kernels if this source set has no library yet. Returns
    the library path."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    digest = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR,
                       f"libvsm_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
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
