"""Native (C++) host components of the port, bound via ctypes (port of
``vsmartmom/native/__init__.py``).

Currently the HITRAN line-list scanner (``hitran_parser.cpp``, a copy of
the JAX package's). A component compiles at its first use with the system
``g++`` into the repository's ``build/`` directory (beside the CUDA
kernels' library, cuda/build.py), named by a digest of its source, the
flags and the host, and written with an atomic rename so that concurrent
processes can build it at once. Callers choose what a failed build does
(spectroscopy/hitran.py: read_hitran's ``engine``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

from vsmartmom_torch._paths import BUILD_DIR

#: no -march=native: the build directory may travel to another host
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB_CACHE: dict = {}


def load_native(name: str) -> ctypes.CDLL:
    """Compile (once per source digest) and dlopen the named component."""
    if name in _LIB_CACHE:
        return _LIB_CACHE[name]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CXX_FLAGS + platform.uname()).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.tmp.{os.getpid()}"
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _LIB_CACHE[name] = lib
    return lib
