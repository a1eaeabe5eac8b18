"""Locations of the data files the port reads in place.

The port shares its data with the JAX package (``vsmartmom/``) and the
repository's ``data/`` tree but imports none of that package's code:
importing any ``vsmartmom.*`` module loads JAX. Paths resolve from this
package's parent directory, so any working directory works.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's directory (YAML defaults, TIPS / isotopologue tables)
REFERENCE_PKG = os.path.join(REPO_ROOT, "vsmartmom")
#: HITRAN-format line lists (``<MOL>.par`` or ``<MOL>.npz``)
HITRAN_DIR = os.path.join(REPO_ROOT, "data", "hitran")
#: the Toon GGG2014 merged solar transmission line list (nu, transmission)
SOLAR_FILE = os.path.join(REPO_ROOT, "data", "solar", "solar.out")
#: what the port builds at run time: the CUDA kernels' library
#: (cuda/build.py) and the native host components (native/)
BUILD_DIR = os.path.join(REPO_ROOT, "build")
