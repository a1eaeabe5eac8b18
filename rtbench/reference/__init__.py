"""The plain reference of the benchmark's comparison: the optics of a scene
worked out again from its parameter file and the repository's line lists,
and doubling-adding RT in float64 with exact solves.

Plain PyTorch and NumPy. It imports nothing of the program: the modules
beside this file are frozen copies of the plain float64 paths they follow
(parameter parsing, profile, Rayleigh, line-by-line Voigt, TIPS, NAI2 Mie
with delta-BGE truncation, Z moments, quadrature), and ``scene`` and
``rt`` hold what the benchmark adds on them.
"""
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: HITRAN-format line lists, read in place
HITRAN_DIR = os.path.join(REPO_ROOT, "data", "hitran")
#: TIPS-2017 partition sums and isotopologue tables, read in place
TIPS_DIR = os.path.join(REPO_ROOT, "vsmartmom", "spectroscopy", "data")
