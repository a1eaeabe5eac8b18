"""Canopy scene demo: red-edge reflectance of vegetation under an
atmosphere, with in-canopy radiation profiles.

Port twin of ``examples/canopy_demo.py``: a Rayleigh atmosphere over a
3-slab vegetation canopy over dark soil, the leaf single-scattering albedo
swept across a PROSPECT-like red edge (0.25 -> 0.95); prints TOA
reflectance, HDRF and the downwelling profile inside the canopy (the light
available at each canopy depth). Mirrors the reference's rt_run_canopy
capability (ref: src/CoreRT/rt_run_canopy.jl:10-487).

Run: python -m vsmartmom_torch.canopy_demo [--device cpu]
(the card by default).
"""
import argparse

import numpy as np
import torch

from vsmartmom_torch.core.canopy import CanopyRTInputs, rt_run_canopy
from vsmartmom_torch.core.rt_run import BandRTInputs
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.device import DEFAULT_DEVICE
from vsmartmom_torch.util.quadrature import rt_set_streams

#: the demo's canopy: LAI 3 in 3 slabs, chi 0.1, a red-edge leaf albedo
CANOPY = dict(lai=3.0, rho_l=0.45, tau_l=0.40, chi=0.1, n_layers=3)
SOIL = {"type": "LambertianSurfaceScalar", "albedo": 0.05}
LEVELS = [0, 1, 2, 3]


def canopy_scene(device=DEFAULT_DEVICE, dtype=torch.float64):
    """The demo's scene: (leaf ssa, rt_run_canopy's seven outputs)."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 30.0, [0.0], pol.n)

    # "red edge": leaf albedo from strongly absorbing (red) to strongly
    # scattering (NIR) across the spectral axis
    n_spec = 6
    ssa = np.linspace(0.25, 0.95, n_spec)

    # thin Rayleigh atmosphere above
    n_z = 2
    tau = np.full((n_z, n_spec), 0.04)
    band = BandRTInputs(tau=tau, omega=np.full_like(tau, 0.999),
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.03)])
    canopy = CanopyRTInputs(ssa=ssa, **CANOPY)
    return ssa, rt_run_canopy(pol, quad, band, canopy, [0.0], [0.0], 3,
                              SOIL, dtype=dtype, device=device,
                              sensor_levels=LEVELS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    ssa, (R, T, hdr, bhr_uw, bhr_dw, uw, dw) = canopy_scene(args.device)

    print("leaf ssa:          ", " ".join(f"{v:6.2f}" for v in ssa))
    print("TOA reflectance:   ", " ".join(f"{v:6.3f}" for v in R[0, 0]))
    print("HDRF (surface):    ", " ".join(f"{v:6.3f}" for v in hdr[0, 0]))
    print("BHR up/down ratio: ", " ".join(
        f"{u/d:6.3f}" for u, d in zip(bhr_uw, bhr_dw)))
    print("DIFFUSE downwelling I at canopy interfaces (top->soil; the\n"
          "  direct beam converts to diffuse inside the canopy, so the\n"
          "  profile peaks below the top then decays):")
    for k in range(len(LEVELS)):
        print(f"  level {k}:", " ".join(f"{v:8.1e}" for v in dw[k, 0, 0]))

    # physical checks: reflectance rises along the red edge; light decays
    # downward through the canopy at the absorbing end
    if not np.all(np.diff(R[0, 0]) > 0):
        raise SystemExit("TOA reflectance does not rise along the red edge")
    if not dw[3, 0, 0, 0] < dw[1, 0, 0, 0]:
        raise SystemExit("diffuse light does not decay down the canopy at "
                         "the absorbing end")
    print("canopy demo OK")


if __name__ == "__main__":
    main()
