"""Ring-effect demo: rotational-Raman filling-in of an absorption line.

Port twin of ``examples/ring_effect_demo.py``: runs the Raman-coupled RT
over a band with a synthetic absorption feature and prints the filling-in
factor ieR / R in the continuum and at the line core (the Grainger-Ring
signature that motivates the reference's RRS mode).

Run: python -m vsmartmom_torch.ring_effect_demo [--device cpu]
(the card by default).
"""
import argparse

import numpy as np
import torch

from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
from vsmartmom_torch.core.rt_run import BandRTInputs
from vsmartmom_torch.inelastic import make_rrs
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.device import DEFAULT_DEVICE
from vsmartmom_torch.util.quadrature import rt_set_streams


def ring_filling(device=DEFAULT_DEVICE, dtype=torch.float64):
    """Filling-in factor ieR / R over the demo band: (grid, fill)."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.05}

    grid = np.arange(12740.0, 13268.0, 4.0)
    n_spec = len(grid)
    rrs = make_rrs(grid, T=250.0)
    print(f"nSpec={n_spec}  n_Raman={rrs.n_raman}  "
          f"Cabannes fraction={rrs.omega_cabannes:.4f}")

    tau_rayl = np.full((2, n_spec), 0.2)
    line = 2.5 * np.exp(-0.5 * ((grid - grid[n_spec // 2]) / 6.0) ** 2)
    tau = tau_rayl + line[None, :]
    band = BandRTInputs(tau=tau,
                        omega=tau_rayl * rrs.omega_cabannes / tau,
                        zw=np.ones((2, 1, n_spec)),
                        greeks=[get_greek_rayleigh(rrs.depol_rayl)])
    R, _, ieR, _ = rt_run_band_rrs(pol, quad, band, rrs, tau_rayl / tau,
                                   [0.0], [0.0], 2, surf, dtype=dtype,
                                   device=device)
    return grid, ieR[0, 0] / R[0, 0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    grid, fill = ring_filling(device=args.device)
    c = len(grid) // 2
    print(f"filling-in: continuum {fill[10]:.4f}  line core {fill[c]:.4f} "
          f"(ratio {fill[c] / fill[10]:.2f})")
    if not fill[c] > fill[10]:
        raise SystemExit("no Ring effect: the line core is not filled in "
                         "more than the continuum")
    print("Ring effect reproduced")


if __name__ == "__main__":
    main()
