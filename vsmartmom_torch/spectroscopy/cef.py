"""Complex error (Faddeeva) function w(z) for Voigt lineshapes, in torch.

ref: src/Absorption/complex_error_functions.jl (Humlicek 1982 region II,
Weideman 1994 32-term rational approximation). Only the reference's
default CEF is ported; the other CEFs of the JAX package's registry are
not (ROADMAP queue 1, item 5).

Takes a complex tensor z = x + i*y with y > 0 and returns complex w(z);
both branches are evaluated and selected with torch.where.
"""
from __future__ import annotations

import numpy as np
import torch

_ISQRTPI = 1.0 / np.sqrt(np.pi)

# Weideman (1994) eq. 38.I, N=32 coefficients (Table I)
_W32 = np.array([
    2.5722534081245696e+00, 2.2635372999002676e+00, 1.8256696296324824e+00,
    1.3455441692345453e+00, 9.0192548936480144e-01, 5.4601397206393498e-01,
    2.9544451071508926e-01, 1.4060716226893769e-01, 5.7304403529837900e-02,
    1.9006155784845689e-02, 4.5195411053501429e-03, 3.9259136070122748e-04,
    -2.4532980269928922e-04, -1.3075449254548613e-04, -2.1409619200870880e-05,
    6.8210319440412389e-06, 4.4015317319048931e-06, 4.2558331390536872e-07,
    -4.1840763666294341e-07, -1.4813078891201116e-07, 2.2930439569075392e-08,
    2.3797557105844622e-08, 8.1248960947953431e-10, -3.2080150458594088e-09,
    -5.2310170266050247e-10, 4.1537465934749353e-10, 1.1658312885903929e-10,
    -5.5441820344468828e-11, -2.1542618451370239e-11, 8.0314997274316680e-12,
    3.7424975634801558e-12, -1.3031797863050087e-12])


def humlicek2(z):
    """Humlicek (1982) region II (fortran-code variant)."""
    t = torch.complex(z.imag, -z.real)           # y - i x
    u = t * t
    return (t * (1.410474 + u * _ISQRTPI)) / (0.75 + u * (3.0 + u))


def weideman32(z):
    """Weideman (1994) 32-term rational approximation."""
    L = float(np.sqrt(32.0 / np.sqrt(2.0)))
    iz = torch.complex(-z.imag, z.real)
    rec = 1.0 / (L - iz)
    Z = (L + iz) * rec
    poly = torch.zeros_like(z) + float(_W32[-1])
    for c in _W32[-2::-1]:
        poly = poly * Z + float(c)
    return (_ISQRTPI + 2.0 * poly * rec) * rec


def w_humlicek_weideman32_sd(z):
    """|x|+y >= 8: Humlicek region II; else Weideman-32 (reference default)."""
    s = torch.abs(z.real) + z.imag
    return torch.where(s >= 8.0, humlicek2(z), weideman32(z))


CEF_REGISTRY = {
    "HumlicekWeidemann32SDErrorFunction": w_humlicek_weideman32_sd,
}
