"""Generalized spherical function recursions (Siewert / Sanghavi 2014 eq. 15).

Host-side (numpy, float64) setup math: these tables are computed once per run
for fixed angle grids and truncation length, then fed into the RT core.
ref: src/Scattering/legendre_functions.jl:17-186 (compute_associated_legendre_PRT)

All indexing here is 0-based: P[i_mu, l, m] holds P_l^m(mu_i) normalized by
sqrt((l-m)!/(l+m)!); similarly for the R, T generalized functions used for
polarized phase matrices.
"""
from __future__ import annotations

import numpy as np


def compute_associated_legendre_PRT(mu: np.ndarray, l_max: int):
    """Normalized P_l^m, R_l^m, T_l^m for l, m in [0, l_max-1].

    Returns three arrays of shape (len(mu), l_max, l_max) indexed [i, l, m].
    The internal recursion tracks -T; the returned T has the physical sign.
    """
    mu = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    n = len(mu)
    P = np.zeros((n, l_max, l_max))
    R = np.zeros((n, l_max, l_max))
    T = np.zeros((n, l_max, l_max))  # stores -T during recursion

    s = np.sqrt(1.0 - mu**2)
    c = mu

    for m in range(l_max):
        for l in range(m, l_max):
            if m == 0:
                if l == 0:
                    P[:, 0, 0] = 1.0
                elif l == 1:
                    P[:, 1, 0] = c
                elif l == 2:
                    P[:, 2, 0] = 0.5 * (3.0 * c * c - 1.0)
                    R[:, 2, 0] = 0.5 * np.sqrt(1.5) * s * s
                else:
                    P[:, l, 0] = ((2 * l - 1) * c * P[:, l - 1, 0]
                                  - (l - 1) * P[:, l - 2, 0]) / l
                    R[:, l, 0] = ((2 * l - 1) * c * R[:, l - 1, 0]
                                  - np.sqrt((l + 1.0) * (l - 3.0)) * R[:, l - 2, 0]
                                  ) / np.sqrt(l * l - 4.0)
            elif m == 1:
                if l == 1:
                    P[:, 1, 1] = np.sqrt(0.5) * s
                elif l == 2:
                    m1 = np.sqrt(1.0 / 6.0)
                    P[:, 2, 1] = m1 * 3.0 * c * s
                    R[:, 2, 1] = -m1 * c * np.sqrt(1.5) * s
                    T[:, 2, 1] = m1 * np.sqrt(1.5) * s
                else:
                    m1 = np.sqrt((l - 1.0) / (l + 1.0))
                    m2 = m1 * np.sqrt((l - 2.0) / l)
                    P[:, l, 1] = (m1 * (2 * l - 1) * c * P[:, l - 1, 1]
                                  - m2 * (l - 1 + m) * P[:, l - 2, 1]) / (l - m)
                    Z = (2.0 * m * (2 * l - 1)) / (l * (l - 1.0))
                    Y = ((l + m - 1.0) / (l - 1.0)) * np.sqrt((l - 3.0) * (l + 1.0))
                    X = ((l - m) / l) * np.sqrt(l * l - 4.0)
                    R[:, l, 1] = (m1 * (2 * l - 1) * c * R[:, l - 1, 1]
                                  - m2 * Y * R[:, l - 2, 1]
                                  + m1 * Z * T[:, l - 1, 1]) / X
                    T[:, l, 1] = (m1 * (2 * l - 1) * c * T[:, l - 1, 1]
                                  - m2 * Y * T[:, l - 2, 1]
                                  + m1 * Z * R[:, l - 1, 1]) / X
            else:
                if l == m:
                    fact1 = np.ones(n)
                    fact2 = np.ones(n)
                    for i in range(1, m + 1):
                        fact1 = fact1 * ((2 * i - 1) * s) / np.sqrt(i * (i + m))
                        if i > 2:
                            fact2 = fact2 * (s / 2.0) * np.sqrt((m + i) / (i - 2.0))
                        else:
                            fact2 = fact2 * (s / 2.0)
                    # Limits for s -> 0 (mu -> +-1)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        Aii = fact2 * (1.0 + c * c) / (s * s)
                        Aij = fact2 * (2.0 * c) / (s * s)
                    small = s <= 1e-8
                    if m == 2:
                        Aii = np.where(small, 0.5, Aii)
                        Aij = np.where(small, 0.5, Aij)
                    else:
                        Aii = np.where(small, 0.0, Aii)
                        Aij = np.where(small, 0.0, Aij)
                    P[:, l, m] = fact1
                    R[:, l, m] = Aii
                    T[:, l, m] = -Aij
                elif l == m + 1:
                    m1 = np.sqrt(1.0 / (l + m))
                    P[:, l, m] = (m1 * (2 * l - 1) * c * P[:, l - 1, m]) / (l - m)
                    Z = (2.0 * m * (2 * l - 1)) / (l * (l - 1.0))
                    X = ((l - m) / l) * np.sqrt(l * l - 4.0)
                    R[:, l, m] = (m1 * (2 * l - 1) * c * R[:, l - 1, m]
                                  + m1 * Z * T[:, l - 1, m]) / X
                    T[:, l, m] = (m1 * (2 * l - 1) * c * T[:, l - 1, m]
                                  + m1 * Z * R[:, l - 1, m]) / X
                else:
                    m1 = np.sqrt((l - m) / (l + m + 0.0))
                    m2 = m1 * np.sqrt((l - m - 1.0) / (l + m - 1.0))
                    P[:, l, m] = (m1 * (2 * l - 1) * c * P[:, l - 1, m]
                                  - m2 * (l - 1 + m) * P[:, l - 2, m]) / (l - m)
                    Z = (2.0 * m * (2 * l - 1)) / (l * (l - 1.0))
                    Y = ((l + m - 1.0) / (l - 1.0)) * np.sqrt((l - 3.0) * (l + 1.0))
                    X = ((l - m) / l) * np.sqrt(l * l - 4.0)
                    R[:, l, m] = (m1 * (2 * l - 1) * c * R[:, l - 1, m]
                                  - m2 * Y * R[:, l - 2, m]
                                  + m1 * Z * T[:, l - 1, m]) / X
                    T[:, l, m] = (m1 * (2 * l - 1) * c * T[:, l - 1, m]
                                  - m2 * Y * T[:, l - 2, m]
                                  + m1 * Z * R[:, l - 1, m]) / X

    return P, R, -T


def compute_mie_pi_tau(mu: np.ndarray, n_max: int):
    """Mie angular functions pi_n, tau_n (Bohren & Huffman pp. 94-96).

    ref: src/Scattering/legendre_functions.jl:188-215 (compute_mie_π_τ)
    Returns arrays of shape (len(mu), n_max).
    """
    mu = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    n = len(mu)
    pi_ = np.zeros((n, n_max))
    tau_ = np.zeros((n, n_max))
    pi_[:, 0] = 1.0
    pi_[:, 1] = 3.0 * mu
    tau_[:, 0] = mu
    tau_[:, 1] = 6.0 * mu**2 - 3.0
    for k in range(2, n_max):
        # 1-based order nn = k corresponds to recursion index in BH
        nn = k
        pi_[:, k] = ((2 * nn + 1) * mu * pi_[:, k - 1]
                     - (nn + 1) * pi_[:, k - 2]) / nn
        tau_[:, k] = (nn + 1) * mu * pi_[:, k] - (nn + 2) * pi_[:, k - 1]
    return pi_, tau_


def compute_legendre_poly(x: np.ndarray, n_max: int):
    """Legendre P_l and generalized P^2_l, R^2_l, T^2_l on x in [-1, 1].

    ref: src/Scattering/legendre_functions.jl:217-259 (compute_legendre_poly)
    Returns four arrays of shape (len(x), n_max), 0-based order along axis 1.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(x)
    assert n_max > 1
    P0 = np.zeros((n, n_max))
    P2 = np.zeros((n, n_max))
    R2 = np.zeros((n, n_max))
    T2 = np.zeros((n, n_max))
    P0[:, 0] = 1.0
    P0[:, 1] = x
    if n_max > 2:
        P2[:, 2] = 3.0 * (1.0 - x**2)
        R2[:, 2] = np.sqrt(1.5) * (1.0 + x**2)
        T2[:, 2] = np.sqrt(6.0) * x
    for k in range(2, n_max):
        l = k - 1
        P0[:, k] = ((2 * l + 1) * x * P0[:, k - 1] - l * P0[:, k - 2]) / (l + 1)
        if k > 2:
            ia = (2 * l + 1) * x
            ib = np.sqrt((l + 2.0) * (l - 2.0)) * (l + 2) / l
            ic = 4.0 * (2 * l + 1) / ((l + 1.0) * l)
            idd = np.sqrt((l + 3.0) * (l - 1.0)) * (l - 1) / (l + 1)
            P2[:, k] = (ia * P2[:, k - 1] - (l + 2) * P2[:, k - 2]) / (l - 1)
            R2[:, k] = (ia * R2[:, k - 1] - ib * R2[:, k - 2] - ic * T2[:, k - 1]) / idd
            T2[:, k] = (ia * T2[:, k - 1] - ib * T2[:, k - 2] - ic * R2[:, k - 1]) / idd
    return P0, P2, R2, T2
