"""Wigner 3-j symbol tables for the PCW (Domke) Mie decomposition.

The reference builds its tables with memoized scalar recursions from
Sanghavi 2014 eqs. 25-31 (ref: src/Scattering/compute_wigner_values.jl).
Here we instead use the standard three-term recurrence in j1 (Schulten &
Gordon 1975; Luscombe & Luban 1998): for fixed (j2, j3, m1, m2, m3) the
entire row f(j1), j1 = jmin..jmax, satisfies

    j A(j+1) f(j+1) + B(j) f(j) + (j+1) A(j) f(j-1) = 0
    A(j) = sqrt[(j^2-(j2-j3)^2)((j2+j3+1)^2-j^2)(j^2-m1^2)]
    B(j) = -(2j+1)[ j2(j2+1) m1 - j3(j3+1) m1 - j(j+1)(m3-m2) ]

with A(jmin) = A(jmax+1) = 0, normalization sum_j (2j+1) f(j)^2 = 1 and
sign(f(jmax)) = (-1)^(j2-j3+m2-m3). We run the recursion forward from jmin
and backward from jmax, match the branches where both are healthy, then
normalize — and the whole table construction is vectorized across every
(j2, j3) row at once (one global sweep over j), which is what makes
full-size production tables (N_max ~ several hundred) build in seconds.

Needed configurations (m1, m2, m3): (-1, 1, 0) -> table A,
(-1, -1, 2) -> table B, (0, 0, 0) (used only via scalar calls in tests).
"""
from __future__ import annotations

import numpy as np


def _row_coeffs(j, j2, j3, m1, m2, m3):
    """A(j), B(j) of the three-term recurrence, vectorized over j and rows."""
    with np.errstate(invalid="ignore"):
        a = np.sqrt(np.maximum(
            (j**2 - (j2 - j3) ** 2).astype(np.float64)
            * ((j2 + j3 + 1) ** 2 - j**2)
            * (j**2 - m1**2), 0.0))
    b = -(2.0 * j + 1.0) * (j2 * (j2 + 1.0) * m1 - j3 * (j3 + 1.0) * m1
                            - j * (j + 1.0) * (m3 - m2))
    return a, b


def wigner3j_row(j2: int, j3: int, m1: int, m2: int, m3: int):
    """All w3j(j1, j2, j3; m1, m2, m3) for j1 = jmin..jmax.

    Returns (jmin, values). Thin scalar wrapper over the vectorized
    row solver (used by tests and the scalar `wigner3j`).
    """
    rows = _solve_rows(np.array([j2]), np.array([j3]), m1, m2, m3)
    jmin = max(abs(j2 - j3), abs(m1))
    return jmin, rows[0, jmin:j2 + j3 + 1]


def wigner3j(j1, j2, j3, m1, m2, m3) -> float:
    """Scalar Wigner 3-j symbol for the supported m-configurations
    (any (m1, m2, m3) with m1 + m2 + m3 = 0)."""
    if m1 + m2 + m3 != 0:
        return 0.0
    jmin = max(abs(j2 - j3), abs(m1))
    if j1 < jmin or j1 > j2 + j3 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    jm, row = wigner3j_row(j2, j3, m1, m2, m3)
    return float(row[j1 - jm])


def _solve_rows(j2s, j3s, m1, m2, m3):
    """Vectorized row solver: w3j(j1, j2s[r], j3s[r]; m1, m2, m3) for every
    row r and j1 = 0..max(j2+j3). Returns (n_rows, jmax_global+1); entries
    outside [jmin, jmax] of a row are 0.
    """
    return _solve_cols(j2s, j3s, m1, m2, m3).T


def _solve_cols(j2s, j3s, m1, m2, m3, keep=None):
    """_solve_rows with j1 on the leading axis: (jmax_global+1, n_rows), or
    its first ``keep`` entries of j1. The sweeps over j read and write
    contiguous rows of every array, and touch only the rows whose range
    reaches the current j: the rows are ordered by jmax, descending, for
    the sweeps (with rows as the leading axis each step touches one element
    per cache line). The arithmetic of every entry is the same, operation
    for operation, so the tables equal those of the row-major solver."""
    j2s = np.asarray(j2s, dtype=np.int64)
    j3s = np.asarray(j3s, dtype=np.int64)
    order = np.argsort(-(j2s + j3s), kind="stable")
    j2s, j3s = j2s[order][None, :], j3s[order][None, :]     # (1, R)
    n_rows = j2s.shape[1]
    jmins = np.maximum(np.abs(j2s - j3s), abs(m1))[0]  # (R,)
    jmaxs = (j2s + j3s)[0]
    L = int(jmaxs.max()) + 1
    js = np.arange(L + 1, dtype=np.int64)[:, None]     # (L+1, 1)
    ridx = np.arange(n_rows)
    # rows a sweep step at j touches: jmax >= j + 1, a prefix of the order
    reach = np.searchsorted(-jmaxs, -(np.arange(L + 1) + 1), side="right")

    a, b = _row_coeffs(js.astype(np.float64), j2s, j3s,
                       float(m1), float(m2), float(m3))   # (L+1, R)

    in_range = (js[:L] >= jmins) & (js[:L] <= jmaxs)

    # --- forward branch: seed f(jmin) = 1, f(jmin+1) from the jmin relation
    ff = np.zeros((L, n_rows))
    ff[jmins, ridx] = 1.0
    # f(jmin+1) = -B(jmin)/(jmin*A(jmin+1)); rows with jmin == 0 are
    # degenerate (B(0) = 0): leave the forward branch as a delta and rely on
    # the backward branch there.
    denom = jmins.astype(np.float64) * a[np.minimum(jmins + 1, L), ridx]
    seed1 = -b[jmins, ridx] / np.where(denom == 0, 1.0, denom)
    ok = (denom != 0) & (jmins + 1 <= jmaxs)
    ff[jmins[ok] + 1, ridx[ok]] = seed1[ok]
    fwd_ok = jmins > 0

    # Global forward sweep: f(j+1) = -(B(j) f(j) + (j+1) A(j) f(j-1)) / (j A(j+1))
    for j in range(1, L - 1):
        k = reach[j]
        active = (j >= jmins[:k] + 1) & (j <= jmaxs[:k] - 1)
        denom = j * a[j + 1, :k]
        with np.errstate(invalid="ignore", divide="ignore"):
            nxt = -(b[j, :k] * ff[j, :k] + (j + 1) * a[j, :k] * ff[j - 1, :k]) \
                / np.where(denom == 0, 1.0, denom)
        ff[j + 1, :k] = np.where(active & (denom != 0), nxt, ff[j + 1, :k])
        # overflow guard: rescale the whole forward row
        big = np.nonzero(np.abs(ff[j + 1, :k]) > 1e250)[0]
        if big.size:
            ff[:, big] *= 1e-250

    # --- backward branch: seed f(jmax) = 1, f(jmax-1) from the jmax relation
    fb = np.zeros((L, n_rows))
    fb[jmaxs, ridx] = 1.0
    denom = (jmaxs.astype(np.float64) + 1.0) * a[jmaxs, ridx]
    seedm1 = -b[jmaxs, ridx] / np.where(denom == 0, 1.0, denom)
    okb = (denom != 0) & (jmaxs - 1 >= jmins)
    fb[jmaxs[okb] - 1, ridx[okb]] = seedm1[okb]

    # Global backward sweep: f(j-1) = -(j A(j+1) f(j+1) + B(j) f(j)) / ((j+1) A(j))
    for j in range(L - 2, 0, -1):
        k = reach[j]
        active = (j - 1 >= jmins[:k]) & (j <= jmaxs[:k] - 1)
        denom = (j + 1) * a[j, :k]
        with np.errstate(invalid="ignore", divide="ignore"):
            prv = -(j * a[j + 1, :k] * fb[j + 1, :k] + b[j, :k] * fb[j, :k]) \
                / np.where(denom == 0, 1.0, denom)
        fb[j - 1, :k] = np.where(active & (denom != 0), prv, fb[j - 1, :k])
        big = np.nonzero(np.abs(fb[j - 1, :k]) > 1e250)[0]
        if big.size:
            fb[:, big] *= 1e-250

    # --- match branches at the per-row argmax of |ff * fb| -----------------
    jc = np.argmax(np.where(in_range, np.abs(ff * fb), -1.0), axis=0)  # (R,)
    fb_c = fb[jc, ridx]
    ff_c = ff[jc, ridx]
    good = (np.abs(ff_c) > 0) & fwd_ok
    scale = np.where(good, fb_c / np.where(ff_c == 0, 1.0, ff_c), 1.0)
    use_fwd = good & (js[:L] < jc)
    f = np.where(use_fwd, ff * scale, fb)
    f = np.where(in_range, f, 0.0)

    # --- normalize + fix sign ---------------------------------------------
    # summed along contiguous rows, in the order of the row-major layout
    root = np.sqrt(np.sum(np.ascontiguousarray(
        ((2.0 * js[:L] + 1.0) * f * f).T), axis=1))
    sgn_target = np.where((j2s - j3s + m2 - m3)[0] % 2 == 0, 1.0, -1.0)
    f_last = f[jmaxs, ridx] / root
    flip = np.where(np.sign(f_last) * sgn_target < 0, -1.0, 1.0)
    out = np.empty((min(L, L if keep is None else keep), n_rows))
    out[:, order] = f[:out.shape[0]] / root * flip
    return out


def compute_wigner_values(m_max: int, n_max: int = None, l_max: int = None):
    """Tables A[m-1, n-1, l] = w3j(m, n, l; -1, 1, 0) and
    B[m-1, n-1, l] = w3j(m, n, l; -1, -1, 2) for m = 1..m_max, n = 1..n_max,
    l = 0..l_max-1 (ref: compute_wigner_values.jl:190-222; same table
    semantics, 0-based l index = degree).

    Called with a single argument N_max, uses the reference's shorthand
    sizes (2 N_max + 1, N_max + 1, 2 N_max + 1).
    """
    if n_max is None:
        n_max = m_max + 1
        m_max, l_max = 2 * m_max + 1, 2 * m_max + 1

    tab_a = np.zeros((m_max, n_max, l_max))
    tab_b = np.zeros((m_max, n_max, l_max))
    for l0, l1, a, b in wigner_value_chunks(m_max, n_max, l_max):
        tab_a[:, :, l0:l1] = a
        tab_b[:, :, l0:l1] = b
    return tab_a, tab_b


def wigner_value_chunks(m_max: int, n_max: int, l_max: int):
    """compute_wigner_values' tables a block of l at a time: yields
    (l0, l1, A[:, :, l0:l1], B[:, :, l0:l1]). A consumer that needs one
    block at a time (the PCW sums) never holds the full tables, which at
    N_max ~ 400 take ~0.9 GB each."""
    # One row per (n, l) pair; each row spans all m at once. Chunk over l
    # blocks to bound peak memory for production-size tables
    # (N_max ~ 400 -> ~300k rows x ~1100 cols).
    l_chunk = max(1, int(2e7 // (n_max * (n_max + l_max))))
    for l0 in range(0, l_max, l_chunk):
        l1 = min(l0 + l_chunk, l_max)
        ns, ls = np.meshgrid(np.arange(1, n_max + 1), np.arange(l0, l1),
                             indexing="ij")
        ns, ls = ns.ravel(), ls.ravel()
        blocks = []
        for cfg in ((-1, 1, 0), (-1, -1, 2)):
            cols = _solve_cols(ns, ls, *cfg, keep=m_max + 1)
            width = min(m_max, cols.shape[0] - 1)
            blk = np.zeros((m_max, n_max, l1 - l0))
            blk[:width] = cols[1:width + 1].reshape(width, n_max, l1 - l0)
            blocks.append(blk)
        # (-1,-1,2) requires j3 >= 2; _solve_rows handles m3 > j3 rows
        # through the triangle mask, but zero them explicitly for safety.
        blocks[1][:, :, :max(0, 2 - l0)] = 0.0
        yield l0, l1, blocks[0], blocks[1]


def save_wigner_values(filepath: str, wigner_A, wigner_B):
    """Cache tables to disk (ref: compute_wigner_values.jl:224-229)."""
    np.savez_compressed(filepath, wigner_A=wigner_A, wigner_B=wigner_B)


def load_wigner_values(filepath: str):
    with np.load(filepath) as z:
        return z["wigner_A"], z["wigner_B"]
