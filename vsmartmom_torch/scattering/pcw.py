"""PCW (Domke) aerosol decomposition: Greek coefficients directly from
Wigner-3j pair sums (Sanghavi 2014 eqs. 22-24).

Independent of the NAI2 route — the two must agree (this is the reference's
NAI2-vs-PCW cross-implementation gate, test/test_Scattering.jl:68-124).
Vectorized over (m, n) with one matrix product per block of degrees l
instead of the reference's triple scalar loop (ref:
src/Scattering/compute_PCW.jl:16-192). The Wigner tables are consumed a
block of l at a time (wigner.wigner_value_chunks), so a production size
(N_max ~ 400, tables of ~0.9 GB each) never holds them whole.
"""
from __future__ import annotations

import numpy as np

from vsmartmom_torch.scattering.mie import (compute_mie_ab_batch,
                                            cross_sections, get_n_max,
                                            size_distribution_weights)
from vsmartmom_torch.scattering.nai2 import AerosolOptics, _aerosol_from_spec
from vsmartmom_torch.scattering.phase import GreekCoefs
from vsmartmom_torch.util.quadrature import gauleg

#: degrees l per block when slicing caller-given Wigner tables
_L_BLOCK = 64


def _pair_mats(an, bn, wx):
    """Size-distribution-averaged coefficient products
    M_xy[m, n] = sum_i wx[i] conj(x_n) y_m  (ref: mie_helper_functions.jl:
    compute_avg_anbns!; an/bn are already truncated per radius)."""
    # (nr, N) arrays -> (N_m, N_n), as matrix products over the radii
    wan = wx[:, None] * np.conj(an)
    wbn = wx[:, None] * np.conj(bn)
    anam = an.T @ wan
    anbm = bn.T @ wan
    bnam = an.T @ wbn
    bnbm = bn.T @ wbn
    return anam, anbm, bnam, bnbm


def _table_blocks(wigner_A, wigner_B, n_max, l_max):
    """(l0, l1, A, B) blocks of the (m = 1..N, n = 1..N, l < l_max) tables:
    sliced from the caller's tables, or built block by block."""
    if wigner_A is None or wigner_B is None:
        from vsmartmom_torch.scattering.wigner import wigner_value_chunks
        yield from wigner_value_chunks(n_max, n_max, l_max)
        return
    for tab in (wigner_A, wigner_B):
        if tab.shape[0] < n_max or tab.shape[1] < n_max \
                or tab.shape[2] < l_max:
            raise ValueError(f"Wigner tables of shape {tab.shape} are too "
                             f"small: need ({n_max}, {n_max}, {l_max})")
    for l0 in range(0, l_max, _L_BLOCK):
        l1 = min(l0 + _L_BLOCK, l_max)
        yield (l0, l1, wigner_A[:n_max, :n_max, l0:l1],
               wigner_B[:n_max, :n_max, l0:l1])


def compute_aerosol_optical_properties_pcw(spec, lam: float, r_max: float,
                                           nquad_radius: int,
                                           wigner_A=None, wigner_B=None,
                                           n_ref: complex = None
                                           ) -> AerosolOptics:
    """Greek coefficients via the precomputed-Wigner route.

    wigner_A/B: tables from `compute_wigner_values` with
    m_max >= N_max, n_max >= N_max, l_max >= 2 N_max - 1 (built block by
    block when omitted). ref: compute_PCW.jl:16-118.
    """
    aero = _aerosol_from_spec(spec)
    r, w_r = gauleg(nquad_radius, 0.0, r_max)
    w_r = w_r / w_r.sum()
    k = 2.0 * np.pi / lam
    x = k * r
    n_max = get_n_max(x.max())
    m_refr = n_ref if n_ref is not None else complex(aero.n_r, aero.n_i)
    m_refr = complex(m_refr.real, abs(m_refr.imag))

    an, bn = compute_mie_ab_batch(x, m_refr, n_max)
    c_sca, c_ext = cross_sections(an, bn, k)
    wx = size_distribution_weights(aero, w_r, r)
    avg_c_sca = float(np.sum(wx * c_sca))
    avg_c_ext = float(np.sum(wx * c_ext))
    l_max = 2 * n_max - 1

    anam, anbm, bnam, bnbm = _pair_mats(an, bn, wx)
    nvec = np.arange(1, n_max + 1, dtype=np.float64)
    two_np1 = 2.0 * nvec + 1.0                             # (N,)
    an_m_bn = wx @ (np.abs(an - bn) ** 2)
    an_p_bn = wx @ (np.abs(an + bn) ** 2)

    # Off-diagonal weights: strictly m > n (the reference's m-loop starts at
    # n+1 and multiplies by 2 for the transposed partner).
    idx = np.arange(1, n_max + 1)
    mgt = idx[:, None] > idx[None, :]                      # (m, n) mask
    cmn = 2.0 * np.outer(two_np1, two_np1) * mgt           # 2(2m+1)(2n+1)
    # parity (-1)^(l + n + m) = (-1)^(m + n) (-1)^l: the (m, n) factor
    # rides the weights, the l factor the block's sums
    par_mn = np.where((idx[:, None] + idx[None, :]) % 2 == 0, 1.0, -1.0)

    re_sum = np.real(anam + anbm + bnam + bnbm)            # (m, n)
    re_dif = np.real(anam - anbm - bnam + bnbm)
    w_sum = (cmn * re_sum).ravel()
    w_dif = (cmn * par_mn * re_dif).ravel()
    w_02p = (cmn * par_mn * (anam + bnam - anbm - bnbm)).ravel()
    w_02c = (cmn * np.conj(anam - bnam + anbm - bnbm)).ravel()
    diag = np.arange(n_max)
    sq_p = two_np1**2 * an_p_bn
    sq_m = two_np1**2 * an_m_bn
    sq_02 = 2.0 * two_np1**2 * np.einsum("nn->n",
                                         anam - anbm + bnam - bnbm)

    sl = {key: np.zeros(l_max, dtype=complex if key == "02" else float)
          for key in ("00", "0m0", "22", "2m2", "02")}
    for l0, l1, wa, wb in _table_blocks(wigner_A, wigner_B, n_max, l_max):
        parl = np.where(np.arange(l0, l1) % 2 == 0, 1.0, -1.0)
        aa = (wa * wa).reshape(n_max * n_max, -1)
        bb = (wb * wb).reshape(n_max * n_max, -1)
        ab = (wa * wb).reshape(n_max * n_max, -1)
        dwa = wa[diag, diag]                                # (N, block)
        dwb = wb[diag, diag]
        # first (pair) terms, then the second (diagonal) ones
        sl["00"][l0:l1] = w_sum @ aa + sq_p @ (dwa * dwa)
        sl["0m0"][l0:l1] = parl * (w_dif @ aa + sq_m @ (dwa * dwa))
        sl["22"][l0:l1] = w_sum @ bb + sq_p @ (dwb * dwb)
        sl["2m2"][l0:l1] = parl * (w_dif @ bb + sq_m @ (dwb * dwb))
        sl["02"][l0:l1] = (parl * (w_02p @ ab) + w_02c @ ab
                           + sq_02 @ (dwa * dwb))

    coef = (2.0 * np.arange(l_max) + 1.0) * np.pi / k**2 / avg_c_sca
    sl_00, sl_0m0 = coef * sl["00"], coef * sl["0m0"]
    sl_22, sl_2m2 = coef * sl["22"], coef * sl["2m2"]
    sl_02 = coef * sl["02"]

    gc = GreekCoefs(alpha=sl_22 + sl_2m2, beta=sl_00 + sl_0m0,
                    gamma=np.real(sl_02), delta=sl_00 - sl_0m0,
                    epsilon=np.imag(sl_02), zeta=sl_22 - sl_2m2)
    return AerosolOptics(greek_coefs=gc, ssa=avg_c_sca / avg_c_ext,
                         k=avg_c_ext, f_t=1.0)
