"""Lower-boundary (surface) layers as LayerRT slabs.

ref: src/CoreRT/Surfaces/lambertian_surface.jl (Lambertian scalar /
spectral albedo), Surfaces/rpv_surface.jl (a BRDF's Fourier moment, whose
matrices core/brdf.py builds).
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core import precision
from vsmartmom_torch.core.rt import LayerRT


def lambertian_surface_layer(albedo, n_spec, n_stokes, qp, wt, i0_vec,
                             tau_sum, mu0, is_m0, spectral_albedo=None
                             ) -> LayerRT:
    """Lambertian surface as an added layer.

    ref: src/CoreRT/Surfaces/lambertian_surface.jl:20-75. Only the m == 0
    Fourier moment reflects (isotropic surface); higher moments are pure
    identity transmission. ``albedo`` and ``mu0`` are 0-dim tensors; dtype
    and device follow ``qp``.

    ``spectral_albedo``: optional (nSpec,) tensor overriding the scalar
    albedo per wavelength.
    """
    n = qp.shape[0]
    dtype, device = qp.dtype, qp.device
    eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
    zero_m = torch.zeros((n_spec, n, n), dtype=dtype, device=device)
    zero_v = torch.zeros((n_spec, n), dtype=dtype, device=device)
    if not is_m0:
        return LayerRT(zero_m, zero_m, eye, eye, zero_v, zero_v)

    # rho = 2 * albedo for the 0th Fourier moment; reflection couples only
    # the intensity (I) components of every stream pair.
    is_i_comp = (torch.arange(n, device=device) % n_stokes) == 0
    ones_block = torch.outer(is_i_comp.to(dtype), is_i_comp.to(dtype))

    if spectral_albedo is not None:
        rho = (2.0 * spectral_albedo)[:, None, None]    # (nSpec,1,1)
    else:
        rho = 2.0 * albedo
    r_surf_pre = rho * ones_block                        # pre-weighting
    atten = torch.exp(-tau_sum / mu0)[:, None]

    j_p = i0_vec.expand(n_spec, n) * atten
    r_i0 = torch.sum(r_surf_pre.expand(n_spec, n, n)
                     * i0_vec[None, None, :], dim=-1)
    j_m = mu0 * r_i0 * atten

    r_mp = (r_surf_pre * (qp * wt)[None, None, :]).expand(n_spec, n, n)
    return LayerRT(r_mp=r_mp, r_pm=zero_m, t_pp=eye, t_mm=eye,
                   j_p=j_p, j_m=j_m)


def brdf_surface_layer(rho_pre, n_spec, qp, wt, i0_vec, tau_sum, mu0
                       ) -> LayerRT:
    """Generic BRDF surface as an added layer, from the pre-weight Fourier
    reflection matrix rho_pre (N, N) of the current moment m (a tensor of
    ``qp``'s dtype and device).

    r^-+ = rho_pre diag(qp wt); the sources use the unweighted matrix at
    the solar node (ref: Surfaces/rpv_surface.jl create_surface_layer!:
    28-64). Unlike a Lambertian's, a BRDF's moments m > 0 are generally
    nonzero.
    """
    n = qp.shape[0]
    dtype, device = qp.dtype, qp.device
    eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
    zero_m = torch.zeros((n_spec, n, n), dtype=dtype, device=device)
    atten = torch.exp(-tau_sum / mu0)[:, None]

    j_p = i0_vec.expand(n_spec, n) * atten
    j_m = mu0 * precision.mm(rho_pre, i0_vec)[None, :] * atten

    r_mp = (rho_pre * (qp * wt)[None, :]).expand(n_spec, n, n)
    return LayerRT(r_mp=r_mp, r_pm=zero_m, t_pp=eye, t_mm=eye,
                   j_p=j_p, j_m=j_m)
