"""The port's differentiable Mie -> NAI2 -> Greek chain
(vsmartmom_torch/scattering/mie_ad.py) against the JAX package, the numpy
path and finite differences, and a retrieval through the full RT.

tests/test_mie_ad.py's case: lambda 0.55 um, r_max 6 um, 40 radii,
theta = (mu, sigma, n_r, n_i) = (0.3, 1.8, 1.45, 0.001), float64 on the
CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.scattering.mie_ad import \
    aerosol_optics_with_derivs as jax_optics_with_derivs
from vsmartmom.scattering.phase import Polarization as JPolarization
from vsmartmom.scattering.phase import compute_Z_moments_jax, \
    make_z_cache as jax_z_cache

from vsmartmom_torch.scattering.mie import Aerosol
from vsmartmom_torch.scattering.mie_ad import (aerosol_optics_with_derivs,
                                               greek_stack, make_setup)
from vsmartmom_torch.scattering.nai2 import compute_aerosol_optical_properties
from vsmartmom_torch.scattering.phase import (GreekCoefs, Polarization,
                                              compute_Z_moments,
                                              compute_Z_moments_torch,
                                              get_greek_rayleigh,
                                              make_z_cache)

torch.set_num_threads(2)

LAM, R_MAX, NQ = 0.55, 6.0, 40
THETA0 = (0.3, 1.8, 1.45, 0.001)
NAMES = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")


@pytest.fixture(scope="module")
def both():
    return (aerosol_optics_with_derivs(*THETA0, LAM, R_MAX, NQ,
                                       device="cpu"),
            jax_optics_with_derivs(*THETA0, LAM, R_MAX, NQ))


def test_values_match_jax_and_numpy(both):
    (opt, _), (jopt, _) = both
    ref = compute_aerosol_optical_properties(Aerosol(*THETA0), LAM, R_MAX,
                                             NQ)
    for other in (jopt, ref):
        np.testing.assert_allclose(opt.ssa, other.ssa, rtol=1e-12)
        np.testing.assert_allclose(opt.k, other.k, rtol=1e-12)
        for nm in NAMES:
            np.testing.assert_allclose(getattr(opt.greek_coefs, nm),
                                       getattr(other.greek_coefs, nm),
                                       atol=1e-12)


def test_derivatives_match_jax(both):
    (_, der), (_, jder) = both
    assert der["d_greeks"].shape == jder["d_greeks"].shape
    assert der["d_greeks"].shape[:2] == (4, 6)
    for key in ("d_greeks", "d_ssa", "d_k"):
        ref = np.asarray(jder[key])
        assert np.abs(ref).max() > 0
        assert np.abs(der[key] - ref).max() < 1e-9 * np.abs(ref).max(), key


def test_derivatives_match_finite_differences():
    """tests/test_mie_ad.py's gate on the port."""
    setup = make_setup(LAM, R_MAX, NQ)
    th0 = torch.tensor(THETA0, dtype=torch.float64)

    def f(th):
        greeks, ssa, k = greek_stack(setup, th)
        return torch.cat([greeks[1, :6], torch.stack([ssa, k])])

    jac = torch.func.jacfwd(f)(th0).numpy()
    for i, eps in enumerate((1e-7, 1e-7, 1e-7, 1e-8)):
        dv = torch.zeros(4, dtype=torch.float64)
        dv[i] = eps
        fd = ((f(th0 + dv) - f(th0 - dv)) / (2 * eps)).numpy()
        np.testing.assert_allclose(jac[:, i], fd, rtol=2e-5, atol=5e-8)


@pytest.mark.parametrize("name", ["Stokes_I", "Stokes_IQU", "Stokes_IQUV"])
@pytest.mark.parametrize("m", [0, 2])
def test_z_moments_torch_match(name, m):
    """compute_Z_moments_torch on a Mie Greek stack (its first 40 terms)
    against the numpy compute_Z_moments and JAX's compute_Z_moments_jax."""
    full = compute_aerosol_optical_properties(Aerosol(*THETA0), LAM, R_MAX,
                                              NQ).greek_coefs
    gc = GreekCoefs(*(getattr(full, nm)[:40] for nm in NAMES))
    stack = np.stack([getattr(gc, nm) for nm in NAMES])
    mu = np.array([0.1, 0.45, 0.8, 1.0])
    pol, jpol = Polarization.from_name(name), JPolarization.from_name(name)
    zpp, zmp = compute_Z_moments_torch(
        torch.as_tensor(stack), make_z_cache(pol, mu, gc.l_max, m))
    ref = compute_Z_moments(pol, mu, gc, m)
    jref = compute_Z_moments_jax(jnp.asarray(stack),
                                 jax_z_cache(jpol, mu, gc.l_max, m))
    for got, r, jr in zip((zpp, zmp), ref, jref):
        assert got.shape == r.shape == (len(mu) * pol.n,) * 2
        scale = np.abs(r).max()
        assert np.abs(got.numpy() - r).max() < 1e-12 * scale
        assert np.abs(got.numpy() - np.asarray(jr)).max() < 1e-12 * scale


def test_retrieval_through_full_rt():
    """Gauss-Newton recovery of perturbed (mu, n_r) from TOA radiances
    through Mie -> Greek -> Z -> layer RT -> R, tests/test_mie_ad.py's
    retrieval on the port's modules (ref: AD_OCO2_test.jl:71-160)."""
    from vsmartmom_torch.core.rt import (interaction, make_added_layer,
                                         rsolve_lu, vacuum_layer)
    from vsmartmom_torch.core.surface import lambertian_surface_layer
    from vsmartmom_torch.util.quadrature import rt_set_streams

    f64 = torch.float64
    setup = make_setup(LAM, R_MAX, NQ)
    pol = Polarization.from_name("Stokes_I")
    vza = [10.0, 30.0, 50.0]
    quad = rt_set_streams("GaussQuadFullSphere", 8, 40.0, vza, pol.n)
    n = len(quad.qp_mu_n)
    l_full = 2 * setup.n_max - 1
    caches = [make_z_cache(pol, quad.qp_mu, l_full, m) for m in range(2)]
    gr = get_greek_rayleigh(0.0)
    rayl_stack = np.zeros((6, l_full))
    for i, nm in enumerate(NAMES):
        rayl_stack[i, :3] = getattr(gr, nm)
    rayl_stack = torch.as_tensor(rayl_stack)

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=f64)

    tau_rayl, tau_aer = 0.05, 0.3
    i0 = np.zeros(n)
    i0[quad.i_mu0_n:quad.i_mu0_n + pol.n] = pol.i0
    d_vec = t(np.tile(pol.d, quad.n_quad))
    mu0_node = t(quad.qp_mu_n[quad.i_mu0_n])
    min_mu = t(np.min(quad.qp_mu))
    i_vza = [int(np.argmin(np.abs(quad.qp_mu - np.cos(np.deg2rad(v)))))
             for v in vza]
    eye = torch.eye(n, dtype=f64).expand(1, n, n)

    def forward(theta):
        greeks, ssa, _ = greek_stack(setup, torch.stack(
            [theta[0], t(1.8), theta[1], t(0.001)]))
        tau = (tau_rayl + tau_aer) * torch.ones(1, dtype=f64)
        omega = (tau_rayl + ssa * tau_aer) / tau
        w_rayl = tau_rayl / (tau_rayl + ssa * tau_aer)
        out = 0.0
        for m in range(2):
            z_pp_r, z_mp_r = compute_Z_moments_torch(rayl_stack, caches[m])
            z_pp_a, z_mp_a = compute_Z_moments_torch(greeks, caches[m])
            z_pp = (w_rayl * z_pp_r + (1 - w_rayl) * z_pp_a)[None]
            z_mp = (w_rayl * z_mp_r + (1 - w_rayl) * z_mp_a)[None]
            wct2 = quad.wt_mu_n / 2.0 if m == 0 else quad.wt_mu_n / 4.0
            lay = make_added_layer(
                tau, omega, z_pp, z_mp, torch.zeros(1, dtype=f64),
                t(quad.qp_mu_n), t(wct2), t(0.5 if m == 0 else 0.25), t(i0),
                quad.i_mu0_n, pol.n, mu0_node, t(quad.mu0), d_vec, min_mu,
                eye, rsolve=rsolve_lu)
            surf = lambertian_surface_layer(
                t(0.1), 1, pol.n, t(quad.qp_mu_n), t(quad.wt_mu_n), t(i0),
                tau, t(quad.mu0), m == 0)
            comp = interaction(vacuum_layer(1, n, f64, "cpu"), lay, eye,
                               rsolve=rsolve_lu)
            comp = interaction(comp, surf, eye, rsolve=rsolve_lu)
            weight = 0.5 if m == 0 else 1.0
            out = out + weight * comp.j_m[0, i_vza]     # vaz = 0 synthesis
        return out

    theta_true = torch.tensor([0.30, 1.45], dtype=f64)
    y_obs = forward(theta_true)
    theta = torch.tensor([0.36, 1.40], dtype=f64)     # perturbed start
    for _ in range(8):
        r = forward(theta) - y_obs
        J = torch.func.jacfwd(forward)(theta)
        step = torch.linalg.lstsq(J, -r[:, None]).solution[:, 0]
        theta = theta + torch.clamp(step, -0.05, 0.05)
    err = (theta - theta_true).abs().numpy()
    assert err[0] < 1e-5 and err[1] < 1e-5, (theta, err)
