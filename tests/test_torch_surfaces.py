"""BRDF and Legendre surfaces of the port against the JAX package (CPU,
f64), and the BRDF gates of tests/test_surfaces.py run on the port.

Tolerances: the BRDF kernels, their Fourier matrices and the surface layer
at rtol 1e-12 (same numpy/torch arithmetic); radiances against JAX at rtol
1e-8; the Lambertian limits at rtol 1e-6 (RPV, Ross-Li: the azimuth
quadrature of a constant BRDF) and 1e-8 (Legendre), as the JAX gates; every
layer-scan engine with an RPV surface against the torch engine at 1e-10 of
max R (float64 schulz).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core import brdf as jbrdf
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.core.surface import brdf_surface_layer as jax_brdf_layer
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core import brdf as tbrdf
from vsmartmom_torch.core.rt_run import ENGINES, BandRTInputs, rt_run_band
from vsmartmom_torch.core.surface import brdf_surface_layer
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

VZA = [0.0, 30.0, 60.0]
VAZ = [0.0, 90.0, 180.0]
RPV = {"type": "rpvSurfaceScalar", "rho0": 0.1, "rho_c": 0.6, "k": 0.7,
       "theta": -0.1}
ROSSLI = {"type": "RossLiSurfaceScalar", "fiso": 0.2, "fvol": 0.05,
          "fgeo": 0.03}
LIMITS = {
    "rpv": ({"type": "rpvSurfaceScalar", "rho0": 0.2, "rho_c": 1.0,
             "k": 1.0, "theta": 0.0}, 0.2, 1e-6),
    "rossli": ({"type": "RossLiSurfaceScalar", "fiso": 0.3, "fvol": 0.0,
                "fgeo": 0.0}, 0.3, 1e-6),
    "legendre": ({"type": "LambertianSurfaceLegendre",
                  "legendre_coeff": [0.25]}, 0.25, 1e-8),
}


def _run(surface, pol_name="Stokes_I", tau=0.2, **kw):
    """The gates' one-layer Rayleigh run through the port."""
    pol = Polarization.from_name(pol_name)
    quad = rt_set_streams("GaussQuadFullSphere", 12, 45.0, VZA, pol.n)
    band = BandRTInputs(tau=np.full((1, 2), tau), omega=np.ones((1, 2)),
                        zw=np.ones((1, 1, 2)),
                        greeks=[get_greek_rayleigh(0.0)])
    return rt_run_band(pol, quad, band, VZA, VAZ, 3, surface, device="cpu",
                       **kw)


def _run_jax(surface, pol_name="Stokes_I", tau=0.2, **kw):
    pol = JaxPol.from_name(pol_name)
    quad = jax_streams("GaussQuadFullSphere", 12, 45.0, VZA, pol.n)
    band = JaxBand(tau=np.full((1, 2), tau), omega=np.ones((1, 2)),
                   zw=np.ones((1, 1, 2)), greeks=[jax_greek(0.0)])
    return jax_rt_run_band(pol, quad, band, VZA, VAZ, 3, surface, **kw)


def _angles(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 1.0, 50), rng.uniform(0.05, 1.0, 50),
            rng.uniform(0.0, np.pi, 50))


@pytest.mark.parametrize("kind", ["rpv", "rossli"])
def test_brdf_kernels_match_jax(kind):
    mu_i, mu_r, dphi = _angles(0)
    if kind == "rpv":
        args = (0.1, 0.6, 0.7, -0.1)
        fn_t, fn_j = tbrdf.rpv_reflectance, jbrdf.rpv_reflectance
    else:
        args = (0.2, 0.05, 0.03)
        fn_t, fn_j = tbrdf.rossli_reflectance, jbrdf.rossli_reflectance
    np.testing.assert_allclose(fn_t(mu_i, mu_r, dphi, *args),
                               fn_j(mu_i, mu_r, dphi, *args), rtol=1e-12)


@pytest.mark.parametrize("n_stokes", [1, 3])
@pytest.mark.parametrize("surface", [RPV, ROSSLI], ids=["rpv", "rossli"])
def test_brdf_fourier_matrix_matches_jax(surface, n_stokes):
    mu = np.array([0.12, 0.3, 0.55, 0.8, 1.0])
    for m in range(3):
        np.testing.assert_allclose(
            tbrdf.brdf_fourier_matrix(surface, mu, m, n_stokes),
            jbrdf.brdf_fourier_matrix(surface, mu, m, n_stokes),
            rtol=1e-12, atol=1e-15)


def test_legendre_spectral_albedo_matches_jax():
    coeff = [0.1, 0.05, 0.02]
    a = tbrdf.legendre_spectral_albedo(coeff, 5)
    np.testing.assert_allclose(a, jbrdf.legendre_spectral_albedo(coeff, 5),
                               rtol=1e-12)
    x = np.linspace(-1, 1, 5)
    np.testing.assert_allclose(
        a, 0.1 + 0.05 * x + 0.02 * 0.5 * (3 * x**2 - 1), rtol=1e-12)


def test_brdf_surface_layer_matches_jax():
    rng = np.random.default_rng(1)
    n, n_spec = 6, 4
    rho = rng.uniform(0.0, 0.3, (n, n))
    qp, wt = rng.uniform(0.1, 1.0, n), rng.uniform(0.05, 0.3, n)
    i0 = np.zeros(n)
    i0[2] = 1.0
    tau_sum = rng.uniform(0.0, 1.0, n_spec)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    got = brdf_surface_layer(t(rho), n_spec, t(qp), t(wt), t(i0),
                             t(tau_sum), t(0.7))
    ref = jax_brdf_layer(rho, n_spec, jnp.asarray(qp), jnp.asarray(wt),
                         jnp.asarray(i0), jnp.asarray(tau_sum), 0.7,
                         jnp.float64)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("kind", list(LIMITS))
def test_lambertian_limits(kind):
    """Each surface at its Lambertian limit reproduces the Lambertian run
    through the port's surface path, and matches JAX's run."""
    surface, albedo, rtol = LIMITS[kind]
    r_surf, _ = _run(surface)
    r_lam, _ = _run({"type": "LambertianSurfaceScalar", "albedo": albedo})
    np.testing.assert_allclose(r_surf, r_lam, rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(r_surf, _run_jax(surface)[0], rtol=1e-8)


def test_brdf_reciprocity():
    """RPV and Ross-Li are reciprocal: every Fourier matrix of the port is
    symmetric (intensity block)."""
    mu = np.array([0.3, 0.55, 0.8, 1.0])
    for m in range(3):
        for surface in (RPV, ROSSLI):
            r = tbrdf.brdf_fourier_matrix(surface, mu, m, 1)
            np.testing.assert_allclose(r, r.T, rtol=1e-10, atol=1e-14)


def test_rpv_hotspot_enhancement():
    """The RPV hot-spot factor (rho_c < 1) brightens the retro direction."""
    f_hot = tbrdf.rpv_reflectance(0.7, 0.7, np.pi, 0.1, 0.2, 0.8, -0.1)
    f_no = tbrdf.rpv_reflectance(0.7, 0.7, np.pi, 0.1, 1.0, 0.8, -0.1)
    assert f_hot > f_no
    assert f_hot == jbrdf.rpv_reflectance(0.7, 0.7, np.pi, 0.1, 0.2, 0.8,
                                          -0.1)


def test_rpv_anisotropy_changes_viewing_pattern():
    """A bowl-shaped RPV (k < 1) differs from a Lambertian off nadir, as in
    JAX."""
    surface = {"type": "rpvSurfaceScalar", "rho0": 0.2, "rho_c": 1.0,
               "k": 0.6, "theta": -0.2}
    r_rpv, _ = _run(surface)
    r_lam, _ = _run({"type": "LambertianSurfaceScalar", "albedo": 0.2})
    assert np.max(np.abs(r_rpv[:, 0, 0] - r_lam[:, 0, 0])
                  / r_lam[:, 0, 0]) > 0.01
    np.testing.assert_allclose(r_rpv, _run_jax(surface)[0], rtol=1e-8)


def test_rossli_finite_polarized():
    """Ross-Li under IQU stays finite, U = 0 in the principal plane, and
    R/T match JAX."""
    surface = {"type": "RossLiSurfaceScalar", "fiso": 0.2, "fvol": 0.05,
               "fgeo": 0.02}
    R, T = _run(surface, pol_name="Stokes_IQU")
    assert np.all(np.isfinite(R))
    assert abs(R[0, 2, 0]) < 1e-10
    jR, jT = _run_jax(surface, pol_name="Stokes_IQU")
    np.testing.assert_allclose(R, jR, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(T, jT, rtol=1e-8, atol=1e-14)


def test_hdr_and_composite_with_brdf_match_jax():
    """return_hdr and return_composite on an RPV surface, against JAX."""
    got = _run(RPV, return_hdr=True, return_composite=True)
    ref = _run_jax(RPV, return_hdr=True, return_composite=True)
    for a, b in zip(got[:5], ref[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-14)
    assert len(got[5]) == len(ref[5]) == 3
    for ct, cj in zip(got[5], ref[5]):
        for a, b in zip(ct, cj):
            assert isinstance(a, np.ndarray)
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("engine", ENGINES)
def test_every_engine_takes_brdf_surfaces(engine):
    """The surface layer is built after the layer scan, so every engine
    (each kernel's plain version on the CPU) runs a BRDF surface."""
    ref, _ = _run(RPV, pol_name="Stokes_IQU", solver="schulz",
                  engine="torch")
    R, _ = _run(RPV, pol_name="Stokes_IQU", solver="schulz", engine=engine)
    assert np.abs(R - ref).max() < 1e-10 * np.abs(ref).max()
