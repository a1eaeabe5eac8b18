"""The port's canopy RT against the JAX package (CPU, float64), the
canopy gates of tests/test_canopy.py run on the port, and its float32
guards.

1. elemental_directional, make_canopy_layer and rt_run_canopy (sensor
   levels, RPV soil) match JAX within 1e-10 of max per field.
2. The nine gates of tests/test_canopy.py on the port, with their bounds.
3. float32: make_canopy_layer with near-black leaves (omega 1e-9, one
   slab, so no doubling: dtau is the whole slab) at LAI 8 under
   GaussQuadHemisphere l_trunc 15 is finite and within 1e-3 of max of
   float64, where JAX's form gives a non-finite T^++ (0 * inf in
   e^-a expm1(a - b)); the same at chi = 0.6, where
   mu_i G_j - mu_j G_i = phi1 (mu_i - mu_j) with phi1 = 0.0012; and at
   O2Parameters.yaml's streams, where a view and mu0 merge with a Gauss
   node in float32 (JAX: non-finite J^+, T^++ off by > 1e-2).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core import canopy as jc
from vsmartmom.core.rt import make_rsolve as jax_rsolve
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import compute_Z_moments as jax_z
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core.canopy import (CanopyRTInputs, bilambertian_greek,
                                         elemental_directional,
                                         make_canopy_layer, ross_g,
                                         rt_run_canopy)
from vsmartmom_torch.core.rt import (elemental, interaction, make_rsolve,
                                     vacuum_layer)
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.core.surface import lambertian_surface_layer
from vsmartmom_torch.scattering.phase import (Polarization,
                                              compute_Z_moments,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-10
RPV = {"type": "rpvSurfaceScalar", "rho0": 0.2, "rho_c": 0.6, "k": 0.8,
       "theta": -0.1}


def T(x, dtype=F64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, tol=TOL, what=""):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        assert np.isfinite(a).all(), (what, i)
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-300)
        assert err <= tol, (what, i, err)


def _setup(n_spec=3):
    """tests/test_canopy.py's layer setup on the port."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 40.0, [0.0], pol.n)
    n = len(quad.qp_mu_n)
    i0_vec = np.zeros(n)
    i0_vec[quad.i_mu0_n] = 1.0
    gc, ssa = bilambertian_greek(0.45, 0.35)
    z_pp, z_mp = compute_Z_moments(pol, quad.qp_mu, gc, 0)
    return pol, quad, n, i0_vec, z_pp, z_mp, ssa


# --- 1. against JAX ---------------------------------------------------------

def _layer_inputs(lib, quad_type, l_trunc, views, chi, dtype, sza=30.0):
    """One canopy slab's inputs for either package (Stokes I)."""
    port = lib == "torch"
    pol = (Polarization if port else JaxPol).from_name("Stokes_I")
    quad = (rt_set_streams if port else jax_streams)(quad_type, l_trunc,
                                                     sza, views, pol.n)
    gc, _ = (bilambertian_greek if port else jc.bilambertian_greek)(0.45,
                                                                   0.35)
    z_pp, z_mp = (compute_Z_moments if port else jax_z)(pol, quad.qp_mu,
                                                        gc, 0)
    n = len(quad.qp_mu_n)
    i0 = np.zeros(n)
    i0[quad.i_mu0_n] = 1.0
    g = ross_g(quad.qp_mu_n, chi)
    arr = ((lambda x: T(x, dtype)) if port
           else (lambda x: jnp.asarray(np.asarray(x), dtype)))
    return pol, quad, n, arr, i0, z_pp, z_mp, g


def _canopy_layer(lib, lai, ssa, dtype, quad_type="GaussQuadFullSphere",
                  l_trunc=8, views=(0.0, 35.0), chi=0.1, n_spec=3, sza=30.0):
    port = lib == "torch"
    _, quad, n, arr, i0, z_pp, z_mp, g = _layer_inputs(
        lib, quad_type, l_trunc, list(views), chi, dtype, sza)
    if port:
        eye = torch.eye(n, dtype=dtype).expand(n_spec, n, n)
        rs, mu0n = make_rsolve("lu"), arr(quad.qp_mu_n[quad.i_mu0_n])
        fn = make_canopy_layer
    else:
        eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (n_spec, n, n))
        rs, mu0n = jax_rsolve("lu"), float(quad.qp_mu_n[quad.i_mu0_n])
        fn = jc.make_canopy_layer
    return fn(arr(np.full(n_spec, lai)), arr(np.full(n_spec, ssa)),
              arr(z_pp)[None], arr(z_mp)[None], arr(g),
              arr(np.linspace(0.0, 0.3, n_spec)), arr(quad.qp_mu_n),
              arr(quad.wt_mu_n / 2.0), arr(0.5), arr(i0), quad.i_mu0_n, 1,
              mu0n, arr(quad.mu0), arr(np.ones(n)), float(quad.qp_mu.min()),
              eye, rs)


@pytest.mark.parametrize("chi,g_one", [(0.1, False), (-0.3, False),
                                       (0.0, True)])
def test_elemental_directional_matches_jax(chi, g_one):
    outs = []
    for lib in ("torch", "jax"):
        _, quad, n, arr, i0, z_pp, z_mp, g = _layer_inputs(
            lib, "GaussQuadFullSphere", 8, [0.0, 35.0], chi,
            F64 if lib == "torch" else jnp.float64)
        if g_one:
            g = np.ones(n)
        mu0n = float(quad.qp_mu_n[quad.i_mu0_n])
        fn = (elemental_directional if lib == "torch"
              else jc.elemental_directional)
        outs.append(fn(arr([2e-4, 3e-3, 0.02]), arr([0.8, 0.5, 0.95]),
                       arr(z_pp)[None], arr(z_mp)[None], arr(g),
                       arr(quad.qp_mu_n), arr(quad.wt_mu_n / 2.0), 0.5,
                       arr([0.0, 0.1, 0.4]), arr(i0), quad.i_mu0_n, 1,
                       mu0n if lib == "jax" else arr(mu0n)))
    _close(outs[0], outs[1], what=f"chi={chi} g1={g_one}")


@pytest.mark.parametrize("lai,ssa", [(1.5, 0.8), (8.0, 0.95),
                                     (1.5, 1e-9)])
def test_make_canopy_layer_matches_jax(lai, ssa):
    got = _canopy_layer("torch", lai, ssa, F64)
    want = _canopy_layer("jax", lai, ssa, jnp.float64)
    _close(got, want, what=f"lai={lai} ssa={ssa}")


def _scene_inputs(lib, n_z_atm=2, n_spec=3):
    """tests/test_canopy.py's scene (Rayleigh atmosphere, sza 40, a 15 deg
    view) for either package."""
    port = lib == "torch"
    pol = (Polarization if port else JaxPol).from_name("Stokes_I")
    quad = (rt_set_streams if port else jax_streams)(
        "GaussQuadFullSphere", 8, 40.0, [15.0], pol.n)
    tau = np.full((n_z_atm, n_spec), 0.05) * (1 + np.arange(n_z_atm))[:,
                                                                     None]
    band = (BandRTInputs if port else JaxBand)(
        tau=tau, omega=np.full_like(tau, 0.95),
        zw=np.ones((n_z_atm, 1, n_spec)),
        greeks=[(get_greek_rayleigh if port else jax_greek)(0.03)])
    return pol, quad, band


@pytest.mark.parametrize("case", ["sensors", "rpv", "spectral_ssa"])
def test_rt_run_canopy_matches_jax(case):
    kw = dict(lai=1.5, rho_l=0.45, tau_l=0.35, chi=0.1)
    soil = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    levels = None
    if case == "sensors":
        kw["n_layers"], levels = 3, [0, 2, 3]
    elif case == "rpv":
        kw["n_layers"], levels, soil = 2, [1], RPV
    else:
        kw["ssa"] = np.array([0.3, 0.6, 0.9])
    outs = []
    for lib in ("torch", "jax"):
        pol, quad, band = _scene_inputs(lib)
        if lib == "torch":
            outs.append(rt_run_canopy(
                pol, quad, band, CanopyRTInputs(**kw), [15.0], [30.0], 3,
                soil, device="cpu", sensor_levels=levels))
        else:
            outs.append(jc.rt_run_canopy(
                pol, quad, band, jc.CanopyRTInputs(**kw), [15.0], [30.0],
                3, soil, dtype=jnp.float64, sensor_levels=levels))
    _close(outs[0], outs[1], what=case)


# --- 2. the gates of tests/test_canopy.py on the port -----------------------

def test_g_one_reduces_to_standard():
    pol, quad, n, i0_vec, z_pp, z_mp, ssa = _setup()
    dtau = T(np.full(3, 2e-4))
    omega = T(np.full(3, ssa))
    qp = T(quad.qp_mu_n)
    wct2 = T(quad.wt_mu_n) / 2
    tau_sum = T(np.zeros(3))
    mu0n = T(quad.qp_mu_n[quad.i_mu0_n])
    args = (dtau, omega, T(z_pp)[None], T(z_mp)[None], qp, wct2, 0.5,
            tau_sum, T(i0_vec), quad.i_mu0_n, 1, mu0n)
    r0, t0, jp0, jm0 = elemental(*args)
    r1, t1, jp1, jm1 = elemental_directional(
        dtau, omega, T(z_pp)[None], T(z_mp)[None], T(np.ones(n)), qp, wct2,
        0.5, tau_sum, T(i0_vec), quad.i_mu0_n, 1, mu0n)
    for a, b in ((r1, r0), (t1, t0), (jp1, jp0), (jm1, jm0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_canopy_direct_transmission():
    """Black leaves (ssa -> 0): T++ diagonal == exp(-G tau / mu)."""
    pol, quad, n, i0_vec, z_pp, z_mp, _ = _setup()
    g = ross_g(np.asarray(quad.qp_mu_n), chi=0.0)
    eye = torch.eye(n, dtype=F64).expand(3, n, n)
    lay = make_canopy_layer(
        T(np.full(3, 1.5)), T(np.full(3, 1e-9)), T(z_pp)[None],
        T(z_mp)[None], T(g), T(np.zeros(3)), T(quad.qp_mu_n),
        T(quad.wt_mu_n) / 2, 0.5, T(i0_vec), quad.i_mu0_n, 1,
        T(quad.qp_mu_n[quad.i_mu0_n]), T(quad.mu0), T(np.ones(n)),
        float(quad.qp_mu.min()), eye, make_rsolve("lu"))
    t_diag = np.diagonal(lay.t_pp.numpy()[0])
    expect = np.exp(-1.5 * g / np.asarray(quad.qp_mu_n))
    np.testing.assert_allclose(t_diag, expect, rtol=1e-6)


def test_ross_g_values():
    mu = np.linspace(0.05, 1.0, 20)
    np.testing.assert_allclose(ross_g(mu, 0.0), 0.5, atol=1e-12)
    # planophile leaves: higher G toward nadir (mu -> 1)
    g_plan = ross_g(mu, 0.6)
    assert g_plan[-1] > g_plan[0]
    # erectophile: opposite
    g_erec = ross_g(mu, -0.4)
    assert g_erec[-1] < g_erec[0]


def test_bilambertian_phase():
    gc, ssa = bilambertian_greek(0.45, 0.35)
    assert ssa == pytest.approx(0.8)
    assert gc.beta[0] == pytest.approx(1.0)
    # reconstruct and check normalization + positivity
    from numpy.polynomial.legendre import leggauss, legvander
    x, w = leggauss(200)
    p = legvander(x, len(gc.beta) - 1) @ gc.beta
    assert np.sum(w * p) / 2 == pytest.approx(1.0, rel=1e-8)
    assert np.all(p > -1e-9)
    # purely transmitting leaves forward-scatter more than reflecting ones
    gc_t, _ = bilambertian_greek(0.0, 0.8)
    gc_r, _ = bilambertian_greek(0.8, 0.0)
    p_t = legvander(x, len(gc_t.beta) - 1) @ gc_t.beta
    p_r = legvander(x, len(gc_r.beta) - 1) @ gc_r.beta
    assert p_t[-1] > p_r[-1]        # x = +1 is forward


def test_canopy_lai_saturation():
    """Reflectance grows monotonically with LAI and saturates; guards the
    G-projection factor in the scattering terms (without it doubling
    diverges at LAI ~ 2)."""
    pol, quad, n, i0_vec, z_pp, z_mp, ssa = _setup()
    qp = T(quad.qp_mu_n)
    g = T(ross_g(np.asarray(quad.qp_mu_n), 0.0))
    eye = torch.eye(n, dtype=F64).expand(1, n, n)
    rs = make_rsolve("lu")
    vals = []
    for lai in (0.5, 1.0, 2.0, 4.0, 8.0):
        lay = make_canopy_layer(
            T(np.full(1, lai)), T(np.full(1, ssa)), T(z_pp)[None],
            T(z_mp)[None], g, T(np.zeros(1)), qp, T(quad.wt_mu_n) / 2,
            0.5, T(i0_vec), quad.i_mu0_n, 1, T(quad.qp_mu_n[quad.i_mu0_n]),
            T(quad.mu0), T(np.ones(n)), float(quad.qp_mu.min()), eye, rs)
        comp = interaction(vacuum_layer(1, n, F64, "cpu"), lay, eye,
                           rsolve=rs)
        surf = lambertian_surface_layer(
            T(0.05), 1, 1, qp, T(quad.wt_mu_n), T(i0_vec),
            T(np.full(1, 0.5 * lai)), T(quad.mu0), True)
        comp = interaction(comp, surf, eye, rsolve=rs)
        vals.append(float(comp.j_m[0, 0]))
    vals = np.array(vals)
    assert np.all(np.isfinite(vals)) and np.all(vals > 0)
    assert np.all(np.diff(vals) > 0)
    assert vals[-1] - vals[-2] < vals[1] - vals[0]


def _scene(lai=1.5, albedo=0.1, g_override=None, n_layers=1, n_z_atm=2):
    pol, quad, band = _scene_inputs("torch", n_z_atm=n_z_atm)
    canopy = CanopyRTInputs(lai=lai, rho_l=0.45, tau_l=0.35,
                            g_override=g_override, n_layers=n_layers)
    surf = {"type": "LambertianSurfaceScalar", "albedo": albedo}
    return pol, quad, band, canopy, surf


def _canopy(pol, quad, band, canopy, surf, **kw):
    return rt_run_canopy(pol, quad, band, canopy, [15.0], [30.0], 3, surf,
                         device="cpu", **kw)


def test_rt_run_canopy_g1_reduces_to_standard_scene():
    """G = 1 turns the canopy slab into a plain atmospheric layer with the
    bi-Lambertian phase: rt_run_canopy matches rt_run_band on the
    equivalent 3-layer atmosphere."""
    pol, quad, band, canopy, surf = _scene(g_override=1.0)
    R_c, T_c, hdr, bhr_uw, bhr_dw = _canopy(pol, quad, band, canopy, surf)
    gc_can, ssa = bilambertian_greek(canopy.rho_l, canopy.tau_l,
                                     canopy.n_moments)
    n_z, n_spec = band.tau.shape
    tau2 = np.vstack([band.tau, np.full((1, n_spec), canopy.lai)])
    omega2 = np.vstack([band.omega, np.full((1, n_spec), ssa)])
    zw2 = np.zeros((n_z + 1, 2, n_spec))
    zw2[:n_z, 0] = band.zw[:, 0]
    zw2[n_z, 1] = 1.0
    band2 = BandRTInputs(tau=tau2, omega=omega2, zw=zw2,
                         greeks=[band.greeks[0], gc_can])
    R_b, T_b, hdr_b, bhr_uw_b, bhr_dw_b = rt_run_band(
        pol, quad, band2, [15.0], [30.0], 3, surf, device="cpu",
        return_hdr=True)
    np.testing.assert_allclose(R_c, R_b, rtol=2e-7, atol=1e-12)
    np.testing.assert_allclose(T_c, T_b, rtol=2e-7, atol=1e-12)
    np.testing.assert_allclose(hdr, hdr_b, rtol=2e-7, atol=1e-12)
    np.testing.assert_allclose(bhr_uw, bhr_uw_b, rtol=2e-7)
    np.testing.assert_allclose(bhr_dw, bhr_dw_b, rtol=2e-7)


def test_rt_run_canopy_dense_lai_soil_independence():
    """LAI -> large: the soil becomes invisible, while a sparse canopy
    shows a clear soil signal."""
    bright = {"type": "LambertianSurfaceScalar", "albedo": 0.9}
    pol, quad, band, canopy, surf = _scene(lai=12.0, albedo=0.05)
    R_dark = _canopy(pol, quad, band, canopy, surf)[0]
    R_bright = _canopy(pol, quad, band, canopy, bright)[0]
    assert np.abs(R_bright - R_dark).max() / np.abs(R_dark).max() < 1e-3
    pol, quad, band, canopy_s, surf = _scene(lai=0.3, albedo=0.05)
    R_d2 = _canopy(pol, quad, band, canopy_s, surf)[0]
    R_b2 = _canopy(pol, quad, band, canopy_s, bright)[0]
    assert np.abs(R_b2 - R_d2).max() / np.abs(R_d2).max() > 0.5


def test_rt_run_canopy_sensor_levels():
    """With no atmosphere the upwelling field at canopy top == the TOA
    radiance, and the diffuse downwelling at canopy top is zero."""
    pol, quad, band, canopy, surf = _scene(n_z_atm=0, n_layers=2)
    R, T_, hdr, bhr_uw, bhr_dw, uw, dw = _canopy(
        pol, quad, band, canopy, surf, sensor_levels=[0, 1])
    np.testing.assert_allclose(uw[0], R, rtol=1e-8, atol=1e-14)
    assert np.abs(dw[0]).max() < 1e-12
    assert np.all(np.isfinite(uw[1])) and np.abs(dw[1]).max() > 0
    assert np.abs(uw[1] - uw[0]).max() > 0
    with pytest.raises(ValueError, match="sensor levels"):
        _canopy(pol, quad, band, canopy, surf, sensor_levels=[3])


def test_rt_run_canopy_brdf_soil():
    """RPV soil under the canopy reduces toward the Lambertian result when
    the RPV parameters approach Lambertian (k = 1, theta = 0, rho_c = 1)."""
    pol, quad, band, canopy, _ = _scene(lai=0.8)
    rpv_lamb = {"type": "rpvSurfaceScalar", "rho0": 0.3, "rho_c": 1.0,
                "k": 1.0, "theta": 0.0}
    R_rpv = _canopy(pol, quad, band, canopy, rpv_lamb)[0]
    R_lam = _canopy(pol, quad, band, canopy,
                    {"type": "LambertianSurfaceScalar", "albedo": 0.3})[0]
    assert np.all(np.isfinite(R_rpv))
    assert np.abs(R_rpv - R_lam).max() / np.abs(R_lam).max() < 0.05


# --- 3. float32 guards ------------------------------------------------------

BLACK = dict(lai=8.0, ssa=1e-9, quad_type="GaussQuadHemisphere", l_trunc=15,
             views=(0.0, 15.0, 30.0, 45.0, 60.0), chi=0.0)


def test_float32_black_leaves_finite_where_jax_is_not():
    """JAX's float32 T^++ at these grazing streams is non-finite: its
    e^-a expm1(a - b) is 0 * inf; the port's exp_difference takes e^-b
    there."""
    got = _canopy_layer("torch", dtype=torch.float32, **BLACK)
    ref = _canopy_layer("torch", dtype=F64, **BLACK)
    _close(got, ref, tol=1e-3, what="black leaves float32")
    jax32 = _canopy_layer("jax", dtype=jnp.float32, **BLACK)
    assert not np.isfinite(np.asarray(jax32.t_pp)).all()


def test_float32_planophile_near_zero_denominators():
    """chi = 0.6: every mu_i G_j - mu_j G_i is phi1 (mu_i - mu_j) with
    phi1 = 0.0012; one rounded value is both the expm1 argument's and the
    denominator."""
    kw = dict(lai=3.0, ssa=0.85, quad_type="GaussQuadFullSphere",
              l_trunc=20, views=(0.0, 30.0, 60.0), chi=0.6)
    got = _canopy_layer("torch", dtype=torch.float32, **kw)
    ref = _canopy_layer("torch", dtype=F64, **kw)
    _close(got, ref, tol=1e-3, what="chi 0.6 float32")


def test_float32_merged_nodes():
    """O2Parameters.yaml's streams (GaussQuadHemisphere l_trunc 5, sza and
    a view at 60 deg, 1 ulp from the Gauss node 0.5): in float32 the view
    merges with the node and with mu0. The port gives T^++ between the
    merged nodes, and J^+ at the node on mu0, their float64 limits and
    stays within 1e-3 of float64; JAX's float32 layer has a non-finite
    J^+ there and a T^++ off by more than 1e-2 of max."""
    kw = dict(lai=1.5, ssa=0.8, quad_type="GaussQuadHemisphere", l_trunc=5,
              views=(60.0, 60.0, 30.0, 30.0), chi=0.1, sza=60.0)
    got = _canopy_layer("torch", dtype=torch.float32, **kw)
    ref = _canopy_layer("torch", dtype=F64, **kw)
    _close(got, ref, tol=1e-3, what="merged nodes float32")
    jax32 = _canopy_layer("jax", dtype=jnp.float32, **kw)
    assert not np.isfinite(np.asarray(jax32.j_p)).all()
    t32 = np.asarray(jax32.t_pp, np.float64)
    assert np.abs(t32 - ref.t_pp.numpy()).max() > 1e-2 * np.abs(
        ref.t_pp.numpy()).max()
