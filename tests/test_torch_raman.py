"""The port's Raman (RRS) core against the JAX package, and the reference's
Raman gates on the port alone.

1. ie_elemental, raman_doubling (lu, schulz with materialize_m, a static
   NS schedule), raman_interaction and rt_run_band_rrs (both solvers, the
   static-schedule keyword, RRS, layered-T RRS, VS and _plus specs) match
   JAX on the same numpy inputs within 1e-9 of max per field (float64).
2. Algebra gates: the factored Raman doubling and interaction equal the
   brute-force composition of the full (2N x 2N) block matrices; per-layer
   weights equal a manual per-layer composition.
3. Physics gates: energy conservation (Cabannes + Raman == full Rayleigh at
   band centre), Ring filling-in, RRS_plus == per-band runs, VS and VS_plus
   magnitudes.
4. float32: a line-core source feeding a continuum output (dd > 80, where
   JAX's float32 ie_elemental is NaN), and a view merged with a quadrature
   node (O2Parameters.yaml's geometry), both within 1e-5 of float64.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vsmartmom.core.rt as jrt
import vsmartmom.core.rt_raman as jrr
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.inelastic.plus import make_rrs_plus as jax_make_rrs_plus
from vsmartmom.inelastic.plus import make_vs_plus as jax_make_vs_plus
from vsmartmom.inelastic.rrs import make_rrs as jax_make_rrs
from vsmartmom.inelastic.rrs import make_rrs_profile as jax_make_rrs_profile
from vsmartmom.inelastic.rrs import make_vs as jax_make_vs
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

import vsmartmom_torch.core.rt_raman as rr
from vsmartmom_torch.core.rt import (LayerRT, elemental, make_rsolve,
                                     vacuum_layer)
from vsmartmom_torch.core.rt_raman import (IELayer, build_coupling,
                                           ie_elemental, raman_doubling,
                                           raman_interaction,
                                           raman_make_added_layer, roll0,
                                           roll0_id, rt_run_band_rrs, take0,
                                           take0_id, zero_ie)
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.core.surface import lambertian_surface_layer
from vsmartmom_torch.inelastic import (make_rrs, make_rrs_plus,
                                       make_rrs_profile, make_vs,
                                       make_vs_plus)
from vsmartmom_torch.scattering.phase import (Polarization,
                                              compute_Z_moments,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

TOL = 1e-9
F64 = torch.float64
UV_GRID = np.arange(20500.0, 20530.0, 1.0)
LAMB = {"type": "LambertianSurfaceScalar", "albedo": 0.2}


def T(x, dtype=F64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, tol=TOL, what=""):
    """max |got - want| <= tol * max |want|, field by field."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-300)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, (what, i, err)


class _Setup:
    """A small slab: Stokes_IQU (a D-flip that matters), 9 points, three
    shift rows with per-output weights over two Raman phase matrices."""

    def __init__(self, pol_name="Stokes_IQU", n_spec=9, seed=0):
        self.pol = Polarization.from_name(pol_name)
        self.quad = rt_set_streams("GaussQuadFullSphere", 6, 40.0,
                                   [0.0, 30.0], self.pol.n)
        q = self.quad
        n = self.n = len(q.qp_mu_n)
        rng = np.random.default_rng(seed)
        self.n_spec = n_spec
        self.tau = rng.uniform(0.05, 0.4, n_spec)
        self.omega = rng.uniform(0.5, 0.95, n_spec)
        self.f_rayl = rng.uniform(0.3, 0.9, n_spec)
        self.tau_sum = rng.uniform(0.0, 0.3, n_spec)
        z = [compute_Z_moments(self.pol, q.qp_mu, get_greek_rayleigh(d), 0)
             for d in (0.03, 0.4, 0.2)]
        self.z_pp, self.z_mp = z[0]
        self.z_pp_r = np.stack([z[1][0], z[2][0]])
        self.z_mp_r = np.stack([z[1][1], z[2][1]])
        self.shifts = np.array([2, -1, 3])
        self.srcs, self.valids = (np.asarray(x) for x in
                                  rr.coupling_rows_from_shifts(
                                      self.shifts, n_spec))
        self.ws = rng.uniform(0.01, 0.05, (3, n_spec)) * self.valids
        self.gids = np.array([0, 1, 0])
        self.i0 = np.zeros(n)
        self.i0[q.i_mu0_n:q.i_mu0_n + self.pol.n] = self.pol.i0
        self.d_vec = np.tile(self.pol.d, q.n_quad)
        self.mu0_node = float(q.qp_mu_n[q.i_mu0_n])
        self.wct2 = q.wt_mu_n / 2.0

    def ie_args(self, dtau, lib):
        """Arguments after (shift, w) of ie_elemental, per package."""
        if lib == "jax":
            c = jnp.asarray
            return (c(dtau), c(self.f_rayl), c(self.tau_sum))
        return (T(dtau), T(self.f_rayl), T(self.tau_sum))

    def tail(self, lib):
        c = jnp.asarray if lib == "jax" else T
        q = self.quad
        return (c(q.qp_mu_n), c(self.wct2), c(0.5), c(self.i0), q.i_mu0_n,
                self.pol.n, c(self.mu0_node))

    def layer(self, dtau_scale):
        """Elastic and ie elemental operators of a slab (port, float64),
        as numpy."""
        dtau = self.tau * dtau_scale
        el = elemental(T(dtau), T(self.omega), T(self.z_pp)[None],
                       T(self.z_mp)[None], *self.tail("torch")[:3],
                       T(self.tau_sum), *self.tail("torch")[3:])
        ie = ie_elemental((self.srcs, self.valids), T(self.ws), T(dtau),
                          T(self.f_rayl), T(self.tau_sum),
                          T(self.z_pp_r[self.gids]),
                          T(self.z_mp_r[self.gids]), *self.tail("torch"))
        return [x.numpy() for x in el], [x.numpy() for x in ie]


@pytest.fixture(scope="module")
def setup():
    return _Setup()


def test_rows_and_gathers(setup):
    """coupling rows, take0/take0_id and roll0/roll0_id against JAX,
    negative shifts and clipping included."""
    s = setup
    jsrc, jval = jrr.coupling_rows_from_shifts(jnp.asarray(s.shifts),
                                               s.n_spec)
    np.testing.assert_array_equal(s.srcs, np.asarray(jsrc))
    np.testing.assert_array_equal(s.valids, np.asarray(jval))
    x = np.random.default_rng(1).normal(size=(s.n_spec, 3, 3))
    eye = np.broadcast_to(np.eye(3), (s.n_spec, 3, 3))
    for row in range(3):
        src, val = s.srcs[row], s.valids[row]
        np.testing.assert_array_equal(
            take0(T(x), torch.as_tensor(src).long(), torch.as_tensor(val)),
            jrr.take0(jnp.asarray(x), jnp.asarray(src), jnp.asarray(val)))
        np.testing.assert_array_equal(
            take0_id(T(x), torch.as_tensor(src).long(),
                     torch.as_tensor(val), T(eye)),
            jrr.take0_id(jnp.asarray(x), jnp.asarray(src),
                         jnp.asarray(val), jnp.asarray(eye)))
    for sh in (-4, -1, 0, 2, 5):
        np.testing.assert_array_equal(roll0(T(x), sh),
                                      jrr.roll0(jnp.asarray(x), sh))
        np.testing.assert_array_equal(
            roll0_id(T(x), sh, T(eye)),
            jrr.roll0_id(jnp.asarray(x), sh, jnp.asarray(eye)))
    # the batched gather equals the per-row ones
    got = take0(T(x), torch.as_tensor(s.srcs).long(),
                torch.as_tensor(s.valids))
    for row in range(3):
        np.testing.assert_array_equal(
            got[row], jrr.take0(jnp.asarray(x), jnp.asarray(s.srcs[row]),
                                jnp.asarray(s.valids[row])))


def test_ie_elemental_matches(setup):
    s = setup
    dtau = s.tau / 8.0
    got = ie_elemental((s.srcs, s.valids), T(s.ws), *s.ie_args(dtau, "torch"),
                       T(s.z_pp_r[s.gids]), T(s.z_mp_r[s.gids]),
                       *s.tail("torch"))
    for row in range(3):
        want = jrr.ie_elemental(
            (jnp.asarray(s.srcs[row]), jnp.asarray(s.valids[row])),
            jnp.asarray(s.ws[row]), *s.ie_args(dtau, "jax"),
            jnp.asarray(s.z_pp_r[s.gids[row]]),
            jnp.asarray(s.z_mp_r[s.gids[row]]), *s.tail("jax"))
        _close([g[row] for g in got], want, what=f"row {row}")
    # one int shift with a scalar weight returns one unbatched row
    one = ie_elemental(2, 0.03, *s.ie_args(dtau, "torch"), T(s.z_pp_r[0]),
                       T(s.z_mp_r[0]), *s.tail("torch"))
    want = jrr.ie_elemental(2, 0.03, *s.ie_args(dtau, "jax"),
                            jnp.asarray(s.z_pp_r[0]),
                            jnp.asarray(s.z_mp_r[0]), *s.tail("jax"))
    _close(one, want, what="single shift")


def _doubling_inputs(s):
    (r, t, jp, jm), ie = s.layer(1.0 / 8.0)
    dv = s.d_vec
    ek = np.exp(-(s.tau / 8.0) / s.quad.mu0)
    return [dv[:, None] * r, t, jp, dv * jm, ek,
            dv[:, None] * ie[0], ie[1], ie[2], dv * ie[3]]


@pytest.mark.parametrize("mode", ["lu", "schulz", "schedule"])
def test_raman_doubling_matches(setup, mode):
    """lu solves per shift; schulz gathers materialize_m's inverse field;
    a static per-step NS schedule replaces the fixed count."""
    s = setup
    args = _doubling_inputs(s)
    solver = "lu" if mode == "lu" else "schulz"
    sched = (0, 1, 2) if mode == "schedule" else None
    eye = np.broadcast_to(np.eye(s.n), (s.n_spec, s.n, s.n))
    got = raman_doubling(*map(T, args), s.shifts, 3, T(eye),
                         make_rsolve(solver), ns_schedule=sched)
    want = jrr.raman_doubling(*map(jnp.asarray, args),
                              jnp.asarray(s.shifts), 3, jnp.asarray(eye),
                              jrt.make_rsolve(solver), ns_schedule=sched)
    _close(got, want, what=mode)
    if mode == "schulz":
        assert hasattr(make_rsolve("schulz"), "materialize_m")
        assert not hasattr(make_rsolve("lu"), "materialize_m")


@pytest.mark.parametrize("solver", ["lu", "schulz"])
def test_raman_interaction_matches(setup, solver):
    s = setup
    eye = np.broadcast_to(np.eye(s.n), (s.n_spec, s.n, s.n))
    sgn = s.d_vec[:, None] * s.d_vec[None, :]

    def slab(scale, ie_scale):
        (r, t, jp, jm), ie = s.layer(scale)
        el = [r, sgn * r, t, sgn * t, jp, jm]
        iel = [ie_scale * ie[0], ie_scale * sgn * ie[0], ie_scale * ie[1],
               ie_scale * sgn * ie[1], ie_scale * ie[2], ie_scale * ie[3]]
        return el, iel

    (c_el, c_ie), (a_el, a_ie) = slab(0.7, 1.0), slab(0.3, 0.5)
    got = raman_interaction(LayerRT(*map(T, c_el)), IELayer(*map(T, c_ie)),
                            LayerRT(*map(T, a_el)), IELayer(*map(T, a_ie)),
                            (s.srcs, s.valids), T(eye), make_rsolve(solver))
    want = jrr.raman_interaction(
        jrt.LayerRT(*map(jnp.asarray, c_el)),
        jrr.IELayer(*map(jnp.asarray, c_ie)),
        jrt.LayerRT(*map(jnp.asarray, a_el)),
        jrr.IELayer(*map(jnp.asarray, a_ie)),
        (jnp.asarray(s.srcs), jnp.asarray(s.valids)), jnp.asarray(eye),
        jrt.make_rsolve(solver))
    _close(list(got[0]) + list(got[1]), list(want[0]) + list(want[1]),
           what=solver)


# --- whole runs against JAX --------------------------------------------------

def _uv_band(lib, n_z=2, seed=5):
    rng = np.random.default_rng(seed)
    n_spec = len(UV_GRID)
    tau_r = rng.uniform(0.1, 0.3, (n_z, n_spec))
    tau = tau_r + rng.uniform(0.0, 0.1, (n_z, n_spec))
    band = (JaxBand if lib == "jax" else BandRTInputs)(
        tau=tau, omega=tau_r / tau, zw=np.ones((n_z, 1, n_spec)),
        greeks=[(jax_greek if lib == "jax" else get_greek_rayleigh)(0.03)])
    return band, tau_r / tau


def _vs_band(lib, n_spec):
    tau_rayl = np.full((2, n_spec), 0.1)
    band = (JaxBand if lib == "jax" else BandRTInputs)(
        tau=tau_rayl, omega=np.ones_like(tau_rayl),
        zw=np.ones((2, 1, n_spec)),
        greeks=[(jax_greek if lib == "jax" else get_greek_rayleigh)(0.03)])
    return band, np.ones_like(tau_rayl)


RUNS = {
    # name: (polarization, specs(lib), band(lib), solver, static schedules)
    "rrs_lu": ("Stokes_IQU", lambda lib: (jax_make_rrs if lib == "jax"
                                          else make_rrs)(UV_GRID, T=250.0),
               _uv_band, "lu", False),
    "rrs_schulz": ("Stokes_IQU", lambda lib: (jax_make_rrs if lib == "jax"
                                              else make_rrs)(UV_GRID,
                                                             T=250.0),
                   _uv_band, "schulz", False),
    "rrs_schulz_static": ("Stokes_I", lambda lib: (
        jax_make_rrs if lib == "jax" else make_rrs)(UV_GRID, T=250.0),
        _uv_band, "schulz", True),
    "rrs_layered": ("Stokes_I", lambda lib: (
        jax_make_rrs_profile if lib == "jax" else make_rrs_profile)(
            UV_GRID, [210.0, 285.0]), _uv_band, "lu", False),
    "vs": ("Stokes_I", lambda lib: (jax_make_vs if lib == "jax"
                                    else make_vs)(
        np.arange(10500.0, 13300.0, 40.0), T=250.0),
        lambda lib: _vs_band(lib, 70), "lu", False),
    "vs_plus": ("Stokes_I", lambda lib: (
        jax_make_vs_plus if lib == "jax" else make_vs_plus)(
            25000.0, T=250.0, dnu=4.0, margin=4.0, j_max=12).specs,
        lambda lib: _vs_band(lib, make_vs_plus(
            25000.0, T=250.0, dnu=4.0, margin=4.0, j_max=12).n_spec),
        "lu", False),
    "rrs_plus": ("Stokes_I", lambda lib: (
        jax_make_rrs_plus if lib == "jax" else make_rrs_plus)(
            [np.arange(12740.0, 13180.0, 16.0),
             np.arange(14300.0, 14740.0, 16.0)], j_max=16).specs,
        lambda lib: _vs_band(lib, 56), "schulz", False),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_rt_run_band_rrs_matches(name, monkeypatch):
    pol_name, specs, band_fn, solver, static = RUNS[name]
    streams = ("GaussQuadFullSphere", 6, 35.0, [0.0, 30.0])
    band, f_rayl = band_fn("torch")
    pol = Polarization.from_name(pol_name)
    got = rt_run_band_rrs(pol, rt_set_streams(*streams, pol.n), band,
                          specs("torch"), f_rayl, [0.0, 30.0], [0.0, 45.0],
                          2, LAMB, device="cpu", solver=solver,
                          static_schedules=static)
    if static:
        monkeypatch.setenv("VSM_RAMAN_SCHED", "1")
    jband, _ = band_fn("jax")
    want = jrr.rt_run_band_rrs(JaxPol.from_name(pol_name),
                               jax_streams(*streams, pol.n), jband,
                               specs("jax"), f_rayl, [0.0, 30.0],
                               [0.0, 45.0], 2, LAMB, solver=solver)
    _close(got, want, what=name)
    assert np.abs(got[2]).max() > 0


def test_chunked_shift_rows_match_one_chunk(monkeypatch):
    """The drivers take the shift rows in chunks: one row per chunk gives
    the same result as all rows in one."""
    band, f_rayl = _uv_band("torch")
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 35.0, [30.0], pol.n)
    rrs = make_rrs_profile(UV_GRID, [210.0, 285.0])
    one = rt_run_band_rrs(pol, quad, band, rrs, f_rayl, [30.0], [20.0], 2,
                          LAMB, device="cpu")
    n = len(quad.qp_mu_n)
    assert rr.ie_chunk_rows(rrs.n_raman, len(UV_GRID), n, F64, "cpu") \
        == rrs.n_raman
    # the full-width O2 A-band shape on the card: 172 rows of 6 837
    # points, N = 15
    assert rr.ie_chunk_rows(172, 6837, 15, torch.float64, "cuda") == 87
    assert rr.ie_chunk_rows(172, 6837, 15, torch.float32, "cuda") == 172
    monkeypatch.setitem(rr.IE_CHUNK_BYTES, "cpu", 1)
    assert rr.ie_chunk_rows(rrs.n_raman, len(UV_GRID), n, F64, "cpu") == 1
    rows = rt_run_band_rrs(pol, quad, band, rrs, f_rayl, [30.0], [20.0], 2,
                           LAMB, device="cpu")
    _close(rows, one, tol=1e-13)


def test_rt_run_band_rrs_refusals():
    band, f_rayl = _uv_band("torch")
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 35.0, [0.0], pol.n)
    rrs = make_rrs(UV_GRID)
    with pytest.raises(ValueError, match="schulz"):
        rt_run_band_rrs(pol, quad, band, rrs, f_rayl, [0.0], [0.0], 1,
                        LAMB, device="cpu", solver="lu",
                        static_schedules=True)
    with pytest.raises(ValueError, match="LambertianSurfaceScalar"):
        rt_run_band_rrs(pol, quad, band, rrs, f_rayl, [0.0], [0.0], 1,
                        {"type": "rpvSurfaceScalar", "rho_0": 0.1,
                         "rho_c": 0.1, "k": 0.7, "theta": -0.2},
                        device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card: no CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            rt_run_band_rrs(pol, quad, band, rrs, f_rayl, [0.0], [0.0], 1,
                            LAMB)


# --- algebra gates: brute-force block composition ----------------------------

def test_raman_algebra_vs_brute_force():
    """Factored ie doubling+interaction == dense 2Nx2N block composition
    (the gate of tests/test_raman.py, on the port)."""
    s = _Setup("Stokes_I", n_spec=7)
    n, n_spec, shift = s.n, s.n_spec, 2
    dtau = s.tau / 8.0                   # pretend ndoubl = 3
    eye = T(np.broadcast_to(np.eye(n), (n_spec, n, n)))
    rsolve = make_rsolve("lu")
    (r, t, jp, jm), _ = s.layer(1.0 / 8.0)
    ier, iet, iejp, iejm = (x.numpy() for x in ie_elemental(
        shift, 0.03, *s.ie_args(dtau, "torch"), T(s.z_pp), T(s.z_mp),
        *s.tail("torch")))
    ek = np.exp(-dtau / s.quad.mu0)
    out = raman_doubling(T(r), T(t), T(jp), T(jm), T(ek), T(ier[None]),
                         T(iet[None]), T(iejp[None]), T(iejm[None]),
                         [shift], 3, eye, rsolve)
    rf, tf, jpf, jmf, _, ierf, ietf, iejpf, iejmf = (x.numpy() for x in out)
    for n1 in range(n_spec - shift):
        n0 = n1 + shift
        Z = np.zeros((n, n))
        Rb = np.block([[r[n1], ier[n1]], [Z, r[n0]]])
        Tb = np.block([[t[n1], iet[n1]], [Z, t[n0]]])
        Jp = np.concatenate([iejp[n1], jp[n0]])
        Jm = np.concatenate([iejm[n1], jm[n0]])
        Ek = np.concatenate([np.full(n, ek[n1]), np.full(n, ek[n0])])
        for _ in range(3):
            tt = Tb @ np.linalg.inv(np.eye(2 * n) - Rb @ Rb)
            j1p, j1m = Jp * Ek, Jm * Ek
            Jm = Jm + tt @ (j1m + Rb @ Jp)
            Jp = j1p + tt @ (Jp + Rb @ j1m)
            Rb = Rb + tt @ Rb @ Tb
            Tb = tt @ Tb
            Ek = Ek * Ek
        for got, want in ((ierf[0, n1], Rb[:n, n:]), (ietf[0, n1],
                                                       Tb[:n, n:]),
                          (iejmf[0, n1], Jm[:n]), (iejpf[0, n1], Jp[:n]),
                          (rf[n1], Rb[:n, :n])):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)

    # interaction gate: compose two such layers
    lay = LayerRT(*map(T, (rf, rf, tf, tf, jpf, jmf)))
    lay_ie = IELayer(*map(T, (ierf, ierf, ietf, ietf, iejpf, iejmf)))
    c1 = raman_interaction(vacuum_layer(n_spec, n, F64, "cpu"),
                           zero_ie(1, n_spec, n, F64, "cpu"), lay, lay_ie,
                           [shift], eye, rsolve)
    c2, c2_ie = raman_interaction(*c1, lay, lay_ie, [shift], eye, rsolve)
    for n1 in range(n_spec - shift):
        n0 = n1 + shift
        Z = np.zeros((n, n))

        def blk(x, xie):
            return np.block([[x[n1], xie[0, n1]], [Z, x[n0]]])

        Rmp, Tpp = blk(rf, ierf), blk(tf, ietf)
        Jp = np.concatenate([iejpf[0, n1], jpf[n0]])
        Jm = np.concatenate([iejmf[0, n1], jmf[n0]])
        I2 = np.eye(2 * n)
        t01 = Tpp @ np.linalg.inv(I2 - Rmp @ Rmp)
        jm_new = Jm + t01 @ (Rmp @ Jp + Jm)
        rmp_new = Rmp + t01 @ Rmp @ Tpp
        jp_new = Jp + t01 @ (Jp + Rmp @ Jm)
        tpp_new = t01 @ Tpp
        for got, want in ((c2_ie.r_mp[0, n1], rmp_new[:n, n:]),
                          (c2_ie.t_pp[0, n1], tpp_new[:n, n:]),
                          (c2_ie.j_m[0, n1], jm_new[:n]),
                          (c2_ie.j_p[0, n1], jp_new[:n])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                       atol=1e-13)


def test_layered_weights_match_per_layer_composition():
    """(nZ, nR) per-layer weights == manual per-layer composition with each
    layer's own make_rrs weights (the gate of test_raman_layert.py)."""
    t_layers = [210.0, 285.0]
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 40.0, [0.0], pol.n)
    n, n_spec = len(quad.qp_mu_n), len(UV_GRID)
    band, f_rayl = _uv_band("torch")
    rrs = make_rrs_profile(UV_GRID, t_layers)
    R, T_, ieR, ieT = rt_run_band_rrs(pol, quad, band, rrs, f_rayl, [0.0],
                                      [0.0], 1, LAMB, device="cpu")

    rsolve = make_rsolve("lu")
    eye = T(np.broadcast_to(np.eye(n), (n_spec, n, n)))
    z_pp, z_mp = compute_Z_moments(pol, quad.qp_mu, band.greeks[0], 0)
    z_pp_r, z_mp_r = compute_Z_moments(pol, quad.qp_mu, rrs.greek_raman, 0)
    i0 = np.zeros(n)
    i0[quad.i_mu0_n] = 1.0
    tau_sum = np.vstack([np.zeros((1, n_spec)),
                         np.cumsum(band.tau, axis=0)])
    comp, comp_ie = None, None
    for iz, t_l in enumerate(t_layers):
        srcs, valids, ws, gids = build_coupling([make_rrs(UV_GRID, T=t_l)],
                                                n_spec)
        lay = raman_make_added_layer(
            T(band.tau[iz]), T(band.omega[iz]), T(z_pp)[None],
            T(z_mp)[None], T(z_pp_r)[None], T(z_mp_r)[None],
            T(tau_sum[iz]), T(f_rayl[iz]), (srcs, valids), T(ws), gids,
            T(quad.qp_mu_n), T(quad.wt_mu_n / 2.0), T(0.5), T(i0),
            quad.i_mu0_n, 1, T(quad.qp_mu_n[quad.i_mu0_n]), T(quad.mu0),
            T(np.ones(n)), float(np.min(quad.qp_mu)), eye, rsolve)
        if comp is None:
            comp, comp_ie = (vacuum_layer(n_spec, n, F64, "cpu"),
                             zero_ie(len(srcs), n_spec, n, F64, "cpu"))
        comp, comp_ie = raman_interaction(comp, comp_ie, *lay,
                                          (srcs, valids), eye, rsolve)
    surf = lambertian_surface_layer(
        T(0.2), n_spec, 1, T(quad.qp_mu_n), T(quad.wt_mu_n), T(i0),
        T(tau_sum[-1]), T(quad.mu0), True)
    comp, comp_ie = raman_interaction(
        comp, comp_ie, surf, zero_ie(len(srcs), n_spec, n, F64, "cpu"),
        (srcs, valids), eye, rsolve)
    i_mu = int(np.argmin(np.abs(quad.qp_mu - 1.0)))
    np.testing.assert_allclose(R[0, 0], 0.5 * comp.j_m[:, i_mu].numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(
        ieR[0, 0], 0.5 * comp_ie.j_m.sum(0)[:, i_mu].numpy(), rtol=1e-12)
    # and the layered run differs from a uniform mean-T run
    _, _, ie_mean, _ = rt_run_band_rrs(pol, quad, band,
                                       make_rrs(UV_GRID, T=247.5), f_rayl,
                                       [0.0], [0.0], 1, LAMB, device="cpu")
    assert np.abs(ie_mean - ieR).max() / np.abs(ieR).max() > 1e-3


# --- physics gates -----------------------------------------------------------

def _rrs_band(tau_abs_center=0.0):
    """Pure-Rayleigh band (optionally with a gaussian absorption line) on a
    grid spanning the +-~200 cm^-1 rotational shifts (tests/test_raman.py's
    band)."""
    grid = np.arange(12740.0, 13268.0, 6.0)
    n_spec = len(grid)
    rrs = make_rrs(grid, T=250.0)
    tau_rayl = np.full((2, n_spec), 0.15)
    tau_abs = tau_abs_center * np.exp(
        -0.5 * ((np.arange(n_spec) - n_spec // 2) / 1.0) ** 2)
    tau = tau_rayl + tau_abs[None, :]
    greeks = [get_greek_rayleigh(rrs.depol_rayl)]
    band_cab = BandRTInputs(tau=tau, omega=tau_rayl * rrs.omega_cabannes
                            / tau, zw=np.ones((2, 1, n_spec)), greeks=greeks)
    band_full = BandRTInputs(tau=tau, omega=tau_rayl / tau,
                             zw=np.ones((2, 1, n_spec)), greeks=greeks)
    return grid, rrs, band_cab, band_full, tau_rayl / tau


def test_rrs_energy_conservation_and_ring_effect():
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.0}
    grid, rrs, band_cab, band_full, f_rayl = _rrs_band()
    R_cab, _, ieR, _ = rt_run_band_rrs(pol, quad, band_cab, rrs, f_rayl,
                                       [0.0], [0.0], 2, surf, device="cpu")
    R_full, _ = rt_run_band(pol, quad, band_full, [0.0], [0.0], 2, surf,
                            device="cpu")
    c = len(grid) // 2
    assert R_cab[0, 0, c] + ieR[0, 0, c] == pytest.approx(R_full[0, 0, c],
                                                          rel=2e-3)
    assert 0.01 < ieR[0, 0, c] / R_cab[0, 0, c] < 0.06

    grid, rrs, band_cab, _, f_rayl = _rrs_band(tau_abs_center=2.0)
    R_cab, _, ieR, _ = rt_run_band_rrs(pol, quad, band_cab, rrs, f_rayl,
                                       [0.0], [0.0], 2, surf, device="cpu")
    fill = ieR[0, 0] / R_cab[0, 0]
    assert fill[c] > fill[2] * 1.2


def test_ring_effect_demo(capsys):
    from vsmartmom_torch import ring_effect_demo
    ring_effect_demo.main(["--device", "cpu"])
    assert "Ring effect reproduced" in capsys.readouterr().out


def test_rrs_plus_equals_per_band_runs():
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.0}
    g1 = np.arange(12740.0, 13180.0, 8.0)
    g2 = np.arange(14300.0, 14740.0, 8.0)
    cb = make_rrs_plus([g1, g2], T=250.0, j_max=16)
    n_tot = cb.n_spec
    rng = np.random.default_rng(3)
    tau_rayl = np.full((2, n_tot), 0.12)
    tau = tau_rayl + rng.uniform(0.0, 0.3, (2, n_tot))
    f_rayl = tau_rayl / tau
    omega_j = tau_rayl.copy()
    for (lo, hi), c in zip(cb.band_spec_lim, cb.omega_cabannes):
        omega_j[:, lo:hi] *= c
    greeks = [get_greek_rayleigh(cb.depol_rayl)]
    band_j = BandRTInputs(tau=tau, omega=omega_j / tau,
                          zw=np.ones((2, 1, n_tot)), greeks=greeks)
    Rj, _, ieRj, _ = rt_run_band_rrs(pol, quad, band_j, cb.specs, f_rayl,
                                     [15.0], [0.0], 2, surf, device="cpu")
    for (lo, hi), g in zip(cb.band_spec_lim, [g1, g2]):
        single = make_rrs(g, T=250.0, j_max=16)
        band = BandRTInputs(tau=tau[:, lo:hi], omega=tau_rayl[:, lo:hi]
                            * single.omega_cabannes / tau[:, lo:hi],
                            zw=np.ones((2, 1, hi - lo)), greeks=greeks)
        Rs, _, ieRs, _ = rt_run_band_rrs(pol, quad, band, single,
                                         f_rayl[:, lo:hi], [15.0], [0.0], 2,
                                         surf, device="cpu")
        np.testing.assert_allclose(Rj[..., lo:hi], Rs, rtol=1e-10)
        np.testing.assert_allclose(ieRj[..., lo:hi], ieRs, rtol=1e-8,
                                   atol=1e-14)


def test_vs_and_vs_plus_physics():
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.0}
    grid = np.arange(10500.0, 13300.0, 20.0)
    n_spec = len(grid)
    specs = make_vs(grid, T=250.0, direction="0to1")
    band, f_rayl = _vs_band("torch", n_spec)
    R, _, ieR, _ = rt_run_band_rrs(pol, quad, band, specs, f_rayl, [0.0],
                                   [0.0], 2, surf, device="cpu")
    assert np.all(np.isfinite(ieR))
    max_shift = max(int(s.i_shift.max()) for s in specs)
    fill = ieR[0, 0, :] / R[0, 0, :]
    # vibrational filling is ~1e-4 of the elastic signal
    assert 1e-5 < np.median(fill[: n_spec - max_shift - 1]) < 5e-3

    cb = make_vs_plus(25000.0, T=250.0, direction="0to1", dnu=4.0,
                      margin=4.0, j_max=12)
    quad = rt_set_streams("GaussQuadFullSphere", 6, 45.0, [0.0], pol.n)
    band, f_rayl = _vs_band("torch", cb.n_spec)
    R, _, ieR, _ = rt_run_band_rrs(pol, quad, band, cb.specs, f_rayl, [0.0],
                                   [0.0], 2, surf, device="cpu")
    fill = ieR[0, 0]
    assert fill[cb.i_ref] == 0.0           # no VS into the incident column
    for lo, hi in cb.band_spec_lim[1:]:
        assert fill[lo:hi].max() > 0
    assert 1e-5 < fill.sum() / R[0, 0, cb.i_ref] < 1e-2
    w_all = np.zeros(cb.n_spec)
    for s in cb.specs:
        np.add.at(w_all, s.i_out, s.w)
    np.testing.assert_array_equal(fill[w_all == 0.0], 0.0)


# --- float32 -----------------------------------------------------------------

def test_float32_line_core_source():
    """A source in an O2 line core (dtau 15.8 at mu = 0.1127: dt0/mu =
    140) feeding an output in the continuum: e^-a expm1(a - b) is 0 * inf
    in float32. JAX's float32 T^++ is NaN there; the port's is finite and
    within 1e-5 of max of float64."""
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadHemisphere", 5, 60.0, [60.0, 30.0],
                          pol.n)
    n = len(quad.qp_mu_n)
    z_pp, z_mp = compute_Z_moments(pol, quad.qp_mu, get_greek_rayleigh(0.03),
                                   0)
    dtau = np.array([1e-3, 15.8, 1e-3, 2e-3, 15.8, 1e-3])
    i0 = np.zeros(n)
    i0[quad.i_mu0_n:quad.i_mu0_n + 3] = pol.i0
    args = (dtau, np.full(6, 0.5), np.zeros(6), z_pp, z_mp, quad.qp_mu_n,
            quad.wt_mu_n / 2.0, 0.5, i0)
    mu0 = quad.qp_mu_n[quad.i_mu0_n]
    for shift in (1, -1):
        f64 = ie_elemental(shift, 0.03, *map(T, args[:7]), T(0.5),
                           T(args[8]), quad.i_mu0_n, 3, T(mu0))
        f32 = ie_elemental(shift, 0.03,
                           *(T(a, torch.float32) for a in args[:7]),
                           T(0.5, torch.float32), T(args[8], torch.float32),
                           quad.i_mu0_n, 3, T(mu0, torch.float32))
        assert all(torch.isfinite(x).all() for x in f32)
        _close([x.double() for x in f32], f64, tol=1e-5, what=shift)
        jax32 = jrr.ie_elemental(
            shift, 0.03, *(jnp.asarray(a, jnp.float32) for a in args[:7]),
            jnp.asarray(0.5, jnp.float32), jnp.asarray(args[8], jnp.float32),
            quad.i_mu0_n, 3, jnp.asarray(mu0, jnp.float32))
        assert np.isnan(np.asarray(jax32[1])).any()


def test_float32_merged_view_node():
    """O2Parameters.yaml's geometry: the view at 60 deg (mu 0.5 + 1 ulp) is
    a node of its own in float64 and merges with the Gauss node 0.5 in
    float32. The T^++ coupling between them, elastic and Raman, and the
    Raman source of the merged node keep their float64 values: elastic
    fields within 1e-5, Raman fields within 1e-4 of max (float32 forms
    e^-a - e^-b of nearby small arguments there); dropping the coupling
    is off by 4.5e-4 (elastic T^++) and 0.22 (Raman T^++)."""
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadHemisphere", 5, 60.0, [60.0, 30.0],
                          pol.n)
    qp32 = quad.qp_mu_n.astype(np.float32)
    assert len(np.unique(quad.qp_mu_n)) > len(np.unique(qp32))
    n = len(quad.qp_mu_n)
    z_pp, z_mp = compute_Z_moments(pol, quad.qp_mu, get_greek_rayleigh(0.03),
                                   0)
    rng = np.random.default_rng(2)
    dtau = rng.uniform(1e-3, 3e-3, 5)
    i0 = np.zeros(n)
    i0[quad.i_mu0_n:quad.i_mu0_n + 3] = pol.i0
    mu0 = quad.qp_mu_n[quad.i_mu0_n]
    common = (quad.qp_mu_n, quad.wt_mu_n / 2.0, 0.5)

    def both(dtype):
        c = (lambda x: T(x, dtype))
        el = elemental(c(dtau), c(np.full(5, 0.9)), c(z_pp)[None],
                       c(z_mp)[None], *map(c, common), c(np.zeros(5)), c(i0),
                       quad.i_mu0_n, 3, c(mu0))
        ie = ie_elemental(1, 0.03, c(dtau), c(np.full(5, 0.5)),
                          c(np.zeros(5)), c(z_pp), c(z_mp), *map(c, common),
                          c(i0), quad.i_mu0_n, 3, c(mu0))
        return [x.double() for x in el], [x.double() for x in ie]

    (el32, ie32), (el64, ie64) = both(torch.float32), both(F64)
    _close(el32, el64, tol=1e-5, what="elastic")
    _close(ie32, ie64, tol=1e-4, what="raman")


def _node_band(lib):
    """Three Rayleigh layers of spectrally flat tau (so dtau is equal at
    source and output away from the line), a line of peak tau 1, 10 and 60
    at 13 075 cm^-1, 70 points at 5 cm^-1."""
    grid = np.arange(12900.0, 13250.0, 5.0)
    tau_r = 0.05 * np.array([[0.2], [0.5], [1.0]]) * np.ones(len(grid))
    line = np.exp(-0.5 * ((grid - 13075.0) / 6.0) ** 2)
    tau = tau_r + np.array([[1.0], [10.0], [60.0]]) * line[None]
    band = (JaxBand if lib == "jax" else BandRTInputs)(
        tau=tau, omega=tau_r / tau, zw=np.ones((3, 1, len(grid))),
        greeks=[(jax_greek if lib == "jax" else get_greek_rayleigh)(0.03)])
    specs = (jax_make_rrs_profile if lib == "jax" else make_rrs_profile)(
        grid, [220.0, 250.0, 280.0])
    return band, specs, tau_r / tau


def test_view_on_a_quadrature_node():
    """The sun and a view 1 ulp from a quadrature node (60 deg on the
    GaussQuadHemisphere node 0.5, as in O2Parameters.yaml), at equal dtau:
    the port's Raman run is continuous with both moved 1e-4 deg off the
    node (within 1e-5 of max per field), in float64 and float32. The JAX
    package's ie_elemental subtracts two equal exponentials there (T^++
    and the solar source), and its ieR is more than 1e-2 of max off."""
    pol = Polarization.from_name("Stokes_I")
    band, specs, f_rayl = _node_band("torch")

    def run(angle, dtype=F64):
        quad = rt_set_streams("GaussQuadHemisphere", 5, angle,
                              [angle, 30.0], pol.n)
        return rt_run_band_rrs(pol, quad, band, specs, f_rayl,
                               [angle, 30.0], [0.0, 0.0], 2, LAMB,
                               dtype=dtype, device="cpu")

    off = run(60.0001)
    _close(run(60.0), off, tol=1e-5, what="float64")
    _close(run(60.0, torch.float32), off, tol=1e-5, what="float32")
    jband, jspecs, _ = _node_band("jax")
    want = jrr.rt_run_band_rrs(
        JaxPol.from_name("Stokes_I"),
        jax_streams("GaussQuadHemisphere", 5, 60.0, [60.0, 30.0], 1), jband,
        jspecs, f_rayl, [60.0, 30.0], [0.0, 0.0], 2, LAMB)
    assert np.abs(want[2] - off[2]).max() / np.abs(off[2]).max() > 1e-2
