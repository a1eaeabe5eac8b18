"""Forward-mode AD of the port (vsmartmom_torch/core/autodiff.py) against
the JAX package and finite differences.

The setups are tests/test_autodiff.py's (Stokes_I, GaussQuadFullSphere
l_trunc 10 with two views, 3 layers, 4 spectral points, 2 moments, random
absorption from seed 0). In float64 the port's radiance and its
torch.func.jacfwd Jacobian equal JAX's within 1e-10 of max; the port's
float32 engines (the two fused layer steps' plain versions on the CPU
under their forward rule, and the split form) stay within JAX's 2e-3 of
max of float64 central differences.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vsmartmom.core.autodiff import make_radiance_fn as jax_make
from vsmartmom.core.rt_run import build_layer_schedules as jax_schedules
from vsmartmom.scattering.phase import Polarization as JPolarization
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_rayleigh
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core.autodiff import (AD_ENGINES, gauss_newton,
                                           make_radiance_fn)
from vsmartmom_torch.core.rt_run import (ENGINES, BandRTInputs,
                                         build_layer_schedules, rt_run_band)
from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
from vsmartmom_torch.cuda import layer_step_kernel as lsk
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

VZA = [0.0, 45.0]
VAZ = [0.0, 90.0]
N_Z, N_SPEC = 3, 4
F64_BOUND = 1e-10


def _profile():
    rng = np.random.default_rng(0)
    tau_scat = np.full((N_Z, N_SPEC), 0.1)
    tau = tau_scat + rng.uniform(0.0, 0.4, (N_Z, N_SPEC))
    return tau, tau_scat / tau


def _quad():
    return rt_set_streams("GaussQuadFullSphere", 10, 40.0, VZA, 1)


def _port_fn(dtype=torch.float64, **kw):
    """The port's radiance on the CPU and f(x) = nadir I spectrum at state
    x = (log scaling of tau, albedo)."""
    fn = make_radiance_fn(Polarization.from_name("Stokes_I"), _quad(),
                          [get_greek_rayleigh(0.0)], VZA, VAZ, 2, N_Z,
                          N_SPEC, dtype=dtype, device="cpu", **kw)
    tau, omega = (torch.as_tensor(a, dtype=dtype) for a in _profile())
    zw = torch.ones((N_Z, 1, N_SPEC), dtype=dtype)

    def f(x):
        return fn(tau * torch.exp(x[0]), omega, zw, x[1])
    return f


def _schedules(build):
    tau, omega = _profile()
    return build(tau, omega, float(np.min(_quad().qp_mu)), "schulz")


def _jax_fn(**kw):
    pol = JPolarization.from_name("Stokes_I")
    quad = jax_streams("GaussQuadFullSphere", 10, 40.0, VZA, pol.n)
    fn = jax_make(pol, quad, [jax_rayleigh(0.0)], VZA, VAZ, 2, N_Z, N_SPEC,
                  **kw)
    tau, omega = (jnp.asarray(a) for a in _profile())
    zw = jnp.ones((N_Z, 1, N_SPEC))

    def f(x):
        return fn(tau * jnp.exp(x[0]), omega, zw, x[1])
    return f


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("engine", ["torch", "torch_dev"])
def test_radiance_and_jacfwd_match_jax(engine):
    """float64: the lu/xla setup of tests/test_autodiff.py, and the split
    form at build_layer_schedules' static schedules (JAX's xla_dev)."""
    if engine == "torch":
        port, ref = _port_fn(), _jax_fn()
    else:
        nd, sched, scheds = _schedules(build_layer_schedules)
        assert (nd, sched, scheds) == tuple(
            _schedules(jax_schedules)[:2]) + (None,)
        kw = dict(solver="schulz", layer_schedules=scheds,
                  ndoubl_static=nd, ns_schedule=sched)
        port = _port_fn(engine="torch_dev", **kw)
        ref = _jax_fn(doubling_engine="xla_dev", **kw)
    x0 = np.array([0.1, 0.2])
    R = port(torch.as_tensor(x0))
    # one JAX trace gives both (a jit compile of the radiance is seconds)
    J_ref, R_ref = (np.asarray(a) for a in jax.jacfwd(
        lambda x: (ref(x), ref(x)), has_aux=True)(jnp.asarray(x0)))
    assert R.shape == R_ref.shape == (len(VZA), 1, N_SPEC)
    assert _rel(R.numpy(), R_ref) < F64_BOUND
    J = torch.func.jacfwd(port)(torch.as_tensor(x0))
    assert J.shape == J_ref.shape == (len(VZA), 1, N_SPEC, 2)
    assert np.abs(J_ref).max() > 0
    assert _rel(J.numpy(), J_ref) < F64_BOUND


def _central_differences(f, x0, eps=1e-6):
    cols = []
    for k in range(len(x0)):
        dx = np.zeros(len(x0))
        dx[k] = eps
        cols.append((f(torch.as_tensor(x0 + dx))
                     - f(torch.as_tensor(x0 - dx))).numpy() / (2 * eps))
    return np.stack(cols, axis=-1)


def test_jacfwd_matches_finite_differences():
    """tests/test_autodiff.py's gate on the port: nadir I spectrum."""
    f = _port_fn()

    def nadir(x):
        return f(x)[0, 0, :]

    x0 = np.array([0.1, 0.2])
    J = torch.func.jacfwd(nadir)(torch.as_tensor(x0)).numpy()
    fd = _central_differences(nadir, x0)
    np.testing.assert_allclose(J, fd, rtol=2e-5, atol=1e-10)


def test_gauss_newton_retrieval():
    """Recover (tau scaling, albedo) from synthetic radiances."""
    f = _port_fn()
    x_true = torch.tensor([0.25, 0.3], dtype=torch.float64)
    y_meas = f(x_true).ravel()
    x_hat, hist = gauss_newton(lambda x: f(x).ravel() - y_meas,
                               torch.tensor([0.0, 0.1], dtype=torch.float64),
                               n_iter=6)
    np.testing.assert_allclose(x_hat.numpy(), x_true.numpy(), atol=1e-6)
    assert hist[-1] < hist[0] * 1e-8


@pytest.mark.parametrize("engine", ["kernel", "kernel_dev", "torch_dev"])
def test_float32_engines_against_float64_differences(engine):
    """jacfwd through the float32 layer-step engines at static schedules
    (the kernels' forward rule: primal from the wrapper, tangent from the
    plain version) against float64 central differences of the lu path,
    JAX's gate (tests/test_autodiff.py:test_jacfwd_through_production_
    engines)."""
    nd, sched, scheds = _schedules(build_layer_schedules)
    f32 = _port_fn(torch.float32, solver="schulz", engine=engine,
                   layer_schedules=scheds, ndoubl_static=nd,
                   ns_schedule=sched)
    lsk.launches = ldk.launches = 0
    x0 = np.array([0.1, 0.2])
    J = torch.func.jacfwd(lambda x: f32(x)[0, 0, :])(
        torch.tensor(x0, dtype=torch.float32)).numpy()
    assert lsk.launches == ldk.launches == 0     # CPU: plain versions
    assert np.all(np.isfinite(J)) and np.abs(J).max() > 0
    f64 = _port_fn()
    fd = _central_differences(lambda x: f64(x)[0, 0, :], x0)
    assert np.abs(J - fd).max() < 2e-3 * np.abs(fd).max()


@pytest.mark.parametrize("engine", ["torch", "kernel"])
def test_radiance_fn_matches_rt_run_band(engine):
    """make_radiance_fn's torch synthesis against rt_run_band's numpy
    one: the same geometry, engine and static schulz schedules, Stokes_IQU
    at two views, float64, within 1e-12 of max."""
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 40.0, VZA, pol.n)
    tau, omega = _profile()
    zw = np.ones((N_Z, 1, N_SPEC))
    greeks = [get_greek_rayleigh(0.03)]
    nd, sched, scheds = build_layer_schedules(
        tau, omega, float(np.min(quad.qp_mu)), "schulz")
    assert sched is not None or scheds is not None
    fn = make_radiance_fn(pol, quad, greeks, VZA, VAZ, 3, N_Z, N_SPEC,
                          device="cpu", solver="schulz", engine=engine,
                          layer_schedules=scheds, ndoubl_static=nd,
                          ns_schedule=sched)
    R = fn(*(torch.as_tensor(a, dtype=torch.float64)
             for a in (tau, omega, zw)), 0.15).numpy()
    R0, _ = rt_run_band(pol, quad, BandRTInputs(tau=tau, omega=omega, zw=zw,
                                                greeks=greeks),
                        VZA, VAZ, 3,
                        {"type": "LambertianSurfaceScalar", "albedo": 0.15},
                        device="cpu", solver="schulz", engine=engine)
    assert R.shape == R0.shape == (len(VZA), pol.n, N_SPEC)
    assert np.abs(R0[:, 1:]).max() > 0
    assert np.abs(R - R0).max() <= 1e-12 * np.abs(R0).max()


@pytest.mark.parametrize("engine", [e for e in ENGINES
                                    if e not in AD_ENGINES] + ["auto"])
def test_engines_without_forward_rule_raise(engine):
    """kernel_doubling, kernel_scan and kernel_lanes have no forward rule
    (their JAX counterparts fail under jax.jacfwd); auto is not an AD
    engine either."""
    with pytest.raises(ValueError, match="no forward-mode rule"):
        _port_fn(engine=engine)


def test_entry_points_default_to_cuda():
    """The AD entry points run on the card unless the caller asks for the
    CPU; without CUDA they raise."""
    import inspect
    from vsmartmom_torch.scattering.mie_ad import aerosol_optics_with_derivs
    from vsmartmom_torch.spectroscopy.voigt import absorption_cross_section
    fns = (make_radiance_fn, aerosol_optics_with_derivs,
           absorption_cross_section)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the calls would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_radiance_fn(Polarization.from_name("Stokes_I"), _quad(),
                         [get_greek_rayleigh(0.0)], VZA, VAZ, 2, N_Z, N_SPEC)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aerosol_optics_with_derivs(0.3, 1.8, 1.45, 0.001, 0.55, 6.0, 40)
