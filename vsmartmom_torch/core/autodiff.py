"""Forward-mode differentiability through the full RT pipeline.

Port of ``vsmartmom/core/autodiff.py``. The reference threads ForwardDiff
dual numbers through custom CUBLAS overloads (ref: CoreRT/tools/
gpu_batched.jl:100-151) and demonstrates Jacobians with respect to a
retrieval state vector (test/prototyping/AD_OCO2_test.jl). Here the torch
engines are differentiable as they stand, and the two fused layer-step
kernels carry a forward rule (kernel primal, plain-version tangent:
cuda/layer_step_kernel.py, cuda/layer_step_dev_kernel.py), as the JAX
package's custom_jvp does. This module gives an end-to-end differentiable
radiance function and a Gauss-Newton helper mirroring the reference's
retrieval loop.

The AD API is ``torch.func`` (``jacfwd``, ``jvp``), not
``torch.autograd.forward_ad``: the kernels' forward rule runs
torch.func.jvp of their plain versions, which dual tensors of
forward_ad cannot nest. Reverse mode is not ported (the JAX package uses
jacfwd only).
"""
from __future__ import annotations

import torch

from vsmartmom_torch.core import precision
from vsmartmom_torch.core.rt_run import (_fourier_step, _per_layer_schedules,
                                         default_solver, geometry,
                                         synthesis_weights)
from vsmartmom_torch.scattering.phase import Polarization
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device
from vsmartmom_torch.util.quadrature import QuadPoints
from vsmartmom_torch.util.timing import timeit

#: the engines torch.func.jacfwd passes through, with their JAX
#: counterparts: torch [xla], torch_dev [xla_dev], kernel [pallas_step],
#: kernel_dev [pallas_dd]
AD_ENGINES = ("torch", "torch_dev", "kernel", "kernel_dev")


def make_radiance_fn(pol: Polarization, quad: QuadPoints, greeks, vza, vaz,
                     max_m: int, n_z: int, n_spec: int,
                     dtype=torch.float64, device=DEFAULT_DEVICE,
                     solver: str | None = None, engine: str = "torch",
                     layer_schedules=None, ndoubl_static=None,
                     ns_schedule=None, matmul_precision: str = "highest",
                     dd_precision=None):
    """Build a differentiable radiance function.

    Returns radiance(tau, omega, zw, albedo) -> R of shape (n_vza,
    n_stokes, nSpec) on ``device``: tau, omega (nZ, nSpec), zw (nZ, K,
    nSpec) and albedo (a scalar) as in rt_run_band, which runs the same
    Fourier-moment loop; here the azimuthal synthesis is torch, so
    torch.func.jacfwd/jvp flow end to end. The Z moments and synthesis
    weights are geometry constants, computed once, on the device.

    ``engine``: one of AD_ENGINES. The kernel engines launch the fused
    layer-step kernels for the primal on CUDA tensors (their plain
    versions on CPU tensors) with the plain version's tangent. The other
    engines of rt_run (kernel_doubling, kernel_scan, kernel_lanes) raise
    ValueError: the JAX package's counterparts (pallas, pallas_scan,
    pallas_lanes) fail under jax.jacfwd as well.

    ``layer_schedules``/``ndoubl_static``/``ns_schedule``: the static
    schedules of rt_run.build_layer_schedules on a representative profile.
    The kernel and split-form engines need them. The Jacobian is then that
    of the model at this frozen discretization, which is the retrieval use
    case. ``solver``: "lu" or "schulz" (default: "lu" on the CPU, "schulz"
    on CUDA).

    ``matmul_precision``/``dd_precision``: the product modes of the
    kernel and kernel_dev engines' kernels (core/precision.py; dd None
    resolves as in rt_run_band), and of the plain version whose jvp is
    their tangent. As in the JAX package, which calls its Fourier step
    outside the precision context, they reach the kernels only: the torch
    ops run in full float32 (TF32 off) or float64.
    """
    dd_precision = precision.resolve_dd(matmul_precision, dd_precision)
    if engine not in AD_ENGINES:
        raise ValueError(
            f"engine {engine!r} has no forward-mode rule: take one of "
            f"{AD_ENGINES}; the JAX package cannot differentiate through "
            f"its counterpart either")
    device = resolve_device(device)
    solver = default_solver(device, solver)
    schedules = _per_layer_schedules(n_z, solver, ndoubl_static,
                                      ns_schedule, layer_schedules)
    n_stokes = pol.n
    geom = geometry(pol, quad, dtype, device)
    z = [geom.z_moments(greeks, m) for m in range(max_m)]

    # synthesis weights (max_m, n_vza, n_stokes) and the streams of each
    # view's Stokes components (n_vza, n_stokes)
    weights = [synthesis_weights(quad, vza, vaz, m, n_stokes)
               for m in range(max_m)]
    csw = geom.to_dev([[w for _, w in wm] for wm in weights])
    gather = torch.as_tensor([list(range(sl.start, sl.stop))
                              for sl, _ in weights[0]], device=device)

    def radiance(tau, omega, zw, albedo):
        with timeit("radiance"), precision.matmul_precision("highest"):
            albedo = torch.as_tensor(albedo, dtype=dtype, device=device)
            R = torch.zeros((len(vza), n_stokes, n_spec), dtype=dtype,
                            device=device)
            for m in range(max_m):
                with timeit("fourier step (layer scan + surface)"):
                    comp, _ = _fourier_step(
                        tau, omega, zw, *z[m], geom, albedo, None, m=m,
                        solver=solver, layer_schedules=schedules,
                        engine=engine,
                        matmul_precision=matmul_precision,
                        dd_precision=dd_precision)
                with timeit("synthesis"):
                    j_m = comp.j_m[:, gather]    # (nSpec, n_vza, n_stokes)
                    R = R + csw[m][:, :, None] * j_m.permute(1, 2, 0)
            return R

    return radiance


def gauss_newton(residual_fn, x0, n_iter: int = 5, damping: float = 0.0):
    """Tiny Gauss-Newton loop with torch.func.jacfwd Jacobians (mirrors
    test/prototyping/AD_OCO2_test.jl:71-160). Returns the state after
    ``n_iter`` steps and the chi^2 = |r|^2 before each step."""
    x = torch.as_tensor(x0)

    def value_and_residual(x):
        r = residual_fn(x)
        return r, r

    jac = torch.func.jacfwd(value_and_residual, has_aux=True)
    history = []
    for _ in range(n_iter):
        K, r = jac(x)
        A = K.T @ K + damping * torch.eye(x.shape[0], dtype=x.dtype,
                                          device=x.device)
        x = x - torch.linalg.solve(A, K.T @ r)
        history.append(float(torch.sum(r ** 2)))
    return x, history
