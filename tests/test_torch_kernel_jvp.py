"""Forward rules of the port's fused layer steps (rows 1 and 3) against the
JAX package's custom_jvp, and the operand check of the kernels without one.

The port's wrappers are torch.autograd.Functions: the primal is the kernel
(its plain version on CPU tensors), the tangent torch.func.jvp of the plain
version. JAX's custom_jvp computes the primal with the Pallas kernel (here
in interpret mode) and the tangent with its jnp twin. Inputs: the passive
slabs of tests/test_torch_layer_step.py and tests/test_torch_dev_form.py
at S = 8, N = 12, float32 (the kernels' type), from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vsmartmom.core import rt as jrt
from vsmartmom.pallas.layer_step_kernel import fused_layer_step as jax_step
from vsmartmom.pallas.layer_step_kernel import \
    fused_layer_step_dev as jax_step_dev

from vsmartmom_torch.core import rt as trt
from vsmartmom_torch.cuda import build
from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
from vsmartmom_torch.cuda import layer_step_kernel as lsk

torch.set_num_threads(2)

S, N = 8, 12
SCHED, NI = (1, 2, 3), 3
D = np.tile([1.0, 1.0, -1.0], N // 3)
TANGENT_BOUND = 1e-5


def _slab(dev, seed, scale=1.0):
    """Elemental inputs after the composite: plain (r_f, t, jp, jm, ek) or
    split (r_f, g, e, jp, jm, ek), numpy float64."""
    rng = np.random.default_rng(seed)
    tau_scat, mqm = 0.2, 0.2
    dtau = tau_scat / 2 ** len(SCHED)
    r = rng.uniform(0, 1, (S, N, N)) * dtau * scale / (N * mqm)
    e = rng.uniform(0, 1, (S, N, N)) * dtau / (2 * N * mqm)
    g = np.exp(-dtau / np.linspace(mqm, 1.0, N))[None].repeat(S, 0)
    jp = rng.uniform(0, dtau, (S, N))
    jm = rng.uniform(0, dtau, (S, N))
    ek = np.full(S, np.exp(-dtau / 0.7))
    if dev:
        return [r, g, e, jp, jm, ek]
    return [r, e + g[:, :, None] * np.eye(N), jp, jm, ek]


def _case(dev):
    """(jax step, port step, port plain, composite (numpy), elemental
    inputs, tangents of both): the composite is two JAX steps from
    vacuum."""
    j32 = lambda x: jnp.asarray(x, jnp.float32)   # noqa: E731
    if dev:
        jstep, tstep = jax_step_dev, ldk.fused_layer_step_dev
        plain = ldk.fused_layer_step_dev_plain
        comp = jrt.vacuum_layer_dev(S, N, jnp.float32)
        kw = dict(precision_name="highest")
        tkw = dict(precision="highest")
    else:
        jstep, tstep = jax_step, lsk.fused_layer_step
        plain = lsk.fused_layer_step_plain
        comp = jrt.vacuum_layer(S, N, jnp.float32)
        kw = tkw = {}
    for k, scale in enumerate((1.0, 0.6)):
        comp = jstep(comp, *map(j32, _slab(dev, k, scale)), j32(D),
                     ns_schedule=SCHED, ni=4, interpret=True, **kw)
    comp = [np.asarray(x) for x in comp]
    elem = [np.asarray(x, np.float32) for x in _slab(dev, 5, 0.8)]
    rng = np.random.default_rng(11)
    tangents = [rng.standard_normal(x.shape).astype(np.float32) * x.std()
                for x in comp + elem]
    return jstep, tstep, plain, comp, elem, tangents, kw, tkw


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dev", [False, True], ids=["row1", "row3"])
def test_tangent_matches_jax_custom_jvp(dev):
    jstep, tstep, plain, comp, elem, tangents, kw, tkw = _case(dev)
    layer = trt.LayerRTDev if dev else trt.LayerRT
    n_c = len(comp)
    d32 = np.asarray(D, np.float32)

    def jfun(*xs):
        jlayer = jrt.LayerRTDev if dev else jrt.LayerRT
        return jstep(jlayer(*xs[:n_c]), *xs[n_c:], jnp.asarray(d32),
                     ns_schedule=SCHED, ni=NI, interpret=True, **kw)

    def tfun(*xs):
        return tstep(layer(*xs[:n_c]), *xs[n_c:], _t(d32),
                     ns_schedule=SCHED, ni=NI, **tkw)

    jp_out, jt_out = jax.jvp(jfun, tuple(map(jnp.asarray, comp + elem)),
                             tuple(map(jnp.asarray, tangents)))
    lsk.launches = ldk.launches = 0
    tp_out, tt_out = torch.func.jvp(tfun, tuple(map(_t, comp + elem)),
                                    tuple(map(_t, tangents)))
    # the primal is the plain version bit for bit; nothing launched on
    # CPU tensors
    ref = plain(layer(*map(_t, comp)), *map(_t, elem), _t(d32),
                ns_schedule=SCHED, ni=NI, **tkw)
    assert lsk.launches == ldk.launches == 0
    for name, a, b in zip(layer._fields, tp_out, ref):
        assert torch.equal(a, b), name
    for name, a, b, c in zip(layer._fields, tt_out, jt_out, jp_out):
        assert a.dtype == torch.float32
        assert np.isfinite(a.numpy()).all(), name
        assert np.abs(b).max() > 0, name
        assert _rel(a.numpy(), b) < TANGENT_BOUND, (name, _rel(a.numpy(), b))
        assert _rel(tp_out[layer._fields.index(name)].numpy(), c) < 1e-5


@pytest.mark.parametrize("dev", [False, True], ids=["row1", "row3"])
def test_partial_tangents_and_jacfwd(dev):
    """Inputs outside the transform get zero tangents (the Function's jvp
    receives None or zeros for them), and jacfwd over a scalar equals the
    plain version's jacfwd."""
    _, tstep, plain, comp, elem, _, _, tkw = _case(dev)
    layer = trt.LayerRTDev if dev else trt.LayerRT
    c_t, e_t = list(map(_t, comp)), list(map(_t, elem))
    d32 = _t(np.asarray(D, np.float32))

    def run(step, x):
        e = [e_t[0] * x[0]] + e_t[1:]
        c = c_t[:-1] + [c_t[-1] * x[1]]
        return torch.cat([f.reshape(-1) for f in step(
            layer(*c), *e, d32, ns_schedule=SCHED, ni=NI, **tkw)])

    x0 = torch.tensor([1.1, 0.9])
    calls = []
    fwd = (ldk._FusedLayerStepDev if dev else lsk._FusedLayerStep).forward

    def spy(*args):
        calls.append(any(torch._C._functorch.is_functorch_wrapped_tensor(a)
                         for a in args if isinstance(a, torch.Tensor)))
        return fwd(*args)
    cls = ldk._FusedLayerStepDev if dev else lsk._FusedLayerStep
    cls.forward = staticmethod(spy)
    try:
        J = torch.func.jacfwd(lambda x: run(tstep, x))(x0)
    finally:
        cls.forward = staticmethod(fwd)
    J_ref = torch.func.jacfwd(lambda x: run(plain, x))(x0)
    # one primal call under jacfwd, on unwrapped tensors (a launch reads
    # their data pointers)
    assert calls == [False]
    assert J.shape == (J_ref.shape[0], 2) and torch.equal(J, J_ref)


#: the kernels without a forward rule and their operand checks
NO_RULE = ["voigt_tiles", "fused_doubling", "fused_layer_scan",
           "fused_layer_step_lanes"]


@pytest.mark.parametrize("name", NO_RULE + ["fused_layer_step",
                                            "fused_layer_step_dev"])
def test_wrapped_operand_raises_before_any_launch(name):
    """A tensor wrapped by a torch.func transform never reaches a launch:
    check_operands (and check_unwrapped, the Voigt kernel's) raises
    NotImplementedError naming the kernel and the two with a rule."""
    x = torch.zeros(3, dtype=torch.float32)

    def f(v):
        build.check_operands(name, [x, v], v.device)
        return v

    with pytest.raises(NotImplementedError) as err:
        torch.func.jvp(f, (x,), (torch.ones_like(x),))
    assert name in str(err.value)
    assert "fused_layer_step (engine kernel)" in str(err.value)
    assert "fused_layer_step_dev (engine kernel_dev)" in str(err.value)
    with pytest.raises(NotImplementedError):
        torch.func.vmap(lambda v: build.check_unwrapped(name, [v]))(
            torch.zeros(2, 3))
    build.check_operands(name, [x], x.device)   # unwrapped: passes
