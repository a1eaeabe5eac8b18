"""Matrix-product precision modes of the port (core/precision.py) against
the JAX package.

JAX runs as its own tests run it on the CPU: its batch_mm builds the bf16x3
split by hand, its Pallas kernels run in interpret mode with the same
``precision_name``, its run functions take the mode from their arguments
and the environment. A bf16 pass multiplies bf16 values exactly and sums in
float32, so the port and JAX differ only by the order of those float32
sums: products within 1e-6 of max, whole layer steps within 1e-5 (float32)
or 1e-6 (float64, whose products in a bf16 mode are float32 sums too).
Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core import rt as jrt
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.pallas.doubling_kernel import batch_mm as jax_batch_mm
from vsmartmom.pallas.doubling_kernel import fused_doubling as jax_doubling
from vsmartmom.pallas.layer_step_kernel import fused_layer_step as jax_step
from vsmartmom.pallas.layer_step_kernel import \
    fused_layer_step_dev as jax_step_dev
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core import precision
from vsmartmom_torch.core import rt as trt
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.cuda import doubling_kernel as dk
from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
from vsmartmom_torch.cuda import layer_step_kernel as lsk
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

#: max|diff| / max|ref| of one product: float32 sums in another order
MM_BOUND = 1e-6
#: a split-form layer step: the product bound grown over its recursion
STEP_BOUNDS = {"float32": 1e-5, "float64": 1e-6}
#: a plain-form step or doubling at "high": where the two sums leave an
#: operand on two sides of a bf16 rounding, its x_lo moves by up to 2^-17
#: (7.6e-6) of the operand, and the ~1.0 transmission diagonal rides the
#: plain form's products
PLAIN_HIGH_BOUND = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _operands(seed, shape_a=(6, 9, 9), k=11, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape_a).astype(dtype)
    b = rng.standard_normal(shape_a[-3:-1] + (k,)).astype(dtype)
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batch_mm_high_is_jax_bf16x3(dtype):
    """batch_mm("high") and ("bf16x3") against JAX's batch_mm("bf16x3"):
    the same three passes; the result takes the operands' dtype."""
    a, b = _operands(0, dtype=getattr(np, dtype))
    ref = np.asarray(jax_batch_mm("bf16x3")(jnp.asarray(a), jnp.asarray(b)))
    full = a.astype(np.float64) @ b.astype(np.float64)
    for name in ("high", "bf16x3"):
        got = precision.batch_mm(name)(torch.as_tensor(a),
                                       torch.as_tensor(b))
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got, ref) < MM_BOUND, _rel(got, ref)
    # the dropped a_lo b_lo term: near float32, not at it
    err = _rel(got, full)
    assert 1e-8 < err < 1e-4, err


def test_batch_mm_default_is_one_bf16_pass():
    """batch_mm("default") against numpy on operands cast through
    jnp.bfloat16 (round to nearest even), summed in float32; "highest" is
    torch.matmul itself."""
    a, b = _operands(1)
    bf = lambda x: np.asarray(x.astype(jnp.bfloat16), np.float32)  # noqa
    ref = np.matmul(bf(a), bf(b))
    got = precision.batch_mm("default")(torch.as_tensor(a),
                                        torch.as_tensor(b))
    assert _rel(got, ref) < MM_BOUND
    assert _rel(got, a.astype(np.float64) @ b) > 1e-4
    assert precision.batch_mm("highest") is torch.matmul


def test_batch_mm_broadcasts_over_raman_rows():
    """The ie products broadcast (nR, S, N, N) @ (S, N, N): each row is
    the row's own product, bit for bit."""
    a, b = _operands(2, shape_a=(3, 4, 5, 5), k=5)
    mm = precision.batch_mm("high")
    got = mm(torch.as_tensor(a), torch.as_tensor(b))
    for r in range(3):
        assert torch.equal(got[r], mm(torch.as_tensor(a[r]),
                                      torch.as_tensor(b)))


def _elemental(S, n, nd, seed, dtype):
    """Passive plain-form elemental slab (r, t, jp, jm, ek)."""
    rng = np.random.default_rng(seed)
    dtau, mqm = 0.5 / 2 ** nd, 0.2
    r = rng.uniform(0, 1, (S, n, n)) * dtau / (n * mqm)
    t = (np.eye(n) * np.exp(-dtau / mqm)
         + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm))
    return [x.astype(dtype) for x in (
        r, t, rng.uniform(0, dtau, (S, n)), rng.uniform(0, dtau, (S, n)),
        np.full((S,), np.exp(-dtau / 0.7)))]


def _dev_slab(S, n, nd, seed, dtype, scale=1.0):
    """Passive split-form elemental slab (r, g, e, jp, jm, ek)."""
    rng = np.random.default_rng(seed)
    dtau, mqm = 0.2 / 2 ** nd, 0.2
    r = rng.uniform(0, 1, (S, n, n)) * dtau * scale / (n * mqm)
    e = rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm)
    g = np.exp(-dtau / np.linspace(mqm, 1.0, n))[None].repeat(S, 0)
    return [x.astype(dtype) for x in (
        r, g, e, rng.uniform(0, dtau, (S, n)), rng.uniform(0, dtau, (S, n)),
        np.full(S, np.exp(-dtau / 0.7)))]


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("row,dtype", [("row1", "float32"),
                                       ("row3", "float32"),
                                       ("row3", "float64"),
                                       ("row4", "float32")])
def test_twins_at_bf16x3_match_jax_interpret(row, dtype):
    """Rows 1, 3 and 4's plain versions (what the wrappers run on CPU
    tensors) at "high" / "bf16x3" against JAX's Pallas kernels in interpret
    mode at the same precision_name, on a composite of two steps.
    Rows 1 and 4 in float64 cannot run at "high" in JAX's interpret mode
    (it stores a float32 product into a float64 output), so float64 holds
    row 3 alone, as tests/test_dev_form.py:175-186 does."""
    S, n, sched, ni = 8, 12, (1, 2, 3), 3
    bound = STEP_BOUNDS[dtype] if row == "row3" else PLAIN_HIGH_BOUND
    npdt, jdt = getattr(np, dtype), getattr(jnp, dtype)
    d = np.tile([1.0, 1.0, -1.0], n // 3).astype(npdt)
    jx = lambda x: jnp.asarray(x, jdt)  # noqa: E731
    if row == "row4":
        el = _elemental(S, n, len(sched), 3, npdt)
        ref = jax_doubling(*map(jx, el), ns_schedule=sched, interpret=True,
                           precision_name="high")

        def run(mode):
            return dk.fused_doubling(*map(_t, el), ns_schedule=sched,
                                     precision=mode)
        fields = ("r", "t", "jp", "jm")
    elif row == "row1":
        comp = trt.vacuum_layer(S, n, getattr(torch, dtype), "cpu")
        for k, scale in enumerate((1.0, 0.6)):
            el = _elemental(S, n, len(sched), k, npdt)
            el[0] = el[0] * scale
            comp = lsk.fused_layer_step(comp, *map(_t, el), _t(d),
                                        ns_schedule=sched, ni=4)
        comp = [x.numpy() for x in comp]
        el = _elemental(S, n, len(sched), 5, npdt)
        ref = jax_step(jrt.LayerRT(*map(jx, comp)), *map(jx, el), jx(d),
                       ns_schedule=sched, ni=ni, interpret=True,
                       precision_name="high")

        def run(mode):
            return lsk.fused_layer_step(trt.LayerRT(*map(_t, comp)),
                                        *map(_t, el), _t(d),
                                        ns_schedule=sched, ni=ni,
                                        precision=mode)
        fields = trt.LayerRT._fields
    else:
        comp = trt.vacuum_layer_dev(S, n, getattr(torch, dtype), "cpu")
        for k, scale in enumerate((1.0, 0.6)):
            comp = ldk.fused_layer_step_dev(
                comp, *map(_t, _dev_slab(S, n, 3, k, npdt, scale)), _t(d),
                ns_schedule=sched, ni=4)
        comp = [x.numpy() for x in comp]
        el = _dev_slab(S, n, 3, 5, npdt, 0.8)
        ref = jax_step_dev(jrt.LayerRTDev(*map(jx, comp)), *map(jx, el),
                           jx(d), ns_schedule=sched, ni=ni, interpret=True,
                           precision_name="bf16x3")

        def run(mode=None):
            # None: the wrapper's default mode, JAX's bf16x3
            kw = {} if mode is None else dict(precision=mode)
            return ldk.fused_layer_step_dev(trt.LayerRTDev(*map(_t, comp)),
                                            *map(_t, el), _t(d),
                                            ns_schedule=sched, ni=ni, **kw)
        fields = trt.LayerRTDev._fields
    got = run("high") if row != "row3" else run()
    for name, x, y in zip(fields, got, ref):
        assert x.dtype == getattr(torch, dtype), name
        assert np.isfinite(x.numpy()).all(), name
        assert _rel(x, y) < bound, (name, _rel(x, y))
    # the bound alone would pass a twin that ignored the mode: the twin at
    # JAX's mode must be nearer JAX's kernel than the twin at "highest"
    # (2.0-8.1x nearer on these inputs)
    worst = max(_rel(x, y) for x, y in zip(got, ref))
    worst_highest = max(_rel(x, y) for x, y in zip(run("highest"), ref))
    assert worst < 0.75 * worst_highest, (worst, worst_highest)


def test_bf16x3_precision_cliff():
    """The JAX package's cliff test (tests/test_dev_form.py:161-246) on the
    port: on a grazing-mu 13-doubling stack the plain doubling at "high"
    sits well above the float32 floor and agrees with JAX's row 4 in
    interpret mode at "high"; the split form at "bf16x3" stays at the
    floor. (On the CPU, as on the card, "high" is the documented three-pass
    function: 4-7x the floor here. The TPU's 0.36-0.42 of
    data/qualification/precision_r03.jsonl came from XLA's own HIGH dots.)
    """
    rng = np.random.default_rng(1)
    S, n, nd = 16, 16, 13
    mu = np.linspace(0.02, 1.0, n)
    dtau = 1e-6
    z = 0.5 + 0.5 * rng.random((S, n, n))
    w = np.full(n, 2.0 / n)
    r0 = 0.9999 * z * (w[None, :] * dtau
                       / (mu[:, None] + mu[None, :]))[None]
    g0 = np.tile(np.exp(-dtau / mu)[None], (S, 1))
    e0 = 0.3 * 0.9999 * z * (w[None, :] * dtau
                             / np.abs(mu[:, None] - mu[None, :]
                                      + 1e-1))[None]
    t0 = e0 + g0[:, :, None] * np.eye(n)[None]
    jp0 = rng.uniform(0, dtau, (S, n))
    jm0 = rng.uniform(0, dtau, (S, n))
    ek0 = np.full(S, np.exp(-dtau / 0.5))
    sched = (4,) * nd
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    plain = (r0, t0, jp0, jm0, ek0)

    r64, t64, _, _ = dk.fused_doubling(*map(torch.as_tensor, plain),
                                       ns_schedule=sched)

    def err(r, t):
        return max(_rel(r, r64), _rel(t, t64))

    r32, t32, _, _ = dk.fused_doubling(*map(f32, plain), ns_schedule=sched)
    floor = err(r32, t32)
    rb3, tb3, _, _ = dk.fused_doubling(*map(f32, plain), ns_schedule=sched,
                                       precision="high")
    plain_b3 = err(rb3, tb3)
    jr, jt, _, _ = jax_doubling(*(jnp.asarray(x, jnp.float32) for x in plain),
                                ns_schedule=sched, interpret=True,
                                precision_name="high")
    rd, gd, ed, _, _ = trt.doubling_dev(
        *map(f32, (r0, g0, e0, jp0, jm0, ek0)), ns_schedule=sched,
        mm=precision.batch_mm("bf16x3"))
    dev_b3 = err(rd, ed + gd[:, :, None] * torch.eye(n)[None])

    assert plain_b3 > 4.0 * floor, (plain_b3, floor)
    assert max(_rel(rb3, jr), _rel(tb3, jt)) < 1e-4
    assert dev_b3 < 1.5 * floor and dev_b3 < 1e-3, (dev_b3, floor)


def _band(n_z=6, n_spec=8, seed=3):
    """Heterogeneous profile (thin stratosphere over thick scatterers), as
    tests/test_dev_form.py:_band_fixture at a smaller size."""
    rng = np.random.default_rng(seed)
    tau = np.concatenate([np.full((n_z // 2, n_spec), 0.002),
                          rng.uniform(0.05, 0.3, (n_z - n_z // 2, n_spec))])
    om = rng.uniform(0.4, 0.999, (n_z, n_spec))
    return tau, om, np.ones((n_z, 1, n_spec))


def test_kernel_dev_bf16x3_run_matches_jax_and_float64(monkeypatch):
    """rt_run_band(engine="kernel_dev", dd_precision="bf16x3") in float64
    (the split-form step's plain version at bf16x3) within 3e-5 of the
    float64 torch_dev run, and within 1e-6 of JAX's pallas_dd_interpret
    under VSM_DD_PRECISION=bf16x3 (tests/test_dev_form.py:175-186), on
    three layers of one schedule at moment 0 (one interpret-mode
    kernel)."""
    monkeypatch.setenv("VSM_DD_PRECISION", "bf16x3")
    rng = np.random.default_rng(3)
    tau = rng.uniform(0.15, 0.3, (3, 6))
    om = rng.uniform(0.4, 0.999, tau.shape)
    zw = np.ones((3, 1, 6))
    quad_args = ("GaussQuadFullSphere", 8, 45.0, [10.0, 40.0], 3)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    kw = dict(dtype=torch.float64, solver="schulz", device="cpu")
    band = BandRTInputs(tau=tau, omega=om, zw=zw,
                        greeks=[get_greek_rayleigh(0.03)])
    pol, quad = Polarization.from_name("Stokes_IQU"), rt_set_streams(
        *quad_args)
    R0, _ = rt_run_band(pol, quad, band, [30.], [0.], 1, surf,
                        engine="torch_dev", **kw)
    R1, _ = rt_run_band(pol, quad, band, [30.], [0.], 1, surf,
                        engine="kernel_dev", dd_precision="bf16x3", **kw)
    Rj, _ = jax_rt_run_band(
        JaxPol.from_name("Stokes_IQU"), jax_streams(*quad_args),
        JaxBand(tau=tau, omega=om, zw=zw, greeks=[jax_greek(0.03)]), [30.],
        [0.], 1, surf, dtype=jnp.float64, solver="schulz",
        doubling_engine="pallas_dd_interpret")
    assert 0 < _rel(R1, R0) < 3e-5
    assert _rel(R1, Rj) < 1e-6


def _small_run(**kw):
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 30.0, [0.0, 35.0], pol.n)
    tau, om, zw = _band(n_z=4, n_spec=5, seed=4)
    band = BandRTInputs(tau=tau, omega=om, zw=zw,
                        greeks=[get_greek_rayleigh(0.03)])
    return rt_run_band(pol, quad, band, [0.0, 35.0], [0.0, 60.0], 2,
                       {"type": "LambertianSurfaceScalar", "albedo": 0.1},
                       device="cpu", solver="schulz", dtype=torch.float32,
                       **kw)


@pytest.mark.parametrize("engine", ["torch", "kernel", "torch_dev",
                                    "kernel_dev", "kernel_doubling",
                                    "kernel_scan", "kernel_lanes"])
def test_defaults_are_highest_and_modes_reach_the_engines(engine):
    """Default arguments equal an explicit "highest" bit for bit; "high"
    changes the float32 result of every engine but kernel_scan and
    kernel_lanes, whose kernels stay in full float32 (the JAX package pins
    them) and whose torch ops (the surface step) take the mode."""
    R0, T0 = _small_run(engine=engine)
    R1, T1 = _small_run(engine=engine, matmul_precision="highest",
                        dd_precision="highest")
    assert np.array_equal(R0, R1) and np.array_equal(T0, T1)
    Rh, _ = _small_run(engine=engine, matmul_precision="high")
    assert 0 < _rel(Rh, R0) < 1e-3


def test_wrapper_defaults_and_unknown_modes():
    """Rows 1 and 4 default to "highest", row 3 to "bf16x3" (JAX's
    defaults); every entry point raises ValueError on a name it does not
    take."""
    S, n, sched = 4, 6, (1, 2)
    el = [_t(x) for x in _elemental(S, n, 2, 0, np.float32)]
    d = torch.ones(n)
    comp = trt.vacuum_layer(S, n, torch.float32, "cpu")
    kw = dict(ns_schedule=sched, ni=2)
    for a, b in zip(lsk.fused_layer_step(comp, *el, d, **kw),
                    lsk.fused_layer_step(comp, *el, d, precision="highest",
                                         **kw)):
        assert torch.equal(a, b)
    for a, b in zip(dk.fused_doubling(*el, ns_schedule=sched),
                    dk.fused_doubling(*el, ns_schedule=sched,
                                      precision="highest")):
        assert torch.equal(a, b)
    dv = [_t(x) for x in _dev_slab(S, n, 2, 0, np.float32)]
    comp_d = trt.vacuum_layer_dev(S, n, torch.float32, "cpu")
    for a, b in zip(ldk.fused_layer_step_dev(comp_d, *dv, d, **kw),
                    ldk.fused_layer_step_dev(comp_d, *dv, d,
                                             precision="bf16x3", **kw)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        lsk.fused_layer_step(comp, *el, d, precision="bf16x3", **kw)
    with pytest.raises(ValueError):
        ldk.fused_layer_step_dev(comp_d, *dv, d, precision="high", **kw)
    with pytest.raises(ValueError):
        dk.fused_doubling(*el, ns_schedule=sched, precision="tf32")
    with pytest.raises(ValueError):
        _small_run(matmul_precision="tf32")
    with pytest.raises(ValueError):
        _small_run(engine="kernel_dev", dd_precision="high")
    with pytest.raises(ValueError):
        precision.batch_mm("fp8")
    assert precision.resolve_dd("highest") == "highest"
    assert precision.resolve_dd("high") == "bf16x3"
    assert precision.resolve_dd("default") == "bf16x3"
    assert precision.resolve_dd("high", "default") == "default"


def test_matmul_precision_block_scopes_mode_and_tf32():
    """The block sets the engines' mode and turns TF32 off; both return to
    their previous values after it, an exception included. float64
    operands ignore the mode."""
    a, b = (torch.as_tensor(x) for x in _operands(5))
    prev_precision = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            with precision.matmul_precision("default"):
                assert precision.active() == "default"
                assert not torch.backends.cuda.matmul.allow_tf32
                assert torch.equal(trt.bmm(a, b),
                                   precision.batch_mm("default")(a, b))
                assert torch.equal(trt.bmm(a.double(), b.double()),
                                   torch.matmul(a.double(), b.double()))
                raise RuntimeError
        assert torch.backends.cuda.matmul.allow_tf32
        assert precision.active() == "highest"
        assert torch.equal(trt.bmm(a, b), torch.matmul(a, b))
    finally:
        # both, in this order: TF32 alone would leave the legacy and the
        # per-backend settings disagreeing, which torch then refuses to read
        torch.set_float32_matmul_precision(prev_precision)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    assert torch.get_float32_matmul_precision() == prev_precision


@pytest.mark.parametrize("mode", ["high", "default"])
def test_bmv_and_z_mixing_take_the_mode(mode):
    """bmv and the Z mixing (the dots JAX runs under the default precision
    beside bmm's) equal batch_mm of the block's mode bit for bit, and
    torch.matmul / the einsum outside any block."""
    a, v = (torch.as_tensor(x) for x in _operands(7, k=1))
    zw = torch.as_tensor(np.random.default_rng(8).uniform(0.1, 1.0, (3, 5)),
                         dtype=torch.float32)
    zc = torch.as_tensor(_operands(9, shape_a=(3, 4, 4))[0])
    mm = precision.batch_mm(mode)
    with precision.matmul_precision(mode):
        assert torch.equal(trt.bmv(a, v[..., 0]), mm(a, v)[..., 0])
        got = trt.mix_z(zw, zc)
        assert torch.equal(got, mm(zw.T, zc.reshape(3, 16)).reshape(5, 4, 4))
        assert torch.equal(trt.mix_z(zw.double(), zc.double()),
                           torch.einsum("kn,kij->nij", zw.double(),
                                        zc.double()))
    full = torch.einsum("kn,kij->nij", zw, zc)
    assert _rel(got, full) > 1e-8
    assert torch.equal(trt.mix_z(zw, zc), full)
    assert torch.equal(trt.bmv(a, v[..., 0]), torch.matmul(a, v)[..., 0])


def test_radiance_fn_and_sharded_runs_take_the_modes():
    """make_radiance_fn passes its modes to the kernels (the default equals
    an explicit "highest" bit for bit, "high" moves the float32 radiance)
    and its forward rule runs at the kernel's mode; rt_run_band_sharded
    forwards both keywords, so a sharded run at "high" equals the
    unsharded one bit for bit."""
    from vsmartmom_torch.core.autodiff import make_radiance_fn
    from vsmartmom_torch.core.rt_run import build_layer_schedules
    from vsmartmom_torch.parallel.sharding import rt_run_band_sharded
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 30.0, [0.0], pol.n)
    tau, om, zw = _band(n_z=3, n_spec=4, seed=6)
    nd, sched, ls = build_layer_schedules(tau, om, float(quad.qp_mu.min()),
                                          "schulz")
    t32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731

    def radiance(**kw):
        fn = make_radiance_fn(pol, quad, [get_greek_rayleigh(0.0)], [0.0],
                              [0.0], 2, 3, 4, dtype=torch.float32,
                              device="cpu", solver="schulz", engine="kernel",
                              layer_schedules=ls, ndoubl_static=nd,
                              ns_schedule=sched, **kw)
        return lambda s: fn(t32(tau) * s, t32(om), t32(zw), 0.1)

    one = torch.tensor(1.0)
    R0 = radiance()(one)
    assert torch.equal(R0, radiance(matmul_precision="highest")(one))
    Rh, dRh = torch.func.jvp(radiance(matmul_precision="high"), (one,),
                             (one,))
    assert 0 < _rel(Rh, R0) < 1e-3
    _, dR0 = torch.func.jvp(radiance(), (one,), (one,))
    assert 0 < _rel(dRh, dR0) < 1e-2

    band = BandRTInputs(tau=tau, omega=om, zw=zw,
                        greeks=[get_greek_rayleigh(0.0)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    kw = dict(dtype=torch.float32, solver="schulz", engine="kernel_dev",
              matmul_precision="high", dd_precision="default")
    R1, T1 = rt_run_band(pol, quad, band, [0.0], [0.0], 2, surf,
                         device="cpu", **kw)
    Rs, Ts = rt_run_band_sharded(pol, quad, band, [0.0], [0.0], 2, surf,
                                 devices=["cpu", "cpu"], **kw)
    assert np.array_equal(Rs, R1) and np.array_equal(Ts, T1)
