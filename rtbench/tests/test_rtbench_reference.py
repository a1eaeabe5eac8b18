"""The plain reference against the port at a small size on the CPU, the
roofline count against the port's kernel count, and the checks that keep
JAX and the program out of where they do not belong."""
import ast
import os
import sys

import numpy as np
import pytest
import torch

from rtbench import roofline, run
from rtbench.reference import rt as ref_rt
from rtbench.reference import scene as ref_scene

TINY = os.path.join(os.path.dirname(__file__), "data", "o2a_tiny.yaml")


def test_reference_agrees_with_the_port_in_float64():
    """The port's float64 torch engine under the schulz solver's static
    doubling counts, against the reference built from the same file."""
    import vsmartmom_torch as vt
    from vsmartmom_torch.core.api import build_band_inputs
    from vsmartmom_torch.core.rt_run import rt_run_band
    torch.set_num_threads(2)
    p = vt.parameters_from_yaml(TINY)
    p.float_type = "Float64"
    m = vt.model_from_parameters(p, device="cpu")
    R, T = rt_run_band(m.pol, m.quad_points, build_band_inputs(m, 0), p.vza,
                       p.vaz, p.max_m, p.surfaces[0], dtype=torch.float64,
                       device="cpu", solver="schulz", engine="torch")
    sc = ref_scene.build_scene(TINY)
    band = sc.bands[0]
    idx = np.arange(len(band.grid))
    gas = ref_scene.gas_tau(sc, 0, idx, "cpu")
    np.testing.assert_allclose(gas, m.tau_abs[0], rtol=1e-12, atol=0)
    nds = ref_rt.doubling_counts(
        ref_scene.scattering_depth(band).max(axis=0),
        float(np.min(sc.quad.qp_mu)))
    r, t = ref_rt.radiance(
        sc, ref_scene.greeks(sc, band),
        *(ref_scene.to_torch(a, "cpu") for a in ref_scene.band_inputs(
            band, idx, gas)),
        ref_scene.to_torch(band.albedo, "cpu"), nds, "cpu")
    assert np.max(np.abs(R - r.numpy())) < 1e-10 * np.max(np.abs(R))
    assert np.max(np.abs(T - t.numpy())) < 1e-10 * np.max(np.abs(T))


@pytest.mark.parametrize("n", [1, 15, 30, 44, 63])
@pytest.mark.parametrize("sched", [(), (0, 1, 2, 4), (3,) * 9])
@pytest.mark.parametrize("ni", [0, 4])
def test_roofline_count_pinned_to_the_port(n, sched, ni):
    """The count equals the port's step_flops with each Newton-Schulz
    solve (2 products an iteration) taken out and one inverse put in."""
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    ns = sum(2 * n * n * 2 * n * it for it in sched) + 2 * n * n * 2 * n * ni
    inverses = (len(sched) + 1) * roofline.inverse_flops(n)
    assert roofline.step_flops(n, len(sched)) - inverses \
        == lsk.step_flops(n, sched, ni) - ns
    assert roofline.step_bytes(n) == lsk.step_bytes(n)


def test_roofline_bound_takes_the_larger_side():
    work = [(15, 22669, 12)]
    t = roofline.bound_s(work)
    assert t == max(roofline.flops(work) / roofline.PEAK_FP32_FLOPS,
                    22669 * roofline.step_bytes(15)
                    / roofline.PEAK_BYTES_PER_S)


@pytest.mark.parametrize("names,found", [
    (["vsmartmom_torch", "vsmartmom_torch.core"], []),
    (["vsmartmom.core.rt"], ["vsmartmom"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "jaxtyping"], ["flax"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    saved = dict(sys.modules)
    try:
        for n in names:
            sys.modules[n] = object()
        assert [m for m in run.forbidden_loaded()
                if m in {n.split(".")[0] for n in names}] == found
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


REF_DIR = os.path.join(run.HERE, "reference")


@pytest.mark.parametrize("fn", sorted(f for f in os.listdir(REF_DIR)
                                      if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program_or_jax(fn):
    tops = {m.split(".")[0] for m in _imports(os.path.join(REF_DIR, fn))}
    assert not tops & {"vsmartmom_torch", "vsmartmom", "jax", "jaxlib",
                       "flax"}


def test_harness_imports_no_jax():
    for fn in os.listdir(run.HERE):
        if fn.endswith(".py"):
            tops = {m.split(".")[0]
                    for m in _imports(os.path.join(run.HERE, fn))}
            assert not tops & {"vsmartmom", "jax", "jaxlib", "flax"}


def test_port_kernels_read_from_the_sources():
    from rtbench import trace
    names = trace.port_kernels()
    assert {"layer_step_kernel", "layer_step_kernel_bf16",
            "layer_step_tc_kernel", "voigt_kernel"} <= names
    assert trace.kernel_of("void layer_step_kernel<Cfg<16, 32> >(float*)",
                           names) == "layer_step_kernel"
    assert trace.kernel_of("void layer_step_kernel_bf16<Cfg<16> >(float*)",
                           names) == "layer_step_kernel_bf16"
    assert trace.kernel_of("void at::native::elementwise_kernel<128>()",
                           names) is None
