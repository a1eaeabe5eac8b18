"""The port stands alone: neither the package nor chip_smoke.py imports JAX
or the JAX package, every engine runs on the CPU with JAX blocked, and
building a kernel waits for the first launch on a CUDA tensor."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "vsmartmom_torch"

_SCRIPT = """
import sys
sys.modules["jax"] = None            # any JAX import now raises
import numpy as np, torch
torch.set_num_threads(1)
import vsmartmom_torch
from vsmartmom_torch.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util.quadrature import rt_set_streams
import vsmartmom_torch.canopy_demo
import vsmartmom_torch.check_bucketed
import vsmartmom_torch.core.brdf
import vsmartmom_torch.core.canopy
import vsmartmom_torch.core.multisensor
import vsmartmom_torch.core.precision
import vsmartmom_torch.core.rami
import vsmartmom_torch.core.rt_raman
import vsmartmom_torch.inelastic
import vsmartmom_torch.ring_effect_demo
import vsmartmom_torch.scattering.pcw
import vsmartmom_torch.scattering.wigner
import vsmartmom_torch.solar
import vsmartmom_torch.spectroscopy.absco
import vsmartmom_torch.spectroscopy.lut
import vsmartmom_torch.util.show
import vsmartmom_torch.util.timing
import vsmartmom_torch.cuda.doubling_kernel
import vsmartmom_torch.cuda.lanes_kernel
import vsmartmom_torch.cuda.layer_scan_kernel
import vsmartmom_torch.cuda.layer_step_dev_kernel
import vsmartmom_torch.cuda.layer_step_kernel
import vsmartmom_torch.cuda.voigt_kernel
import vsmartmom_torch.native
import vsmartmom_torch.qualify_precision
import vsmartmom_torch.parallel.distributed
import vsmartmom_torch.parallel.sharding
import vsmartmom_torch.scaling_bench
import vsmartmom_torch.spectroscopy.hitran_native
pol = Polarization.from_name("Stokes_IQU")
quad = rt_set_streams("GaussQuadFullSphere", 8, 30.0, [0.0], pol.n)
band = BandRTInputs(tau=np.full((1, 3), 0.2), omega=np.ones((1, 3)),
                    zw=np.ones((1, 1, 3)), greeks=[get_greek_rayleigh(0.0)])
R, T = rt_run_band(pol, quad, band, [0.0], [0.0], 2,
                   {"type": "LambertianSurfaceScalar", "albedo": 0.1},
                   device="cpu")
assert R.shape == (1, 3, 3) and np.isfinite(R).all() and R[0, 0, 0] > 0
for engine in ("torch_dev", "kernel_dev", "kernel_doubling", "kernel_scan",
               "kernel_lanes"):
    Re, _ = rt_run_band(pol, quad, band, [0.0], [0.0], 2,
                        {"type": "LambertianSurfaceScalar", "albedo": 0.1},
                        device="cpu", solver="schulz", engine=engine)
    assert np.abs(Re - R).max() < 1e-10 * np.abs(R).max(), engine
Rb, _ = rt_run_band(pol, quad, band, [0.0], [0.0], 2,
                    {"type": "RossLiSurfaceScalar", "fiso": 0.1, "fvol": 0.0,
                     "fgeo": 0.0}, device="cpu")
assert np.abs(Rb - R).max() < 1e-6 * np.abs(R).max()
from vsmartmom_torch.parallel.sharding import rt_run_band_sharded
Rs, _ = rt_run_band_sharded(pol, quad, band, [0.0], [0.0], 2,
                            {"type": "LambertianSurfaceScalar",
                             "albedo": 0.1}, devices=["cpu", "cpu"])
assert np.abs(Rs - R).max() <= 1e-12 * np.abs(R).max()
from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
from vsmartmom_torch.inelastic import make_rrs
grid = np.arange(12740.0, 13268.0, 24.0)
band_r = BandRTInputs(tau=np.full((1, len(grid)), 0.2),
                      omega=np.ones((1, len(grid))),
                      zw=np.ones((1, 1, len(grid))),
                      greeks=[get_greek_rayleigh(0.03)])
out = rt_run_band_rrs(pol, quad, band_r, make_rrs(grid),
                      np.ones((1, len(grid))), [0.0], [0.0], 2,
                      {"type": "LambertianSurfaceScalar", "albedo": 0.1},
                      device="cpu")
assert len(out) == 4 and all(np.isfinite(x).all() for x in out)
assert out[2][0, 0, len(grid) // 2] > 0
from vsmartmom_torch.core.multisensor import rt_run_band_ms
uw, dw = rt_run_band_ms(pol, quad, band, [0.0], [0.0], 2,
                        {"type": "LambertianSurfaceScalar", "albedo": 0.1},
                        [0, 1], device="cpu")
assert np.abs(uw[0] - R).max() < 1e-12 * np.abs(R).max()
ssa, outs = vsmartmom_torch.canopy_demo.canopy_scene(device="cpu")
assert len(outs) == 7 and all(np.isfinite(x).all() for x in outs)
from vsmartmom_torch.scattering.mie import Aerosol
from vsmartmom_torch.scattering.pcw import \
    compute_aerosol_optical_properties_pcw
opt = compute_aerosol_optical_properties_pcw(
    Aerosol(mu=0.1, sigma=1.5, n_r=1.4, n_i=0.001), 0.55, 1.0, 50)
assert abs(opt.greek_coefs.beta[0] - 1.0) < 1e-8
assert not any(m == "jax" or m.startswith(("jax.", "vsmartmom."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd="/",
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        assert mod != "jax" and not mod.startswith("jax."), (path, mod)
        assert mod != "vsmartmom" and not mod.startswith("vsmartmom."), \
            (path, mod)


#: top-level definitions of the JAX package (outside pallas/) that the port
#: does not define, by file, with what takes their place
JAX_ONLY = {
    "core/multisensor.py": {
        # the jitted body of rt_run_band_ms's step; the port runs
        # _fourier_step_ms eagerly
        "_fourier_step_ms_body"},
    "core/rt_run.py": {
        # the uncached schedules function behind an lru_cache (the port's
        # build_layer_schedules is the one function), jit signatures, the
        # Pallas compile watchdog and its fallback dispatch, and the body of
        # the jitted step (the port's _fourier_step runs eagerly)
        "_build_layer_schedules", "_arg_sig", "_watchdog_compile",
        "_call_fourier_step", "_fourier_step_body"},
    "native/__init__.py": {
        # a cache directory under the system temp dir; the port builds into
        # the repository's build/ (_paths.BUILD_DIR)
        "_build_dir"},
    "parallel/distributed.py": {
        # jax.sharding meshes; the port places shards on torch devices
        "global_spectral_mesh"},
    "parallel/sharding.py": {"spectral_mesh"},
    "scattering/mie_ad.py": {
        # traced JAX twins of the host Mie code; the port's torch functions
        # differentiate as they stand (mie_ad.greek_stack, _mie_ab)
        "_mie_ab_jax", "greek_stack_jax"},
    # its twin here is compute_Z_moments_torch
    "scattering/phase.py": {"compute_Z_moments_jax"},
    # the port's loops draw no bars
    "util/logging.py": {"progress"},
    "spectroscopy/voigt.py": {
        # the jitted line-sum body of absorption_cross_section
        "_xsec_kernel"},
}


def _top_level(root):
    """{file relative to root: names of its top-level functions and
    classes}."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        out[str(path.relative_to(root))] = {
            n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    return out


def test_every_jax_definition_has_a_counterpart():
    """Outside pallas/ (whose kernels the port's cuda/ and csrc/ replace)
    and the JAX-only helpers above, every top-level function and class of
    the JAX package has a counterpart of the same name in the port."""
    jax_defs = _top_level(ROOT / "vsmartmom")
    port_names = set().union(*_top_level(PKG).values())
    missing = {f: sorted(names - port_names - JAX_ONLY.get(f, set()))
               for f, names in jax_defs.items()
               if not f.startswith("pallas/")}
    assert not any(missing.values()), {f: m for f, m in missing.items()
                                       if m}
    # the list names only what the JAX package still defines
    for f, names in JAX_ONLY.items():
        assert names <= jax_defs[f], (f, names - jax_defs[f])
        assert not names & port_names, (f, names & port_names)


def test_cuda_wrappers_build_nothing_for_cpu_tensors():
    """CPU tensors take the plain versions: no library is built or
    loaded, and no launch is counted."""
    from vsmartmom_torch.core.rt import vacuum_layer
    from vsmartmom_torch.cuda import build
    from vsmartmom_torch.cuda import layer_step_kernel as lsk
    from vsmartmom_torch.cuda import voigt_kernel as vk
    from vsmartmom_torch.cuda.layer_step_kernel import fused_layer_step
    from vsmartmom_torch.cuda.voigt_kernel import VoigtPlan
    from vsmartmom_torch.core.rt import vacuum_layer_dev
    from vsmartmom_torch.cuda import doubling_kernel as dk
    from vsmartmom_torch.cuda import layer_step_dev_kernel as ldk
    from vsmartmom_torch.cuda import lanes_kernel as lnk
    from vsmartmom_torch.cuda import layer_scan_kernel as scn

    before = (lsk.launches, vk.launches, ldk.launches, dk.launches,
              scn.launches, lnk.launches)
    S, n = 3, 4
    comp = vacuum_layer(S, n, torch.float32, "cpu")
    r = torch.full((S, n, n), 0.01)
    t = torch.eye(n).repeat(S, 1, 1) * 0.9
    v = torch.full((S, n), 0.01)
    ek = torch.full((S,), 0.99)
    out = fused_layer_step(comp, r, t, v, v, ek, torch.ones(n),
                           ns_schedule=(1, 2), ni=1)
    assert all(torch.isfinite(x).all() for x in out)
    out = ldk.fused_layer_step_dev(vacuum_layer_dev(S, n, torch.float32,
                                                    "cpu"),
                                   r, torch.full((S, n), 0.9), r * 0.5, v,
                                   v, ek, torch.ones(n), ns_schedule=(1, 2),
                                   ni=1)
    assert all(torch.isfinite(x).all() for x in out)
    out = dk.fused_doubling(r, t, v, v, ek, ns_schedule=(1, 2))
    assert all(torch.isfinite(x).all() for x in out)
    out = lnk.fused_layer_step_lanes(lnk.to_lanes(comp), lnk.to_lanes_m(r),
                                     lnk.to_lanes_m(t), v.t(), v.t(), ek,
                                     torch.ones(n), ns_schedule=(1, 2), ni=1)
    assert all(torch.isfinite(x).all() for x in out)
    layer = torch.full((1, S), 0.1)
    out = scn.fused_layer_scan(
        comp, layer, torch.full((1, S), 0.5), torch.ones((1, 1, S)), layer,
        torch.full((1, n, n), 0.1), torch.full((1, n, n), 0.1),
        torch.linspace(0.2, 0.9, n), torch.full((n,), 0.25), torch.ones(n),
        torch.ones(n), 0.5, 0.9, 0.5, ns_schedule=(1, 2), i_mu0_n=0,
        n_stokes=1, inter_iters=1)
    assert all(torch.isfinite(x).all() for x in out)
    plan = VoigtPlan(np.linspace(13000.0, 13001.0, 50), [13000.5], 5.0,
                     device="cpu")
    sig = plan.run([13000.5], [1e-22], [0.01], [0.5])
    assert sig.shape == (50,) and float(sig.max()) > 0
    assert build._lib is None
    assert (lsk.launches, vk.launches, ldk.launches, dk.launches,
            scn.launches, lnk.launches) == before


def _slice_entry_points(tmp):
    """The slice's entry points, each called without ``device``."""
    from vsmartmom_torch.core.canopy import CanopyRTInputs, rt_run_canopy
    from vsmartmom_torch.core.multisensor import rt_run_band_ms
    from vsmartmom_torch.core.rami import run_rami_scenario
    from vsmartmom_torch.core.rt_run import BandRTInputs
    from vsmartmom_torch.scattering.phase import (Polarization,
                                                  get_greek_rayleigh)
    from vsmartmom_torch.util.quadrature import rt_set_streams
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 4, 30.0, [0.0], pol.n)
    band = BandRTInputs(tau=np.full((1, 2), 0.1), omega=np.ones((1, 2)),
                        zw=np.ones((1, 1, 2)),
                        greeks=[get_greek_rayleigh(0.0)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    scenario = {"measures": [{"bands": ["8a"]}],
                "atmosphere": {"atmosphere_type": "AtmosphereType.RAYLEIGH"},
                "illumination": {"sza": {"value": 30.0}},
                "surface": {"name": "LAM",
                            "surface_parameters": {"reflectance": [0.2]}}}
    return {
        "rt_run_band_ms": lambda: rt_run_band_ms(
            pol, quad, band, [0.0], [0.0], 1, surf, [0, 1]),
        "rt_run_canopy": lambda: rt_run_canopy(
            pol, quad, band, CanopyRTInputs(lai=1.0, rho_l=0.4, tau_l=0.4),
            [0.0], [0.0], 1, surf),
        # a data directory with no files: any work before the device
        # check would raise FileNotFoundError instead
        "run_rami_scenario": lambda: run_rami_scenario(scenario,
                                                       str(tmp)),
    }


@pytest.mark.parametrize("name", ["rt_run_band_ms", "rt_run_canopy",
                                  "run_rami_scenario"])
def test_slice_entry_points_default_to_cuda(name, tmp_path):
    """rt_run_band_ms, rt_run_canopy and run_rami_scenario run on the card
    unless the caller asks for the CPU: on a machine without CUDA a call
    that names no device raises resolve_device's error before any work."""
    import inspect
    from vsmartmom_torch.core import canopy, multisensor, rami
    fn = {"rt_run_band_ms": multisensor.rt_run_band_ms,
          "rt_run_canopy": canopy.rt_run_canopy,
          "run_rami_scenario": rami.run_rami_scenario}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the call would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _slice_entry_points(tmp_path)[name]()
