"""The precision qualification tool (vsmartmom_torch/qualify_precision.py)
and float32 on the thickest layer of the 3-band configuration.

The tool's gate function runs the 6SV1 case's azimuths as extra views of
one call; JAX's tools/qualify_precision.py runs one call per azimuth. On
one case at "highest" (float32, schulz) the two give the same gate value
within 2e-5 (float32 runs of one algebra, sums in another order; R agrees
to ~1e-6 of max). On the CPU the kernel engines run their plain versions,
so the tool's kernel delta is exercised end to end at a small size.

The thickest layer of tests/data/ref_yaml/3BandParameters.yaml (tau 59.94,
an O2 A-band line core, at the quadrature's grazing mu = 0.0199) runs in
float32 through every engine's plain version and the Raman path at
"highest" and "high" against float64: every field finite, and within the
stated bounds.
"""
import json
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch import qualify_precision as qp
from vsmartmom_torch.core.rt_raman import rt_run_band_rrs
from vsmartmom_torch.core.rt_run import ENGINES, BandRTInputs, rt_run_band
from vsmartmom_torch.inelastic import make_rrs
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)
logging.getLogger("vsmartmom_torch").setLevel(logging.WARNING)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_6sv1_case_through_the_gate_matches_jax():
    """Case 5 (tau 0.5, black surface) at SZA 78.46 deg, three azimuths:
    the port's gate value against the same value from JAX's rt_run_band
    (float32, schulz, the plain XLA engine, one call per azimuth)."""
    case, sza_i = qp.CASES_6SV1[4], 2
    got = qp.sv6_errors(qp.run_kwargs("highest", "cpu"), cases=[case],
                        sza_index=sza_i)
    ci, azs, szas, tau, rho = case
    with open(f"{qp.DATA}/6sv1_r_trues.json") as f:
        r_true = np.asarray(json.load(f))[ci - 1, sza_i]
    pol = JaxPol.from_name("Stokes_IQUV")
    quad = jax_streams("RadauQuad", 20, szas[sza_i], qp.VZA_16, pol.n)
    band = JaxBand(tau=np.full((1, 2), tau), omega=np.ones((1, 2)),
                   zw=np.ones((1, 1, 2)), greeks=[jax_greek(0.0)])
    ref = 0.0
    for az_i, az in enumerate(azs):
        R, _ = jax_rt_run_band(pol, quad, band, qp.VZA_16, [az] * 16, 3,
                               {"type": "LambertianSurfaceScalar",
                                "albedo": rho}, dtype=jnp.float32,
                               solver="schulz", doubling_engine="xla",
                               matmul_precision="highest")
        r_model = np.asarray(R)[:, 0, 0] / quad.mu0
        ref = max(ref, float(np.max(np.abs(r_true[az_i] - r_model)
                                    / r_true[az_i])))
    assert got < qp.GATES["sv6"] and ref < qp.GATES["sv6"]
    assert abs(got - ref) < 2e-5, (got, ref)


def test_tokens_and_kernel_delta():
    """Plain tokens take the torch engine at their mode, dev tokens the
    split form; an unknown token raises. The kernel delta on the CPU holds
    each kernel engine's plain version against its torch engine: at
    "highest" and in split form at rounding, at "high" within the bf16x3
    floor of the plain form."""
    assert qp.run_kwargs("high", "cpu")["engine"] == "torch"
    assert qp.run_kwargs("high", "cpu")["matmul_precision"] == "high"
    assert qp.run_kwargs("dev", "cpu")["matmul_precision"] == "highest"
    assert qp.run_kwargs("dev_high", "cpu")["engine"] == "torch_dev"
    assert qp.run_kwargs("dev_high", "cpu")["matmul_precision"] == "high"
    with pytest.raises(ValueError):
        qp.run_kwargs("tf32", "cpu")
    deltas = {tok: qp.kernel_vs_torch_delta(tok, "cpu", n_spec=8, n_z=2)
              for tok in ("highest", "high", "dev_highest", "dev_high")}
    assert deltas["highest"] < 1e-6 and deltas["dev_highest"] < 1e-6
    assert deltas["dev_high"] < 1e-5
    assert deltas["high"] < 1e-4, deltas


def test_main_prints_and_appends_lines_with_a_note(tmp_path, monkeypatch,
                                                    capsys):
    """main() rejects an unknown token before any run, prints one JSON
    line a token and appends them with a note line naming the device."""
    out = tmp_path / "q.jsonl"
    with pytest.raises(ValueError):
        qp.main(["highest", "fp8"], out=str(out), device="cpu")
    assert not out.exists()
    monkeypatch.setattr(qp, "qualify", lambda tok, device: {
        "precision": tok, "gates_pass": tok == "dev"})
    qp.main(["high", "dev"], out=str(out), device="cpu")
    qp.main(["highest"], out=str(out), device="cpu")
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert [d.get("precision") for d in lines] == ["high", "dev", None,
                                                   "highest", None]
    assert "the CPU" in lines[2]["note"]
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["precision"] for d in printed] == ["high", "dev", "highest"]


# the thickest layer of 3BandParameters.yaml (the port's float64 model of the
# file: band 1, layer 29 of 34, an O2 line core: tau 59.94, scattering depth
# 0.0054) under a thin scattering layer, on the file's quadrature
# (Stokes_IQU, GaussQuadHemisphere l_trunc 15, SZA 32.4436 deg: N = 30,
# min mu 0.0199)
THICK_TAU, THICK_SCAT = 59.94, 0.0054
SURF = {"type": "LambertianSurfaceScalar", "albedo": 0.3}


def _thick(n_spec):
    tau = np.stack([np.full(n_spec, 0.02), np.full(n_spec, THICK_TAU)])
    om = np.stack([np.full(n_spec, 0.9),
                   np.full(n_spec, THICK_SCAT / THICK_TAU)])
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadHemisphere", 15, 32.4436, [0.072],
                          pol.n)
    band = BandRTInputs(tau=tau, omega=om, zw=np.ones((2, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.03)])
    return pol, quad, band


@pytest.mark.parametrize("engine", ENGINES)
def test_float32_on_the_thickest_layer(engine):
    """Every engine's plain version in float32 against float64, R and T
    (T ~ 3.5e-26 through this layer) all finite: no float32 overflow
    beyond the elemental layer. Within 1e-4 at "highest", and at "high" in
    split form and in the scan and lanes engines (full float32 kernels);
    the plain engines at "high" within 1e-2, their bf16x3 floor (2.8e-3 of
    T here)."""
    pol, quad, band = _thick(3)
    args = (pol, quad, band, [0.072], [0.0], 3, SURF)
    kw = dict(solver="schulz", device="cpu")
    assert abs(float(quad.qp_mu.min()) - 0.0199) < 1e-4
    R64, T64 = rt_run_band(*args, dtype=torch.float64, **kw)
    plain_high = engine in ("torch", "kernel", "kernel_doubling")
    for mode, bound in (("highest", 1e-4),
                        ("high", 1e-2 if plain_high else 1e-4)):
        R, T = rt_run_band(*args, dtype=torch.float32, engine=engine,
                           matmul_precision=mode, **kw)
        assert np.isfinite(R).all() and np.isfinite(T).all()
        assert _rel(R, R64) < bound and _rel(T, T64) < bound, \
            (mode, _rel(R, R64), _rel(T, T64))


def test_float32_raman_on_the_thickest_layer():
    """The Raman path's doubling and interaction on the same layer, float32
    at ie_precision "highest" and "high" against float64: R, T, ieR and
    ieT finite and within 1e-4 of max."""
    grid = np.arange(12740.0, 13268.0, 48.0)
    pol, quad, band = _thick(len(grid))
    args = (pol, quad, band, make_rrs(grid), np.ones((2, len(grid))),
            [0.072], [0.0], 3, SURF)
    kw = dict(solver="schulz", device="cpu")
    ref = rt_run_band_rrs(*args, dtype=torch.float64, **kw)
    for mode in ("highest", "high"):
        out = rt_run_band_rrs(*args, dtype=torch.float32, ie_precision=mode,
                              **kw)
        for name, a, b in zip(("R", "T", "ieR", "ieT"), out, ref):
            assert np.isfinite(a).all(), (mode, name)
            assert _rel(a, b) < 1e-4, (mode, name, _rel(a, b))


def test_raman_ie_precision_reaches_the_ie_products_only():
    """ie_precision: the default equals "highest" bit for bit; "high"
    moves the float32 ie fields by less than 1e-4 of max and leaves the
    elastic R and T bit-equal (their products stay in full float32)."""
    grid = np.arange(12740.0, 13268.0, 48.0)
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 30.0, [0.0], pol.n)
    band = BandRTInputs(tau=np.full((1, len(grid)), 0.2),
                        omega=np.ones((1, len(grid))),
                        zw=np.ones((1, 1, len(grid))),
                        greeks=[get_greek_rayleigh(0.03)])
    args = (pol, quad, band, make_rrs(grid), np.ones((1, len(grid))),
            [0.0], [0.0], 2, {"type": "LambertianSurfaceScalar",
                              "albedo": 0.1})
    kw = dict(dtype=torch.float32, device="cpu")
    base = rt_run_band_rrs(*args, **kw)
    same = rt_run_band_rrs(*args, ie_precision="highest", **kw)
    high = rt_run_band_rrs(*args, ie_precision="high", **kw)
    assert all(np.array_equal(a, b) for a, b in zip(base, same))
    assert np.array_equal(high[0], base[0])
    assert np.array_equal(high[1], base[1])
    for a, b in zip(high[2:], base[2:]):
        assert 0 < _rel(a, b) < 1e-4, _rel(a, b)
    with pytest.raises(ValueError):
        rt_run_band_rrs(*args, ie_precision="bf16x3", **kw)
