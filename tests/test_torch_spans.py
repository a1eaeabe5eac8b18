"""The port's span recorder (vsmartmom_torch/util/timing.py) on the CPU: the
span list kept while a profiler runs, nothing kept with neither the
profiler nor the flat report on, the ``tangent`` spans of the fused layer
step's forward rule under torch.func.jacfwd, and the shared clock of the
spans and the profiler's events."""
import collections

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vsmartmom_torch.core.autodiff import make_radiance_fn
from vsmartmom_torch.core.rt_run import (BandRTInputs, build_layer_schedules,
                                         rt_run_band)
from vsmartmom_torch.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom_torch.util import timing
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

FOURIER = "fourier step (layer scan + surface)"
N_Z, N_SPEC, MAX_M = 2, 3, 2


@pytest.fixture
def recorder():
    """An empty recorder with the flat report off; restored after."""
    saved = (dict(timing._STATS), list(timing._SPANS), timing._ENABLED)
    timing.reset_timer()
    timing.enable_timer(False)
    yield timing
    timing.reset_timer()
    timing._STATS.update(saved[0])
    timing._SPANS.extend(saved[1])
    timing.enable_timer(saved[2])


def _band():
    tau = np.full((N_Z, N_SPEC), 0.2)
    return BandRTInputs(tau=tau, omega=np.full_like(tau, 0.9),
                        zw=np.ones((N_Z, 1, N_SPEC)),
                        greeks=[get_greek_rayleigh(0.0)])


def _quad():
    return rt_set_streams("GaussQuadFullSphere", 8, 30.0, [0.0], 1)


def _run_band(**kw):
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    return rt_run_band(Polarization.from_name("Stokes_I"), _quad(), _band(),
                       [0.0], [0.0], MAX_M, surf, device="cpu", **kw)


def test_nested_spans_carry_parent_and_call(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        with recorder.timeit("a"):
            with recorder.timeit("b"):
                pass
            with pytest.raises(ValueError):
                with recorder.timeit("c"):
                    raise ValueError
        with recorder.timeit("d"):
            pass
    s = {sp.name: sp for sp in recorder.spans()}
    assert [sp.name for sp in recorder.spans()] == ["b", "c", "a", "d"]
    assert s["a"].parent is None and s["a"].call == s["a"].id
    assert s["b"].parent == s["c"].parent == s["a"].id
    assert s["b"].call == s["c"].call == s["a"].id
    assert s["d"].parent is None and s["d"].call == s["d"].id
    assert s["a"].start_ns <= s["b"].start_ns <= s["b"].end_ns \
        <= s["c"].start_ns <= s["c"].end_ns <= s["a"].end_ns
    assert recorder.timer_report() == "(no timing data)"
    assert not recorder._OPEN
    recorder.reset_timer()
    assert recorder.spans() == []


def test_recording_off_stores_nothing(recorder):
    """Neither the flat report nor a profiler: a run stores no span and
    no aggregate; the flat report alone keeps no span list."""
    _run_band()
    assert recorder.spans() == [] and not recorder._STATS
    assert recorder.timer_report() == "(no timing data)"
    recorder.enable_timer()
    _run_band()
    assert recorder.spans() == []
    assert recorder._STATS["elemental"][0] == MAX_M * N_Z


def test_tangent_under_jacfwd(recorder):
    """Under torch.func.jacfwd through make_radiance_fn, the kernel
    engine's every layer_step span holds one tangent span (the forward
    rule's jvp of the plain version), in the radiance call."""
    tau, omega = _band().tau, _band().omega
    nd, sched, scheds = build_layer_schedules(
        tau, omega, float(np.min(_quad().qp_mu)), "schulz")
    fn = make_radiance_fn(Polarization.from_name("Stokes_I"), _quad(),
                          [get_greek_rayleigh(0.0)], [0.0], [0.0], MAX_M,
                          N_Z, N_SPEC, dtype=torch.float32, device="cpu",
                          solver="schulz", engine="kernel",
                          layer_schedules=scheds, ndoubl_static=nd,
                          ns_schedule=sched)
    t_tau = torch.as_tensor(tau, dtype=torch.float32)
    t_omega = torch.as_tensor(omega, dtype=torch.float32)
    zw = torch.ones((N_Z, 1, N_SPEC))

    def f(x):
        return fn(t_tau * torch.exp(x[0]), t_omega, zw, x[1]).reshape(-1)
    with profile(activities=[ProfilerActivity.CPU]):
        K = torch.func.jacfwd(f)(torch.tensor([0.0, 0.1]))
    assert K.shape == (N_SPEC, 2) and torch.isfinite(K).all()
    spans = recorder.spans()
    by_id = {sp.id: sp for sp in spans}
    roots = [sp for sp in spans if sp.parent is None]
    assert [sp.name for sp in roots] == ["radiance"]
    assert all(sp.call == roots[0].id for sp in spans)
    names = collections.Counter(sp.name for sp in spans)
    assert names["layer_step"] == names["tangent"] == MAX_M * N_Z
    assert names[FOURIER] == names["synthesis"] == MAX_M
    for sp in spans:
        if sp.name == "tangent":
            assert by_id[sp.parent].name == "layer_step"


def test_spans_share_the_profilers_clock(recorder):
    """Under a CPU-activity profiler, the aten:: events that start inside
    an elemental span end inside it, and none straddles its bounds: the
    spans and the profiler's events are on one clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_band(dtype=torch.float32)
    ops = [(e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and e.name().startswith("aten::")]
    elemental = [sp for sp in recorder.spans() if sp.name == "elemental"]
    assert len(elemental) == MAX_M * N_Z
    for sp in elemental:
        inside = [(s, e) for s, e in ops if sp.start_ns <= s <= sp.end_ns]
        assert inside, "no aten:: event inside an elemental span"
        assert all(e <= sp.end_ns for _, e in inside)
        assert not [(s, e) for s, e in ops
                    if s < sp.start_ns < e or s < sp.end_ns < e]
