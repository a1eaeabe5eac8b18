"""rtbench.spans and the readers of the span metrics, on synthetic device
intervals and spans whose idle milliseconds are counted by hand (CPU, no
card)."""
from types import SimpleNamespace

import pytest

from rtbench import run, spans

FOURIER, FETCH = spans.FOURIER, spans.FETCH


def forward_call(t0, first_id):
    """One forward call at t0 us: (spans, device intervals). Root
    rt_run [0, 100]; band_inputs [0, 10]; fourier step [20, 60] holding
    elemental [20, 30] and layer_step [30, 40]; the fetch [60, 80];
    synthesis [80, 100], where the device runs nothing. The device gap
    [50, 65] straddles the fourier step's end and the fetch's start."""
    i = first_id
    tree = [("band_inputs", 0, 10, i + 1, i), ("elemental", 20, 30, i + 3,
                                                 i + 2),
            ("layer_step", 30, 40, i + 4, i + 2), (FOURIER, 20, 60, i + 2, i),
            (FETCH, 60, 80, i + 5, i), ("synthesis", 80, 100, i + 6, i),
            ("rt_run", 0, 100, i, None)]
    recorded = [(n, int(1e3 * (t0 + s)), int(1e3 * (t0 + e)), sid, parent, i)
                for n, s, e, sid, parent in tree]
    device = [("k", t0 + s, t0 + e) for s, e in ((5, 25), (35, 50),
                                                  (65, 70))]
    return recorded, device


def jacobian():
    """One Jacobian: root radiance [0, 100]; fourier step [10, 90] holding
    layer_step [20, 60] and its tangent [40, 60]; synthesis [90, 100]."""
    tree = [("tangent", 40, 60, 4, 3), ("layer_step", 20, 60, 3, 2),
            (FOURIER, 10, 90, 2, 1), ("synthesis", 90, 100, 5, 1),
            ("radiance", 0, 100, 1, None)]
    recorded = [(n, 1000 * s, 1000 * e, sid, parent, 1)
                for n, s, e, sid, parent in tree]
    device = [("k", 0.0, 15.0), ("k", 30.0, 45.0), ("k", 55.0, 95.0)]
    return recorded, device


def two_forward_calls():
    """Two forward calls at 0 and 200 us, a device event after them, and
    the spans of a call made long before the trace began."""
    a, da = forward_call(0.0, 1)
    b, db = forward_call(200.0, 11)
    old, _ = forward_call(-10_000.0, 21)
    return old + a + b, da + db + [("k", 320.0, 330.0)]


def ctx_of(device, host=()):
    return SimpleNamespace(trace=SimpleNamespace(device=list(device),
                                                 host=list(host)))


@pytest.fixture
def program_spans(monkeypatch):
    """Hand the readers a span list in place of the program's."""
    def use(recorded):
        monkeypatch.setattr(spans, "recorded", lambda: list(recorded))
    return use


def test_union_and_subtract():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 9), (4, 4)]) \
        == [(0, 3), (5, 9)]
    a = [(0, 10), (20, 30), (40, 50)]
    b = [(-5, 2), (4, 6), (8, 22), (25, 26), (29, 41), (60, 70)]
    assert spans.subtract(a, b) == [(2, 4), (6, 8), (22, 25), (26, 29),
                                    (41, 50)]
    assert spans.subtract(a, []) == a
    assert spans.length(spans.subtract(a, b)) == 2 + 2 + 3 + 3 + 9


def test_forward_split_by_hand(program_spans):
    recorded, device = two_forward_calls()
    program_spans(recorded)
    t = spans.traced(ctx_of(device))
    assert t.kind == "rt_run" and len(t.roots) == 2
    # host: [0, 20] and [80, 100] of each call
    assert t.host_ms(("rt_run",), (FOURIER, FETCH)) == pytest.approx(0.040)
    # idle outside the fourier step and the fetch: [0, 5] and [80, 100]
    assert t.idle_ms(("rt_run",), (FOURIER, FETCH)) == pytest.approx(0.025)
    # the straddling gap [50, 65]: 10 us in the fourier step, 5 in the fetch
    assert t.idle_ms((FOURIER,)) == pytest.approx(0.020)
    assert t.idle_ms((FETCH,)) == pytest.approx(0.015)
    # a span with no device event inside it is idle throughout
    assert t.idle_ms(("synthesis",)) == pytest.approx(0.020)
    # the stages add up to the idle time inside the root
    assert t.idle_ms(("rt_run",)) == pytest.approx(0.025 + 0.020 + 0.015)


def test_forward_readers(program_spans):
    recorded, device = two_forward_calls()
    program_spans(recorded)
    ctx = ctx_of(device)
    read = {n: run.load_reader(n)(ctx) for n in (
        "host_driver_ms.fwd", "idle_host_driver_ms.fwd",
        "idle_enqueue_ms.fwd", "idle_tangent_ms.jac")}
    assert read["host_driver_ms.fwd"] == pytest.approx(0.040)
    assert read["idle_host_driver_ms.fwd"] == pytest.approx(0.025)
    assert read["idle_enqueue_ms.fwd"] == pytest.approx(0.020)
    assert read["idle_tangent_ms.jac"] is None


def test_jacobian_readers(program_spans):
    recorded, device = jacobian()
    program_spans(recorded)
    ctx = ctx_of(device)
    # fourier step less the tangent: [10, 40] and [60, 90]; idle [15, 30]
    assert run.load_reader("idle_enqueue_ms.jac")(ctx) \
        == pytest.approx(0.015)
    # the tangent [40, 60]: idle [45, 55]
    assert run.load_reader("idle_tangent_ms.jac")(ctx) \
        == pytest.approx(0.010)
    assert run.load_reader("host_driver_ms.fwd")(ctx) is None
    assert run.load_reader("idle_host_driver_ms.fwd")(ctx) is None


@pytest.mark.parametrize("name", ["host_driver_ms.fwd",
                                  "idle_host_driver_ms.fwd",
                                  "idle_enqueue_ms.fwd", "idle_enqueue_ms.jac",
                                  "idle_tangent_ms.jac"])
def test_readers_without_trace_or_spans(program_spans, name):
    read = run.load_reader(name)
    assert read(SimpleNamespace(trace=None)) is None
    program_spans([])
    _, device = forward_call(0.0, 1)
    assert read(ctx_of(device)) is None


def test_program_without_span_list(monkeypatch):
    from vsmartmom_torch.util import timing
    monkeypatch.delattr(timing, "spans")
    assert spans.recorded() == []
