"""The readers of the program's spans and trace counters on hand-made
events and counts: the device's idle time inside a span and the spans
nested in it, a span's host time a request or call, the share of the slots
that hold a pedestrian, and nothing where the spans or counts are absent."""
import pytest
from torch.profiler import ProfilerActivity, profile

from etbench.layers import Context, reader
from etbench.trace import Trace
from eigentrajectory_tpu_torch.utils import profiling
from test_etbench_trace import Ev

CELL = {"serve": ("serve.et_forward", "serve.pad", "serve.slots_valid", "serve.slots_padded"),
        "eval": ("eval.et_forward", "data.pad", "eval.slots_valid", "eval.slots_padded")}


def _ctx(events, attempted=2, on_card=True):
    return Context({}, {}, {"attempted": attempted}, 0.0, Trace(events, 1e-6), on_card)


def _forward(forward, pad):
    """Two calls: the forward's host span with spans nested in it, the
    device's operations partly inside, and the padding before each."""
    return [
        Ev(pad, 0, 40, False, span=True), Ev(pad, 1000, 1100, False, span=True),
        Ev(forward, 100, 500, False, span=True),
        Ev("et.project", 110, 200, False, span=True),
        Ev("et.predictor", 200, 450, False, span=True),
        Ev("agentformer.encoder", 210, 300, False, span=True),
        Ev(forward, 1200, 1400, False, span=True),
        Ev(forward, 150, 700, True, span=True),           # a device-side twin: no work
        Ev("gemm", 120, 180, True), Ev("softmax", 160, 260, True),    # overlapping
        Ev("copy", 480, 600, True),                       # 20 inside the span
        Ev("gemm", 1300, 1500, True),                     # 100 inside
    ]


@pytest.mark.parametrize("cell", sorted(CELL))
def test_dispatch_idle_is_the_spans_time_less_the_busy_inside(cell):
    forward, pad, _, _ = CELL[cell]
    # Spans 400 + 200 ns; busy inside 120-260 (140), 480-500 (20), 1300-1400 (100).
    got = reader("layer_metrics", f"{cell}_dispatch_idle_ms")(_ctx(_forward(forward, pad)))
    assert got == pytest.approx((600 - 260) * 1e-6 / 2, rel=1e-12)


@pytest.mark.parametrize("cell", sorted(CELL))
@pytest.mark.parametrize("attempted", [1, 4])
def test_pad_ms_is_the_spans_host_time_a_request_or_call(cell, attempted):
    forward, pad, _, _ = CELL[cell]
    got = reader("layer_metrics", f"{cell}_pad_ms")(_ctx(_forward(forward, pad), attempted))
    assert got == pytest.approx((40 + 100) * 1e-6 / attempted, rel=1e-12)


@pytest.mark.parametrize("cell", sorted(CELL))
def test_span_readers_read_nothing_without_their_spans(cell):
    events = [Ev("gemm", 120, 180, True), Ev("bench.request", 0, 500, False, span=True)]
    for metric in ("dispatch_idle_ms", "pad_ms"):
        assert reader("layer_metrics", f"{cell}_{metric}")(_ctx(events)) is None
    forward, pad, _, _ = CELL[cell]
    off = _ctx(_forward(forward, pad), on_card=False)
    assert reader("layer_metrics", f"{cell}_pad_ms")(off) is None


def _counted(counts):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.span("trace")               # a trace's first span clears the counts
        for name, n in counts.items():
            profiling.count(name, n)


@pytest.mark.parametrize("cell", sorted(CELL))
def test_slot_fill_is_valid_over_padded(cell):
    _, _, valid, padded = CELL[cell]
    read = reader("layer_metrics", f"{cell}_slot_fill_pct")
    _counted({valid: 1057, padded: 18240})
    assert read(_ctx([])) == pytest.approx(100.0 * 1057 / 18240, rel=1e-12)
    assert read(_ctx([], on_card=False)) is None
    _counted({valid: 3})
    assert read(_ctx([])) is None
    _counted({})
    assert read(_ctx([])) is None


def test_slot_fill_reads_nothing_from_a_program_without_counters(monkeypatch):
    _counted({"serve.slots_valid": 14, "serve.slots_padded": 24})
    monkeypatch.delattr(profiling, "counters")
    assert reader("layer_metrics", "serve_slot_fill_pct")(_ctx([])) is None
