"""The trace's reductions on hand-made events: busy time as a union, a
span's device time from its device-side twin, idle time by host span, spans
told from operations by their kind and not by their name."""
import pytest
from torch.autograd import DeviceType

from etbench.trace import Trace


class Ev:
    def __init__(self, name, start, end, device, span=False):
        self._n, self._s, self._d = name, start, end - start
        self._t = DeviceType.CUDA if device else DeviceType.CPU
        self._span = span

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._span


@pytest.fixture
def trace():
    events = [
        Ev("bench.request", 0, 1000, False, span=True),
        Ev("serve.et_forward", 100, 500, False, span=True),
        Ev("serve.et_forward", 150, 700, True, span=True),   # the span's device-side twin
        Ev("gemm", 200, 300, True), Ev("softmax", 250, 400, True),   # overlapping
        Ev("Memcpy DtoH (Device -> Pageable)", 650, 750, True),
        Ev("reconstruct_kernel<12, 6>", 800, 900, True),
    ]
    return Trace(events, window_s=1e-6)


def test_busy_is_the_union(trace):
    assert trace.busy().tolist() == [[200, 400], [650, 750], [800, 900]]
    assert trace.busy_s() == pytest.approx(400e-9)


def test_span_device_time_from_its_twin(trace):
    # gemm 100 + softmax 150 + the copy clipped at 700: 50
    assert trace.span_device_s("serve.et_forward") == pytest.approx(300e-9)
    assert trace.op_seconds(lambda n: "reconstruct_kernel" in n) == pytest.approx(100e-9)
    assert trace.busy_within([(0, 1000)]) == (pytest.approx(400e-9), pytest.approx(1000e-9))


def test_idle_by_host_span(trace):
    # gap 400-650 has its middle (525) outside serve.et_forward (100-500):
    # bench.request; gap 750-800 too.
    assert trace.idle_by_host() == [["bench.request", pytest.approx(300e-9)]]
    top = trace.top_ops()
    assert len(top) == 4 and top[0][0] == "softmax"


@pytest.mark.parametrize("name", ["attention.scores", "anchor_refine", "serve.pad"])
def test_a_span_of_any_name_is_no_device_work(trace, name):
    events = [
        Ev("serve.et_forward", 150, 700, True, span=True),
        Ev("gemm", 200, 300, True), Ev("softmax", 250, 400, True),
        Ev(name, 100, 600, False, span=True), Ev(name, 120, 680, True, span=True),
    ]
    t = Trace(events, window_s=1e-6)
    assert t.busy_s() == pytest.approx(200e-9)
    assert t.op_count(lambda n: True) == 2
    assert [op for op, _ in t.top_ops()] == ["softmax", "gemm"]
    assert t.span_device_s(name) == pytest.approx(250e-9)   # gemm 100 + softmax 150
    assert t.host_spans == {name: [(100, 600)]}
