"""The readers of the agent-aware attention kernel on hand-made events and
counts: its device ms a request by the kernel's name, the share of the
attentions that took the fused op, and nothing where the program has
neither (a program without the kernel or its counters)."""
import pytest
from torch.profiler import ProfilerActivity, profile

from etbench.layers import Context, reader
from etbench.trace import Trace
from eigentrajectory_tpu_torch.utils import profiling
from test_etbench_trace import Ev

KERNEL = "void (anonymous namespace)::agent_attention_kernel(float const*, float const*)"


def _ctx(events, attempted=2, on_card=True):
    return Context({}, {}, {"attempted": attempted}, 0.0, Trace(events, 1e-6), on_card)


def _counted(counts):
    profiling.counters()                  # read with no profiler: the trace counts from zero
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.span("trace")
        for name, n in counts.items():
            profiling.count(name, n)


@pytest.mark.parametrize("attempted", [1, 3])
def test_attention_ms_is_the_kernels_device_time_a_request(attempted):
    events = [Ev("serve.et_forward", 0, 900, True, span=True),
              Ev(KERNEL, 100, 400, True), Ev("gemm", 400, 450, True), Ev(KERNEL, 500, 620, True),
              Ev(KERNEL, 50, 60, False)]             # a host event of that name: no device work
    got = reader("layer_metrics", "serve_attention_ms")(_ctx(events, attempted))
    assert got == pytest.approx((300 + 120) * 1e-6 / attempted, rel=1e-12)


def test_attention_ms_reads_nothing_without_the_kernel():
    read = reader("layer_metrics", "serve_attention_ms")
    assert read(_ctx([Ev("gemm", 0, 10, True), Ev("softmax_warp_forward", 10, 30, True)])) is None
    assert read(_ctx([Ev(KERNEL, 0, 10, True)], on_card=False)) is None


def test_fused_share_is_fused_over_every_attention():
    read = reader("layer_metrics", "serve_attn_fused_pct")
    _counted({"agentformer.attn_fused": 18, "agentformer.attn_plain": 6})
    assert read(_ctx([])) == pytest.approx(75.0, rel=1e-12)
    assert read(_ctx([], on_card=False)) is None
    _counted({"agentformer.attn_fused": 12})
    assert read(_ctx([])) == 100.0
    _counted({"agentformer.attn_plain": 12})
    assert read(_ctx([])) == 0.0


def test_fused_share_reads_nothing_from_a_program_without_the_counts(monkeypatch):
    read = reader("layer_metrics", "serve_attn_fused_pct")
    _counted({"serve.slots_valid": 14, "serve.slots_padded": 24})
    assert read(_ctx([])) is None
    _counted({"agentformer.attn_fused": 6})
    monkeypatch.delattr(profiling, "counters")
    assert read(_ctx([])) is None
