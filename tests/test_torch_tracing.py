"""The port's tracing: the spans `predict()` and `test()` open and how
they nest (on the CPU), the detail spans' hold on the outer span's
device-side twin (on the card), `span()` and `count()` with no profiler running, the
slot counters against hand counts, and each trace's counts starting from
zero. Small requests and splits on the committed zara2 (ET-AgentFormer)
and hotel (ET-STGCNN) checkpoints; the counters run on the cheaper
ET-STGCNN."""
import os

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.inference import ETPredictor
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from eigentrajectory_tpu_torch.utils import profiling
from eigentrajectory_tpu_torch.utils.profiling import count, counters, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
ZARA2 = os.path.join(REPO, "configs", "eigentrajectory-agentformer-zara2.json")
HOTEL = os.path.join(REPO, "configs", "eigentrajectory-stgcnn-hotel.json")
ET = ("et.project", "et.predictor", "et.refine")

# Each span a path opens with ET_TRACE_DETAIL=1, with the innermost program
# span it opens inside (None: inside none), and how many times one call
# opens it. The detail spans are the `et.*` and `agentformer.*` ones.
SERVE = {"serve.pad": (None, 1), "serve.to_device": (None, 1), "serve.et_forward": (None, 1),
         **{name: ("serve.et_forward", 1) for name in ET},
         "agentformer.masks": ("et.predictor", 1), "agentformer.encoder": ("et.predictor", 1),
         "agentformer.decoder": ("et.predictor", 1), "serve.gather": (None, 1),
         "serve.reconstruct": (None, 1), "serve.to_host": (None, 1)}
EVAL = {"data.pad": (None, 1), "eval.to_device": (None, 1), "eval.et_forward": (None, 1),
        **{name: ("eval.et_forward", 1) for name in ET},
        "eval.recon_metrics": (None, 1), "eval.col": (None, 1), "eval.to_host": (None, 1),
        "eval.meters": (None, 1)}
PACKED_EVAL = {**EVAL, "agentformer.masks": ("et.predictor", 1),
               "agentformer.encoder": ("et.predictor", 1),
               "agentformer.decoder": ("et.predictor", 1)}


def _split():
    return make_synthetic_data(n_scenes=3, max_peds=8, seed=5)


@pytest.fixture(scope="module")
def zara2():
    splits = (_split(),) * 3
    tr = ETTorchTrainer(load_config(ZARA2, checkpoint_dir=CKPT), tag="parity",
                        datasets=splits, device="cpu")
    tr.load_model()
    return tr


@pytest.fixture(scope="module")
def hotel():
    splits = (_split(),) * 3
    tr = ETTorchTrainer(load_config(HOTEL, checkpoint_dir=CKPT, n_max_peds=8), tag="parity",
                        datasets=splits, device="cpu")
    tr.load_model()
    return tr


def _request(sizes=(2, 5, 7), seed=3):
    """Walkers of 8 observed steps, `sizes[i]` of them in scene i."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    start, vel = rng.normal(size=(n, 1, 2)) * 5, rng.normal(size=(n, 1, 2)) * 0.4
    wiggle = 0.05 * np.cumsum(rng.normal(size=(n, 8, 2)), axis=1)
    obs = start + vel * np.arange(8)[None, :, None] + wiggle
    return obs.astype(np.float32), np.repeat(np.arange(len(sizes)), sizes)


def _traced(fn):
    """The program's host spans of one traced `fn()`: [(name, start, end)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _innermost(spans, i):
    """The name of the innermost span other than `spans[i]` holding it."""
    _, s, e = spans[i]
    holders = [x for j, x in enumerate(spans) if j != i and x[1] <= s and e <= x[2]]
    return max(holders, key=lambda x: (x[1], -x[2]))[0] if holders else None


@pytest.mark.parametrize("path,detail", [("serve", "1"), ("eval", "1"), ("packed_eval", "1"),
                                         ("eval", "0")])
def test_each_span_opens_where_its_work_runs(zara2, hotel, path, detail, monkeypatch):
    monkeypatch.setenv("ET_TRACE_DETAIL", detail)
    if path == "serve":
        obs, ids = _request()
        spans, want = _traced(lambda: ETPredictor(zara2, bucket=8).predict(obs, ids)), SERVE
    elif path == "eval":
        spans, want = _traced(lambda: hotel.test(eval_batch=4)), EVAL
    else:
        spans, want = _traced(lambda: zara2.test(eval_ped_batch=128)), PACKED_EVAL
    if detail == "0":           # the detail spans stay shut, the rest as they were
        want = {k: v for k, v in want.items() if k.split(".")[0] not in ("et", "agentformer")}
    names = [name for name, _, _ in spans]
    assert sorted(set(names)) == sorted(want)
    for name, (parent, times) in want.items():
        assert names.count(name) == times, name
    for i, (name, _, _) in enumerate(spans):
        assert _innermost(spans, i) == want[name][0], name


def test_no_profiler_opens_no_span_and_counts_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name))
    counters()                          # read with no profiler: the next trace counts from zero
    with profile(activities=[ProfilerActivity.CPU]):
        span("traced")                  # the trace's first span clears the counts
    assert entered == ["traced"] and counters() == {}
    with span("untraced") as inside:
        assert inside is None
    count("serve.slots_valid", 3)
    assert entered == ["traced"] and counters() == {}


@pytest.mark.parametrize("path", ["serve", "eval"])
def test_slot_counters_are_the_hand_counts(hotel, path):
    if path == "serve":
        # Scenes of 2, 5 and 7 at bucket 8: three rows of 8 slots.
        obs, ids = _request((2, 5, 7))
        _traced(lambda: ETPredictor(hotel, bucket=8).predict(obs, ids))
        assert counters() == {"serve.slots_valid": 14, "serve.slots_padded": 24}
    else:
        # Three scenes in one block of eval_batch 4 rows of n_max 8 slots.
        _traced(lambda: hotel.test(eval_batch=4))
        valid = int(hotel.data_test.num_peds_in_seq.sum())
        assert hotel.data_test.num_scenes == 3 and 6 <= valid <= 24
        assert counters() == {"eval.slots_valid": valid, "eval.slots_padded": 32}


@pytest.mark.parametrize("between", ["counters_read", "untraced_request"])
def test_a_second_trace_counts_from_zero(hotel, between):
    predictor = ETPredictor(hotel, bucket=8)
    first, second = _request((2, 5, 7)), _request((3,), seed=4)
    _traced(lambda: predictor.predict(*first))
    if between == "counters_read":
        assert counters()["serve.slots_valid"] == 14
    else:
        predictor.predict(*first)
    _traced(lambda: predictor.predict(*second))
    assert counters() == {"serve.slots_valid": 3, "serve.slots_padded": 8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _device_share(events, names):
    """The share of the device operations' time whose operations start
    inside a device-side twin of one of the spans `names`."""
    twins = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.is_user_annotation() and e.device_type() == DeviceType.CUDA
             and e.name() in names]
    ops = [(e.start_ns(), e.duration_ns()) for e in events
           if not e.is_user_annotation() and e.device_type() == DeviceType.CUDA]
    inside = sum(d for s, d in ops if any(a <= s < b for a, b in twins))
    return inside / sum(d for _, d in ops)


@pytest.mark.cuda
@pytest.mark.parametrize("detail", ["0", "1"])
def test_detail_spans_take_their_kernels_from_the_forwards_twin(cuda_device, detail,
                                                                monkeypatch):
    """The profiler gives a kernel to the innermost span open at its launch:
    with the detail spans shut, `serve.et_forward`'s device-side twin holds
    the forward's kernels (what `serve_forward_ms` reads); opened, they take
    them."""
    monkeypatch.setenv("ET_TRACE_DETAIL", detail)
    tr = ETTorchTrainer(load_config(ZARA2, checkpoint_dir=CKPT), tag="parity",
                        datasets=(_split(),) * 3, device="cuda")
    tr.load_model()
    predictor = ETPredictor(tr, bucket=32)
    obs, ids = _request(tuple(range(2, 22)))
    predictor.predict(obs, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor.predict(obs, ids)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    forward = _device_share(events, {"serve.et_forward"})
    inner = _device_share(events, {n for n in SERVE if n.split(".")[0] in ("et", "agentformer")})
    if detail == "0":
        assert forward > 0.8
    else:
        assert forward < 0.2 and inner > 0.8
