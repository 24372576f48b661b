"""ET-AgentFormer's agent-aware attention (`ops/attention.py`): on the CPU
the plain version against the attention as the model computed it before
the kernel (the dense (B, L, S) bias and (L, S) same-agent mask built by
the model, the two logit products blended), bitwise, for the encoder, the
decoder's causal self-attention, cross-attention, a packed row with scene
ids and a `conn_dist` cut, in eval mode and with dropout drawn; which path
each attention of a forward takes (the `agentformer.attn_*` counts); the
wrapper's refusals. On the card the module's fused route (the CUDA kernel)
against the attention as it was within the JAX suite's forward tolerance
(1e-4) at the serve cell's shapes (16 and 301 rows of 32 slots), the
packed 147-slot row and an -inf agent mask, and no launch from a training
step."""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.models import agentformer as taf
from eigentrajectory_tpu_torch.models.common import set_dropout_generator
from eigentrajectory_tpu_torch.ops import attention
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from eigentrajectory_tpu_torch.utils.profiling import counters

E, H = taf.TF_MODEL_DIM, taf.TF_NHEAD
TOL = dict(atol=1e-4, rtol=1e-4)


# ------------------------------------------------- the attention as it was
def _dense_masks(mask: taf.AgentMask, tq: int, tk: int):
    """The (L, S) same-agent mask and (B, L, S) bias as the model built them
    before the kernel (`_same_agent`, `pad_bias`, the decoder's causal cut)."""
    agent_mask, key_bias = mask.agent_mask, mask.key_bias
    n, p = agent_mask.shape[1:]
    dev = agent_mask.device
    q_slots = torch.arange(n, device=dev) if mask.q_slots is None else mask.q_slots
    keys = torch.arange(p, device=dev)
    sa = q_slots.repeat(tq)[:, None] == keys.repeat(tk)[None, :]
    bias = agent_mask.repeat(1, tq, tk) + key_bias.repeat(1, tk)[:, None]
    if mask.causal:
        zero = torch.zeros((), device=dev, dtype=agent_mask.dtype)
        causal = torch.where(torch.arange(tq * n, device=dev)[:, None] // n
                             >= torch.arange(tk * p, device=dev)[None, :] // p, zero,
                             torch.full_like(zero, -math.inf))
        bias = causal + bias
    return sa, bias


def _attention_as_it_was(mod, query, key, same_agent, attn_bias, rows=None):
    """`AgentAwareAttention.forward` before the kernel, line for line."""
    e, h = mod.embed_dim, mod.num_heads
    hd = e // h
    scaling = hd ** -0.5
    if mod.cross:
        w, b = mod.in_proj_kernel, mod.in_proj_bias
        q = query @ w[:, :e] + b[:e]
        k, v = (key @ w[:, e:] + b[e:]).chunk(2, dim=-1)
        ws, bs = mod.in_proj_self_kernel, mod.in_proj_self_bias
        q_self = query @ ws[:, :e] + bs[:e]
        k_self = key @ ws[:, e:] + bs[e:]
    else:
        q, k, v = mod.in_proj(query).chunk(3, dim=-1)
        q_self, k_self = mod.in_proj_self(query).chunk(2, dim=-1)
    q, q_self = q * scaling, q_self * scaling

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], h, hd).transpose(1, 2)

    inter = heads(q) @ heads(k).transpose(-1, -2)
    own = heads(q_self) @ heads(k_self).transpose(-1, -2)
    m = same_agent.to(inter.dtype)
    w_att = inter * (1 - m) + own * m + attn_bias[:, None]
    w_att = mod.dropout(torch.softmax(w_att, dim=-1), rows, dim=2)
    out = (w_att @ heads(v)).transpose(1, 2).reshape(query.shape[0], -1, e)
    return mod.out_proj(out)


# ---------------------------------------------------------------- cases
# kind: (cross, causal, query steps, key steps)
KINDS = {"encoder": (False, False, 8, 8), "decoder_self": (False, True, 6, 6),
         "cross": (True, False, 6, 8)}


def _case(kind, b, p, seed, scenes=None, conn=False, device="cpu"):
    """A module of `kind`, its query and key tokens (B, tq * P, E) and
    (B, tk * P, E), and the row's AgentMask: the last slots of each row
    padded (key bias -1e9), -1e9 across the `scenes` ids, -inf between
    slots farther apart than 0.8 under `conn`."""
    cross, causal, tq, tk = KINDS[kind]
    g = torch.Generator().manual_seed(seed)
    mod = taf.AgentAwareAttention(cross=cross)
    for prm in mod.parameters():          # biases off zero too
        prm.data.normal_(0.0, 0.08, generator=g)
    query = torch.randn(b, tq * p, E, generator=g)
    key = query if not cross and tq == tk else torch.randn(b, tk * p, E, generator=g)
    if scenes is None:
        valid = torch.arange(p)[None, :] < torch.randint(1, p + 1, (b, 1), generator=g)
    else:
        valid = torch.as_tensor(scenes)[None].expand(b, p) >= 0
    zero = torch.zeros(())
    key_bias = torch.where(valid, zero, torch.full_like(zero, -1e9))
    agent_mask = torch.zeros(b, p, p)
    if conn:
        cur = torch.rand(b, p, 2, generator=g) * 2
        dist = torch.linalg.vector_norm(cur[:, :, None] - cur[:, None], dim=-1)
        agent_mask = torch.where(dist > 0.8, torch.full_like(zero, -math.inf), zero)
    if scenes is not None:
        ids = torch.as_tensor(scenes)[None].expand(b, p)
        agent_mask = agent_mask + torch.where(ids[:, :, None] != ids[:, None, :],
                                              torch.full_like(zero, -1e9), zero)
    return (mod.to(device), query.to(device), key.to(device),
            taf.AgentMask(agent_mask.to(device), key_bias.to(device), causal), tq, tk)


def _packed_scenes(p, seed, pad=4):
    """Scene ids of a packed row of p slots: scenes of 2-20 interleaved,
    the last `pad` slots padding (-1)."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < p - pad:
        sizes.append(int(rng.integers(2, 21)))
    ids = np.repeat(np.arange(len(sizes)), sizes)[:p - pad]
    return rng.permutation(ids).tolist() + [-1] * pad


CPU_CASES = {"encoder": ("encoder", 3, 5, {}), "decoder_self": ("decoder_self", 3, 5, {}),
             "cross": ("cross", 3, 5, {}),
             "packed": ("encoder", 1, 11, {"scenes": [0, 0, 1, 2, 1, 2, 2, 0, -1, -1, -1]}),
             "conn_dist": ("decoder_self", 2, 6, {"conn": True})}


@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_plain_is_bitwise_the_attention_as_it_was(name):
    kind, b, p, kw = CPU_CASES[name]
    mod, query, key, mask, tq, tk = _case(kind, b, p, seed=len(name), **kw)
    mod.eval()
    with torch.no_grad():
        got = mod(query, key, mask)
        want = _attention_as_it_was(mod, query, key, *_dense_masks(mask, tq, tk))
        dense = mod(query, key, *_dense_masks(mask, tq, tk))
    assert torch.isfinite(want).all()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(dense, want)       # dense masks: the plain blend


@pytest.mark.parametrize("kind", ["encoder", "cross"])
def test_plain_with_dropout_is_bitwise_the_attention_as_it_was(kind):
    """Train mode: the same draws from the same generator state, and the
    same gradients."""
    mod, query, key, mask, tq, tk = _case(kind, 2, 4, seed=7)
    mod.train()
    grads = []
    for fn in (lambda: mod(query, key, mask),
               lambda: _attention_as_it_was(mod, query, key, *_dense_masks(mask, tq, tk))):
        set_dropout_generator(mod, torch.Generator().manual_seed(11))
        mod.zero_grad()
        out = fn()
        out.square().sum().backward()
        grads.append((out.detach(), [prm.grad.clone() for prm in mod.parameters()]))
    (got, g_got), (want, g_want) = grads
    assert torch.equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(g_got, g_want))


def _routes(model, train, grad):
    """The `agentformer.attn_*` counts of one forward of a small row."""
    g = torch.Generator().manual_seed(3)
    pre = torch.randn(1, 8, 3, 1, generator=g)
    valid = torch.tensor([[True, True, False]])
    model.train(train)
    set_dropout_generator(model, torch.Generator().manual_seed(1))
    counters()                             # read with no profiler: the trace counts from zero
    with profile(activities=[ProfilerActivity.CPU]), torch.set_grad_enabled(grad):
        model(pre, valid)
        got = {k: v for k, v in counters().items() if k.startswith("agentformer.attn")}
    model.eval()
    return got


@pytest.mark.parametrize("train,grad,route", [(False, False, "fused"), (False, True, "plain"),
                                              (True, True, "plain"), (True, False, "plain")])
def test_each_attention_routes_by_grad_and_dropout(train, grad, route):
    model = taf.AgentFormerLight(past_frames=8, future_frames=6, forecast_dim=20)
    assert _routes(model, train, grad) == {f"agentformer.attn_{route}": 6}


def test_eval_with_dropout_rate_zero_and_frozen_weights_goes_fused():
    model = taf.AgentFormerLight(past_frames=8, future_frames=6, forecast_dim=20)
    model.requires_grad_(False)
    assert _routes(model, False, True) == {"agentformer.attn_fused": 6}
    for m in model.modules():
        if isinstance(m, taf.Dropout):
            m.rate = 0.0
    assert _routes(model, True, False) == {"agentformer.attn_fused": 6}


def test_a_plain_forward_builds_each_dense_mask_once(monkeypatch):
    """The six plain attentions of a training forward share three dense
    mask pairs (encoder, decoder self-attention, cross-attention), as the
    model built them before the kernel."""
    built, real = [], attention.dense_masks

    def noting(agent_mask, key_bias, tq, tk, causal, q_slots):
        built.append((tq, tk, causal))
        return real(agent_mask, key_bias, tq, tk, causal, q_slots)

    monkeypatch.setattr(attention, "dense_masks", noting)
    model = taf.AgentFormerLight(past_frames=8, future_frames=6, forecast_dim=20)
    assert _routes(model, True, True) == {"agentformer.attn_plain": 6}
    assert sorted(built) == [(6, 6, True), (6, 8, False), (8, 8, False)]


def test_launch_refuses_cpu_tensors():
    mod, query, key, mask, _, _ = _case("encoder", 1, 3, seed=1)
    x = torch.zeros(1, 24, E)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        attention._launch(x, x, x, x, x, mask.agent_mask, mask.key_bias, H, False)
    launches = attention.LAUNCHES
    with torch.no_grad():
        attention.agent_attention(x, x, x, x, x, mask.agent_mask, mask.key_bias, H)
    assert attention.LAUNCHES == launches        # CPU tensors: plain version


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _kernel_against_plain(cuda_device, kind, b, p, seed, **kw):
    """The module's fused route (one kernel launch) against the attention as
    it was, which the plain version is bitwise."""
    mod, query, key, mask, tq, tk = _case(kind, b, p, seed, device=cuda_device, **kw)
    mod.eval()
    with torch.no_grad():
        launches = attention.LAUNCHES
        got = mod(query, key, mask)
        assert attention.LAUNCHES == launches + 1
        want = _attention_as_it_was(mod, query, key, *_dense_masks(mask, tq, tk))
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 301])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_kernel_matches_plain_at_the_serve_shapes(cuda_device, kind, rows):
    _kernel_against_plain(cuda_device, kind, rows, 32, seed=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_kernel_matches_plain_on_the_packed_row(cuda_device, kind):
    _kernel_against_plain(cuda_device, kind, 1, 147, seed=5, scenes=_packed_scenes(147, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_kernel_matches_plain_with_an_inf_agent_mask(cuda_device, kind):
    _kernel_against_plain(cuda_device, kind, 7, 23, seed=9, conn=True)


@pytest.mark.cuda
def test_cuda_training_step_launches_no_kernel_and_eval_six(cuda_device, tmp_path):
    split = make_synthetic_data(n_scenes=6, max_peds=6, seed=1)
    cfg = ExpConfig(baseline="agentformer", batch_size=12, dataset="synthetic",
                    static_dist=0.3, checkpoint_dir=str(tmp_path))
    tr = ETTorchTrainer(cfg, tag="attn", datasets=(split,) * 3, device="cuda")
    tr.init_descriptor()
    batch = next(iter(tr.train_batches(0)))
    launches = attention.LAUNCHES
    tr.model.train()
    try:
        tr.loss_and_grads(*tr._to_device(batch))
    finally:
        tr.model.eval()
    torch.cuda.synchronize()
    assert attention.LAUNCHES == launches
    pre = torch.randn(2, 8, 5, 1, device=cuda_device)
    with torch.no_grad():
        tr.model(pre, torch.ones(2, 5, dtype=torch.bool, device=cuda_device))
    assert attention.LAUNCHES == launches + 6
