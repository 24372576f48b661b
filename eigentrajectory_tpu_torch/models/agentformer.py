"""ET-AgentFormer: the agent-aware transformer predictor in ET coefficient
space.

The counterpart of `eigentrajectory_tpu/models/agentformer.py`
(`AgentFormerLight`) at the published widths: model width 256, feed-forward
512, 8 heads, dropout 0.1, 2 encoder and 2 decoder layers, the positional
table concatenated to the input. The scene axis is written out: a (B, N)
block is B rows of N agent slots, and each row is one sequence. A packed
batch of the collated regime is one row (B = 1).

Sequence layout is time-major, agent-interleaved: token t * N + a is agent
a at step t. The decoder is one causal pass over k copies of the last
observed token, which equals the reference's k-step loop: with no latent
code the loop feeds back the original token, not its prediction, so step
i's input is i + 1 copies of it and only the last step's output is kept.

Attention is agent-aware: the inter-agent and the same-agent logits come
from two projections of the queries and keys and are blended by the
same-agent mask before the softmax. The additive mask holds -1e9 on padded
key slots, -inf between agents farther apart than `conn_dist` (off by
default), -1e9 across scenes when `scene_ids` is given (the packed eval
only: training attends across the whole packed batch, as the reference's
collated training does) and the block-causal -inf of the decoder.

A data-parallel training step splits the packed row's slots over the ranks
(`parallel.SlotShard`, `ROW_SPLIT = "slots"`): a rank's queries are its
slots' tokens, and each attention gathers every rank's projected keys,
values and same-agent keys (one (B, T * width, 3E) tensor) into the single
process's token order, so no projection is repeated and the rank's score
tensors hold T * width rows. The masks are the single process's rows of
the rank's queries, and each dropout draws the single process's mask and
takes the rank's rows.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import agent_attention, agent_attention_plain, blend_attention
from ..parallel import SlotShard
from ..utils.profiling import count, span
from .common import Dropout, zero_invalid

TF_MODEL_DIM = 256
TF_FF_DIM = 512
TF_NHEAD = 8
TF_DROPOUT = 0.1
NLAYER_ENC = 2
NLAYER_DEC = 2
# Layer norm epsilon: flax's default (torch's is 1e-5).
LN_EPS = 1e-6


def positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal table (max_len, d_model), float32, as the JAX module
    computes it."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def _xavier_linear(in_features: int, out_features: int) -> nn.Linear:
    """Linear with a xavier-uniform weight and a zero bias (the attention
    projections' initialization)."""
    layer = nn.Linear(in_features, out_features)
    nn.init.xavier_uniform_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class AgentMask(NamedTuple):
    """The masks of one attention of a row, as `ops.attention` takes them:
    agent_mask (B, n, P) between the queries' and the keys' slots, key_bias
    (B, P) on the keys' slots, the decoder's block-causal cut, and the
    queries' slots among the P where they are not 0 .. n - 1 (a rank's).
    `memo` keeps the plain version's dense masks across the attentions of
    a forward."""
    agent_mask: torch.Tensor
    key_bias: torch.Tensor
    causal: bool = False
    q_slots: Optional[torch.Tensor] = None
    memo: Optional[dict] = None


class AgentAwareAttention(nn.Module):
    """Agent-aware multi-head attention over (B, L, E) queries and (B, S, E)
    keys.

    Self-attention (`cross=False`) projects q, k, v with one fused
    `in_proj` and q_self, k_self with `in_proj_self`. Cross-attention keeps
    the JAX module's bare (E, 3E) and (E, 2E) kernels, in the JAX layout:
    the queries take their first E columns, the keys the rest.

    The model hands each attention an `AgentMask`. Where no gradient is
    needed and no dropout is drawn (`predict()`, `test()`), it goes to
    `ops.attention.agent_attention` (the CUDA kernel on the card); a
    training step, a slot-split one included, goes to its plain version,
    which applies the dropout. A dense (L, S) same-agent mask with its
    (B, L, S) `attn_bias` is taken as well, through the plain blend.
    """

    def __init__(self, cross: bool, embed_dim: int = TF_MODEL_DIM,
                 num_heads: int = TF_NHEAD, dropout: float = TF_DROPOUT):
        super().__init__()
        e = embed_dim
        self.cross, self.embed_dim, self.num_heads = cross, e, num_heads
        if cross:
            self.in_proj_kernel = nn.Parameter(nn.init.xavier_uniform_(torch.empty(e, 3 * e)))
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
            self.in_proj_self_kernel = nn.Parameter(
                nn.init.xavier_uniform_(torch.empty(e, 2 * e)))
            self.in_proj_self_bias = nn.Parameter(torch.zeros(2 * e))
        else:
            self.in_proj = _xavier_linear(e, 3 * e)
            self.in_proj_self = _xavier_linear(e, 2 * e)
        self.out_proj = nn.Linear(e, e)
        self.dropout = Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor, mask,
                attn_bias: Optional[torch.Tensor] = None, shard: Optional[SlotShard] = None,
                rows: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
        # query (B, L, E), key (B, S, E); mask an AgentMask, or a dense (L, S)
        # bool same-agent mask with attn_bias (B, L, S).
        # Under `shard` the key holds this rank's tokens, S is every rank's,
        # and `rows` places the queries among the single process's (Dropout).
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        scaling = hd ** -0.5
        if self.cross:
            w, b = self.in_proj_kernel, self.in_proj_bias
            q = query @ w[:, :e] + b[:e]
            k, v = (key @ w[:, e:] + b[e:]).chunk(2, dim=-1)
            ws, bs = self.in_proj_self_kernel, self.in_proj_self_bias
            q_self = query @ ws[:, :e] + bs[:e]
            k_self = key @ ws[:, e:] + bs[e:]
        else:
            q, k, v = self.in_proj(query).chunk(3, dim=-1)
            q_self, k_self = self.in_proj_self(query).chunk(2, dim=-1)
        if shard is not None:
            k, v, k_self = shard.gather(torch.cat([k, v, k_self], dim=-1)).split(e, dim=-1)
        q, q_self = q * scaling, q_self * scaling
        qkv = (q, k, v, q_self, k_self)
        fused = (attn_bias is None and shard is None
                 and not (self.training and self.dropout.rate > 0)
                 and not (torch.is_grad_enabled() and any(x.requires_grad for x in qkv)))
        count("agentformer.attn_fused" if fused else "agentformer.attn_plain")
        drop = lambda w_att: self.dropout(w_att, rows, dim=2)
        if attn_bias is not None:
            out = blend_attention(*qkv, mask, attn_bias, h, drop)
        elif fused:
            out = agent_attention(*qkv, mask.agent_mask, mask.key_bias, h, mask.causal)
        else:
            out = agent_attention_plain(*qkv, mask.agent_mask, mask.key_bias, h, mask.causal,
                                        mask.q_slots, drop, mask.memo)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: self-attention, then the feed-forward block,
    each with dropout, a residual and a layer norm."""

    def __init__(self):
        super().__init__()
        self.self_attn = AgentAwareAttention(cross=False)
        self.norm1 = nn.LayerNorm(TF_MODEL_DIM, eps=LN_EPS)
        self.linear1 = nn.Linear(TF_MODEL_DIM, TF_FF_DIM)
        self.linear2 = nn.Linear(TF_FF_DIM, TF_MODEL_DIM)
        self.norm2 = nn.LayerNorm(TF_MODEL_DIM, eps=LN_EPS)
        self.drops = nn.ModuleList(Dropout(TF_DROPOUT) for _ in range(3))

    def forward(self, src, mask, attn_bias=None, shard=None, rows=None):
        att = self.self_attn(src, src, mask, attn_bias, shard, rows)
        src = self.norm1(src + self.drops[0](att, rows))
        h = self.linear2(self.drops[1](torch.relu(self.linear1(src)), rows))
        return self.norm2(src + self.drops[2](h, rows))


class DecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention on the
    encoder's context, then the feed-forward block."""

    def __init__(self):
        super().__init__()
        self.self_attn = AgentAwareAttention(cross=False)
        self.norm1 = nn.LayerNorm(TF_MODEL_DIM, eps=LN_EPS)
        self.multihead_attn = AgentAwareAttention(cross=True)
        self.norm2 = nn.LayerNorm(TF_MODEL_DIM, eps=LN_EPS)
        self.linear1 = nn.Linear(TF_MODEL_DIM, TF_FF_DIM)
        self.linear2 = nn.Linear(TF_FF_DIM, TF_MODEL_DIM)
        self.norm3 = nn.LayerNorm(TF_MODEL_DIM, eps=LN_EPS)
        self.drops = nn.ModuleList(Dropout(TF_DROPOUT) for _ in range(4))

    def forward(self, tgt, memory, mask_tgt, bias_tgt=None, mask_mem=None, bias_mem=None,
                shard=None, rows=None):
        att = self.self_attn(tgt, tgt, mask_tgt, bias_tgt, shard, rows)
        tgt = self.norm1(tgt + self.drops[0](att, rows))
        att = self.multihead_attn(tgt, memory, mask_mem, bias_mem, shard, rows)
        tgt = self.norm2(tgt + self.drops[1](att, rows))
        h = self.linear2(self.drops[2](torch.relu(self.linear1(tgt)), rows))
        return self.norm3(tgt + self.drops[3](h, rows))


class PosEncodeConcat(nn.Module):
    """fc([x, pe]) and dropout, pe the sinusoidal table repeated over the
    agents (token t * N + a gets row t).

    The table is no parameter or buffer, so it is no checkpoint leaf: it is
    built from NumPy at the first forward of each (length, agents, device,
    dtype) and kept in a plain dict.
    """

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(2 * TF_MODEL_DIM, TF_MODEL_DIM)
        self.dropout = Dropout(TF_DROPOUT)
        self._tables: Dict[Tuple, torch.Tensor] = {}

    def table(self, t_len: int, n_agent: int, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
        key = (t_len, n_agent, device, dtype)
        if key not in self._tables:
            pe = np.repeat(positional_encoding(t_len, TF_MODEL_DIM), n_agent, axis=0)
            self._tables[key] = torch.from_numpy(pe).to(device, dtype)
        return self._tables[key]

    def forward(self, x: torch.Tensor, t_len: int, n_agent: int,
                rows: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
        pe = self.table(t_len, n_agent, x.device, x.dtype)
        h = torch.cat([x, pe.expand(x.shape[0], -1, -1)], dim=-1)
        return self.dropout(self.fc(h), rows)


class AgentFormerLight(nn.Module):
    """The ET-wired AgentFormer over (B, T, N, 1) rows of coefficient
    "positions" -> (B, N, k, s)."""

    def __init__(self, past_frames: int, future_frames: int, forecast_dim: int,
                 conn_dist: float = 100000.0, traj_scale: float = 1.0):
        super().__init__()
        self.past_frames, self.future_frames = past_frames, future_frames
        self.forecast_dim = forecast_dim
        self.conn_dist, self.traj_scale = conn_dist, traj_scale
        self.ctx_input_fc = nn.Linear(1, TF_MODEL_DIM)
        self.ctx_pos_encoder = PosEncodeConcat()
        for i in range(NLAYER_ENC):
            self.add_module(f"enc_layer_{i}", EncoderLayer())
        self.dec_input_fc = nn.Linear(1, TF_MODEL_DIM)
        self.dec_pos_encoder = PosEncodeConcat()
        for i in range(NLAYER_DEC):
            self.add_module(f"dec_layer_{i}", DecoderLayer())
        # out_fc: N(0, 0.01) weights and a zero bias, in the JAX layout (in, out).
        self.out_fc_kernel = nn.Parameter(torch.randn(TF_MODEL_DIM, forecast_dim) * 0.01)
        self.out_fc_bias = nn.Parameter(torch.zeros(forecast_dim))

    def forward(self, pre_motion: torch.Tensor, valid: torch.Tensor,
                scene_ids: Optional[torch.Tensor] = None,
                shard: Optional[SlotShard] = None) -> torch.Tensor:
        # pre_motion (B, T, N, 1), valid (B, N), scene_ids (B, N) or None;
        # under `shard` N is this rank's slots (shard.width) of a row of
        # shard.slots, and the queries are this rank's tokens alone.
        b, t, n, _ = pre_motion.shape
        tf, dev, dtype = self.future_frames, pre_motion.device, pre_motion.dtype
        zero = torch.zeros((), device=dev, dtype=dtype)
        if shard is None:
            q_slots, rows_ctx = torch.arange(n, device=dev), None
            key_valid, cur = valid, pre_motion[:, -1]                           # (B, P), (B, P, 1)
        else:
            if scene_ids is not None:
                raise ValueError("a slot-split forward is training's: it takes no scene ids")
            q_slots = shard.own_slots(dev)
            rows_ctx = (shard.token_rows(t, dev), t * shard.slots)
            # Every slot's validity and last position: the masks of world-1 keys.
            every = shard.gather(torch.cat([valid[..., None].to(dtype), pre_motion[:, -1]], -1))
            key_valid, cur = every[..., 0] > 0.5, every[..., 1:]
        p = key_valid.shape[1]
        with span("agentformer.masks", detail=True):
            key_bias = torch.where(key_valid, zero, torch.full_like(zero, -1e9))    # (B, P)
            if self.conn_dist < 1000.0:
                dist = torch.linalg.vector_norm(cur[:, :, None] - cur[:, None], dim=-1)
                agent_mask = torch.where(dist > self.conn_dist / self.traj_scale,
                                         torch.full_like(zero, -math.inf), zero)   # (B, P, P)
            else:
                agent_mask = torch.zeros((b, p, p), device=dev, dtype=dtype)
            if scene_ids is not None:
                cross_scene = scene_ids[:, :, None] != scene_ids[:, None, :]
                agent_mask = agent_mask + torch.where(cross_scene, torch.full_like(zero, -1e9),
                                                      zero)
            if shard is not None:
                agent_mask = agent_mask[:, q_slots]                             # (B, n, P)
            # The attentions tile these over the query and key steps themselves.
            mask = AgentMask(agent_mask, key_bias, False, None if shard is None else q_slots,
                             {})

        # --- context encoder ---
        with span("agentformer.encoder", detail=True):
            x = self.ctx_input_fc(pre_motion.reshape(b, t * n, 1))
            x = self.ctx_pos_encoder(x, t, n, rows_ctx)
            for i in range(NLAYER_ENC):
                x = getattr(self, f"enc_layer_{i}")(x, mask, shard=shard, rows=rows_ctx)
        context = x                                                             # (B, T*n, E)

        # --- future decoder: one causal pass over tf copies of the last token ---
        with span("agentformer.decoder", detail=True):
            rows_dec = None if shard is None else (shard.token_rows(tf, dev), tf * p)
            dec_tokens = pre_motion[:, -1].repeat(1, tf, 1)                     # (B, tf*n, 1)
            y = self.dec_pos_encoder(self.dec_input_fc(dec_tokens), tf, n, rows_dec)
            for i in range(NLAYER_DEC):
                y = getattr(self, f"dec_layer_{i}")(y, context, mask._replace(causal=True),
                                                    mask_mem=mask, shard=shard, rows=rows_dec)
            seq_out = y @ self.out_fc_kernel + self.out_fc_bias                  # (B, tf*n, s)
        return seq_out.reshape(b, tf, n, self.forecast_dim).transpose(1, 2)      # (B, n, tf, s)


def make_model(cfg) -> nn.Module:
    bc = getattr(cfg, "baseline_config", None) or {}
    return AgentFormerLight(past_frames=cfg.k + 2, future_frames=cfg.k,
                            forecast_dim=cfg.num_samples,
                            conn_dist=float(bc.get("conn_dist", 100000.0)),
                            traj_scale=float(bc.get("traj_scale", 1.0)))


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, N), obs_ori (B, 2, N) -> (pre_motion
    (B, k + 2, N, 1) = [C_obs; ori] zeroed at the invalid slots and
    detached, valid (B, N)), and the scene ids (B, N) under
    `isolate_scenes` (the packed eval), or the rank's `slot_shard` (a
    data-parallel training step; N is then its slots)."""
    valid = aux["ped_valid"]
    obs = zero_invalid(torch.cat([c_obs, obs_ori], dim=1), valid, 2).detach()
    if aux.get("isolate_scenes", False):
        return (obs[..., None], valid, aux["scene_ids"])
    if aux.get("slot_shard") is not None:
        return (obs[..., None], valid, None, aux["slot_shard"])
    return (obs[..., None], valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, N, k, s) -> (B, k, N, s)."""
    return output_data.transpose(1, 2)


BATCHING = "collated"
# Training attends across every scene of the packed row: a data-parallel
# step splits the row's slots over the ranks (`data.batching.shard_slots`)
# and the attention gathers every rank's keys, not whole scenes a rank.
ROW_SPLIT = "slots"
# Packed-eval cap: every token of a packed row attends to every other, so
# the score tensors grow with the square of the slots.
EVAL_PED_CAP = 128
