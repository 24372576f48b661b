"""ET-AgentFormer's agent-aware attention between the projections and
`out_proj`: the CUDA kernel, its wrapper and its plain PyTorch version.

The attention of a (B, L, E) query block over (B, S, E) keys, in heads of
`E / num_heads`. Tokens are time-major and agent-interleaved: query token
i is slot i % n at step i // n, key token j slot j % P at step j // P,
where `agent_mask` is (B, n, P) and `key_bias` (B, P). A query takes its
`same-agent` logit (q_self . k_self) at the keys of its own slot and its
inter-agent logit (q . k) at every other key; each logit gets the additive
bias agent_mask[b, i % n, j % P] + key_bias[b, j % P], and under `causal`
the keys of later steps than the query's are cut off (-inf). Then the
softmax over the keys and the product with v. The 1/sqrt(head size)
scaling is the caller's (it scales q and q_self).

`agent_attention` runs the hand-written kernel (`csrc/agent_attention.cu`,
built at first use, see `build.py`) on CUDA tensors and raises on what the
kernel does not take; on CPU tensors it runs the plain version. The plain
version, `agent_attention_plain`, builds the (B, L, S) bias and the (L, S)
same-agent mask and blends the two full logit products, as the model
always did; it also takes what only training needs: another slot order for
the queries (a rank's slots) and a dropout of the attention weights.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

from . import build

SOURCE = "agent_attention.cu"
# The kernel's head size (ET-AgentFormer's 256 / 8).
HEAD_DIM = 32
# The most key steps (S / P) whose same-agent logits, 64 query rows of them,
# fit in a block's 227 KB of shared memory beside its 66,048 bytes of tiles.
MAX_KEY_STEPS = (227 * 1024 - 66048) // (64 * 4)
# The grid's limit on its rows (B) and heads.
MAX_GRID = 65535

# Kernel launches made by `agent_attention`, for showing that a run went
# through the kernel. Callers may reset it to 0.
LAUNCHES = 0


def same_agent(q_slots: torch.Tensor, tq: int, n_keys: int, tk: int) -> torch.Tensor:
    """(tq * nq, tk * n_keys) bool: query tokens (the slot of each of the
    nq queries, `q_slots`, at each of tq steps) against key tokens (n_keys
    slots at tk steps) of the same agent."""
    keys = torch.arange(n_keys, device=q_slots.device)
    return q_slots.repeat(tq)[:, None] == keys.repeat(tk)[None, :]


def blend_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_self: torch.Tensor,
                    k_self: torch.Tensor, same: torch.Tensor, attn_bias: torch.Tensor,
                    num_heads: int, drop: Optional[Callable] = None) -> torch.Tensor:
    """The attention over dense masks: same (L, S) bool, attn_bias
    (B, L, S); `drop` (or none) takes the (B, H, L, S) weights -> (B, L, E)."""
    b, e = q.shape[0], q.shape[-1]
    hd = e // num_heads

    def heads(x):                          # (B, L, E) -> (B, H, L, hd)
        return x.reshape(x.shape[0], x.shape[1], num_heads, hd).transpose(1, 2)

    inter = heads(q) @ heads(k).transpose(-1, -2)               # (B, H, L, S)
    own = heads(q_self) @ heads(k_self).transpose(-1, -2)
    m = same.to(inter.dtype)
    w_att = torch.softmax(inter * (1 - m) + own * m + attn_bias[:, None], dim=-1)
    if drop is not None:
        w_att = drop(w_att)
    return (w_att @ heads(v)).transpose(1, 2).reshape(b, -1, e)


def dense_masks(agent_mask: torch.Tensor, key_bias: torch.Tensor, tq: int, tk: int,
                causal: bool, q_slots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's dense masks at tq query and tk key steps: the
    (L, S) same-agent mask and the (B, L, S) bias (the agent mask tiled over
    the steps, the key bias, and under `causal` the cut of later steps)."""
    n, p = agent_mask.shape[1:]
    bias = agent_mask.repeat(1, tq, tk) + key_bias.repeat(1, tk)[:, None]
    if causal:
        dev = agent_mask.device
        zero = torch.zeros((), device=dev, dtype=agent_mask.dtype)
        bias = torch.where(torch.arange(tq * n, device=dev)[:, None] // n
                           >= torch.arange(tk * p, device=dev)[None, :] // p, zero,
                           torch.full_like(zero, -math.inf)) + bias
    return same_agent(q_slots, tq, p, tk), bias


def agent_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_self: torch.Tensor, k_self: torch.Tensor, agent_mask: torch.Tensor,
                          key_bias: torch.Tensor, num_heads: int, causal: bool = False,
                          q_slots: Optional[torch.Tensor] = None,
                          drop: Optional[Callable] = None,
                          memo: Optional[dict] = None) -> torch.Tensor:
    """Plain version: q, q_self (B, L, E), k, v, k_self (B, S, E),
    agent_mask (B, n, P), key_bias (B, P) -> (B, L, E). `q_slots` (n,)
    gives the queries' slots among the P (default: 0 .. n - 1); `drop`
    takes the (B, H, L, S) attention weights. A `memo` dict keeps the dense
    masks by their steps and `causal`, for the other attentions of a
    forward that share the agent mask."""
    n, p = agent_mask.shape[1:]
    tq, tk = q.shape[1] // n, k.shape[1] // p
    if q_slots is None:
        q_slots = torch.arange(n, device=q.device)
    key = (tq, tk, bool(causal))
    if memo is not None and key in memo:
        same, bias = memo[key]
    else:
        same, bias = dense_masks(agent_mask, key_bias, tq, tk, causal, q_slots)
        if memo is not None:
            memo[key] = same, bias
    return blend_attention(q, k, v, q_self, k_self, same, bias, num_heads, drop)


def agent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_self: torch.Tensor,
                    k_self: torch.Tensor, agent_mask: torch.Tensor, key_bias: torch.Tensor,
                    num_heads: int, causal: bool = False) -> torch.Tensor:
    """Same signature and output as `agent_attention_plain` without its
    training arguments; runs the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors. Computes no gradient."""
    if q.device.type == "cpu":
        return agent_attention_plain(q, k, v, q_self, k_self, agent_mask, key_bias,
                                     num_heads, causal)
    return _launch(q, k, v, q_self, k_self, agent_mask, key_bias, num_heads, causal)


def _check_args(q, k, v, q_self, k_self, agent_mask, key_bias, num_heads):
    """Check the kernel's inputs on a CUDA device; returns (B, L, S, E, n, P)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA or CPU tensors, got {device}")
    named = (("q", q), ("k", k), ("v", v), ("q_self", q_self), ("k_self", k_self),
             ("agent_mask", agent_mask), ("key_bias", key_bias))
    for name, x in named:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected torch.float32")
    if q.dim() != 3 or q_self.shape != q.shape:
        raise ValueError(f"q and q_self must be one (B, L, E) shape, got {tuple(q.shape)} "
                         f"and {tuple(q_self.shape)}")
    b, l, e = q.shape
    s = k.shape[1] if k.dim() == 3 else -1
    for name, x in (("k", k), ("v", v), ("k_self", k_self)):
        if tuple(x.shape) != (b, s, e):
            raise ValueError(f"{name} must be {(b, s, e)} as k, got {tuple(x.shape)}")
    if e != num_heads * HEAD_DIM:
        raise ValueError(f"the attention kernel takes heads of {HEAD_DIM}; got width {e} "
                         f"in {num_heads} heads")
    if torch.is_grad_enabled() and any(x.requires_grad for _, x in named):
        raise ValueError("the attention kernel computes no gradient: call it under no_grad "
                         "or on tensors that require none")
    if agent_mask.dim() != 3 or agent_mask.shape[0] != b:
        raise ValueError(f"agent_mask must be (B, n, P), got {tuple(agent_mask.shape)}")
    n, p = agent_mask.shape[1:]
    if tuple(key_bias.shape) != (b, p):
        raise ValueError(f"key_bias must be {(b, p)}, got {tuple(key_bias.shape)}")
    if n < 1 or p < 1 or s < 1 or l % n or s % p:
        raise ValueError(f"{l} query tokens of {n} slots and {s} key tokens of {p} slots "
                         "are no whole steps")
    if s // p > MAX_KEY_STEPS or b > MAX_GRID or num_heads > MAX_GRID:
        raise ValueError(f"the attention kernel takes up to {MAX_KEY_STEPS} key steps and "
                         f"{MAX_GRID} rows and heads; got {s // p}, {b}, {num_heads}")
    if not (agent_mask.is_contiguous() and key_bias.is_contiguous()):
        raise ValueError("agent_mask and key_bias must be contiguous")
    for name, x in named[:5]:
        # Rows are read 16 bytes at a time.
        if (x.stride(2) != 1 or x.stride(1) % 4 or x.stride(0) % 4
                or x.data_ptr() % 16):
            raise ValueError(f"{name} must have unit column stride and rows of 16-byte "
                             "aligned addresses")
    return b, l, s, e, n, p


def _launch(q, k, v, q_self, k_self, agent_mask, key_bias, num_heads, causal):
    global LAUNCHES
    b, l, s, e, n, p = _check_args(q, k, v, q_self, k_self, agent_mask, key_bias, num_heads)
    device = q.device
    out = torch.empty((b, l, e), dtype=torch.float32, device=device)
    if b == 0 or l == 0:
        return out
    lib = _library()
    strides = [x.stride(i) for x in (q, k, v, q_self, k_self) for i in (0, 1)]
    # The runtime launches on the current device (and sets the kernel's
    # shared-memory attribute there): make it the tensors' card.
    with torch.cuda.device(device):
        err = lib.et_agent_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_self.data_ptr(), k_self.data_ptr(),
            agent_mask.data_ptr(), key_bias.data_ptr(), out.data_ptr(), *strides,
            b, l, s, num_heads, n, p, int(bool(causal)),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.et_cuda_error_string(err).decode()} ({err})")
    LAUNCHES += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.et_agent_attention.argtypes is None:
        lib.et_agent_attention.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 10
                                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.et_agent_attention.restype = ctypes.c_int
        lib.et_cuda_error_string.argtypes = [ctypes.c_int]
        lib.et_cuda_error_string.restype = ctypes.c_char_p
    return lib
