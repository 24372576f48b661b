"""ET-AgentFormer, the reference: AgentFormer (Yuan et al., ICCV 2021) as
EigenTrajectory publishes it in ET space (InhwanBae/EigenTrajectory,
`baseline/agentformer`), at the published widths: model 256, feed-forward
512, 8 heads, 2 encoder and 2 decoder layers, post-LN, in eval mode (no
dropout). One group of G scenes of n agents, unpadded.

Tokens are time-major: token t * n + a is agent a at step t. The encoder
reads the k + 2 = 8 "steps" (the k observed coefficients and the two centred
origin coordinates, a scalar each), embedded and concatenated with the
sinusoidal table of the step. Agent-aware attention takes the inter-agent
logits from one projection of queries and keys and the same-agent logits
from another, and blends them by the same-agent mask before the softmax.
The decoder reads k copies of the last encoder input, each with its step's
table row, under a block-causal mask (a query of step i attends to keys of
steps <= i): with no latent code, the published k-step loop feeds back the
original token, so its last step's output is this one causal pass. Its
output at step i is coefficient i of each of the S samples.

Departure from the published code: layer norms use epsilon 1e-6, the value
of the checkpoint's training framework.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

MODEL, FF, HEADS, ENC, DEC = 256, 512, 8, 2, 2
LN_EPS = 1e-6


def _table(steps: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(steps, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, MODEL, 2, dtype=torch.float64) * (-math.log(10000.0) / MODEL))
    pe = torch.zeros(steps, MODEL, dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    return pe.to(device, dtype)


class Model:
    """The predictor over (c_obs (G, k, n), centred origins (G, 2, n)) ->
    the refinement (G, k, n, S), with the checkpoint's weights."""

    def __init__(self, tree: Dict, dtype: torch.dtype, device):
        def t(x):
            return torch.from_numpy(np.array(x)).to(device, dtype)
        self.p = {path: t(v) for path, v in _leaves(tree["params"])}
        self.dtype, self.device = dtype, device

    def _lin(self, name, x):
        return x @ self.p[f"{name}/kernel"] + self.p[f"{name}/bias"]

    def _ln(self, name, x):
        return F.layer_norm(x, (MODEL,), self.p[f"{name}/scale"], self.p[f"{name}/bias"], LN_EPS)

    def _embed(self, name, tokens, steps, n):
        x = self._lin(f"{name}_input_fc", tokens)                        # (G, steps*n, E)
        pe = _table(steps, x.dtype, x.device).repeat_interleave(n, dim=0)
        h = torch.cat([x, pe.expand(x.shape[0], -1, -1)], dim=-1)
        return self._lin(f"{name}_pos_encoder/fc", h)

    def _attn(self, name, query, key, same, bias, cross):
        e, hd = MODEL, MODEL // HEADS
        if cross:
            w, b = self.p[f"{name}/in_proj_kernel"], self.p[f"{name}/in_proj_bias"]
            ws, bs = self.p[f"{name}/in_proj_self_kernel"], self.p[f"{name}/in_proj_self_bias"]
        else:
            w, b = self.p[f"{name}/in_proj/kernel"], self.p[f"{name}/in_proj/bias"]
            ws, bs = self.p[f"{name}/in_proj_self/kernel"], self.p[f"{name}/in_proj_self/bias"]
        q = query @ w[:, :e] + b[:e]
        k = key @ w[:, e:2 * e] + b[e:2 * e]
        v = key @ w[:, 2 * e:] + b[2 * e:]
        q_self = query @ ws[:, :e] + bs[:e]
        k_self = key @ ws[:, e:] + bs[e:]

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], HEADS, hd).transpose(1, 2)
        scale = hd ** -0.5
        inter = heads(q * scale) @ heads(k).transpose(-1, -2)
        own = heads(q_self * scale) @ heads(k_self).transpose(-1, -2)
        logits = torch.where(same, own, inter) + bias
        out = torch.softmax(logits, dim=-1) @ heads(v)
        out = out.transpose(1, 2).reshape(query.shape[0], -1, e)
        return self._lin(f"{name}/out_proj", out)

    def _ff(self, name, x):
        return self._lin(f"{name}/linear2", torch.relu(self._lin(f"{name}/linear1", x)))

    def __call__(self, c_obs: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
        g, k, n = c_obs.shape
        t_in = k + 2
        inputs = torch.cat([c_obs, ori], dim=1)                          # (G, T, n)
        agent_in = torch.arange(t_in * n, device=self.device) % n
        agent_out = torch.arange(k * n, device=self.device) % n
        zero = torch.zeros((), dtype=self.dtype, device=self.device)

        x = self._embed("ctx", inputs.reshape(g, t_in * n, 1), t_in, n)
        same = agent_in[:, None] == agent_in[None, :]
        for i in range(ENC):
            name = f"enc_layer_{i}"
            x = self._ln(f"{name}/norm1", x + self._attn(f"{name}/self_attn", x, x, same, zero,
                                                          cross=False))
            x = self._ln(f"{name}/norm2", x + self._ff(name, x))

        y = self._embed("dec", inputs[:, -1:].repeat(1, k, 1).reshape(g, k * n, 1), k, n)
        step = torch.arange(k * n, device=self.device) // n
        causal = torch.where(step[:, None] >= step[None, :], zero, torch.full_like(zero, -math.inf))
        same_tgt = agent_out[:, None] == agent_out[None, :]
        same_mem = agent_out[:, None] == agent_in[None, :]
        for i in range(DEC):
            name = f"dec_layer_{i}"
            y = self._ln(f"{name}/norm1", y + self._attn(f"{name}/self_attn", y, y, same_tgt,
                                                          causal, cross=False))
            y = self._ln(f"{name}/norm2", y + self._attn(f"{name}/multihead_attn", y, x,
                                                          same_mem, zero, cross=True))
            y = self._ln(f"{name}/norm3", y + self._ff(name, y))
        out = y @ self.p["out_fc_kernel"] + self.p["out_fc_bias"]          # (G, k*n, S)
        return out.reshape(g, k, n, -1)                                    # (G, k, n, S)


def _leaves(tree: Dict, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def flops(n: int, k: int = 6, samples: int = 20) -> int:
    """Operations of the model on one scene of n agents: each multiply and
    each add of its matrix products (2 a multiply-add), the masked logits of
    full attention matrices included; softmax, layer norms and the
    element-wise blend are not counted."""
    e, f = MODEL, FF
    le, ld = (k + 2) * n, k * n                     # encoder and decoder tokens
    embed = (le + ld) * (1 * e + 2 * e * e)         # input fc, then fc over [x, table]
    enc = le * (3 * e * e + 2 * e * e + e * e + 2 * e * f) + 3 * le * le * e
    dec_self = ld * (3 * e * e + 2 * e * e + e * e) + 3 * ld * ld * e
    dec_cross = ld * (e * e + e * e + e * e) + le * (2 * e * e + e * e) + 3 * ld * le * e
    dec = dec_self + dec_cross + ld * 2 * e * f
    return 2 * (embed + ENC * enc + DEC * dec + ld * e * samples)
