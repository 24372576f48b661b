"""ET-STGCNN, the reference: Social-STGCNN (Mohamed et al., CVPR 2020) wired
into ET space as EigenTrajectory publishes it (InhwanBae/EigenTrajectory,
`baseline/stgcnn`): one ST-GCN block (1 -> S channels, a graph kernel per
observed step, a temporal kernel of 3) and a TXP-CNN of 3x3 convolutions
over (channel, pedestrian), in eval mode (batch norm on its running
statistics). Inputs: the k observed coefficients and the two centred origin
coordinates of each pedestrian, k + 2 = 8 "steps". One group of G scenes of
n pedestrians, unpadded.

Departures from the published code, each exact: the inverse-distance graph
is the normalized Laplacian I - D^-1/2 (A + I) D^-1/2 written as one
broadcast product, and the view between the two stages is the same raw
reinterpretation of memory the published code makes (a reshape, not a
transpose).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

N_TXPCNN = 5            # the TXP-CNN layers built; the last hidden one is never called
BN_EPS = 1e-5


class Model:
    """The predictor over (c_obs (G, k, n), centred origins (G, 2, n)) ->
    the refinement (G, k, n, S), with the checkpoint's weights."""

    def __init__(self, tree: Dict, dtype: torch.dtype, device):
        def t(x):
            return torch.from_numpy(np.array(x)).to(device, dtype)
        self.p = {path: t(v) for path, v in _leaves(tree["params"])}
        self.stats = {path: t(v) for path, v in _leaves(tree["batch_stats"])}

    def _conv(self, name, x, padding=0):
        return F.conv2d(x, self.p[f"{name}/kernel"], self.p[f"{name}/bias"], padding=padding)

    def _bn(self, name, x):
        mean, var = self.stats[f"{name}/mean"], self.stats[f"{name}/var"]
        inv = torch.rsqrt(var + BN_EPS) * self.p[f"{name}/scale"]
        return (x - mean[:, None, None]) * inv[:, None, None] + self.p[f"{name}/bias"][:, None, None]

    def _prelu(self, name, x):
        return torch.where(x >= 0, x, self.p[f"{name}/alpha"] * x)

    def __call__(self, c_obs: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
        v = torch.cat([c_obs, ori], dim=1)[:, None]                  # (G, 1, T=8, n)
        a = graph(v[:, 0])                                           # (G, T, n, n)
        g = "st_gcn_0"
        res = self._bn(f"{g}/res_bn", self._conv(f"{g}/res_conv", v))
        h = self._conv(f"{g}/gcn_conv", v)                           # (G, T*C, T, n)
        b, kc, t, n = h.shape
        h = h.reshape(b, t, kc // t, t, n)
        h = torch.einsum("bkctv,bkvw->bctw", h, a)
        h = self._prelu(f"{g}/tcn_prelu", self._bn(f"{g}/tcn_bn1", h))
        h = self._bn(f"{g}/tcn_bn2", self._conv(f"{g}/tcn_conv", h, padding=(1, 0)))
        v = self._prelu(f"{g}/out_prelu", h + res)                   # (G, S, T, n)
        v = v.reshape(v.shape[0], v.shape[2], v.shape[1], v.shape[3])  # raw view: (G, T, S, n)
        v = self._prelu("prelu_0", self._conv("tpcnn_0", v, padding=1))
        for k in range(1, N_TXPCNN - 1):
            v = self._prelu(f"prelu_{k}", self._conv(f"tpcnn_{k}", v, padding=1)) + v
        v = self._conv("tpcnn_output", v, padding=1)                 # (G, k, S, n)
        v = v.reshape(v.shape[0], v.shape[2], v.shape[1], v.shape[3])  # raw view: (G, S, k, n)
        return v.permute(0, 2, 3, 1)                                 # (G, k, n, S)


def graph(x: torch.Tensor) -> torch.Tensor:
    """The inverse-distance graph of each step: x (G, T, n) -> the
    normalized Laplacian (G, T, n, n) of A + I, A_ij = 1 / |x_i - x_j|
    (0 where x_i = x_j)."""
    d = torch.abs(x[..., :, None] - x[..., None, :])
    a_inv = torch.where(d == 0, 0.0, 1.0 / torch.where(d == 0, 1.0, d))
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    a_hat = a_inv + eye
    dinv = a_hat.sum(dim=-1) ** -0.5
    return eye - dinv[..., :, None] * a_hat * dinv[..., None, :]


def _leaves(tree: Dict, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def flops(n: int, k: int = 6, samples: int = 20) -> int:
    """Operations of the model on one scene of n pedestrians: each multiply
    and each add of its convolutions and graph contraction (2 a
    multiply-add). T = k + 2 input steps, C = samples channels."""
    t, c = k + 2, samples
    gcn = t * n * (c * t) * 1 * 2                 # gcn_conv, 1 -> C*T, 1x1
    graph_mix = t * c * t * n * n * 2             # sum over the graph kernels and v
    res = t * n * c * 1 * 2                       # res_conv, 1 -> C
    tcn = t * n * c * c * 3 * 2                   # tcn_conv, C -> C, 3x1
    txp = c * n * (k * t + (N_TXPCNN - 2) * k * k + k * k) * 9 * 2  # 3x3 convs over (C, n)
    return gcn + graph_mix + res + tcn + txp
