"""ET-DMRGCN: disentangled multi-relational GCN predictor in ET space.

The counterpart of `eigentrajectory_tpu/models/dmrgcn.py`, with the wiring
n_stgcn=1, n_tpcnn=4, input_feat=1, output_feat=s, seq_len=k+2,
pred_seq_len=k. The scene axis is written out: v (B, 1, T, V), the
two-relation adjacency (B, 2, T, V, V) [disp, dist] and a (B, V) validity
mask.

Each relation is split into five binary scale bands (disp [0, 1/4, 2/4, 3/4,
1], dist [0, 1/2, 1, 2, 4], upper sentinel 1e10), each band gets its own
graph conv over a normalized Laplacian-tilde, with DropEdge (p = 0.8) in
training; a temporal CNN with global temporal aggregation predicts.

Padding discipline: a padded slot's adjacency row and column are 0 (no band
holds a distance of exactly 0), so its Laplacian row is 0 and the graph convs
do not mix it in; the TPCNN's 3x3 convs run over (C, V) planes of a
(B, T, C, V) tensor and mix neighbouring slots, so padded slots are re-zeroed
before each of them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from .common import DropEdge, PReLU, TorchConv2d, zero_invalid

SPLIT = ((0.0, 0.25, 0.5, 0.75, 1.0), (0.0, 0.5, 1.0, 2.0, 4.0))


def disentangle(a: torch.Tensor, split) -> torch.Tensor:
    """Binary scale bands: band_i = 1 iff s_i < a < s_{i+1} (strict).

    a (B, T, V, V) -> (B, R, T, V, V) with R = len(split) bands.
    """
    bounds = list(split) + [1e10]
    bands = [((a > lo) & (a < hi)).to(a.dtype) for lo, hi in zip(bounds[:-1], bounds[1:])]
    return torch.stack(bands, dim=1)


def degree_rsqrt(deg: torch.Tensor) -> torch.Tensor:
    """deg ** -0.5 where deg > 0, else 0, rounded once from float64: the
    correctly rounded value, as the JAX package's pow gives it (a float32
    pow or rsqrt is off by an ulp at some integers)."""
    return torch.where(deg > 0, deg.double() ** -0.5, 0.0).to(deg.dtype)


def normalized_laplacian_tilde(a: torch.Tensor) -> torch.Tensor:
    """L~ = I - D~^-1/2 (A + I) D~^-1/2 over the leading axes; a padded
    (isolated) node's row comes out 0."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a_t = a + eye
    dinv = degree_rsqrt(a_t.sum(dim=-1))
    return eye - dinv[..., :, None] * a_t * dinv[..., None, :]


class MultiRelationalGCN(nn.Module):
    """A 1x1 conv split into `relation` relations, each contracted against
    its normalized adjacency: "nrtwv,nrctv->nctw". `normalize` maps the
    (dropped-edge) adjacency to the operator; ET-Graph-TERN shares the
    layer with its adjacency-tilde."""

    def __init__(self, in_channels: int, out_channels: int, relation: int, seq_len: int,
                 normalize: Callable[[torch.Tensor], torch.Tensor] = normalized_laplacian_tilde):
        super().__init__()
        self.relation = relation
        self.normalize = normalize
        self.conv = TorchConv2d(in_channels, out_channels * relation, (1, 1))
        self.drop_edge = DropEdge(relation, seq_len)

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        # x (B, C_in, T, V); a (B, R, T, V, V)
        h = self.conv(x)
        b, rc, t, v = h.shape
        h = h.reshape(b, self.relation, rc // self.relation, t, v)
        op = self.normalize(self.drop_edge(a))
        return torch.einsum("nrtwv,nrctv->nctw", op, h)


class STDMRGCN(nn.Module):
    """st_dmrgcn: the two relation stacks of five bands each, summed, then
    PReLU, a (t_kernel, 1) temporal conv, the residual and the output PReLU."""

    def __init__(self, in_channels: int, out_channels: int, seq_len: int, t_kernel: int = 3):
        super().__init__()
        self.same = in_channels == out_channels
        if not self.same:
            self.res_conv = TorchConv2d(in_channels, out_channels, (1, 1))
        for r, split in enumerate(SPLIT):
            self.add_module(f"gcn_{r}", MultiRelationalGCN(in_channels, out_channels,
                                                           len(split), seq_len))
        self.tcn_prelu = PReLU()
        pad = (t_kernel - 1) // 2
        self.tcn_conv = TorchConv2d(out_channels, out_channels, (t_kernel, 1),
                                    padding=(pad, 0))
        self.out_prelu = PReLU()

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        # x (B, C, T, V); a (B, 2, T, V, V) [disp, dist]
        res = x if self.same else self.res_conv(x)
        h = None
        for r, split in enumerate(SPLIT):
            out = getattr(self, f"gcn_{r}")(x, disentangle(a[:, r], split))
            h = out if h is None else h + out
        h = self.tcn_conv(self.tcn_prelu(h))
        return self.out_prelu(h + res)


class TPCNN(nn.Module):
    """tpcnn: n_tpcn 3x3 convs over (C, V) planes with residuals, then the
    global temporal aggregation, a (pred_seq_len, 1) conv over the
    transposed tensor broadcast back over time."""

    def __init__(self, seq_len: int, pred_seq_len: int, output_feat: int, n_tpcn: int = 2,
                 n_gtacn: int = 1):
        super().__init__()
        self.n_tpcn, self.n_gtacn = n_tpcn, n_gtacn
        self.same = seq_len == pred_seq_len
        if not self.same:
            self.res_conv = TorchConv2d(seq_len, pred_seq_len, (1, 1))
        for i in range(n_tpcn):
            self.add_module(f"tpcn_{i}", TorchConv2d(seq_len if i == 0 else pred_seq_len,
                                                     pred_seq_len, (3, 3), padding=(1, 1)))
            self.add_module(f"tpcn_prelu_{i}", PReLU())
        for i in range(n_gtacn):
            self.add_module(f"gta_{i}", TorchConv2d(
                output_feat, output_feat, (pred_seq_len, 1) if i == 0 else (1, 1)))
            self.add_module(f"gta_prelu_{i}", PReLU())

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # x (B, T, C, V)
        res = x if self.same else self.res_conv(x)
        x = zero_invalid(x, valid, 3)
        h = self.tpcn_prelu_0(self.tpcn_0(x)) + res
        for i in range(1, self.n_tpcn):
            h = zero_invalid(h, valid, 3)
            h = getattr(self, f"tpcn_prelu_{i}")(getattr(self, f"tpcn_{i}")(h)) + h
        g = h.transpose(1, 2)                                   # NTCV -> NCTV
        for i in range(self.n_gtacn):
            g = getattr(self, f"gta_prelu_{i}")(getattr(self, f"gta_{i}")(g)) + g
        return g.transpose(1, 2)


class SocialDMRGCN(nn.Module):
    """social_dmrgcn with the ET wiring."""

    def __init__(self, n_stgcn: int = 1, n_tpcnn: int = 4, input_feat: int = 1,
                 output_feat: int = 20, seq_len: int = 8, pred_seq_len: int = 6):
        super().__init__()
        self.n_stgcn, self.n_tpcnn = n_stgcn, n_tpcnn
        for i in range(n_stgcn):
            self.add_module(f"st_dmrgcn_{i}", STDMRGCN(
                input_feat if i == 0 else output_feat, output_feat, seq_len))
        for i in range(n_tpcnn):
            self.add_module(f"tpcnn_{i}", TPCNN(seq_len if i == 0 else pred_seq_len,
                                                pred_seq_len, output_feat))

    def forward(self, v: torch.Tensor, a: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # v (B, input_feat, T, V) -> (B, output_feat, pred_seq_len, V)
        for i in range(self.n_stgcn):
            v = getattr(self, f"st_dmrgcn_{i}")(v, a)
        v = v.transpose(1, 2)                                   # NCTV -> NTCV
        for i in range(self.n_tpcnn):
            v = getattr(self, f"tpcnn_{i}")(v, valid)
        return v.transpose(1, 2)


def make_model(cfg) -> nn.Module:
    return SocialDMRGCN(n_stgcn=1, n_tpcnn=4, input_feat=1, output_feat=cfg.num_samples,
                        seq_len=cfg.k + 2, pred_seq_len=cfg.k)


def generate_adjacency(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[A_disp, A_dist]: absolute differences of the frame-difference and of
    the absolute coefficients, zeroed where either slot is padding.

    v (B, 1, T, V), valid (B, V) -> (B, 2, T, V, V).
    """
    x = v[:, 0]                                                 # (B, T, V)
    x_rel = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:] - x[:, :-1]], dim=1)
    mask = (valid[:, :, None] & valid[:, None, :]).to(x.dtype)[:, None]
    a_dist = torch.abs(x[..., :, None] - x[..., None, :]) * mask
    a_disp = torch.abs(x_rel[..., :, None] - x_rel[..., None, :]) * mask
    return torch.stack([a_disp, a_dist], dim=1)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, V), obs_ori (B, 2, V) -> (v (B, 1, k+2, V), a,
    valid); the adjacency is built outside autograd, as the JAX hook's
    stop_gradient builds it."""
    valid = aux["ped_valid"]
    obs = zero_invalid(torch.cat([c_obs, obs_ori], dim=1), valid, axis=2).detach()
    v = obs[:, None]
    with torch.no_grad():
        a = generate_adjacency(v, valid)
    return (v, a, valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, s, k, V) -> (B, k, V, s)."""
    return output_data.permute(0, 2, 3, 1)


BATCHING = "sequenced"
