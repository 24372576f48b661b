"""ET-SGCN: sparse-graph-convolution predictor in ET coefficient space.

The counterpart of `eigentrajectory_tpu/models/sgcn.py`, with the ET wiring
number_asymmetric_conv_layer=7, embedding_dims=64, obs_len=k+2, pred_len=k,
n_tcn=5, in_dims=1, out_dims=s.

The JAX model sees one (1, T, N, 1) scene under `vmap`; here the scene axis
is written out. The spatial stream keeps (scene, time) on the batch axis,
(B*T, 4, N, N); the temporal stream keeps (scene, ped) there, (B*N, 4, T, T).
Every transpose of the JAX model swaps the same two axes here, with the
scene axis carried in front.

Padding discipline: the spatial attention softmax and the (N, N) asymmetric
convolutions mix ped slots, so invalid keys are masked at the logits and the
spatial maps are re-zeroed before every interaction-mask layer; the temporal
stream keeps peds on the batch axis and needs no masking.

Quirk reproduced deliberately: the temporal "identity" of the bridge is
eye(1), so the temporal interaction mask gets 1 added everywhere.

The GP-Graph variant (`gpgraph_variant`, used by `models/gpgraphsgcn.py`)
takes a loc_pos channel in front of the coefficients: it is kept out of the
spatial attention and the GCN (`drop_first_channel`) and fed to the temporal
attention (in_dims + 1 inputs). Its callers hand a true eye(T) temporal
identity and, for the intra-group stream, a (B, N, N) pair mask that
multiplies the spatial interaction mask.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .common import PReLU, TorchConv2d, zero_invalid


def zero_softmax(x: torch.Tensor, dim: int = -1, eps: float = 1e-5) -> torch.Tensor:
    """ZeroSoftmax: (exp(x) - 1)^2, normalized along `dim`."""
    x_exp = (torch.exp(x) - 1.0) ** 2
    return x_exp / (x_exp.sum(dim=dim, keepdim=True) + eps)


class SelfAttention(nn.Module):
    """Embed -> Q/K -> scaled softmax over 4 heads."""

    def __init__(self, in_dims: int, d_model: int = 64, num_heads: int = 4):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.embedding = nn.Linear(in_dims, d_model)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        # x: (M, L, in_dims); key_mask: (M, L) bool, True = attendable key.
        emb = self.embedding(x)

        def split(h):  # (M, L, D) -> (M, H, L, D/H)
            m, l, d = h.shape
            return h.reshape(m, l, self.num_heads, d // self.num_heads).transpose(1, 2)

        attn = split(self.query(emb)) @ split(self.key(emb)).transpose(-1, -2)
        attn = attn / self.d_model ** 0.5
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, None, :], attn, -1e9)
        return torch.softmax(attn, dim=-1), emb


class AsymmetricConvolution(nn.Module):
    """(3, 1) + (1, 3) convolutions, PReLU, identity shortcut (in == out)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = TorchConv2d(channels, channels, (3, 1), padding=(1, 0), use_bias=False)
        self.conv2 = TorchConv2d(channels, channels, (1, 3), padding=(0, 1))
        self.activation = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.conv2(x) + self.conv1(x)) + x


class InteractionMask(nn.Module):
    """Stacked asymmetric convolutions + sigmoid threshold 0.5."""

    def __init__(self, n_layers: int = 7, spatial_channels: int = 4,
                 temporal_channels: int = 4):
        super().__init__()
        self.n_layers = n_layers
        for j in range(n_layers):
            self.add_module(f"spatial_{j}", AsymmetricConvolution(spatial_channels))
            self.add_module(f"temporal_{j}", AsymmetricConvolution(temporal_channels))

    def forward(self, dense_spatial, dense_temporal, valid_rows, threshold: float = 0.5):
        # dense_spatial (B*T, 4, N, N) with valid_rows (B*T, N): the
        # asymmetric convs mix ped rows/cols, so re-zero invalid slots
        # before each layer. dense_temporal (B*N, 4, T, T).
        for j in range(self.n_layers):
            dense_spatial = zero_invalid(zero_invalid(dense_spatial, valid_rows, 2),
                                         valid_rows, 3)
            dense_spatial = getattr(self, f"spatial_{j}")(dense_spatial)
            dense_temporal = getattr(self, f"temporal_{j}")(dense_temporal)
        spatial_mask = torch.sigmoid(dense_spatial)
        temporal_mask = torch.sigmoid(dense_temporal)
        spatial_mask = torch.where(spatial_mask > threshold, spatial_mask, 0.0)
        temporal_mask = torch.where(temporal_mask > threshold, temporal_mask, 0.0)
        return spatial_mask, temporal_mask


class SparseWeightedAdjacency(nn.Module):
    """Sparse spatial (B*T, 4, N, N) and temporal (B*N, 4, T, T) adjacency."""

    def __init__(self, spa_in_dims: int = 1, tem_in_dims: int = 1,
                 embedding_dims: int = 64, obs_len: int = 8, n_asym: int = 7,
                 drop_first_channel: bool = False):
        super().__init__()
        self.drop_first_channel = drop_first_channel
        self.spatial_attention = SelfAttention(spa_in_dims, embedding_dims)
        self.temporal_attention = SelfAttention(tem_in_dims, embedding_dims)
        self.spa_fusion_conv = TorchConv2d(obs_len, obs_len, (1, 1))
        self.spa_fusion_prelu = PReLU()
        self.interaction_mask = InteractionMask(n_asym)

    def forward(self, graph, identity, valid, pair_mask=None):
        # graph: (B, T, N, d); identity: (eye_n (B, N, N), eye_t: eye(1) or
        # eye(T), the same for every scene); valid (B, N); pair_mask:
        # optional (B, N, N), multiplying the spatial mask.
        b, t, n, d = graph.shape
        valid_rows = valid.repeat_interleave(t, dim=0)                 # (B*T, N)
        spatial_graph = graph[..., 1:] if self.drop_first_channel else graph
        dense_spatial, _ = self.spatial_attention(
            spatial_graph.reshape(b * t, n, spatial_graph.shape[-1]),
            key_mask=valid_rows)                                       # (B*T, 4, N, N)
        dense_temporal, _ = self.temporal_attention(
            graph.transpose(1, 2).reshape(b * n, t, d))                # (B*N, 4, T, T)

        # Spatial-temporal fusion: a 1x1 conv over the T axis, with the heads
        # on the batch axis: (B*T, 4, N, N) -> (B*4, T, N, N) and back.
        heads = dense_spatial.shape[1]
        st = dense_spatial.reshape(b, t, heads, n, n).transpose(1, 2).reshape(
            b * heads, t, n, n)
        st = self.spa_fusion_prelu(self.spa_fusion_conv(st)) + st
        st = st.reshape(b, heads, t, n, n).transpose(1, 2).reshape(b * t, heads, n, n)

        spatial_mask, temporal_mask = self.interaction_mask(st, dense_temporal, valid_rows)

        # self-connected
        eye_n, eye_t = identity
        spatial_mask = spatial_mask + eye_n.repeat_interleave(t, dim=0)[:, None]
        temporal_mask = temporal_mask + eye_t
        if pair_mask is not None:
            spatial_mask = spatial_mask * pair_mask.to(spatial_mask.dtype).repeat_interleave(
                t, dim=0)[:, None]

        norm_spatial = zero_softmax(dense_spatial * spatial_mask, dim=-1)
        norm_temporal = zero_softmax(dense_temporal * temporal_mask, dim=-1)
        return norm_spatial, norm_temporal


class GraphConvolution(nn.Module):
    """adjacency @ graph -> linear (no bias) -> PReLU; dropout p=0."""

    def __init__(self, in_dims: int, embedding_dims: int):
        super().__init__()
        self.embedding = nn.Linear(in_dims, embedding_dims, bias=False)
        self.activation = PReLU()

    def forward(self, graph, adjacency):
        return self.activation(self.embedding(adjacency @ graph))


def _swap_scene_axes(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*P, H, Q, e) -> (B*Q, H, P, e): the JAX model's per-scene
    transpose (2, 1, 0, 3) with the scene axis carried in front."""
    bp, h, q, e = x.shape
    return x.reshape(b, bp // b, h, q, e).permute(0, 3, 2, 1, 4).reshape(
        b * q, h, bp // b, e)


class SparseGraphConvolution(nn.Module):
    """Dual spatial->temporal and temporal->spatial GCN streams."""

    def __init__(self, in_dims: int = 1, embedding_dims: int = 16,
                 drop_first_channel: bool = False):
        super().__init__()
        self.drop_first_channel = drop_first_channel
        self.st_gcn_0 = GraphConvolution(in_dims, embedding_dims)
        self.st_gcn_1 = GraphConvolution(embedding_dims, embedding_dims)
        self.ts_gcn_0 = GraphConvolution(in_dims, embedding_dims)
        self.ts_gcn_1 = GraphConvolution(embedding_dims, embedding_dims)

    def forward(self, graph, norm_spatial, norm_temporal):
        # graph: (B, T, N, d) -> both outputs (B*N, 4, T, e)
        if self.drop_first_channel:
            graph = graph[..., 1:]
        b, t, n, d = graph.shape
        spa_graph = graph.reshape(b * t, 1, n, d)                      # (B*T, 1, N, d)
        tem_graph = graph.transpose(1, 2).reshape(b * n, 1, t, d)      # (B*N, 1, T, d)

        g = self.st_gcn_0(spa_graph, norm_spatial)                     # (B*T, 4, N, e)
        gcn_st = self.st_gcn_1(_swap_scene_axes(g, b), norm_temporal)  # (B*N, 4, T, e)

        h = self.ts_gcn_0(tem_graph, norm_temporal)                    # (B*N, 4, T, e)
        gcn_ts = self.ts_gcn_1(_swap_scene_axes(h, b), norm_spatial)   # (B*T, 4, N, e)
        return gcn_st, _swap_scene_axes(gcn_ts, b)


class SGCNTrajectoryModel(nn.Module):
    """SGCN's TrajectoryModel with the ET wiring."""

    def __init__(self, n_asym: int = 7, embedding_dims: int = 64, obs_len: int = 8,
                 pred_len: int = 6, n_tcn: int = 5, in_dims: int = 1,
                 out_dims: int = 20, num_heads: int = 4, gpgraph_variant: bool = False):
        super().__init__()
        self.n_tcn = n_tcn
        tem_in = in_dims + 1 if gpgraph_variant else in_dims
        self.sparse_adjacency = SparseWeightedAdjacency(
            in_dims, tem_in, embedding_dims, obs_len, n_asym,
            drop_first_channel=gpgraph_variant)
        self.stsgcn = SparseGraphConvolution(in_dims, embedding_dims // num_heads,
                                             drop_first_channel=gpgraph_variant)
        self.fusion = TorchConv2d(num_heads, num_heads, (1, 1), use_bias=False)
        self.tcn_0 = TorchConv2d(obs_len, pred_len, (3, 3), padding=(1, 1))
        self.tcn_prelu_0 = PReLU()
        for j in range(1, n_tcn):
            self.add_module(f"tcn_{j}", TorchConv2d(pred_len, pred_len, (3, 3),
                                                    padding=(1, 1)))
            self.add_module(f"tcn_prelu_{j}", PReLU())
        self.output = nn.Linear(embedding_dims // num_heads, out_dims)

    def forward(self, graph, identity, valid, pair_mask=None):
        # graph: (B, T, N, in_dims), the GP-Graph variant (B, T, N, in_dims + 1)
        # with loc_pos in channel 0 -> (B, pred_len, N, out_dims)
        b, _, n, _ = graph.shape
        norm_spatial, norm_temporal = self.sparse_adjacency(graph, identity, valid, pair_mask)
        # The JAX model names the streams the other way round; kept here.
        gcn_ts, gcn_st = self.stsgcn(graph, norm_spatial, norm_temporal)

        fused = self.fusion(gcn_ts) + gcn_st                           # (B*N, 4, T, e)
        feats = self.tcn_prelu_0(self.tcn_0(fused.transpose(1, 2)))    # (B*N, Tp, 4, e)
        for j in range(1, self.n_tcn):
            feats = getattr(self, f"tcn_prelu_{j}")(getattr(self, f"tcn_{j}")(feats)) + feats

        pred = self.output(feats).mean(dim=-2)                         # (B*N, Tp, s)
        return pred.reshape(b, n, *pred.shape[1:]).transpose(1, 2)


def make_model(cfg) -> nn.Module:
    return SGCNTrajectoryModel(
        n_asym=7, embedding_dims=64, obs_len=cfg.k + 2, pred_len=cfg.k,
        n_tcn=5, in_dims=1, out_dims=cfg.num_samples, num_heads=4)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: identity matrices instead of an adjacency.

    c_obs (B, k, N), obs_ori (B, 2, N) -> (graph (B, k+2, N, 1),
    (eye_n (B, N, N) masked to the valid peds, eye(1)), valid).
    """
    valid = aux["ped_valid"]
    obs = torch.cat([c_obs, obs_ori], dim=1)                 # (B, T, N)
    obs = zero_invalid(obs, valid, axis=2).detach()
    n = obs.shape[2]
    pair = (valid[:, :, None] & valid[:, None, :]).to(obs.dtype)
    eye_n = torch.eye(n, dtype=obs.dtype, device=obs.device) * pair
    eye_t = torch.eye(1, dtype=obs.dtype, device=obs.device)
    return (obs[..., None], (eye_n, eye_t), valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: passthrough (B, k, N, s)."""
    return output_data


BATCHING = "sequenced"
