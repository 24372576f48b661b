"""GP-Graph's group machinery over a block of scenes.

The counterpart of `eigentrajectory_tpu/models/gpgraph_common.py`: learned
L2-norm pair distances -> the sequential group relabel -> straight-through
group pooling -> three streams (original / inter-group pooled / intra-group
masked) through one weight-shared baseline -> an MLP GroupIntegrator.

The JAX package runs these on one scene under `vmap`; here each tensor
carries the scene axis in front. The relabel is `ops.group.group_ranks`:
the hand-written CUDA kernel on the card, one block a scene, as the JAX
package runs its `fori_loop` on the device. A scene's groups are ranked in
ascending label order into the same N-slot buffer, the first n_group slots
valid; padded slots are trailing singleton groups.

The pair distance is sqrt(sum(diff ** 2)), not `torch.linalg.vector_norm`:
at a zero difference (the diagonal) its gradient is NaN, as that of
`jnp.linalg.norm` is, so one backward makes the whole gradient of
`group_cnn` NaN on both sides and the optimizer's NaN filter zeroes it. The
JAX package's `group_cnn` therefore never learns, only decays; the port
keeps that.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group import group_ranks
from ..utils.profiling import span
from .common import PReLU, TorchConv2d, zero_invalid


def merge_mask(dist_mat: torch.Tensor, th: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool: the pairs the relabel merges, dist <= th strictly
    below the diagonal between valid slots."""
    n = valid.shape[1]
    lower = torch.ones((n, n), dtype=torch.bool, device=valid.device).tril(-1)
    return (dist_mat <= th) & lower & valid[:, :, None] & valid[:, None, :]


def find_group_indices(dist_mat: torch.Tensor, th: torch.Tensor, valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dist_mat (B, N, N), th a scalar tensor, valid (B, N) -> (ranks (B, N)
    int32 in [0, N), n_groups (B,) int32, the padded singletons included)."""
    with span("gpgraph.group_relabel"):
        return group_ranks(merge_mask(dist_mat, th, valid).contiguous(), valid.contiguous())


class GroupGenerator(nn.Module):
    """GroupGenerator with d_type='learned_l2norm' and a learned threshold."""

    def __init__(self, in_channels: int = 1, hid_channels: int = 8):
        super().__init__()
        self.group_cnn = TorchConv2d(in_channels, hid_channels, (3, 1), padding=(1, 0))
        self.th = nn.Parameter(torch.ones(1))

    def distances(self, v_abs, valid):
        """(B, N, N) learned pair distances of v_abs (B, 1, T, N): the L2
        norm over the group features, averaged over time; padded pairs at
        1e6, so that they never merge and their weight is ~0."""
        feat = self.group_cnn(v_abs)                             # (B, 8, T, N)
        diff = feat[..., :, None] - feat[..., None, :]           # (B, 8, T, N, N)
        dist = torch.sqrt((diff ** 2).sum(dim=1))                # NaN gradient at 0, see above
        dist_mat = dist.mean(dim=1)                              # (B, N, N)
        pair_ok = (valid[:, :, None] & valid[:, None, :]).to(dist_mat.dtype)
        return dist_mat * pair_ok + (1.0 - pair_ok) * 1e6

    def forward(self, v_rel, v_abs, valid, tau: float = 0.1):
        # v_rel (B, C, T, N), v_abs (B, 1, T, N), valid (B, N)
        dist_mat = self.distances(v_abs, valid)
        th = self.th[0]
        ranks, n_groups = find_group_indices(dist_mat.detach(), th.detach(), valid)

        # Straight-through soft grouping.
        sig = torch.sigmoid(-(dist_mat - th) / tau)
        sig_norm = sig / torch.clamp_min(sig.sum(dim=1, keepdim=True), 1e-12)
        v_soft = v_rel @ sig_norm[:, None]
        v_hard = (v_rel - v_soft).detach() + v_soft
        return v_hard, ranks, n_groups


def pooled_validity(valid: torch.Tensor, n_groups: torch.Tensor) -> torch.Tensor:
    """(B, N) bool: the first n_groups - n_invalid slots of each scene, the
    groups of its valid pedestrians."""
    n = valid.shape[1]
    n_real = n_groups - (~valid).sum(dim=1)
    return torch.arange(n, device=valid.device)[None, :] < n_real[:, None]


def ped_group_pool(v: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Group-mean pooling into the same N-slot buffer: (B, C, T, N) -> (B, C, T, N)."""
    one_hot = F.one_hot(ranks.long(), v.shape[-1]).to(v.dtype)  # (B, N, groups)
    counts = one_hot.sum(dim=1)                                  # (B, N)
    pooled = torch.einsum("bctv,bvg->bctg", v, one_hot)
    return pooled / torch.clamp_min(counts, 1.0)[:, None, None, :]


def ped_group_unpool(v_pool: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Each pedestrian gathers its group's slot: (B, C, T, N) -> (B, C, T, N)."""
    b, c, t, n = v_pool.shape
    return torch.gather(v_pool, 3, ranks.long()[:, None, None, :].expand(b, c, t, n))


def ped_group_mask(ranks: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool: same group, self included."""
    return ranks[:, :, None] == ranks[:, None, :]


class GroupIntegrator(nn.Module):
    """GroupIntegrator with mix_type='mlp'."""

    def __init__(self, out_channels: int, pred_seq_len: int, n_mix: int = 3):
        super().__init__()
        self.pred_seq_len = pred_seq_len
        self.mix_prelu = PReLU()
        self.mix_conv = TorchConv2d(out_channels * pred_seq_len * n_mix,
                                    out_channels * pred_seq_len, (1, 1))

    def forward(self, v_stack: List[torch.Tensor]) -> torch.Tensor:
        # each (B, s, Tp, N); the concatenation is reinterpreted as
        # (B, 3*s*Tp, 1, N), row by row as the JAX package does per scene.
        b, n = v_stack[0].shape[0], v_stack[0].shape[3]
        v = torch.stack(v_stack, dim=0).mean(dim=0)
        cat = torch.cat(v_stack, dim=1).reshape(b, -1, 1, n)
        h = self.mix_conv(self.mix_prelu(cat))
        return v + h.reshape(b, -1, self.pred_seq_len, n)


class GPGraph(nn.Module):
    """The GPGraph wrapper around a weight-shared `baseline_model`:
    weight_share=True, group_type=(True, True, True), mix_type='mlp'.

    Subclasses set `baseline_model` and `_baseline(v, valid, pair_mask)`,
    which runs it on one stream (B, C, T, N) -> (B, s, Tp, N)."""

    def __init__(self, baseline_model: nn.Module, in_dims: int, out_dims: int, pred_len: int):
        super().__init__()
        self.baseline_model = baseline_model
        self.group_gen = GroupGenerator(in_channels=in_dims, hid_channels=8)
        self.group_mix = GroupIntegrator(out_channels=out_dims, pred_seq_len=pred_len, n_mix=3)

    def _baseline(self, v, valid, pair_mask=None):
        raise NotImplementedError

    def forward(self, v_abs, v_rel, valid):
        v_stack = [self._baseline(v_rel, valid)]                 # 1. the original graph

        v_grouped, ranks, n_groups = self.group_gen(v_rel, v_abs, valid)
        v_grouped = zero_invalid(v_grouped, valid, 3)
        pooled_valid = pooled_validity(valid, n_groups)

        v_pool = ped_group_pool(v_grouped, ranks)                # 2. inter-group, pooled
        v_pool = zero_invalid(v_pool, pooled_valid, 3)
        v_stack.append(ped_group_unpool(self._baseline(v_pool, pooled_valid), ranks))

        # 3. intra-group: the original graph masked by group membership
        v_stack.append(self._baseline(v_grouped, valid, ped_group_mask(ranks)))
        return self.group_mix(v_stack)
