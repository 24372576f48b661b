"""ET-GP-Graph-STGCNN: group-pooled Social-STGCNN predictor in ET space.

The counterpart of `eigentrajectory_tpu/models/gpgraphstgcnn.py`: the GPGraph
wrapper of `gpgraph_common.py` around a single-relation Social-STGCNN
(graph conv 'nctv,tvw'). Each stream builds the inverse-distance Laplacian
adjacency from its own detached input; the intra-group stream masks the
adjacency by group membership. ET wiring: obs k+2, pred k, in_dims=1,
out_dims=s; the pre-hook adds no loc_pos channel.

In train mode each of the three streams moves the baseline's masked-BN
running statistics in turn, as the JAX model's flax variables do on one
scene; the update is affine in each scene's statistics, so three updates of
the block's validity-weighted means equal the JAX trainer's mean over
scenes of three per-scene updates.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import zero_invalid
from .gpgraph_common import GPGraph
from .stgcnn import SocialSTGCNN, generate_adjacency_matrix


class GPGraphSTGCNN(GPGraph):
    """GPGraph wrapper with a single-relation Social-STGCNN baseline."""

    def __init__(self, obs_len: int = 8, pred_len: int = 6, in_dims: int = 1,
                 out_dims: int = 20):
        super().__init__(SocialSTGCNN(
            n_stgcnn=1, n_txpcnn=5, input_feat=in_dims, output_feat=out_dims,
            seq_len=obs_len, pred_seq_len=pred_len, kernel_size=3, single_relation=True),
            in_dims, out_dims, pred_len)

    def unused_prefixes(self) -> Tuple[str, ...]:
        """The baseline's layers that are built and never called."""
        return tuple(f"baseline_model.{p}" for p in self.baseline_model.unused_prefixes())

    def _baseline(self, v, valid, pair_mask=None):
        a = generate_adjacency_matrix(v.detach(), valid, pair_mask=pair_mask)
        return self.baseline_model(v, a, valid)                   # (B, s, Tp, N)


def make_model(cfg) -> GPGraphSTGCNN:
    return GPGraphSTGCNN(obs_len=cfg.k + 2, pred_len=cfg.k, in_dims=1,
                         out_dims=cfg.num_samples)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, N), obs_ori (B, 2, N) -> (v_abs, v_rel, valid),
    v_abs = v_rel = the detached (B, 1, k+2, N) coefficients."""
    valid = aux["ped_valid"]
    obs = torch.cat([c_obs, obs_ori], dim=1)
    v_abs = zero_invalid(obs, valid, axis=2).detach()[:, None]
    return (v_abs, v_abs, valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, s, k, N) -> (B, k, N, s)."""
    return output_data.permute(0, 2, 3, 1)


BATCHING = "sequenced"
