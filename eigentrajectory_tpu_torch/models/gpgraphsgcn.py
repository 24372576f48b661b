"""ET-GP-Graph-SGCN: group-pooled SGCN predictor in ET coefficient space.

The counterpart of `eigentrajectory_tpu/models/gpgraphsgcn.py`: the GPGraph
wrapper of `gpgraph_common.py` around the GP-Graph variant of the SGCN
(`sgcn.py`, `gpgraph_variant=True`), applied to the original, the
inter-group pooled and the intra-group masked graph. ET wiring: obs k+2,
pred k, in_dims=1, out_dims=s; the pre-hook puts a loc_pos channel (1..T)
in front of the coefficients.

Unlike the plain SGCN bridge (eye(1)), each stream builds true identities:
eye(N) over its valid slots and eye(T).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import zero_invalid
from .gpgraph_common import GPGraph
from .sgcn import SGCNTrajectoryModel


def _identity_for(v: torch.Tensor, valid: torch.Tensor):
    """(eye_n (B, N, N) over the valid slots, eye_t (T, T)) of a (B, C, T, N) stream."""
    t, n = v.shape[2], v.shape[3]
    pair = (valid[:, :, None] & valid[:, None, :]).to(v.dtype)
    eye_n = torch.eye(n, dtype=v.dtype, device=v.device) * pair
    return eye_n, torch.eye(t, dtype=v.dtype, device=v.device)


class GPGraphSGCN(GPGraph):
    """GPGraph wrapper with an SGCN baseline (7 asymmetric convs, embedding
    64, 4 heads)."""

    def __init__(self, obs_len: int = 8, pred_len: int = 6, in_dims: int = 1,
                 out_dims: int = 20):
        super().__init__(SGCNTrajectoryModel(
            n_asym=7, embedding_dims=64, obs_len=obs_len, pred_len=pred_len, n_tcn=5,
            in_dims=in_dims, out_dims=out_dims, num_heads=4, gpgraph_variant=True),
            in_dims, out_dims, pred_len)

    def _baseline(self, v, valid, pair_mask=None):
        # (B, C, T, N) -> the SGCN's (B, T, N, C); (B, Tp, N, s) -> (B, s, Tp, N)
        out = self.baseline_model(v.permute(0, 2, 3, 1), _identity_for(v, valid), valid,
                                  pair_mask)
        return out.permute(0, 3, 1, 2)


def make_model(cfg) -> GPGraphSGCN:
    return GPGraphSGCN(obs_len=cfg.k + 2, pred_len=cfg.k, in_dims=1,
                       out_dims=cfg.num_samples)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, N), obs_ori (B, 2, N) -> (v_abs (B, 1, T, N),
    v_rel (B, 2, T, N) = [loc_pos, v_abs], valid), detached."""
    valid = aux["ped_valid"]
    obs = torch.cat([c_obs, obs_ori], dim=1)                       # (B, T, N)
    v_abs = zero_invalid(obs, valid, axis=2).detach()[:, None]     # (B, 1, T, N)
    t = v_abs.shape[2]
    loc_pos = torch.arange(1, t + 1, dtype=v_abs.dtype, device=v_abs.device)
    loc_pos = loc_pos[None, None, :, None].expand(v_abs.shape)
    return (v_abs, torch.cat([loc_pos, v_abs], dim=1), valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, s, k, N) -> (B, k, N, s)."""
    return output_data.permute(0, 2, 3, 1)


BATCHING = "sequenced"
