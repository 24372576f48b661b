"""Evaluation metrics: min-of-S ADE / FDE / TCC / COL.

The counterparts of `eigentrajectory_tpu/metrics.py`. The JAX functions take
one scene and are `vmap`ped; these take any leading axes in front of the
sample axis: pred (..., S, N, T, 2), gt (..., N, T, 2), valid (..., N).
"""
from __future__ import annotations

import numpy as np
import torch


def _dist(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pred - gt.unsqueeze(-4), dim=-1)  # (..., S, N, T)


def ade(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(..., S, N, T, 2), (..., N, T, 2) -> (..., N) min-of-S average
    displacement error."""
    return _dist(pred, gt).mean(dim=-1).amin(dim=-2)


def fde(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(..., S, N, T, 2), (..., N, T, 2) -> (..., N) min-of-S final
    displacement error."""
    return _dist(pred, gt)[..., -1].amin(dim=-2)


def tcc(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Temporal correlation coefficient of the best-FDE sample -> (..., N).

    The best sample is the FIRST one of minimal FDE (argmin tie-break). Per
    coordinate the Pearson correlation over time against GT, clipped to
    [-1, 1], 0 where a standard deviation is 0, averaged over x/y.
    """
    best = _dist(pred, gt)[..., -1].argmin(dim=-2)          # (..., N)
    idx = best[..., None, :, None, None].expand(
        *best.shape[:-1], 1, *pred.shape[-3:])
    pred_best = torch.gather(pred, -4, idx).squeeze(-4)     # (..., N, T, 2)
    a = pred_best - pred_best.mean(dim=-2, keepdim=True)
    b = gt - gt.mean(dim=-2, keepdim=True)
    factor = 1.0 / (pred.shape[-2] - 1)
    cov = factor * (a * b).sum(dim=-2)                      # (..., N, 2)
    std_a = torch.sqrt(factor * (a * a).sum(dim=-2))
    std_b = torch.sqrt(factor * (b * b).sum(dim=-2))
    corr = torch.clamp(cov / std_a / std_b, -1.0, 1.0)
    corr = torch.nan_to_num(corr, nan=0.0)
    return corr.mean(dim=-1)


def _dense_window(pred: torch.Tensor) -> torch.Tensor:
    """First 3*num_interp+2 densely-interpolated positions.

    (..., S, N, T, 2) -> (..., S, Td, N, 2). Only the first
    ceil((Td-1)/num_interp) segments reach the Td=14 window, so only those
    are densified; for T < 5 the window is shorter.
    """
    num_interp = 4
    td = 3 * num_interp + 2
    p = pred.transpose(-3, -2)                              # (..., S, T, N, 2)
    nseg = min(-(-(td - 1) // num_interp), p.shape[-3] - 1)
    fp = p[..., :1, :, :]
    rel = (p[..., 1:nseg + 1, :, :] - p[..., :nseg, :, :]) / num_interp
    rel_dense = torch.repeat_interleave(rel, num_interp, dim=-3)
    dense = torch.cat([fp, rel_dense], dim=-3).cumsum(dim=-3)
    return dense[..., :td, :, :]


def col(pred: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Collision rate % per ped: the share of samples in which a ped passes
    within 0.2 of another valid ped over the dense window.

    pred (..., S, N, T, 2), valid (..., N) bool -> (..., N).
    """
    return _col(pred, valid[..., :, None] & valid[..., None, :])


def col_scene_masked(pred: torch.Tensor, valid: torch.Tensor,
                     same_scene: torch.Tensor) -> torch.Tensor:
    """COL over the pairs of one scene only, for flat multi-scene batches:
    pred (..., S, N, T, 2), valid (..., N), same_scene (..., N, N) bool ->
    (..., N)."""
    return _col(pred, same_scene & valid[..., :, None] & valid[..., None, :])


def compute_all(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor):
    """(ade, fde, tcc, col), each (..., N), in one call."""
    return ade(pred, gt), fde(pred, gt), tcc(pred, gt), col(pred, valid)


def _col(pred: torch.Tensor, pair_ok: torch.Tensor) -> torch.Tensor:
    """COL over the pairs where pair_ok (..., N, N) holds."""
    thres = 0.2
    n = pred.shape[-3]
    window = _dense_window(pred)                            # (..., S, Td, N, 2)
    dist = torch.linalg.vector_norm(
        window[..., :, None, :] - window[..., None, :, :], dim=-1)  # (..., S, Td, N, N)
    # Exclude self-pairs and every pair that is not ok.
    block = torch.eye(n, dtype=dist.dtype, device=dist.device) + (~pair_ok).to(dist.dtype)
    dist = dist + block[..., None, None, :, :]
    col_mask = dist.amin(dim=-3) < thres                    # (..., S, N, N)
    collided = col_mask.sum(dim=-1) > 0                     # (..., S, N)
    return collided.to(pred.dtype).mean(dim=-2) * 100.0


class AverageMeter:
    """List-backed meter, host-side."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.data = []

    def append(self, value):
        self.data.append([value])

    def extend(self, values):
        self.data.append(values)

    def mean(self):
        return float(np.concatenate(self.data, axis=0).mean())

    def sum(self):
        return float(np.concatenate(self.data, axis=0).sum())

    def __len__(self):
        return int(np.concatenate(self.data, axis=0).shape[0])
