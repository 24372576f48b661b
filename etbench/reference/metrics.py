"""Min-of-S ADE / FDE / TCC and COL of one group of scenes, written out
from the published evaluation (InhwanBae/EigenTrajectory, `utils/metrics.py`),
with what a judge needs beside each: every sample's FDE and TCC, and every
sample's closest approach to another pedestrian of its scene.

pred (G, S, n, T, 2) futures, gt (G, n, T, 2).
"""
from __future__ import annotations

from typing import Dict

import torch

COL_THRESHOLD = 0.2     # metres: a closer approach is a collision
COL_INTERP = 4          # COL's window: linear interpolation, 4 points a step
COL_STEPS = 3 * COL_INTERP + 2


def _dense_window(pred: torch.Tensor) -> torch.Tensor:
    """The first COL_STEPS positions of the trajectories interpolated
    linearly at COL_INTERP points a step: (G, S, n, T, 2) -> (G, S, n, Td, 2)."""
    seg = pred[..., 1:, :] - pred[..., :-1, :]               # (G, S, n, T-1, 2)
    steps = [pred[..., :1, :]]
    for i in range(-(-(COL_STEPS - 1) // COL_INTERP)):
        for j in range(1, COL_INTERP + 1):
            steps.append(pred[..., i:i + 1, :] + seg[..., i:i + 1, :] * (j / COL_INTERP))
    return torch.cat(steps, dim=-2)[..., :COL_STEPS, :]


def evaluate(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per pedestrian ade, fde, tcc, col (G, n); per sample fde_s, tcc_s and
    the closest approach approach_s (G, S, n)."""
    dist = torch.linalg.vector_norm(pred - gt[:, None], dim=-1)        # (G, S, n, T)
    fde_s = dist[..., -1]
    a = pred - pred.mean(dim=-2, keepdim=True)
    b = (gt - gt.mean(dim=-2, keepdim=True))[:, None]
    cov = (a * b).sum(dim=-2)                                          # (G, S, n, 2)
    den = torch.sqrt((a * a).sum(dim=-2)) * torch.sqrt((b * b).sum(dim=-2))
    corr = torch.where(den > 0, cov / torch.where(den > 0, den, 1.0), 0.0)
    tcc_s = torch.clamp(corr, -1.0, 1.0).mean(dim=-1)                  # (G, S, n)
    best = fde_s.argmin(dim=1, keepdim=True)
    win = _dense_window(pred)                                          # (G, S, n, Td, 2)
    n = pred.shape[2]
    d = torch.linalg.vector_norm(win[:, :, :, None] - win[:, :, None], dim=-1)   # (G,S,n,n,Td)
    d = d.amin(dim=-1) + torch.eye(n, dtype=d.dtype, device=d.device) * 1e9
    approach_s = d.amin(dim=-1)                                        # (G, S, n)
    return {"ade": dist.mean(dim=-1).amin(dim=1), "fde": fde_s.amin(dim=1),
            "tcc": torch.gather(tcc_s, 1, best)[:, 0],
            "col": (approach_s < COL_THRESHOLD).to(pred.dtype).mean(dim=1) * 100.0,
            "fde_s": fde_s, "tcc_s": tcc_s, "approach_s": approach_s}
