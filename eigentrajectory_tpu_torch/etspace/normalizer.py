"""Trajectory normalization as plain tensor functions.

The counterpart of `eigentrajectory_tpu/etspace/normalizer.py`. Every
function takes any number of leading axes before the pedestrian axis, so one
call covers a whole (B, N, T, 2) scene block.

  origin   = last observed point
  rotation = heading angle atan2 of (last - 3rd-last)
  scale    = 2 / ||last - 3rd-last||   (`eps` guards the denominator only;
             used where the scaled values of static peds are masked out)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class NormParams(NamedTuple):
    """Per-ped normalization parameters; leading dims (..., N)."""

    ori: torch.Tensor  # (..., N, 1, 2) translation origin
    rot: torch.Tensor  # (..., N, 2, 2) rotation matrix (right-multiplied)
    sca: torch.Tensor  # (..., N, 1, 1) scale factor


def compute_norm_params(traj: torch.Tensor, eps: float = 0.0) -> NormParams:
    """Normalization params from an observed trajectory (..., N, T, 2)."""
    ori = traj[..., -1:, :]                          # (..., N, 1, 2)
    d = traj[..., -1, :] - traj[..., -3, :]          # (..., N, 2)
    rot_ang = torch.atan2(d[..., 1], d[..., 0])
    c, s = torch.cos(rot_ang), torch.sin(rot_ang)
    # Row-stacked [[cos, -sin], [sin, cos]]
    rot = torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)
    norm = torch.linalg.vector_norm(d, dim=-1)
    if eps:
        norm = torch.clamp_min(norm, eps)
    sca = (2.0 / norm)[..., None, None]              # (..., N, 1, 1)
    return NormParams(ori=ori, rot=rot, sca=sca)


def normalize(traj: torch.Tensor, p: NormParams, ori: bool = True,
              rot: bool = True, sca: bool = True) -> torch.Tensor:
    """Apply normalization. traj: (..., N, T, 2)."""
    if ori:
        traj = traj - p.ori
    if rot:
        traj = traj @ p.rot
    if sca:
        traj = traj * p.sca
    return traj


def denormalize(traj: torch.Tensor, p: NormParams, ori: bool = True,
                rot: bool = True, sca: bool = True) -> torch.Tensor:
    """Invert normalization. traj may carry extra leading sample axes:
    (..., N, T, 2) with the params broadcasting over them."""
    if sca:
        traj = traj / p.sca
    if rot:
        traj = traj @ p.rot.transpose(-1, -2)
    if ori:
        traj = traj + p.ori
    return traj
