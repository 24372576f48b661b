"""The EigenTrajectory space of one group of scenes of equal size, written
out from the paper (EigenTrajectory, ICCV 2023) and the published code
(InhwanBae/EigenTrajectory): normalization, projection onto the truncated
bases, origins centred on the scene, anchor refinement and reconstruction.

Every function takes a group of G scenes of n pedestrians each, unpadded:
obs (G, n, t_obs, 2), and works in the dtype and on the device of its
inputs. The ET parameters come from the checkpoint's `et` tree.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

# Guard of the scale's denominator for an exactly static pedestrian; only
# ever used where the static branch is selected.
SCALE_EPS = 1e-8


class ET(NamedTuple):
    u_obs_m: torch.Tensor    # (2 t_obs, k) moving branch (scale normalized)
    u_pred_m: torch.Tensor   # (2 t_pred, k)
    u_obs_s: torch.Tensor    # static branch (no scale)
    u_pred_s: torch.Tensor
    anchor_m: torch.Tensor   # (k, S)
    anchor_s: torch.Tensor


def et_params(tree: Dict, dtype: torch.dtype, device) -> ET:
    """The checkpoint's ET parameters as tensors."""
    et = tree["et"]
    t = lambda x: torch.from_numpy(np.array(x)).to(device, dtype)
    return ET(t(et["basis_m"]["U_obs"]), t(et["basis_m"]["U_pred"]),
              t(et["basis_s"]["U_obs"]), t(et["basis_s"]["U_pred"]),
              t(et["anchor_m"]), t(et["anchor_s"]))


def moving_mask(obs32: torch.Tensor, static_dist: float) -> torch.Tensor:
    """(G, n) bool: half the displacement over the last two observed steps
    longer than static_dist, computed in float32 as the configuration's
    precision states."""
    d = (obs32[..., -1, :] - obs32[..., -3, :]) / 2.0
    return torch.linalg.vector_norm(d, dim=-1) > static_dist


class Norm(NamedTuple):
    ori: torch.Tensor   # (G, n, 1, 2) last observed point
    rot: torch.Tensor   # (G, n, 2, 2) heading rotation, right-multiplied
    sca: torch.Tensor   # (G, n, 1, 1) 2 / |last - third-last|


def norm_params(obs: torch.Tensor) -> Norm:
    d = obs[..., -1, :] - obs[..., -3, :]
    ang = torch.atan2(d[..., 1], d[..., 0])
    c, s = torch.cos(ang), torch.sin(ang)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    sca = 2.0 / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1), SCALE_EPS)
    return Norm(obs[..., -1:, :], rot, sca[..., None, None])


def predictor_inputs(et: ET, obs: torch.Tensor, mask: torch.Tensor):
    """(c_obs (G, k, n), centred origins (G, 2, n), Norm): the observed
    coefficients of each pedestrian's branch, and the last observed points
    less their mean over the scene."""
    p = norm_params(obs)
    rel = (obs - p.ori) @ p.rot
    flat_m = (rel * p.sca).flatten(-2)                       # (G, n, 2 t_obs)
    flat_s = rel.flatten(-2)
    c_obs = torch.where(mask[..., None], flat_m @ et.u_obs_m, flat_s @ et.u_obs_s)
    ori = p.ori[..., 0, :]                                   # (G, n, 2)
    ori = ori - ori.mean(dim=1, keepdim=True)
    return c_obs.transpose(1, 2), ori.transpose(1, 2), p


def futures(et: ET, c_refine: torch.Tensor, p: Norm, mask: torch.Tensor) -> torch.Tensor:
    """The S futures (G, S, n, t_pred, 2) in world coordinates from the
    predictor's refinement (G, k, n, S): anchors added, each pedestrian's
    branch reconstructed and denormalized."""
    def branch(anchor, u_pred):
        c = anchor[:, None, :] + c_refine                    # (G, k, n, S)
        return torch.einsum("tk,gkns->gsnt", u_pred, c).unflatten(-1, (-1, 2))
    rot_t = p.rot.transpose(-1, -2)[:, None]                 # (G, 1, n, 2, 2)
    ori = p.ori[:, None]
    moving = (branch(et.anchor_m, et.u_pred_m) / p.sca[:, None]) @ rot_t + ori
    static = branch(et.anchor_s, et.u_pred_s) @ rot_t + ori
    return torch.where(mask[:, None, :, None, None], moving, static)


def et_flops(n: int, k: int = 6, samples: int = 20, t_obs: int = 8, t_pred: int = 12) -> int:
    """Operations of the ET space around the model for n pedestrians: the
    projection onto the observed basis and the reconstruction of each
    sample from the predicted one (2 a multiply-add)."""
    return 2 * n * (2 * t_obs * k + samples * 2 * t_pred * k)
