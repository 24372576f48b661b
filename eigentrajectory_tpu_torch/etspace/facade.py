"""The EigenTrajectory facade over a block of scenes.

The counterpart of `eigentrajectory_tpu/etspace/facade.py`. The JAX package
runs it on one scene and `vmap`s it over the block; here the scene axis is
written out: every tensor carries a leading (B,) axis and the scene-centring
of origins averages over the valid pedestrians of each scene.

Both descriptor variants (moving and static) run densely on all pedestrians
and are selected per pedestrian by the moving mask.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from .anchor import refine
from .descriptor import ETBasis, project, reconstruct
from .normalizer import compute_norm_params, normalize

# Guard for the scale denominator of exactly-static peds; the guarded values
# are only ever used on lanes discarded by the moving/static select.
_SCALE_EPS = 1e-8


class ETParams(NamedTuple):
    """Frozen ET-space parameters (from a checkpoint, never optimized)."""

    basis_m: ETBasis       # moving-ped descriptor (scale normalized)
    basis_s: ETBasis       # static-ped descriptor (no scale)
    anchor_m: torch.Tensor  # (k, s)
    anchor_s: torch.Tensor  # (k, s)


def moving_mask(obs_traj: torch.Tensor, static_dist: float) -> torch.Tensor:
    """(..., N, T, 2) -> (..., N) bool: ||(obs[-1] - obs[-3]) / 2|| > static_dist."""
    d = (obs_traj[..., -1, :] - obs_traj[..., -3, :]) / 2.0
    return torch.linalg.vector_norm(d, dim=-1) > static_dist


def et_forward(
    et: ETParams,
    predictor_fn: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor],
    obs_traj: torch.Tensor,
    ped_valid: torch.Tensor,
    static_dist: float,
    aux: Optional[Dict] = None,
    return_coefficients: bool = False,
) -> Dict[str, torch.Tensor]:
    """Forward pass over a block of scenes, masked-dense.

    Args:
      et: frozen ET parameters.
      predictor_fn: (C_obs (B, k, N), obs_ori (B, 2, N), aux) ->
        C_pred_refine (B, k, N, s), the bridged predictor.
      obs_traj: (B, N, t_obs, 2) padded scenes.
      ped_valid: (B, N) bool validity of each ped slot.
      aux: extra inputs forwarded to predictor_fn.
      return_coefficients: return the refined coefficients and the
        normalization params instead of trajectories, for a fused
        reconstruction by the caller.

    Returns recon_traj (B, s, N, t_pred, 2) and moving_mask (B, N), or with
    `return_coefficients` c_pred_m / c_pred_s (B, k, N, s), moving_mask,
    norm_ori (B, N, 2), norm_rot (B, N, 2, 2) and norm_sca (B, N).
    """
    aux = dict(aux or {})
    mask = moving_mask(obs_traj, static_dist)               # (B, N)
    p = compute_norm_params(obs_traj, eps=_SCALE_EPS)

    # --- projection ---
    c_obs_m = project(normalize(obs_traj, p, sca=True), et.basis_m.U_obs)
    c_obs_s = project(normalize(obs_traj, p, sca=False), et.basis_s.U_obs)
    c_obs = torch.where(mask[:, None, :], c_obs_m, c_obs_s).detach()  # (B, k, N)

    # --- absolute coordinate, centred on the valid peds of each scene ---
    obs_ori = p.ori[..., 0, :].transpose(1, 2)              # (B, 2, N)
    valid_f = ped_valid.to(obs_ori.dtype)[:, None, :]       # (B, 1, N)
    denom = torch.clamp_min(valid_f.sum(dim=2, keepdim=True), 1.0)
    center = (obs_ori * valid_f).sum(dim=2, keepdim=True) / denom
    obs_ori = (obs_ori - center) * valid_f

    # --- prediction via the bridged predictor; it must see exactly the
    # scene's real peds ---
    aux["ped_valid"] = ped_valid
    c_pred_refine = predictor_fn(c_obs, obs_ori, aux)       # (B, k, N, s)

    # --- anchor refinement ---
    c_pred_m = refine(et.anchor_m, c_pred_refine)
    c_pred_s = refine(et.anchor_s, c_pred_refine)

    if return_coefficients:
        return {
            "c_pred_m": c_pred_m, "c_pred_s": c_pred_s, "moving_mask": mask,
            "norm_ori": p.ori[..., 0, :], "norm_rot": p.rot,
            "norm_sca": p.sca[..., 0, 0],
        }

    # --- reconstruction; params broadcast over the sample axis ---
    p_s = type(p)(*(x[:, None] for x in p))
    recon_m = reconstruct(c_pred_m, et.basis_m.U_pred, p_s, norm_sca=True)
    recon_s = reconstruct(c_pred_s, et.basis_s.U_pred, p_s, norm_sca=False)
    recon = torch.where(mask[:, None, :, None, None], recon_m, recon_s)
    return {"recon_traj": recon, "moving_mask": mask}
