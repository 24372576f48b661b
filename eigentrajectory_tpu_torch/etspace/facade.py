"""The EigenTrajectory facade over a block of scenes.

The counterpart of `eigentrajectory_tpu/etspace/facade.py`. The JAX package
runs it on one scene and `vmap`s it over the block; here the scene axis is
written out: every tensor carries a leading (B,) axis and the scene-centring
of origins averages over the valid pedestrians of each scene.

Both descriptor variants (moving and static) run densely on all pedestrians
and are selected per pedestrian by the moving mask.

Gradient topology: C_obs, the bases, the anchors and the GT coefficients
carry no gradient; gradients flow only through the predictor's output.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import span
from .anchor import generate_anchors, refine
from .descriptor import ETBasis, fit_basis, project, reconstruct
from .normalizer import compute_norm_params, normalize

# Guard for the scale denominator of exactly-static peds; the guarded values
# are only ever used on lanes discarded by the moving/static select.
_SCALE_EPS = 1e-8


class ETParams(NamedTuple):
    """Frozen ET-space parameters (fitted once or read from a checkpoint,
    never optimized)."""

    basis_m: ETBasis       # moving-ped descriptor (scale normalized)
    basis_s: ETBasis       # static-ped descriptor (no scale)
    anchor_m: torch.Tensor  # (k, s)
    anchor_s: torch.Tensor  # (k, s)


def moving_mask(obs_traj: torch.Tensor, static_dist: float) -> torch.Tensor:
    """(..., N, T, 2) -> (..., N) bool: ||(obs[-1] - obs[-3]) / 2|| > static_dist."""
    d = (obs_traj[..., -1, :] - obs_traj[..., -3, :]) / 2.0
    return torch.linalg.vector_norm(d, dim=-1) > static_dist


def calculate_parameters(
    generator: torch.Generator,
    obs_traj: np.ndarray,
    pred_traj: np.ndarray,
    k: int,
    num_samples: int,
    static_dist: float,
    device: torch.device = torch.device("cpu"),
) -> ETParams:
    """One-time descriptor and anchor fit over flat (N, T, 2) arrays.

    The moving/static split is a ragged gather on the host, in float32; the
    normalization and the k-means run on `device`, the SVD on the host
    (`descriptor.truncated_svd`). `generator` is a CPU generator
    (`anchor._kmeanspp_init`); the moving anchors are fitted first. Returns
    float32 tensors on `device`.
    """
    obs_traj = np.asarray(obs_traj, np.float32)
    pred_traj = np.asarray(pred_traj, np.float32)
    d = (obs_traj[:, -1, :] - obs_traj[:, -3, :]) / 2.0
    mask = np.linalg.norm(d, axis=-1) > static_dist

    def on(x):
        return torch.from_numpy(x).to(device)

    basis_m, pred_m_norm = fit_basis(on(obs_traj[mask]), on(pred_traj[mask]), k,
                                     norm_sca=True, eps=_SCALE_EPS)
    basis_s, pred_s_norm = fit_basis(on(obs_traj[~mask]), on(pred_traj[~mask]), k,
                                     norm_sca=False)
    anchor_m = generate_anchors(generator, pred_m_norm, basis_m.U_pred, num_samples)
    anchor_s = generate_anchors(generator, pred_s_norm, basis_s.U_pred, num_samples)
    return ETParams(basis_m=basis_m, basis_s=basis_s, anchor_m=anchor_m, anchor_s=anchor_s)


def _row_mean(obs_ori: torch.Tensor, valid_f: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp_min(valid_f.sum(dim=2, keepdim=True), 1.0)
    return (obs_ori * valid_f).sum(dim=2, keepdim=True) / denom


def row_center(obs_traj: torch.Tensor, ped_valid: torch.Tensor) -> torch.Tensor:
    """(B, 2, 1): the mean origin of each row's valid pedestrians, the
    centre `et_forward` takes for a row. A caller that splits a row's scenes
    over ranks computes it over the whole row and hands it in as
    `aux["row_center"]`."""
    ori = obs_traj[..., -1, :].transpose(1, 2)              # compute_norm_params' ori
    return _row_mean(ori, ped_valid.to(ori.dtype)[:, None, :])


def et_forward(
    et: ETParams,
    predictor_fn: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor],
    obs_traj: torch.Tensor,
    ped_valid: torch.Tensor,
    static_dist: float,
    pred_traj: Optional[torch.Tensor] = None,
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
      pred_traj: optional (B, N, t_pred, 2) GT for the training loss branch.
      aux: extra inputs forwarded to predictor_fn; its key
        `center_scene_ids` (B, N) is taken out and centres the origins per
        scene instead of per row, and its key `row_center` (B, 2, 1), where
        given, is taken out and is the centre of each row (`row_center()`
        of a whole row that this block holds a part of).
      return_coefficients: return the refined coefficients and the
        normalization params instead of trajectories, for a fused
        reconstruction by the caller.

    Returns recon_traj (B, s, N, t_pred, 2) and moving_mask (B, N), or with
    `return_coefficients` c_pred_m / c_pred_s (B, k, N, s), moving_mask,
    norm_ori (B, N, 2), norm_rot (B, N, 2, 2) and norm_sca (B, N). With
    `pred_traj`, also loss_eigentraj, loss_euclidean_ade and
    loss_euclidean_fde, each (B,): the masked mean over the valid pedestrians
    of each scene (0 for a scene with none).
    """
    aux = dict(aux or {})
    with span("et.project", detail=True):
        mask = moving_mask(obs_traj, static_dist)               # (B, N)
        p = compute_norm_params(obs_traj, eps=_SCALE_EPS)

        # --- projection ---
        c_obs_m = project(normalize(obs_traj, p, sca=True), et.basis_m.U_obs)
        c_obs_s = project(normalize(obs_traj, p, sca=False), et.basis_s.U_obs)
        c_obs = torch.where(mask[:, None, :], c_obs_m, c_obs_s).detach()  # (B, k, N)

        # --- absolute coordinate, centred on the valid peds of each row, or
        # with `center_scene_ids` (B, N) on the valid peds of each ped's
        # scene (a segment mean: a packed row of many scenes gives each the
        # numbers it gets alone) ---
        obs_ori = p.ori[..., 0, :].transpose(1, 2)              # (B, 2, N)
        valid_f = ped_valid.to(obs_ori.dtype)[:, None, :]       # (B, 1, N)
        denom = torch.clamp_min(valid_f.sum(dim=2, keepdim=True), 1.0)
        center_sid = aux.pop("center_scene_ids", None)
        center = aux.pop("row_center", None)
        if center is None and center_sid is None:
            center = _row_mean(obs_ori, valid_f)
        elif center is None:
            same = (center_sid[:, :, None] == center_sid[:, None, :]).to(obs_ori.dtype) * valid_f
            cnt = torch.clamp_min(same.sum(dim=2), 1.0)          # (B, N)
            center = torch.bmm(same, (obs_ori * valid_f).transpose(1, 2))   # (B, N, 2)
            center = (center / cnt[..., None]).transpose(1, 2)   # (B, 2, N)
        obs_ori = (obs_ori - center) * valid_f

    # --- prediction via the bridged predictor; it must see exactly the
    # scene's real peds ---
    aux["ped_valid"] = ped_valid
    with span("et.predictor", detail=True):
        c_pred_refine = predictor_fn(c_obs, obs_ori, aux)       # (B, k, N, s)

    # --- anchor refinement ---
    with span("et.refine", detail=True):
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
    output = {"recon_traj": recon, "moving_mask": mask}

    if pred_traj is not None:
        # GT low-rank approximation, detached.
        c_gt_m = project(normalize(pred_traj, p, sca=True), et.basis_m.U_pred)
        c_gt_s = project(normalize(pred_traj, p, sca=False), et.basis_s.U_pred)
        c_pred_gt = torch.where(mask[:, None, :], c_gt_m, c_gt_s).detach()   # (B, k, N)
        c_pred = torch.where(mask[:, None, :, None], c_pred_m, c_pred_s)     # (B, k, N, s)

        err_coeff = torch.linalg.vector_norm(c_pred - c_pred_gt[..., None], dim=1)  # (B, N, s)
        err_disp = torch.linalg.vector_norm(recon - pred_traj[:, None], dim=-1)  # (B, s, N, T)

        def masked_mean(x):                                  # (B, N) -> (B,)
            return (x * valid_f[:, 0]).sum(dim=1) / denom[:, 0, 0]

        # amin shares the gradient between tied samples, as jnp.min does
        output["loss_eigentraj"] = masked_mean(err_coeff.amin(dim=-1))
        output["loss_euclidean_ade"] = masked_mean(err_disp.mean(dim=-1).amin(dim=1))
        output["loss_euclidean_fde"] = masked_mean(err_disp[..., -1].amin(dim=1))
    return output
