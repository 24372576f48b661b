"""EigenTrajectory descriptor: the truncated-SVD basis fit, projection onto
the bases and reconstruction from them.

The counterpart of `eigentrajectory_tpu/etspace/descriptor.py`. The bases
come from `fit_basis` (training) or from a checkpoint
(`interop.params_from_jax`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .normalizer import NormParams, compute_norm_params, denormalize, normalize


class ETBasis(NamedTuple):
    """Truncated SVD bases. Frozen after init."""

    U_obs: torch.Tensor   # (t_obs * dim, k)
    U_pred: torch.Tensor  # (t_pred * dim, k)


def truncated_svd(traj_norm: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD of stacked normalized trajectories.

    traj_norm: (N, T, dim). The data matrix is M = reshape(N, T*dim).T with
    shape (T*dim, N); returns (U_trunc (T*dim, k), S_trunc (k,), V_trunc
    (N, k)) as float32 tensors on traj_norm's device.

    Singular-vector signs are fixed so that each column's largest-magnitude
    entry is positive (a sign of 0 counts as +1); LAPACK's own signs are
    arbitrary. The factorization runs on the host in float64: it runs once,
    at init, and a float32 SVD is ~1e-3 off orthonormal, too loose for a
    checkpoint that another package reads.
    """
    n, t, dim = traj_norm.shape
    m = traj_norm.detach().cpu().numpy().astype(np.float64).reshape(n, t * dim).T
    u, s, vt = np.linalg.svd(m, full_matrices=False)
    u_t, s_t, v_t = u[:, :k], s[:k], vt[:k, :].T
    idx = np.argmax(np.abs(u_t), axis=0)
    signs = np.sign(u_t[idx, np.arange(u_t.shape[1])])
    signs = np.where(signs == 0, 1.0, signs)

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(traj_norm.device)

    return f32(u_t * signs), f32(s_t), f32(v_t * signs)


def fit_basis(obs_traj: torch.Tensor, pred_traj: torch.Tensor, k: int, norm_sca: bool,
              eps: float = 0.0) -> Tuple[ETBasis, torch.Tensor]:
    """Fit the truncated bases of one branch.

    obs_traj (N, t_obs, 2), pred_traj (N, t_pred, 2). The normalization
    parameters come from the observed part and are applied to both segments.
    Returns the basis and the normalized pred trajectories (reused for the
    anchors).
    """
    p = compute_norm_params(obs_traj, eps=eps)
    obs_norm = normalize(obs_traj, p, sca=norm_sca)
    pred_norm = normalize(pred_traj, p, sca=norm_sca)
    u_obs, _, _ = truncated_svd(obs_norm, k)
    u_pred, _, _ = truncated_svd(pred_norm, k)
    return ETBasis(U_obs=u_obs, U_pred=u_pred), pred_norm


def project(traj_norm: torch.Tensor, evec: torch.Tensor) -> torch.Tensor:
    """Euclidean -> ET space. traj_norm (..., N, T, dim), evec (T*dim, k)
    -> C (..., k, N)."""
    m = traj_norm.flatten(-2)                   # (..., N, T*dim)
    return (m @ evec).transpose(-1, -2)


def reconstruct_norm(c_pred: torch.Tensor, evec: torch.Tensor,
                     dim: int = 2) -> torch.Tensor:
    """ET -> normalized Euclidean, batched over samples.

    c_pred (..., k, N, s), evec (T*dim, k) -> (..., s, N, T, dim).
    """
    m = torch.einsum("tk,...kns->...snt", evec, c_pred)
    return m.unflatten(-1, (evec.shape[0] // dim, dim))


def reconstruct(c_pred: torch.Tensor, evec: torch.Tensor, p: NormParams,
                norm_sca: bool, dim: int = 2) -> torch.Tensor:
    """Reconstruction incl. denormalization -> (..., s, N, T, dim) in world
    coordinates."""
    return denormalize(reconstruct_norm(c_pred, evec, dim=dim), p, sca=norm_sca)
