"""EigenTrajectory descriptor: projection onto and reconstruction from the
truncated-SVD bases.

The counterpart of the projection half of
`eigentrajectory_tpu/etspace/descriptor.py`; the bases come from a checkpoint
(`interop.params_from_jax`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .normalizer import NormParams, denormalize


class ETBasis(NamedTuple):
    """Truncated SVD bases. Frozen after init."""

    U_obs: torch.Tensor   # (t_obs * dim, k)
    U_pred: torch.Tensor  # (t_pred * dim, k)


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
