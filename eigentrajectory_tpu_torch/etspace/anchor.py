"""Anchors: k-means++ over ET coefficients, and the anchor refinement.

The counterpart of `eigentrajectory_tpu/etspace/anchor.py`. The distances and
Lloyd's iterations run on the device of the data. The random draws of the
k-means++ seeding are made on the host from a CPU `torch.Generator` (a CPU and
a CUDA generator give different streams for one seed) and turned into indices
on the device by inverse-CDF sampling, so a fit on the card and a fit on the
CPU from the same seed see the same draws and differ only by the rounding of
the distances. The draws are not those of `jax.random`, so a fit is held
against the JAX package by its inertia, and `_lloyd`, which takes the initial
centres, value by value.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pairwise_sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, d) x (S, d) -> (N, S) squared distances."""
    return (x * x).sum(dim=1, keepdim=True) - 2.0 * x @ c.T + (c * c).sum(dim=1)[None, :]


def _kmeanspp_init(generator: torch.Generator, x: torch.Tensor,
                   n_clusters: int) -> torch.Tensor:
    """k-means++ seeding: the first centre uniformly, each next one with
    probability proportional to its squared distance D^2 to the nearest
    centre so far (uniformly where every D^2 is 0: duplicate points).

    `generator` is a CPU generator: one integer and n_clusters - 1 uniforms
    are drawn from it on the host, whatever the device of x.
    """
    n = x.shape[0]
    first = torch.randint(n, (), generator=generator)
    u = torch.rand(n_clusters - 1, generator=generator, dtype=torch.float64).to(x.device)
    centers = [x[first.to(x.device)]]
    d2 = ((x - centers[0]) ** 2).sum(dim=1)
    for i in range(n_clusters - 1):
        w = torch.where(d2.sum() > 0, d2, torch.ones_like(d2)).to(torch.float64)
        cdf = torch.cumsum(w, dim=0)
        # right=True: a point of weight 0 (an earlier centre) is never drawn
        idx = torch.searchsorted(cdf, u[i] * cdf[-1], right=True).clamp_max(n - 1)
        centers.append(x[idx])
        d2 = torch.minimum(d2, ((x - centers[-1]) ** 2).sum(dim=1))
    return torch.stack(centers)


def _assign_update(x: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step from centres c (S, d): (new centres, inertia under c).
    An empty cluster keeps its centre; a point at equal distance from two
    centres goes to the one of lower index."""
    d2 = _pairwise_sq_dist(x, c)
    lbl = torch.argmin(d2, dim=1)
    one_hot = F.one_hot(lbl, c.shape[0]).to(x.dtype)          # (N, S)
    counts = one_hot.sum(dim=0)                               # (S,)
    sums = one_hot.T @ x                                      # (S, d)
    new_c = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c)
    return new_c, d2.min(dim=1).values.sum()


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int,
           tol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from `centers` until the summed squared shift of the
    centres is at most tol. Returns (centers, inertia), the inertia
    recomputed with the converged centres."""
    c, shift, it = centers, float("inf"), 0
    while shift > tol and it < max_iter:
        new_c, _ = _assign_update(x, c)
        shift = float(((new_c - c) ** 2).sum())
        c, it = new_c, it + 1
    return c, _assign_update(x, c)[1]


def kmeans_fit(generator: torch.Generator, x: torch.Tensor, n_clusters: int,
               n_init: int = 10, max_iter: int = 300, tol: float = 1e-6) -> torch.Tensor:
    """Fit k-means with `n_init` restarts; return the centres (S, d) of the
    restart of least inertia. `generator`: see `_kmeanspp_init`."""
    runs = [_lloyd(x, _kmeanspp_init(generator, x, n_clusters), max_iter, tol)
            for _ in range(n_init)]
    best = torch.argmin(torch.stack([inertia for _, inertia in runs]))
    return torch.stack([c for c, _ in runs])[best]


def batch_kmeans_fit(generator: torch.Generator, x: torch.Tensor, n_clusters: int,
                     n_init: int = 10, max_iter: int = 300, tol: float = 1e-6) -> torch.Tensor:
    """Independent k-means problems over the leading axis: x (B, N, d) ->
    centres (B, S, d), one `kmeans_fit` each. Each problem draws from a CPU
    generator of its own, seeded from `generator`."""
    seeds = torch.randint(2 ** 62, (x.shape[0],), generator=generator)
    return torch.stack([
        kmeans_fit(torch.Generator().manual_seed(int(seed)), xi, n_clusters, n_init, max_iter,
                   tol)
        for seed, xi in zip(seeds, x)])


def kmeans_predict(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Assign points (N, d) to the nearest centres (S, d) -> labels (N,)."""
    return torch.argmin(_pairwise_sq_dist(x, centers), dim=1)


def generate_anchors(generator: torch.Generator, pred_traj_norm: torch.Tensor,
                     u_pred_trunc: torch.Tensor, num_samples: int) -> torch.Tensor:
    """k-means over the projected GT pred coefficients, in float32.

    pred_traj_norm (N, T, dim), u_pred_trunc (T*dim, k) -> C_anchor
    (k, num_samples).
    """
    c_pred = pred_traj_norm.flatten(1) @ u_pred_trunc               # (N, k)
    return kmeans_fit(generator, c_pred.to(torch.float32), num_samples).T


def refine(c_anchor: torch.Tensor, c_pred_refine: torch.Tensor) -> torch.Tensor:
    """Broadcast add with frozen anchors.

    c_anchor (k, s), c_pred_refine (..., k, N, s) -> (..., k, N, s).
    """
    return c_anchor.detach()[:, None, :] + c_pred_refine
