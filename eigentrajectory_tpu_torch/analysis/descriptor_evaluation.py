"""Descriptor evaluation: how well each trajectory descriptor reconstructs a
split's test trajectories (Table 1 of the EigenTrajectory paper).

The counterpart of `eigentrajectory_tpu/analysis/descriptor_evaluation.py`:
Linear, Bézier (degree 2-5), B-spline and truncated-SVD (k = 1..12)
descriptors, each fitted to the observed and to the future trajectories
after the origin and rotation normalization (no scale), scored by the mean
L2 error of the reconstruction in world coordinates. The curve fits are the
closed-form least-squares solves of `analysis/curves.py` on the host; the
normalization and the SVD run on `device` (the card by default), the SVD in
float64.

Run: python -m eigentrajectory_tpu_torch.analysis.descriptor_evaluation
       [--dataset_dir DIR] [--datasets eth hotel ...] [--json out.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..config import resolve_dataset_dir
from ..data.dataset import load_trajectory_data
from ..etspace.normalizer import compute_norm_params, denormalize, normalize
from .curves import bezier_basis, bspline_basis, curve_fit_lstsq, linear_basis


def _recon_error(recon: torch.Tensor, target: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(recon - target, dim=-1).mean())


def eval_dataset(dataset_dir: str, obs_len: int = 8, pred_len: int = 12,
                 device: str = "cuda") -> List[Dict]:
    """Every descriptor family on the test split of `dataset_dir`: a list of
    {method, num_params, obs_error, pred_error[, degree, n_curve, k]}."""
    data = load_trajectory_data(os.path.join(dataset_dir, "test"), obs_len, pred_len)
    obs = torch.from_numpy(data.obs_traj).to(device)
    pred = torch.from_numpy(data.pred_traj).to(device)
    n_ped, t_obs, dim = obs.shape
    t_pred = pred.shape[1]

    p = compute_norm_params(obs)
    obs_norm = normalize(obs, p, sca=False)
    pred_norm = normalize(pred, p, sca=False)
    obs_norm_np, pred_norm_np = obs_norm.cpu().numpy(), pred_norm.cpu().numpy()

    def denorm(x):
        return denormalize(torch.as_tensor(x, dtype=torch.float32, device=device), p, sca=False)

    results = []

    def add(method, params, o_recon_norm, p_recon_norm, **extra):
        results.append(dict(
            method=method, num_params=params,
            obs_error=_recon_error(denorm(o_recon_norm), obs),
            pred_error=_recon_error(denorm(p_recon_norm), pred), **extra))

    add("linear", 2 * dim,
        curve_fit_lstsq(obs_norm_np, linear_basis(t_obs)),
        curve_fit_lstsq(pred_norm_np, linear_basis(t_pred)))

    for deg in range(2, 6):
        add("bezier", (deg + 1) * dim,
            curve_fit_lstsq(obs_norm_np, bezier_basis(deg, t_obs)),
            curve_fit_lstsq(pred_norm_np, bezier_basis(deg, t_pred)),
            degree=deg)

    for deg in range(1, 4):
        for n_curve in range(2, 6):
            if n_curve <= deg:
                continue
            add("bspline", (n_curve + 1) * dim,
                curve_fit_lstsq(obs_norm_np, bspline_basis(n_curve, deg, t_obs)),
                curve_fit_lstsq(pred_norm_np, bspline_basis(n_curve, deg, t_pred)),
                degree=deg, n_curve=n_curve)

    # Truncated SVD, k = 1..12, in float64 on the device.
    a = obs_norm.reshape(n_ped, t_obs * dim).T.to(torch.float64)
    b = pred_norm.reshape(n_ped, t_pred * dim).T.to(torch.float64)
    u_obs = torch.linalg.svd(a, full_matrices=False)[0]
    u_pred = torch.linalg.svd(b, full_matrices=False)[0]
    for k in range(1, 13):
        uo, up = u_obs[:, :k], u_pred[:, :k]
        a_recon = (uo @ (uo.T @ a)).T.reshape(n_ped, t_obs, dim)
        b_recon = (up @ (up.T @ b)).T.reshape(n_ped, t_pred, dim)
        add("svd", k, a_recon.to(torch.float32), b_recon.to(torch.float32), k=k)

    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", default="./datasets/")
    parser.add_argument("--datasets", nargs="+",
                        default=["eth", "hotel", "univ", "zara1", "zara2"])
    parser.add_argument("--obs_len", type=int, default=8)
    parser.add_argument("--pred_len", type=int, default=12)
    parser.add_argument("--json", default=None, help="optional JSON output path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    all_results = {}
    for scene in args.datasets:
        print(f"Scene: {scene}")
        rows = eval_dataset(resolve_dataset_dir(args.dataset_dir, scene),
                            args.obs_len, args.pred_len, device=args.device)
        all_results[scene] = rows
        for r in rows:
            extra = {k: v for k, v in r.items()
                     if k not in ("method", "num_params", "obs_error", "pred_error")}
            print(f"  {r['method']:8s} params={r['num_params']:2d} "
                  f"obs={r['obs_error']:.4f} pred={r['pred_error']:.4f} {extra}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(all_results, f, indent=2)


if __name__ == "__main__":
    main()
