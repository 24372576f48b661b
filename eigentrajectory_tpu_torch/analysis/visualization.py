"""Visualization: eigenvector plots (paper Fig. 3) and ET-coefficient
cluster views (t-SNE of the k-means anchors' clusters).

The counterpart of `eigentrajectory_tpu/analysis/visualization.py`, driven by
the port's normalizer and k-means (`etspace.anchor.kmeans_fit`) on `device`
(the card by default). Figures are saved headless (matplotlib Agg);
matplotlib and sklearn are imported inside the functions that draw, so the
module imports without them.

Usage:
  python -m eigentrajectory_tpu_torch.analysis.visualization fig3 --dataset eth [--device cpu]
  python -m eigentrajectory_tpu_torch.analysis.visualization tsne --dataset eth [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _load_normalized(dataset_dir: str, obs_len=8, pred_len=12, device="cuda"):
    """The train split's observed and future trajectories, normalized by
    origin and rotation (no scale), as numpy arrays."""
    import torch

    from ..data.dataset import load_trajectory_data
    from ..etspace.normalizer import compute_norm_params, normalize

    data = load_trajectory_data(os.path.join(dataset_dir, "train"), obs_len, pred_len)
    obs = torch.from_numpy(data.obs_traj).to(device)
    p = compute_norm_params(obs)
    obs_norm = normalize(obs, p, sca=False).cpu().numpy()
    pred_norm = normalize(torch.from_numpy(data.pred_traj).to(device), p, sca=False)
    return obs_norm, pred_norm.cpu().numpy()


def plot_fig3(dataset_dir: str, out_path: str, k: int = 6, device: str = "cuda"):
    """Eigenvector panels of the future trajectories' SVD: x-y shape, x(t),
    y(t), singular-value share."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, pred_norm = _load_normalized(dataset_dir, device=device)
    n, t, d = pred_norm.shape
    b = pred_norm.reshape(n, t * d).T.astype(np.float64)
    u, s, _ = np.linalg.svd(b, full_matrices=False)

    colors = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
              "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]
    fig, axs = plt.subplots(4, k + 1, figsize=((k + 1) * 2, 8))
    steps = np.arange(t)
    for i in range(k):
        xy = u[:, i].reshape(-1, 2)
        c = colors[i % len(colors)]
        axs[0, i].plot(xy[:, 0], xy[:, 1], color=c)
        axs[0, i].set_xlim(-0.5, 0.5); axs[0, i].set_ylim(-0.5, 0.5)
        axs[0, i].set_aspect("equal", adjustable="box")
        axs[0, i].set_title(f"u{i + 1}")
        axs[1, i].plot(steps, xy[:, 0], color=c)
        axs[2, i].plot(steps, xy[:, 1], color=c)
        axs[3, i].bar([0], [s[i] / s.sum()], color=c)
    # combined panel
    for i in range(k):
        xy = u[:, i].reshape(-1, 2)
        axs[0, k].plot(xy[:, 0], xy[:, 1], color=colors[i % len(colors)])
        axs[1, k].plot(steps, xy[:, 0], color=colors[i % len(colors)])
        axs[2, k].plot(steps, xy[:, 1], color=colors[i % len(colors)])
    axs[3, k].bar(np.arange(k), s[:k] / s.sum(),
                  color=[colors[i % len(colors)] for i in range(k)])
    for row, label in enumerate(["x-y", "x(t)", "y(t)", "sv share"]):
        axs[row, 0].set_ylabel(label)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_coeff_tsne(dataset_dir: str, out_path: str, k: int = 6, s: int = 20,
                    max_points: int = 3000, seed: int = 0, device: str = "cuda"):
    """t-SNE of the future trajectories' ET coefficients, coloured by their
    k-means cluster."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch
    from sklearn.manifold import TSNE

    from ..etspace.anchor import kmeans_fit

    _, pred_norm = _load_normalized(dataset_dir, device=device)
    n, t, d = pred_norm.shape
    b = pred_norm.reshape(n, t * d).T.astype(np.float64)
    u, _, _ = np.linalg.svd(b, full_matrices=False)
    coeff = (u[:, :k].T @ b).T.astype(np.float32)        # (N, k)

    centers = kmeans_fit(torch.Generator().manual_seed(seed),
                         torch.from_numpy(coeff).to(device), s).cpu().numpy()
    d2 = ((coeff[:, None] - centers[None]) ** 2).sum(-1)
    labels = d2.argmin(axis=1)

    if coeff.shape[0] > max_points:
        idx = np.random.default_rng(seed).choice(coeff.shape[0], max_points,
                                                 replace=False)
        coeff, labels = coeff[idx], labels[idx]

    emb = TSNE(n_components=2, random_state=42).fit_transform(coeff)
    plt.figure(figsize=(12, 10))
    cmap = plt.get_cmap("tab20", s)
    plt.scatter(emb[:, 0], emb[:, 1], c=labels, cmap=cmap, marker="o", s=8,
                alpha=0.7, edgecolors="none")
    plt.title("t-SNE of ET coefficients, colored by anchor cluster")
    plt.savefig(out_path, dpi=150)
    plt.close()
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["fig3", "tsne"])
    ap.add_argument("--dataset", default="eth")
    ap.add_argument("--dataset_dir", default="./datasets/")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import resolve_dataset_dir

    ddir = resolve_dataset_dir(args.dataset_dir, args.dataset)
    out = args.out or f"{args.mode}_{args.dataset}.png"
    if args.mode == "fig3":
        print(plot_fig3(ddir, out, device=args.device))
    else:
        print(plot_coeff_tsne(ddir, out, device=args.device))


if __name__ == "__main__":
    main()
