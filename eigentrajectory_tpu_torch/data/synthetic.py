"""Synthetic trajectory data for tests, dry runs, and benchmarks
(a copy of `eigentrajectory_tpu/data/synthetic.py`)."""
from __future__ import annotations

import numpy as np

from .dataset import TrajectoryData


def make_synthetic_data(
    n_scenes: int = 8,
    max_peds: int = 6,
    obs_len: int = 8,
    pred_len: int = 12,
    seed: int = 0,
) -> TrajectoryData:
    """Smooth random-walk scenes with 2..max_peds peds each."""
    rng = np.random.default_rng(seed)
    obs_list, pred_list, npis = [], [], []
    t_total = obs_len + pred_len
    for _ in range(n_scenes):
        n = int(rng.integers(2, max_peds + 1))
        start = rng.normal(size=(n, 1, 2)) * 5
        vel = rng.normal(size=(n, 1, 2))
        t = np.arange(t_total)[None, :, None]
        wiggle = 0.05 * np.cumsum(rng.normal(size=(n, t_total, 2)), axis=1)
        traj = (start + vel * t * 0.4 + wiggle).astype(np.float32)
        obs_list.append(traj[:, :obs_len])
        pred_list.append(traj[:, obs_len:])
        npis.append(n)
    obs = np.concatenate(obs_list)
    pred = np.concatenate(pred_list)
    cum = np.concatenate([[0], np.cumsum(npis)])
    return TrajectoryData(
        obs_traj=obs,
        pred_traj=pred,
        non_linear_ped=np.zeros(obs.shape[0], np.float32),
        loss_mask=np.ones((obs.shape[0], t_total), np.float32),
        num_peds_in_seq=np.asarray(npis),
        seq_start_end=[(int(a), int(b)) for a, b in zip(cum, cum[1:])],
    )
