"""The harness's side of the program under test, `eigentrajectory_tpu_torch`:
its configuration and data types built from a benchmark configuration and
generated scenes. The loops take the program's entry points from here or
import them themselves; nothing of the program reaches `reference/`."""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

from .generator import Scenes


def exp_config(config: Dict, root: str, **overrides):
    """The program's `ExpConfig` for a benchmark configuration: its
    `experiment` fields, the checkpoint directory in the checkout."""
    from eigentrajectory_tpu_torch.config import ExpConfig

    known = {f.name for f in dataclasses.fields(ExpConfig)}
    fields = {k: v for k, v in config["experiment"].items() if k in known}
    fields["checkpoint_dir"] = os.path.join(root, config["checkpoint_dir"])
    fields.update(overrides)
    return ExpConfig(**fields)


def trajectory_data(scenes: Scenes):
    """The program's `TrajectoryData` of generated scenes."""
    from eigentrajectory_tpu_torch.data.dataset import TrajectoryData

    n = scenes.obs.shape[0]
    return TrajectoryData(
        obs_traj=scenes.obs, pred_traj=scenes.pred,
        non_linear_ped=np.zeros(n, np.float32),
        loss_mask=np.ones((n, scenes.obs.shape[1] + scenes.pred.shape[1]), np.float32),
        num_peds_in_seq=scenes.counts,
        seq_start_end=[(int(a), int(b)) for a, b in zip(scenes.starts[:-1], scenes.starts[1:])])


def moving(obs: np.ndarray, static_dist: float) -> np.ndarray:
    """Which pedestrians of obs (N, t_obs, 2) take the moving branch, as the
    configuration defines it (counted by the harness for the kernels'
    bounds): (N,) bool."""
    d = (obs[:, -1] - obs[:, -3]) / np.float32(2.0)
    return np.linalg.norm(d, axis=-1) > static_dist
