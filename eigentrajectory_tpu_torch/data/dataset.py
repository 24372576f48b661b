"""ETH-UCY trajectory dataset ingestion (host-side NumPy).

A copy of `eigentrajectory_tpu/data/dataset.py`: sliding
windows of obs_len+pred_len frames, keeping only pedestrians observed at every
frame of the window, 4-decimal coordinate rounding, the strict `> min_ped`
scene filter and a quadratic-polyfit non-linearity flag, and the flip
augmentation of the descriptor fit. Its output is bitwise equal to the JAX
package's (tests/test_torch_config_data.py). Tab-separated splits go through
the native preprocessor of `native_loader` by default, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class TrajectoryData:
    """Flat per-pedestrian arrays plus scene boundaries.

    obs_traj (N, obs_len, 2), pred_traj (N, pred_len, 2) float32,
    non_linear_ped (N,), loss_mask (N, seq_len), num_peds_in_seq (S,),
    seq_start_end list of (start, end) per scene.
    """

    obs_traj: np.ndarray
    pred_traj: np.ndarray
    non_linear_ped: np.ndarray
    loss_mask: np.ndarray
    num_peds_in_seq: np.ndarray
    seq_start_end: List[Tuple[int, int]]

    @property
    def num_scenes(self) -> int:
        return len(self.seq_start_end)

    @property
    def num_peds(self) -> int:
        return int(self.obs_traj.shape[0])

    @property
    def max_peds_per_scene(self) -> int:
        return int(self.num_peds_in_seq.max())

    def scene(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.seq_start_end[i]
        return self.obs_traj[s:e], self.pred_traj[s:e]


def _load_rows(path: str, delim: str) -> np.ndarray:
    """Parse a `frame ped x y` text file into an (R, 4) float array."""
    if delim in ("\t", " ", "tab", "space"):
        return np.loadtxt(path, ndmin=2)
    return np.loadtxt(path, delimiter=delim, ndmin=2)


def _nonlinearity_flags(coords: np.ndarray, pred_len: int,
                        threshold: float) -> np.ndarray:
    """Quadratic-fit residual flag per pedestrian over the last pred_len steps.

    coords: (n, seq_len, 2). All pedestrians and both axes are fitted in one
    lstsq solve (the columns share the design matrix).
    """
    n = coords.shape[0]
    t = np.arange(pred_len, dtype=np.float64)
    tail = coords[:, -pred_len:, :]                       # (n, pred_len, 2)
    rhs = tail.transpose(1, 0, 2).reshape(pred_len, n * 2)
    residuals = np.polyfit(t, rhs, 2, full=True)[1]       # (n*2,)
    per_ped = residuals.reshape(n, 2).sum(axis=1)
    return (per_ped >= threshold).astype(np.float64)


def _scenes_from_file(data: np.ndarray, seq_len: int, skip: int,
                      min_ped: int) -> List[np.ndarray]:
    """All qualifying (n_kept, seq_len, 2) scene tensors from one raw file,
    from a (ped, frame) occupancy grid and a sliding seq_len window."""
    frames, frame_pos = np.unique(data[:, 0], return_inverse=True)
    _, ped_pos = np.unique(data[:, 1], return_inverse=True)
    n_frames, n_peds = len(frames), ped_pos.max() + 1
    if n_frames < seq_len:
        return []

    present = np.zeros((n_peds, n_frames), dtype=bool)
    present[ped_pos, frame_pos] = True
    grid = np.zeros((n_peds, n_frames, 2))
    grid[ped_pos, frame_pos] = np.round(data[:, 2:4], 4)

    # A running count of present frames differs by exactly seq_len across a
    # window in which the pedestrian is present at every frame.
    csum = np.concatenate(
        [np.zeros((n_peds, 1), np.int64), np.cumsum(present, axis=1)], axis=1)
    starts = range(0, n_frames - seq_len + 1, skip)

    scenes = []
    for s in starts:
        kept = (csum[:, s + seq_len] - csum[:, s]) == seq_len   # (n_peds,)
        if int(kept.sum()) > min_ped:
            scenes.append(grid[kept, s:s + seq_len])
    return scenes


def load_trajectory_data(
    data_dir: str,
    obs_len: int = 8,
    pred_len: int = 12,
    skip: int = 1,
    threshold: float = 0.02,
    min_ped: int = 1,
    delim: str = "\t",
    use_native: bool = True,
) -> TrajectoryData:
    """Build TrajectoryData from a directory of raw txt files.

    Tab-separated files go through the native C++ preprocessor
    (`native_loader`), whose output is bitwise this function's Python route;
    a failed build of it raises. `use_native=False` takes the Python route.
    """
    if use_native and delim == "\t":
        from .native_loader import load_trajectory_data_native

        return load_trajectory_data_native(data_dir, obs_len, pred_len, skip, threshold,
                                           min_ped)

    seq_len = obs_len + pred_len
    scenes: List[np.ndarray] = []
    for name in sorted(os.listdir(data_dir)):
        rows = _load_rows(os.path.join(data_dir, name), delim)
        scenes.extend(_scenes_from_file(rows, seq_len, skip, min_ped))

    coords = np.concatenate(scenes, axis=0)               # (N, seq_len, 2)
    counts = np.array([len(s) for s in scenes])
    non_linear = np.concatenate(
        [_nonlinearity_flags(s, pred_len, threshold) for s in scenes])
    bounds = np.concatenate([[0], np.cumsum(counts)])

    return TrajectoryData(
        obs_traj=coords[:, :obs_len].astype(np.float32),
        pred_traj=coords[:, obs_len:].astype(np.float32),
        non_linear_ped=non_linear.astype(np.float32),
        loss_mask=np.ones((len(coords), seq_len), np.float32),
        num_peds_in_seq=counts,
        seq_start_end=[(int(a), int(b)) for a, b in zip(bounds, bounds[1:])],
    )


def augment_trajectory(
    obs_traj: np.ndarray, pred_traj: np.ndarray, flip: bool = True, reverse: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Flip augmentation of the descriptor fit.

    The flip branch short-circuits reverse, as in the JAX package, so with the
    defaults only the y-flip doubling is applied.
    """
    if flip:
        flip_mul = np.array([[[1.0, -1.0]]], dtype=obs_traj.dtype)
        obs_traj = np.concatenate([obs_traj, obs_traj * flip_mul], axis=0)
        pred_traj = np.concatenate([pred_traj, pred_traj * flip_mul], axis=0)
    elif reverse:
        obs_len = obs_traj.shape[1]
        full = np.concatenate([obs_traj, pred_traj], axis=1)
        rev = full[:, ::-1]
        obs_traj = np.concatenate([obs_traj, rev[:, :obs_len]], axis=0)
        pred_traj = np.concatenate([pred_traj, rev[:, obs_len:]], axis=0)
    return obs_traj, pred_traj
