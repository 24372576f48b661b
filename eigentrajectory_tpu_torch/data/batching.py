"""Padded scene batches for the sequenced regime (host-side NumPy).

The sequenced half of `eigentrajectory_tpu/data/batching.py`: ragged scenes
become fixed-shape (B, N_max, T, 2) blocks with (B, N_max) pedestrian
validity and (B,) scene validity. The arrays are bitwise equal to the JAX
package's; the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from .dataset import TrajectoryData


@dataclasses.dataclass
class SceneBatch:
    """Padded batch of scenes (sequenced regime). All arrays NumPy host-side."""

    obs: np.ndarray          # (B, N, obs_len, 2) float32
    pred: np.ndarray         # (B, N, pred_len, 2) float32
    ped_valid: np.ndarray    # (B, N) bool
    scene_valid: np.ndarray  # (B,) bool
    non_linear: np.ndarray   # (B, N) float32


def pad_scenes(
    data: TrajectoryData, indices: Sequence[int], n_max: int, batch: int
) -> SceneBatch:
    """Pad `indices` scenes to a (batch, n_max, ...) block."""
    obs_len = data.obs_traj.shape[1]
    pred_len = data.pred_traj.shape[1]
    obs = np.zeros((batch, n_max, obs_len, 2), np.float32)
    pred = np.zeros((batch, n_max, pred_len, 2), np.float32)
    ped_valid = np.zeros((batch, n_max), bool)
    scene_valid = np.zeros((batch,), bool)
    non_linear = np.zeros((batch, n_max), np.float32)
    for b, idx in enumerate(indices):
        s, e = data.seq_start_end[idx]
        n = e - s
        obs[b, :n] = data.obs_traj[s:e]
        pred[b, :n] = data.pred_traj[s:e]
        ped_valid[b, :n] = True
        scene_valid[b] = True
        non_linear[b, :n] = data.non_linear_ped[s:e]
    return SceneBatch(obs, pred, ped_valid, scene_valid, non_linear)


class SceneBatcher:
    """Iterates padded scene batches; shuffles with a NumPy RNG when asked.

    Every batch has the shape (batch_size, n_max, ...); the tail of the split
    is padded with invalid scenes.
    """

    def __init__(
        self,
        data: TrajectoryData,
        batch_size: int,
        shuffle: bool,
        n_max: Optional[int] = None,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.n_max = n_max or data.max_peds_per_scene
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = self.data.num_scenes
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[SceneBatch]:
        order = np.arange(self.data.num_scenes)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            chunk = order[i:i + bs]
            if len(chunk) < bs and self.drop_last:
                return
            yield pad_scenes(self.data, chunk.tolist(), self.n_max, bs)
