"""Padded batches of both regimes (host-side NumPy).

The counterpart of `eigentrajectory_tpu/data/batching.py`:

* sequenced: ragged scenes become fixed-shape (B, N_max, T, 2) blocks with
  (B, N_max) pedestrian validity and (B,) scene validity;
* collated: whole scenes are packed greedily into flat (P, T, 2) batches of
  about `batch_size` pedestrians, with (P,) validity and the scene id of
  each slot (-1 on padding), from which the block-diagonal scene mask is
  built on the device.

The arrays are bitwise equal to the JAX package's; the trainer moves them to
the device.

A data-parallel run plans its shards here, on the host: every rank holds
the whole split, draws the same batches and takes its part of each
(`shard_rows`: a contiguous range of a block's scene rows; `shard_scenes`:
whole scenes of a packed batch, repacked into a row of their own;
`shard_slots`: a contiguous range of a packed batch's slots, for a
predictor whose training forward spans the row), so no data is exchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import span
from .dataset import TrajectoryData


@dataclasses.dataclass
class SceneBatch:
    """Padded batch of scenes (sequenced regime). All arrays NumPy host-side."""

    obs: np.ndarray          # (B, N, obs_len, 2) float32
    pred: np.ndarray         # (B, N, pred_len, 2) float32
    ped_valid: np.ndarray    # (B, N) bool
    scene_valid: np.ndarray  # (B,) bool
    non_linear: np.ndarray   # (B, N) float32


@dataclasses.dataclass
class CollatedBatch:
    """Padded flat pedestrian batch (collated regime)."""

    obs: np.ndarray         # (P, obs_len, 2) float32
    pred: np.ndarray        # (P, pred_len, 2) float32
    ped_valid: np.ndarray   # (P,) bool
    scene_ids: np.ndarray   # (P,) int32; padded slots get -1
    non_linear: np.ndarray  # (P,) float32


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
            with span("data.pad"):
                batch = pad_scenes(self.data, chunk.tolist(), self.n_max, bs)
            yield batch


def _collate_groups(
    data: TrajectoryData, order: np.ndarray, batch_size: int, drop_last: bool
) -> List[List[int]]:
    """Greedy pedestrian-count packing: scenes are added in `order` until the
    batch holds at least `batch_size` pedestrians."""
    groups: List[List[int]] = []
    batch: List[int] = []
    total = 0
    for idx in order:
        batch.append(int(idx))
        total += int(data.num_peds_in_seq[idx])
        if total >= batch_size:
            groups.append(batch)
            batch, total = [], 0
    if batch and not drop_last:
        groups.append(batch)
    return groups


def max_collated_peds(data: TrajectoryData, batch_size: int) -> int:
    """Upper bound on the pedestrians of a packed batch: the packer stops as
    soon as the total reaches `batch_size`, so a batch holds at most
    batch_size - 1 pedestrians plus one last scene."""
    return batch_size - 1 + data.max_peds_per_scene


class CollatedBatcher:
    """Iterates padded flat pedestrian batches (collated regime); every batch
    has p_max slots."""

    def __init__(
        self,
        data: TrajectoryData,
        batch_size: int,
        shuffle: bool,
        p_max: Optional[int] = None,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.p_max = p_max or max_collated_peds(data, batch_size)
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        """Batches of an unshuffled pass (a shuffled one may differ by one)."""
        order = np.arange(self.data.num_scenes)
        return len(_collate_groups(self.data, order, self.batch_size, self.drop_last))

    def __iter__(self) -> Iterator[CollatedBatch]:
        order = np.arange(self.data.num_scenes)
        if self.shuffle:
            self._rng.shuffle(order)
        obs_len = self.data.obs_traj.shape[1]
        pred_len = self.data.pred_traj.shape[1]
        for group in _collate_groups(self.data, order, self.batch_size, self.drop_last):
            with span("data.pad"):
                obs = np.zeros((self.p_max, obs_len, 2), np.float32)
                pred = np.zeros((self.p_max, pred_len, 2), np.float32)
                valid = np.zeros((self.p_max,), bool)
                scene_ids = np.full((self.p_max,), -1, np.int32)
                non_linear = np.zeros((self.p_max,), np.float32)
                pos = 0
                for sid, idx in enumerate(group):
                    s, e = self.data.seq_start_end[idx]
                    n = e - s
                    obs[pos:pos + n] = self.data.obs_traj[s:e]
                    pred[pos:pos + n] = self.data.pred_traj[s:e]
                    valid[pos:pos + n] = True
                    scene_ids[pos:pos + n] = sid
                    non_linear[pos:pos + n] = self.data.non_linear_ped[s:e]
                    pos += n
            yield CollatedBatch(obs, pred, valid, scene_ids, non_linear)


def scene_gather(scene_ids: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Maps between a packed batch's flat slots and per-scene blocks, as the
    JAX trainer's packed eval builds them.

    scene_ids (P,) -> gather (G, m) int64, the slots of each of the G scenes
    (in order of first appearance, m = the largest scene, 0 on padding),
    gmask (G, m) bool, and inv_g, inv_i (P,) int64, each slot's scene and
    place in it (0 for the padded slots, whose results are dropped).
    """
    uniq = [s for s in dict.fromkeys(scene_ids.tolist()) if s >= 0]
    groups = [np.flatnonzero(scene_ids == s) for s in uniq]
    m = max((len(idx) for idx in groups), default=1)
    gather = np.zeros((max(len(groups), 1), m), np.int64)
    gmask = np.zeros(gather.shape, bool)
    inv_g = np.zeros(scene_ids.shape, np.int64)
    inv_i = np.zeros(scene_ids.shape, np.int64)
    for g, idx in enumerate(groups):
        gather[g, :len(idx)] = idx
        gmask[g, :len(idx)] = True
        inv_g[idx] = g
        inv_i[idx] = np.arange(len(idx))
    return gather, gmask, inv_g, inv_i


def shard_rows(batch: SceneBatch, rank: int, world: int) -> SceneBatch:
    """Rank `rank`'s scene rows of a block: [rank * B / world, (rank + 1) *
    B / world). B must be divisible by `world`."""
    b = batch.obs.shape[0]
    if b % world:
        raise ValueError(f"a block of {b} scenes does not split over {world} ranks")
    lo, hi = rank * b // world, (rank + 1) * b // world
    return SceneBatch(*(getattr(batch, f.name)[lo:hi] for f in dataclasses.fields(SceneBatch)))


def scene_owners(scene_ids: np.ndarray, world: int) -> np.ndarray:
    """The rank of each slot of a packed batch (-1 on padding): its scenes in
    packing order, contiguous runs cut where a scene's first slot passes
    rank * (valid slots) / world, so each rank holds fewer than
    valid / world + one scene's pedestrians."""
    valid = scene_ids >= 0
    n = int(valid.sum())
    owner = np.full(scene_ids.shape, -1, np.int64)
    if n:
        # Each scene's first pedestrian, counted among the valid slots.
        _, first, inverse = np.unique(scene_ids[valid], return_index=True,
                                      return_inverse=True)
        owner[valid] = (first * world // n)[inverse]
    return owner


def shard_width(p_max: int, n_max: int, world: int) -> int:
    """Slots of a rank's row in `shard_scenes`: enough for any rank's part of
    a packed batch of at most `p_max` pedestrians in scenes of at most
    `n_max` (see `scene_owners`)."""
    return min(p_max, -(-p_max // world) + n_max)


def shard_scenes(batch: CollatedBatch, rank: int, world: int, width: int) -> CollatedBatch:
    """Rank `rank`'s whole scenes of a packed batch (`scene_owners`), in
    packing order, repacked from slot 0 into a row of `width` slots; each
    slot keeps its scene id. A rank without a scene gets a row of padding."""
    own = np.flatnonzero(scene_owners(batch.scene_ids, world) == rank)
    if len(own) > width:
        raise ValueError(f"rank {rank} holds {len(own)} pedestrians in {width} slots")
    obs = np.zeros((width,) + batch.obs.shape[1:], np.float32)
    pred = np.zeros((width,) + batch.pred.shape[1:], np.float32)
    valid = np.zeros((width,), bool)
    scene_ids = np.full((width,), -1, np.int32)
    non_linear = np.zeros((width,), np.float32)
    for dst, src in ((obs, batch.obs), (pred, batch.pred), (valid, batch.ped_valid),
                     (scene_ids, batch.scene_ids), (non_linear, batch.non_linear)):
        dst[:len(own)] = src[own]
    return CollatedBatch(obs, pred, valid, scene_ids, non_linear)


def slot_width(p_max: int, world: int) -> int:
    """Slots of a rank's part in `shard_slots`: ceil(p_max / world)."""
    return -(-p_max // world)


def shard_slots(batch: CollatedBatch, rank: int, world: int) -> CollatedBatch:
    """Rank `rank`'s contiguous range of a packed batch's P slots,
    [rank * m, (rank + 1) * m) with m = `slot_width(P, world)`, the last
    rank's padded past P: JAX's even split of the flat pedestrian axis. Each
    slot keeps its scene id; scenes may straddle two ranks."""
    p = batch.obs.shape[0]
    m = slot_width(p, world)
    lo, hi = min(rank * m, p), min((rank + 1) * m, p)
    obs = np.zeros((m,) + batch.obs.shape[1:], np.float32)
    pred = np.zeros((m,) + batch.pred.shape[1:], np.float32)
    valid = np.zeros((m,), bool)
    scene_ids = np.full((m,), -1, np.int32)
    non_linear = np.zeros((m,), np.float32)
    for dst, src in ((obs, batch.obs), (pred, batch.pred), (valid, batch.ped_valid),
                     (scene_ids, batch.scene_ids), (non_linear, batch.non_linear)):
        dst[:hi - lo] = src[lo:hi]
    return CollatedBatch(obs, pred, valid, scene_ids, non_linear)
