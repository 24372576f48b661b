"""The one traffic generator: scenes of synthetic walkers, and the requests
of a traffic mix, from `--seed`.

Walkers move as the program's synthetic data makes them (a start drawn
N(0, 5^2), a velocity N(0, 1) times 0.4 a step and a wiggle of cumulated
N(0, 0.05^2) steps). The sizes of the scenes are the same for every seed:
the multiset that those data draw from `counts_seed`, put in another order
by each seed, so that every seed carries the same work. A traffic file
names the sizes (`pool` or `split`: scenes, min_peds, max_peds,
counts_seed) and, for requests, their sizes (`scenes_per_request`, a
sequence drawn once from `schedule_seed`, the same for every seed).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

OBS_LEN, PRED_LEN = 8, 12

# Independent streams drawn from one seed.
STREAM_ORDER, STREAM_WALKERS, STREAM_REQUESTS, STREAM_CHECKS = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def drawn_counts(n_scenes: int, min_peds: int, max_peds: int, counts_seed: int) -> np.ndarray:
    """The pedestrians of each scene as the program's synthetic data draw
    them from `counts_seed` (each scene's count, then its walkers, from one
    stream)."""
    g = np.random.default_rng(counts_seed)
    counts = []
    for _ in range(n_scenes):
        n = int(g.integers(min_peds, max_peds + 1))
        g.normal(size=(n, 1, 2)), g.normal(size=(n, 1, 2)), g.normal(size=(n, OBS_LEN + PRED_LEN, 2))
        counts.append(n)
    return np.asarray(counts)


class Scenes(NamedTuple):
    obs: np.ndarray       # (N, OBS_LEN, 2) float32, scene by scene
    pred: np.ndarray      # (N, PRED_LEN, 2) float32
    counts: np.ndarray    # (scenes,) pedestrians of each scene
    starts: np.ndarray    # (scenes + 1,) first pedestrian of each scene, then N

    def peds(self, scenes: Sequence[int]) -> np.ndarray:
        """The pedestrians of `scenes`, scene after scene."""
        counts = self.counts[scenes]
        first = np.repeat(self.starts[scenes] - (np.cumsum(counts) - counts), counts)
        return first + np.arange(counts.sum())


def make_scenes(sizes: dict, seed: int) -> Scenes:
    """The scenes of a `pool` or `split` entry of a traffic file, from `seed`."""
    counts = drawn_counts(sizes["scenes"], sizes["min_peds"], sizes["max_peds"],
                          sizes["counts_seed"])
    counts = rng(seed, STREAM_ORDER).permutation(counts)
    n = int(counts.sum())
    g = rng(seed, STREAM_WALKERS)
    start = g.normal(size=(n, 1, 2)) * 5
    vel = g.normal(size=(n, 1, 2))
    wiggle = 0.05 * np.cumsum(g.normal(size=(n, OBS_LEN + PRED_LEN, 2)), axis=1)
    t = np.arange(OBS_LEN + PRED_LEN)[None, :, None]
    traj = (start + vel * t * 0.4 + wiggle).astype(np.float32)
    return Scenes(np.ascontiguousarray(traj[:, :OBS_LEN]), np.ascontiguousarray(traj[:, OBS_LEN:]),
                  counts, np.concatenate([[0], np.cumsum(counts)]))


def request_sizes(traffic: dict, n_requests: int) -> np.ndarray:
    """Scenes of each of the first `n_requests` requests: uniform over
    `scenes_per_request` [lo, hi], drawn from `schedule_seed`, the same
    sequence for every seed."""
    lo, hi = traffic["scenes_per_request"]
    return np.random.default_rng(traffic["schedule_seed"]).integers(lo, hi + 1, n_requests)


def request_scenes(sizes: np.ndarray, n_scenes: int, seed: int) -> List[np.ndarray]:
    """The scenes of each request, drawn without replacement from the pool."""
    g = rng(seed, STREAM_REQUESTS)
    return [g.choice(n_scenes, int(s), replace=False) for s in sizes]
