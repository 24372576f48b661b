"""The reference end to end: observed scenes in, S futures per pedestrian
out, and the published metrics of them; scene by scene, unpadded, grouped
by size so that scenes of one size run together.

The model is the configuration's `model` module of this package; its
weights and ET parameters come from the configuration's checkpoint file,
read here.
"""
from __future__ import annotations

import importlib
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import etspace, metrics
from .checkpoint import read_checkpoint


def checkpoint_path(config: Dict, root: str) -> str:
    exp = config["experiment"]
    return os.path.join(root, config["checkpoint_dir"], config["tag"], exp["dataset"],
                        "model_best.msgpack")


def model_module(config: Dict):
    """The reference module of the configuration's model."""
    return importlib.import_module(f"{__package__}.{config['model']}")


def scene_flops(config: Dict, n: int) -> int:
    """Operations of the model and the ET space on one scene of n
    pedestrians, at the configuration's sizes."""
    exp = config["experiment"]
    return (model_module(config).flops(n, exp["k"], exp["num_samples"])
            + etspace.et_flops(n, exp["k"], exp["num_samples"], exp["obs_len"], exp["pred_len"]))


class Reference:
    """The configuration's model in `dtype` on `device`."""

    def __init__(self, config: Dict, root: str, dtype: torch.dtype, device):
        tree = read_checkpoint(checkpoint_path(config, root))
        self.model = model_module(config).Model(tree, dtype, device)
        self.et = etspace.et_params(tree, dtype, device)
        self.static_dist = config["experiment"]["static_dist"]
        self.dtype, self.device = dtype, device

    @torch.no_grad()
    def futures(self, obs: np.ndarray) -> torch.Tensor:
        """obs (G, n, t_obs, 2) float32 scenes of n -> futures (G, S, n, t_pred, 2)."""
        obs32 = torch.from_numpy(obs).to(self.device)
        mask = etspace.moving_mask(obs32, self.static_dist)
        c_obs, ori, p = etspace.predictor_inputs(self.et, obs32.to(self.dtype), mask)
        return etspace.futures(self.et, self.model(c_obs, ori), p, mask)


def by_size(counts: np.ndarray, scenes: Sequence[int]) -> Dict[int, List[int]]:
    """Positions in `scenes` of the scenes of each size."""
    groups: Dict[int, List[int]] = {}
    for i, s in enumerate(scenes):
        groups.setdefault(int(counts[s]), []).append(i)
    return groups


def scene_futures(ref: Reference, obs: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                  scenes: Sequence[int]) -> List[np.ndarray]:
    """The futures (S, n, t_pred, 2) as float64 of each of `scenes` (pool
    indices), in their order."""
    out: List[np.ndarray] = [None] * len(scenes)
    for n, pos in by_size(counts, scenes).items():
        group = np.stack([obs[starts[scenes[i]]:starts[scenes[i]] + n] for i in pos])
        fut = ref.futures(group).double().cpu().numpy()
        for j, i in enumerate(pos):
            out[i] = fut[j]
    return out


def scene_metrics(ref: Reference, obs: np.ndarray, pred: np.ndarray, starts: np.ndarray,
                  counts: np.ndarray, scenes: Sequence[int]) -> List[Dict[str, np.ndarray]]:
    """`metrics.evaluate` of each of `scenes`, as float64 NumPy: per
    pedestrian (n,) and per sample (S, n)."""
    out: List[Dict[str, np.ndarray]] = [None] * len(scenes)
    for n, pos in by_size(counts, scenes).items():
        idx = [starts[scenes[i]] for i in pos]
        group_obs = np.stack([obs[s:s + n] for s in idx])
        gt = torch.from_numpy(np.stack([pred[s:s + n] for s in idx])).to(ref.device, ref.dtype)
        res = metrics.evaluate(ref.futures(group_obs), gt)
        res = {k: v.double().cpu().numpy() for k, v in res.items()}
        for j, i in enumerate(pos):
            out[i] = {k: v[j] for k, v in res.items()}
    return out
