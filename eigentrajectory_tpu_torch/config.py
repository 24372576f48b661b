"""Typed experiment configuration.

A copy of `eigentrajectory_tpu/config.py` (that package's `__init__` imports
JAX). Field names and defaults mirror the reference JSON schema so the files
under `configs/` load unchanged through either package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

# Per-dataset static-distance thresholds (key "static_dist" of the reference
# configs).
STATIC_DIST = {
    "eth": 0.419,
    "hotel": 0.353,
    "univ": 0.227,
    "zara1": 0.338,
    "zara2": 0.35,
}


@dataclasses.dataclass
class ExpConfig:
    """Experiment hyper-parameters (same fields and defaults as the JAX package)."""

    dataset_dir: str = "./datasets/"
    checkpoint_dir: str = "./checkpoints/"

    dataset: str = "eth"
    traj_dim: int = 2
    obs_len: int = 8
    obs_step: int = 10
    pred_len: int = 12
    pred_step: int = 10
    skip: int = 1

    k: int = 6
    static_dist: float = 0.419
    num_samples: int = 20
    obs_svd: bool = True
    pred_svd: bool = True
    baseline: str = "stgcnn"

    batch_size: int = 128
    num_epochs: int = 256
    lr: float = 1e-3
    weight_decay: float = 1e-4
    clip_grad: Optional[float] = 10.0
    lr_schd: bool = True
    lr_schd_step: int = 64
    lr_schd_gamma: float = 0.5

    seed: int = 0
    n_max_peds: Optional[int] = None   # pad target; inferred from data if None
    mesh_data_axis: int = 1            # data-parallel shard count (1 = one card)
    use_pallas: bool = True            # kept so that the configs load; not
                                       # read: the tensors' device alone picks
                                       # the CUDA kernels or their plain versions
    micro_batches: int = 1             # training knobs, kept so configs load
    scan_chunks: int = 0
    warmup_epochs: int = 0
    wd_exclude: tuple = ()

    # Free-form per-baseline overrides.
    baseline_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ExpConfig":
        return dataclasses.replace(self, **kw)


def resolve_dataset_dir(dataset_dir: str, dataset: str) -> str:
    """Per-split data directory, `dataset_dir/<name>`. (The JAX package also
    falls back to a fixed reference mount; the port takes the directory the
    config names.)"""
    return os.path.join(dataset_dir, dataset)


def load_config(path: str, **overrides) -> ExpConfig:
    """Load a JSON config file (reference-schema compatible) into ExpConfig."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file {path} does not exist")
    with open(path) as f:
        raw = json.load(f)
    known = {f.name for f in dataclasses.fields(ExpConfig)}
    extra = {k: v for k, v in raw.items() if k not in known}
    kept = {k: v for k, v in raw.items() if k in known}
    cfg = ExpConfig(**kept)
    if extra:
        cfg.baseline_config.update(extra)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
