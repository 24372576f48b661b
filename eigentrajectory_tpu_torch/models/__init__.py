"""Predictor registry.

Each predictor module exports make_model(cfg), prepare(c_obs, obs_ori, aux),
finalize(output, aux) and BATCHING, as in `eigentrajectory_tpu/models`. The
port holds the sequenced ET-STGCNN, ET-SGCN, ET-DMRGCN and ET-Graph-TERN
(its live `GraphTERNLight` path) and the collated ET-PECNet, ET-LB-EBM and
ET-AgentFormer so far; the other predictors follow in later slices.
"""
from __future__ import annotations

import importlib

_BASELINES = ("stgcnn", "sgcn", "dmrgcn", "graphtern", "pecnet", "lbebm", "agentformer")


def available_baselines():
    return _BASELINES


def get_baseline(name: str):
    """Resolve a predictor module by config name."""
    if name not in _BASELINES:
        raise KeyError(f"Unknown baseline '{name}'; available: {_BASELINES}")
    return importlib.import_module(f"{__name__}.{name}")
