"""Predictor registry.

Each predictor module exports make_model(cfg), prepare(c_obs, obs_ori, aux),
finalize(output, aux) and BATCHING, as in `eigentrajectory_tpu/models`. The
port holds all ten: the sequenced ET-STGCNN, ET-SGCN, ET-DMRGCN,
ET-Graph-TERN (its live `GraphTERNLight` path), ET-GP-Graph-STGCNN,
ET-GP-Graph-SGCN and ET-Social-Implicit (`SocialImplicitLight`), and the
collated ET-PECNet, ET-LB-EBM and ET-AgentFormer.
"""
from __future__ import annotations

import importlib

_BASELINES = ("stgcnn", "sgcn", "dmrgcn", "graphtern", "gpgraphstgcnn", "gpgraphsgcn",
              "implicit", "pecnet", "lbebm", "agentformer")


def available_baselines():
    return _BASELINES


def get_baseline(name: str):
    """Resolve a predictor module by config name."""
    if name not in _BASELINES:
        raise KeyError(f"Unknown baseline '{name}'; available: {_BASELINES}")
    return importlib.import_module(f"{__name__}.{name}")
