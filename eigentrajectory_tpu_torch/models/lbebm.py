"""ET-LB-EBM: the LB-EBM predictor's predict path in ET coefficient space.

The counterpart of `eigentrajectory_tpu/models/lbebm.py::LBEBMPredict`:
past-MLP, destination MLP and predictor MLP, per pedestrian (no social
pooling on this path), over (B, N, .) rows. ET wiring: past_length = k // 2,
future_length = k * s // 2, so the predictor emits k * s values; the
scene-centred origin is the pseudo-destination. The EBM prior, the Langevin
sampler and the replay memory never run in the ET pipeline and are not
ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from .common import TorchMLP, zero_invalid
from .pecnet import finalize  # noqa: F401  (the same post-hook)

ENC_PAST_SIZE = (512, 256)
ENC_DEST_SIZE = (256, 128)
PREDICTOR_SIZE = (1024, 512, 256)
FDIM = 16


class LBEBMPredict(nn.Module):
    """LBEBM.predict over (B, N, .) rows."""

    def __init__(self, k: int, future_length: int, fdim: int = FDIM):
        super().__init__()
        self.encoder_past = TorchMLP(k, ENC_PAST_SIZE, fdim)
        self.encoder_dest = TorchMLP(2, ENC_DEST_SIZE, fdim)
        self.predictor = TorchMLP(2 * fdim, PREDICTOR_SIZE, 2 * future_length)

    def forward(self, past: torch.Tensor, generated_dest: torch.Tensor) -> torch.Tensor:
        feat = torch.cat([self.encoder_past(past), self.encoder_dest(generated_dest)], dim=-1)
        return self.predictor(feat)                          # (B, N, k * s)


def make_model(cfg) -> nn.Module:
    return LBEBMPredict(cfg.k, future_length=cfg.k * cfg.num_samples // 2)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, N), obs_ori (B, 2, N) -> (past (B, N, k),
    origin (B, N, 2)), zeroed at the invalid slots."""
    valid = aux["ped_valid"]
    past = zero_invalid(c_obs, valid, 2).detach().transpose(1, 2)
    ori = zero_invalid(obs_ori, valid, 2).detach().transpose(1, 2)
    return (past, ori)


BATCHING = "collated"
