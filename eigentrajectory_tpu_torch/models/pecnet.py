"""ET-PECNet: the endpoint-conditioned MLP predictor in ET coefficient space.

The counterpart of the predict path of `eigentrajectory_tpu/models/pecnet.py`
(`PECNetPredict`): past-MLP encoder, destination MLP, three rounds of
non-local social pooling and the predictor MLP. The scene axis is written
out: a (B, N) block is B rows of N pedestrian slots, and the social pool
mixes the slots of a row under a (B, N, N) mask. A packed batch of the
collated regime is one row (B = 1) whose mask is block-diagonal by scene.

ET wiring: past_length = k // 2, so the encoder takes the k coefficients;
future_length = k * s // 2 + 1, so the predictor emits k * s values; the
scene-centred origin is both the "destination" and the initial position.

`PECNetCVAE`, the full CVAE forward with latent sampling, never runs in the
ET pipeline (neither package's trainer nor predictor reaches it); it is the
counterpart of the JAX package's dormant module, held against it by
tests/test_torch_dormant.py.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .common import TorchMLP, zero_invalid

# The widths of the JAX module (the reference's optimal.yaml).
ENC_PAST_SIZE = (512, 256)
ENC_DEST_SIZE = (8, 16)
ENC_LATENT_SIZE = (8, 50)
DEC_SIZE = (1024, 512, 1024)
PREDICTOR_SIZE = (1024, 512, 256)
NON_LOCAL_THETA = (256, 128, 64)
NON_LOCAL_PHI = (256, 128, 64)
NON_LOCAL_G = (256, 128, 64)
FDIM = 16
ZDIM = 16
SIGMA = 1.3
NON_LOCAL_DIM = 128
NONLOCAL_POOLS = 3


def _social_pool(theta: nn.Module, phi: nn.Module, g: nn.Module, feat: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """One round of non-local social pooling with residual, in the
    reference's composition: softmax over the WHOLE row of logits (masked
    slots included), then the mask, then an L1 renormalization with a 1e-12
    floor. A row whose mask is all zero returns its features unchanged.

    feat (B, N, F), mask (B, N, N) bool -> (B, N, F).
    """
    f = torch.bmm(theta(feat), phi(feat).transpose(1, 2))   # (B, N, N)
    w = torch.softmax(f, dim=-1) * mask.to(feat.dtype)
    w = w / torch.clamp_min(w.abs().sum(dim=-1, keepdim=True), 1e-12)
    return torch.bmm(w, g(feat)) + feat


class PECNetPredict(nn.Module):
    """PECNet.predict with social pooling, over (B, N, .) rows."""

    def __init__(self, k: int, future_length: int, fdim: int = FDIM):
        super().__init__()
        feat = 2 * fdim + 2
        self.encoder_past = TorchMLP(k, ENC_PAST_SIZE, fdim)
        self.encoder_dest = TorchMLP(2, ENC_DEST_SIZE, fdim)
        self.non_local_theta = TorchMLP(feat, NON_LOCAL_THETA, NON_LOCAL_DIM)
        self.non_local_phi = TorchMLP(feat, NON_LOCAL_PHI, NON_LOCAL_DIM)
        self.non_local_g = TorchMLP(feat, NON_LOCAL_G, feat)
        self.predictor = TorchMLP(feat, PREDICTOR_SIZE, 2 * (future_length - 1))

    def forward(self, past: torch.Tensor, generated_dest: torch.Tensor, mask: torch.Tensor,
                initial_pos: torch.Tensor) -> torch.Tensor:
        # past (B, N, k), generated_dest / initial_pos (B, N, 2), mask (B, N, N)
        feat = torch.cat([self.encoder_past(past), self.encoder_dest(generated_dest),
                          initial_pos], dim=-1)
        for _ in range(NONLOCAL_POOLS):
            feat = _social_pool(self.non_local_theta, self.non_local_phi,
                                self.non_local_g, feat, mask)
        return self.predictor(feat)                          # (B, N, k * s)


class PECNetCVAE(nn.Module):
    """The full PECNet CVAE forward over (N, .) pedestrians of one scene
    (or packed batch), as the JAX module takes them. Dormant: nothing in the
    ET pipeline calls it.

    train=True: the destination is encoded, a latent (mu, logvar) inferred,
    z = eps * exp(logvar / 2) + mu decoded into the destination, and the
    predictor runs on the socially pooled features; returns (generated_dest,
    mu, logvar, pred_future). train=False: z = eps * sigma, returns the
    generated destination. `eps` (N, zdim) is injected, or drawn from
    `generator` (on the inputs' device) where it is None.
    """

    def __init__(self, k: int, future_length: int, fdim: int = FDIM, zdim: int = ZDIM,
                 sigma: float = SIGMA):
        super().__init__()
        self.zdim, self.sigma = zdim, sigma
        feat = 2 * fdim + 2
        self.encoder_past = TorchMLP(k, ENC_PAST_SIZE, fdim)
        self.encoder_dest = TorchMLP(2, ENC_DEST_SIZE, fdim)
        self.encoder_latent = TorchMLP(2 * fdim, ENC_LATENT_SIZE, 2 * zdim)
        self.decoder = TorchMLP(fdim + zdim, DEC_SIZE, 2)
        self.non_local_theta = TorchMLP(feat, NON_LOCAL_THETA, NON_LOCAL_DIM)
        self.non_local_phi = TorchMLP(feat, NON_LOCAL_PHI, NON_LOCAL_DIM)
        self.non_local_g = TorchMLP(feat, NON_LOCAL_G, feat)
        self.predictor = TorchMLP(feat, PREDICTOR_SIZE, 2 * (future_length - 1))

    def forward(self, past: torch.Tensor, initial_pos: torch.Tensor,
                mask: Optional[torch.Tensor] = None, dest: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        # past (N, k), initial_pos / dest (N, 2), mask (N, N) bool
        ftraj = self.encoder_past(past)
        if train and (mask is None or dest is None):
            raise ValueError("train=True requires both `dest` and `mask`")
        if eps is None:
            eps = torch.randn((past.shape[0], self.zdim), generator=generator,
                              device=past.device, dtype=past.dtype)
        if train:
            latent = self.encoder_latent(torch.cat([ftraj, self.encoder_dest(dest)], dim=1))
            mu, logvar = latent[:, :self.zdim], latent[:, self.zdim:]
            z = eps * torch.exp(0.5 * logvar) + mu
        else:
            z = eps * self.sigma
        generated_dest = self.decoder(torch.cat([ftraj, z], dim=1))
        if not train:
            return generated_dest

        feat = torch.cat([ftraj, self.encoder_dest(generated_dest), initial_pos], dim=1)[None]
        for _ in range(NONLOCAL_POOLS):
            feat = _social_pool(self.non_local_theta, self.non_local_phi,
                                self.non_local_g, feat, mask[None])
        return generated_dest, mu, logvar, self.predictor(feat[0])


def make_model(cfg) -> nn.Module:
    return PECNetPredict(cfg.k, future_length=cfg.k * cfg.num_samples // 2 + 1)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, N), obs_ori (B, 2, N) -> (past (B, N, k),
    origin (B, N, 2), mask (B, N, N), origin), past and origin zeroed at the
    invalid slots, mask = scene mask & valid_i & valid_j."""
    valid = aux["ped_valid"]
    past = zero_invalid(c_obs, valid, 2).detach().transpose(1, 2)
    ori = zero_invalid(obs_ori, valid, 2).detach().transpose(1, 2)
    mask = aux["scene_mask"] & valid[:, :, None] & valid[:, None, :]
    return (past, ori, mask, ori)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, N, k * s) -> (B, k, N, s), by the JAX package's raw
    reshape to (N, k, s)."""
    b, n, nk = output_data.shape
    s = aux["num_samples"]
    return output_data.reshape(b, n, nk // s, s).transpose(1, 2)


BATCHING = "collated"
