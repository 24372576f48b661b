"""ET-LB-EBM: the LB-EBM predictor's predict path in ET coefficient space.

The counterpart of `eigentrajectory_tpu/models/lbebm.py::LBEBMPredict`:
past-MLP, destination MLP and predictor MLP, per pedestrian (no social
pooling on this path), over (B, N, .) rows. ET wiring: past_length = k // 2,
future_length = k * s // 2, so the predictor emits k * s values; the
scene-centred origin is the pseudo-destination.

The EBM prior, its Langevin sampler, the replay memory and the CVAE train
branch (`LBEBMCVAE`, `ReplayMemory`) never run in the ET pipeline (neither
package's trainer nor predictor reaches them); they are the counterparts of
the JAX package's dormant modules, held against them by
tests/test_torch_dormant.py. The JAX sampler is a `lax.fori_loop` of
`jax.grad` through the energy; here it is a loop of `torch.autograd.grad`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import TorchMLP, zero_invalid
from .pecnet import _social_pool
from .pecnet import finalize  # noqa: F401  (the same post-hook)

ENC_PAST_SIZE = (512, 256)
ENC_DEST_SIZE = (256, 128)
PREDICTOR_SIZE = (1024, 512, 256)
FDIM = 16

# The dormant path's widths and sampler settings (the JAX module's).
ENC_LATENT_SIZE = (256, 512)
DEC_SIZE = (1024, 512, 1024)
NON_LOCAL_THETA = (256, 128, 64)
NON_LOCAL_PHI = (256, 128, 64)
NON_LOCAL_G = (256, 128, 64)
NON_LOCAL_DIM = 128
NONLOCAL_POOLS = 3
ZDIM = 16
SIGMA = 1.3
NY = 1
EBM_HIDDEN = 200
E_PRIOR_SIG = 2.0
E_INIT_SIG = 2.0
E_L_STEPS = 20
E_L_STEP_SIZE = 0.4


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


class ReplayMemory:
    """Persistent-chain buffer: a ring of past Langevin chains, sampled
    uniformly without replacement to warm-start the next chain."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.memory: list = []
        self.position = 0

    def push(self, z_row) -> None:
        if len(self.memory) < self.capacity:
            self.memory.append(None)
        self.memory[self.position] = np.asarray(z_row)
        self.position = (self.position + 1) % self.capacity

    def sample(self, rng: np.random.Generator, n: int = 100) -> np.ndarray:
        idx = rng.choice(len(self.memory), size=n, replace=False)
        # Rows are pushed as (1, zdim) chunks: concatenated, not stacked.
        return np.concatenate([self.memory[i] for i in idx], axis=0)

    def __len__(self) -> int:
        return len(self.memory)


class LBEBMCVAE(nn.Module):
    """The full LB-EBM forward over (N, .) pedestrians, as the JAX module
    takes them. Dormant: nothing in the ET pipeline calls it.

    z_e is drawn from the EBM prior by Langevin dynamics from `z_e_0` (a
    fresh E_INIT_SIG * N(0, I) draw where it is None). train=False decodes
    the destination from z_e. train=True reparameterizes z_g from the CVAE
    posterior and returns (generated_dest, mu, logvar, pred_future, cd,
    en_pos, en_neg). `mask` (N, N) turns on the social pooling of the past
    features. Every draw not injected (`z_e_0`, `eps`, the Langevin noise)
    comes from `generator`, on the inputs' device.

    The EBM head is three bare (in, out) kernels and biases named as the JAX
    module's parameters (`EBM_layers_{0,1,2}_{kernel,bias}`).
    """

    def __init__(self, k: int, future_length: int, fdim: int = FDIM, zdim: int = ZDIM):
        super().__init__()
        self.zdim = zdim
        self.encoder_past = TorchMLP(k, ENC_PAST_SIZE, fdim)
        self.encoder_dest = TorchMLP(2, ENC_DEST_SIZE, fdim)
        self.encoder_latent = TorchMLP(2 * fdim, ENC_LATENT_SIZE, 2 * zdim)
        self.decoder = TorchMLP(fdim + zdim, DEC_SIZE, 2)
        self.predictor = TorchMLP(2 * fdim, PREDICTOR_SIZE, 2 * future_length)
        self.non_local_theta = TorchMLP(fdim, NON_LOCAL_THETA, NON_LOCAL_DIM)
        self.non_local_phi = TorchMLP(fdim, NON_LOCAL_PHI, NON_LOCAL_DIM)
        self.non_local_g = TorchMLP(fdim, NON_LOCAL_G, fdim)
        dims = (zdim + fdim, EBM_HIDDEN, EBM_HIDDEN, NY)
        for i in range(3):
            kernel = torch.randn(dims[i], dims[i + 1]) / dims[i] ** 0.5   # LeCun normal
            self.register_parameter(f"EBM_layers_{i}_kernel", nn.Parameter(kernel))
            self.register_parameter(f"EBM_layers_{i}_bias",
                                    nn.Parameter(torch.zeros(dims[i + 1])))

    def ebm_energy(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """(N,) negative log-sum-exp of the EBM head at [z, cond]; the
        condition is detached."""
        x = torch.cat([z, cond.detach()], dim=1)
        for i in range(3):
            x = x @ getattr(self, f"EBM_layers_{i}_kernel") + getattr(self, f"EBM_layers_{i}_bias")
            if i < 2:
                x = F.gelu(x, approximate="none")
        return -torch.logsumexp(x, dim=1)

    def sample_langevin_prior_z(self, z0: torch.Tensor, cond: torch.Tensor,
                                with_noise: bool = True,
                                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """E_L_STEPS steps of z <- z - s^2 / 2 (dE/dz + z / sig^2) [+ s eps]
        under the energy and the Gaussian prior; the result is detached, and
        no gradient reaches the EBM's parameters from here."""
        s = E_L_STEP_SIZE
        z, cond = z0.detach(), cond.detach()
        with torch.enable_grad():
            for _ in range(E_L_STEPS):
                z = z.detach().requires_grad_(True)
                (grad,) = torch.autograd.grad(self.ebm_energy(z, cond).sum(), z)
                z = z.detach() - 0.5 * s * s * (grad + z.detach() / E_PRIOR_SIG ** 2)
                if with_noise:
                    z = z + s * torch.randn(z.shape, generator=generator, device=z.device,
                                            dtype=z.dtype)
        return z.detach()

    def forward(self, past: torch.Tensor, dest: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, z_e_0: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None, train: bool = False,
                langevin_noise: bool = True, generator: Optional[torch.Generator] = None):
        # past (N, k), dest (N, 2), mask (N, N) bool
        ftraj = self.encoder_past(past)
        if mask is not None:
            feat = ftraj[None]
            for _ in range(NONLOCAL_POOLS):
                feat = _social_pool(self.non_local_theta, self.non_local_phi,
                                    self.non_local_g, feat, mask[None])
            ftraj = feat[0]

        def draw(scale):
            return scale * torch.randn((past.shape[0], self.zdim), generator=generator,
                                       device=past.device, dtype=past.dtype)

        if z_e_0 is None:
            z_e_0 = draw(E_INIT_SIG)
        z_e_k = self.sample_langevin_prior_z(z_e_0, ftraj, with_noise=langevin_noise,
                                             generator=generator)
        if not train:
            return self.decoder(torch.cat([ftraj, z_e_k], dim=1))
        if dest is None:
            raise ValueError("train=True requires `dest`")

        latent = self.encoder_latent(torch.cat([ftraj, self.encoder_dest(dest)], dim=1))
        mu, logvar = latent[:, :self.zdim], latent[:, self.zdim:]
        if eps is None:
            eps = draw(1.0)
        z_g_k = eps * torch.exp(0.5 * logvar) + mu
        generated_dest = self.decoder(torch.cat([ftraj, z_g_k], dim=1))
        pred_future = self.predictor(
            torch.cat([ftraj, self.encoder_dest(generated_dest)], dim=1))
        en_pos = self.ebm_energy(z_g_k, ftraj).mean()
        en_neg = self.ebm_energy(z_e_k, ftraj).mean()
        return (generated_dest, mu, logvar, pred_future, en_pos - en_neg, en_pos, en_neg)


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
