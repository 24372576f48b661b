"""Serving API: raw observed trajectories in, multi-modal futures out.

The counterpart of `eigentrajectory_tpu/inference.py` on one device (the
JAX package's `mesh` argument is not ported). Each request is padded into a
block of scenes, one scene per row and `n_slots` slots a row (the largest
scene rounded up to a multiple of `bucket`), for the sequenced and the
collated predictors alike; the block goes through the ET facade; the requested pedestrians' coefficients are gathered from the block,
and the reconstruction tail, `ops.recon.fused_reconstruct` (the CUDA kernel
on the card, its plain version on the CPU), runs on those alone.

    predictor = ETPredictor.from_checkpoint(cfg, tag)          # on the card
    futures = predictor.predict(obs_traj, scene_ids)           # (S, N, t_pred, 2)
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .config import ExpConfig
from .etspace.facade import et_forward
from .ops.recon import fused_reconstruct
from .train.trainer import ETTorchTrainer


class ETPredictor:
    """Multi-modal trajectory predictor for one experiment on one device."""

    def __init__(self, trainer: ETTorchTrainer, bucket: int = 128):
        if trainer.et is None:
            raise RuntimeError("no ET parameters: load the trainer's checkpoint first")
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.bucket = bucket

    @classmethod
    def from_checkpoint(cls, cfg: ExpConfig, tag: str, bucket: int = 128,
                        datasets=None, device: str = "cuda") -> "ETPredictor":
        tr = ETTorchTrainer(cfg, tag=tag, datasets=datasets, device=device)
        tr.load_model()
        return cls(tr, bucket=bucket)

    @torch.no_grad()
    def predict(self, obs_traj: np.ndarray,
                scene_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """obs_traj: (N, t_obs, 2) world coordinates; scene_ids: (N,) ints
        grouping peds into scenes (one scene if None).
        Returns (num_samples, N, t_pred, 2) in the trainer's dtype (float32
        unless the trainer was made for float64)."""
        tr, cfg = self.trainer, self.cfg
        n = obs_traj.shape[0]
        if scene_ids is None:
            scene_ids = np.zeros(n, np.int32)
        # Each ped's scene row and its slot there, in request order.
        _, row, counts = np.unique(np.asarray(scene_ids), return_inverse=True,
                                   return_counts=True)
        n_slots = -(-int(counts.max()) // self.bucket) * self.bucket
        order = np.argsort(row, kind="stable")
        slot = np.empty(n, np.int64)
        slot[order] = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)
        flat = row * n_slots + slot

        b = len(counts)
        obs = np.zeros((b * n_slots, obs_traj.shape[1], 2), np.float32)
        valid = np.zeros(b * n_slots, bool)
        obs[flat] = obs_traj
        valid[flat] = True

        with record_function("serve.to_device"):
            obs_t = torch.from_numpy(obs.reshape(b, n_slots, -1, 2)).to(tr.device, tr.dtype)
            valid_t = torch.from_numpy(valid.reshape(b, n_slots)).to(tr.device)
            flat_t = torch.from_numpy(flat).to(tr.device)
        with record_function("serve.et_forward"):
            # One scene a row: a collated predictor's scene mask is all true
            # within the row (and cut to the valid slots by its pre-hook).
            aux = tr.make_aux(valid_t, torch.zeros_like(valid_t, dtype=torch.int32))
            coef = et_forward(tr.et, tr._predictor_fn, obs_t, valid_t, cfg.static_dist,
                              aux=aux, return_coefficients=True)
        # Only the requested rows are reconstructed, in request order: the
        # padded slots' coefficients stay behind.
        c_m, c_s, u_m, u_s, ori, rot, sca, mask = tr.recon_args(coef)
        c_m, c_s = c_m.index_select(1, flat_t), c_s.index_select(1, flat_t)
        ori, rot, sca, mask = (x.index_select(0, flat_t) for x in (ori, rot, sca, mask))
        with record_function("serve.reconstruct"):
            recon = fused_reconstruct(c_m, c_s, u_m, u_s, ori, rot, sca, mask)  # (S, n, T, 2)
        with record_function("serve.to_host"):
            return recon.cpu().numpy()
