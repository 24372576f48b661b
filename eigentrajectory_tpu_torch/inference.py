"""Serving API: raw observed trajectories in, multi-modal futures out.

The counterpart of `eigentrajectory_tpu/inference.py`. Each request is
padded into a block of scenes, one scene per row and `n_slots` slots a row
(the largest scene rounded up to a multiple of `bucket`), for the sequenced
and the collated predictors alike; the block goes through the ET facade;
the requested pedestrians' coefficients are gathered from the block, and
the reconstruction tail, `ops.recon.fused_reconstruct` (the CUDA kernel on
the card, its plain version on the CPU), runs on those alone.

With `mesh` (a list of devices, `parallel.make_mesh()`), one replica of the
model and the ET parameters sits on each entry, the block's rows are split
into as many contiguous ranges, each range runs on its device (all are
enqueued before any result is read, so the cards run together) and the
futures are gathered back in request order. A device may be named twice.

    predictor = ETPredictor.from_checkpoint(cfg, tag)          # on the card
    futures = predictor.predict(obs_traj, scene_ids)           # (S, N, t_pred, 2)
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import ExpConfig
from .etspace.descriptor import ETBasis
from .etspace.facade import ETParams, et_forward
from .ops.recon import fused_reconstruct
from .train.trainer import ETTorchTrainer
from .utils.profiling import count, span


class ETPredictor:
    """Multi-modal trajectory predictor for one experiment, on the trainer's
    device or spread over the devices of `mesh` (replicas of the trainer's
    weights as they are when the predictor is made)."""

    def __init__(self, trainer: ETTorchTrainer, bucket: int = 128,
                 mesh: Optional[Sequence] = None):
        if trainer.et is None:
            raise RuntimeError("no ET parameters: load the trainer's checkpoint first")
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.bucket = bucket
        self.mesh: Optional[List[torch.device]] = None
        # (predictor function, ET parameters, device) of each replica.
        self._replicas = [(trainer._predictor_fn, trainer.et, trainer.device)]
        if mesh is not None:
            self.mesh = [torch.device(d) for d in mesh]
            self._replicas = [self._replica(d) for d in self.mesh]

    def _replica(self, device: torch.device):
        tr = self.trainer
        with torch.random.fork_rng(devices=[]):
            model = tr.baseline.make_model(tr.cfg)
        model.load_state_dict(tr.model.state_dict())
        model = model.to(device, tr.dtype).eval()
        base = tr.baseline

        def predictor_fn(c_obs, obs_ori, aux):
            return base.finalize(model(*base.prepare(c_obs, obs_ori, aux)), aux)

        to = lambda x: x.to(device)
        et = ETParams(ETBasis(*map(to, tr.et.basis_m)), ETBasis(*map(to, tr.et.basis_s)),
                      to(tr.et.anchor_m), to(tr.et.anchor_s))
        return predictor_fn, et, device

    @classmethod
    def from_checkpoint(cls, cfg: ExpConfig, tag: str, bucket: int = 128,
                        datasets=None, device: str = "cuda",
                        mesh: Optional[Sequence] = None) -> "ETPredictor":
        tr = ETTorchTrainer(cfg, tag=tag, datasets=datasets, device=device)
        tr.load_model()
        return cls(tr, bucket=bucket, mesh=mesh)

    @torch.no_grad()
    def predict(self, obs_traj: np.ndarray,
                scene_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """obs_traj: (N, t_obs, 2) world coordinates; scene_ids: (N,) ints
        grouping peds into scenes (one scene if None).
        Returns (num_samples, N, t_pred, 2) in the trainer's dtype (float32
        unless the trainer was made for float64)."""
        tr = self.trainer
        n = obs_traj.shape[0]
        if scene_ids is None:
            scene_ids = np.zeros(n, np.int32)
        with span("serve.pad"):
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
        count("serve.slots_valid", n)
        count("serve.slots_padded", b * n_slots)

        parts = []
        for replica, rows in zip(self._replicas, np.array_split(np.arange(b), len(self._replicas))):
            if len(rows):
                lo, hi = int(rows[0]), int(rows[-1]) + 1
                peds = np.flatnonzero((row >= lo) & (row < hi))
                parts.append((peds, self._forward(replica, obs, valid, flat[peds], lo, hi,
                                                  n_slots)))
        with span("serve.to_host"):
            if len(parts) == 1:
                return parts[0][1].cpu().numpy()
            out = np.empty((self.cfg.num_samples, n, self.cfg.pred_len, 2),
                           parts[0][1].cpu().numpy().dtype)
            for peds, recon in parts:
                out[:, peds] = recon.cpu().numpy()
            return out

    def _forward(self, replica, obs: np.ndarray, valid: np.ndarray, flat: np.ndarray,
                 lo: int, hi: int, n_slots: int) -> torch.Tensor:
        """Futures (S, len(flat), T, 2) on the replica's device of the
        pedestrians at `flat` (slots of the whole block) from rows
        [lo, hi) of the padded block."""
        tr, cfg = self.trainer, self.cfg
        predictor_fn, et, device = replica
        rows = slice(lo * n_slots, hi * n_slots)
        with span("serve.to_device"):
            obs_t = torch.from_numpy(obs[rows].reshape(hi - lo, n_slots, -1, 2)).to(device,
                                                                                      tr.dtype)
            valid_t = torch.from_numpy(valid[rows].reshape(hi - lo, n_slots)).to(device)
            flat_t = torch.from_numpy(flat - lo * n_slots).to(device)
        with span("serve.et_forward"):
            # One scene a row: a collated predictor's scene mask is all true
            # within the row (and cut to the valid slots by its pre-hook).
            aux = tr.make_aux(valid_t, torch.zeros_like(valid_t, dtype=torch.int32))
            coef = et_forward(et, predictor_fn, obs_t, valid_t, cfg.static_dist,
                              aux=aux, return_coefficients=True)
        # Only the requested rows are reconstructed, in request order: the
        # padded slots' coefficients stay behind.
        with span("serve.gather"):
            c_m, c_s, u_m, u_s, ori, rot, sca, mask = tr.recon_args(coef, et)
            c_m, c_s = c_m.index_select(1, flat_t), c_s.index_select(1, flat_t)
            ori, rot, sca, mask = (x.index_select(0, flat_t) for x in (ori, rot, sca, mask))
        with span("serve.reconstruct"):
            return fused_reconstruct(c_m, c_s, u_m, u_s, ori, rot, sca, mask)  # (S, n, T, 2)
