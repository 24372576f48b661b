"""Evaluation engine for the sequenced regime.

The counterpart of the evaluation half of
`eigentrajectory_tpu/train/trainer.py` (`ETJaxTrainer.load_model`, the
sequenced eval step and `test()`). Padded blocks of scenes go through the ET
facade with the scene axis written out; the coefficients are flattened to
one pedestrian axis and reconstructed, denormalized and scored by the fused
kernel of `ops/recon.py` (the CUDA kernel on the card, its plain version on
the CPU); COL is computed per scene.

Training (AdamW, masked-BN statistic updates, gradient accumulation) is not
ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from .. import metrics as M
from ..config import ExpConfig, resolve_dataset_dir
from ..data.batching import SceneBatcher
from ..data.dataset import load_trajectory_data
from ..etspace.descriptor import ETBasis
from ..etspace.facade import ETParams, et_forward
from ..interop import params_from_jax, read_flax_msgpack
from ..models import get_baseline
from ..ops.recon import fused_recon_metrics


class ETTorchTrainer:
    """Evaluation of one (baseline, dataset) experiment on one device.

    `datasets` = (train, val, test) TrajectoryData overrides loading the
    splits from `cfg.dataset_dir`. `device` defaults to the card; tests pass
    "cpu". `dtype` is the type of the weights and activations: float32, the
    only type the CUDA kernels take, or float64 on the CPU for a reference
    that f32 rounding does not reach.
    """

    def __init__(self, cfg: ExpConfig, tag: str = "EigenTrajectory-TPU",
                 datasets=None, device: str = "cuda", dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.tag = tag
        self.device = torch.device(device)
        self.dtype = dtype
        self.baseline = get_baseline(cfg.baseline)
        if self.baseline.BATCHING != "sequenced":
            raise NotImplementedError(
                f"the {self.baseline.BATCHING} regime is not ported yet")
        self.dataset_dir = resolve_dataset_dir(cfg.dataset_dir, cfg.dataset)
        self.checkpoint_dir = os.path.join(cfg.checkpoint_dir, tag, cfg.dataset)

        if datasets is not None:
            self.data_train, self.data_val, self.data_test = datasets
        else:
            self.data_train, self.data_val, self.data_test = (
                load_trajectory_data(os.path.join(self.dataset_dir, split),
                                     cfg.obs_len, cfg.pred_len, cfg.skip)
                for split in ("train", "val", "test"))

        self.n_max = cfg.n_max_peds or max(
            self.data_train.max_peds_per_scene,
            self.data_val.max_peds_per_scene,
            self.data_test.max_peds_per_scene,
        )
        self.model = self.baseline.make_model(cfg).to(self.device, dtype).eval()
        self.et: Optional[ETParams] = None

    # ---------------------------------------------------------------- eval
    def _predictor_fn(self, c_obs, obs_ori, aux):
        inputs = self.baseline.prepare(c_obs, obs_ori, aux)
        return self.baseline.finalize(self.model(*inputs), aux)

    def recon_args(self, coef):
        """The fused reconstruction's inputs (c_m, c_s, u_m, u_s, ori, rot,
        sca, mask) from `et_forward(..., return_coefficients=True)` over a
        (B, N) block, flattened to one pedestrian axis of B*N."""
        cfg, et = self.cfg, self.et
        b, _, n, _ = coef["c_pred_m"].shape
        # (B, k, N, S) -> (k, B*N, S)
        c_m, c_s = (coef[key].transpose(0, 1).reshape(cfg.k, b * n, cfg.num_samples)
                    .contiguous() for key in ("c_pred_m", "c_pred_s"))
        return (c_m, c_s, et.basis_m.U_pred, et.basis_s.U_pred,
                coef["norm_ori"].reshape(b * n, 2).contiguous(),
                coef["norm_rot"].reshape(b * n, 2, 2).contiguous(),
                coef["norm_sca"].reshape(b * n).contiguous(),
                coef["moving_mask"].reshape(b * n).contiguous())

    @torch.no_grad()
    def eval_step(self, obs: torch.Tensor, pred: torch.Tensor,
                  valid: torch.Tensor):
        """Per-ped metrics of one padded block of scenes.

        obs (B, N, obs_len, 2), pred (B, N, pred_len, 2), valid (B, N) on the
        trainer's device -> (ade, fde, tcc, col), each (B, N).
        """
        cfg = self.cfg
        b, n = valid.shape
        with record_function("eval.et_forward"):
            coef = et_forward(self.et, self._predictor_fn, obs, valid, cfg.static_dist,
                              return_coefficients=True)
        args = (*self.recon_args(coef), pred.reshape(b * n, cfg.pred_len, 2).contiguous())
        with record_function("eval.recon_metrics"):
            recon, ade, fde, tcc = fused_recon_metrics(*args)
        recon = recon.reshape(recon.shape[0], b, n, cfg.pred_len, 2).transpose(0, 1)
        with record_function("eval.col"):
            cols = M.col(recon, valid)
        return ade.reshape(b, n), fde.reshape(b, n), tcc.reshape(b, n), cols

    def test(self, eval_batch: int = 512) -> Dict[str, float]:
        """Mean min-of-S ADE/FDE/TCC/COL over the valid peds of the test split,
        `eval_batch` padded scenes at a time."""
        if self.et is None:
            raise RuntimeError("no ET parameters: call load_model() first")
        meters = {k: M.AverageMeter() for k in ("ADE", "FDE", "TCC", "COL")}
        for batch in SceneBatcher(self.data_test, eval_batch, False, self.n_max):
            with record_function("eval.to_device"):
                obs, pred = (torch.from_numpy(x).to(self.device, self.dtype)
                             for x in (batch.obs, batch.pred))
                valid = torch.from_numpy(batch.ped_valid).to(self.device)
            metrics = self.eval_step(obs, pred, valid)
            with record_function("eval.to_host"):
                res = torch.stack(metrics).cpu().numpy()
            for j, name in enumerate(("ADE", "FDE", "TCC", "COL")):
                meters[name].extend(res[j][batch.ped_valid])
        return {k: m.mean() for k, m in meters.items()}

    # --------------------------------------------------------- checkpoints
    def load_model(self, filename: str = "model_best.msgpack"):
        """Load predictor weights, BN statistics and ET parameters from the
        JAX package's checkpoint `checkpoint_dir/tag/dataset/filename`."""
        state, et = params_from_jax(read_flax_msgpack(
            os.path.join(self.checkpoint_dir, filename)))
        missing, unexpected = self.model.load_state_dict(state, strict=False)
        unused = getattr(self.model, "unused_prefixes", lambda: ())()
        missing = [k for k in missing if not k.startswith(unused)]
        if missing or unexpected:
            raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                           f"unexpected {unexpected}")
        to = lambda x: x.to(self.device, self.dtype).contiguous()
        self.et = ETParams(
            basis_m=ETBasis(*map(to, et.basis_m)), basis_s=ETBasis(*map(to, et.basis_s)),
            anchor_m=to(et.anchor_m), anchor_s=to(et.anchor_s))
