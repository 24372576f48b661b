"""Training and evaluation engine for both batching regimes.

The counterpart of `eigentrajectory_tpu/train/trainer.py` (`ETJaxTrainer`).

* sequenced (ET-STGCNN, ET-SGCN, ET-DMRGCN, ET-Graph-TERN,
  ET-GP-Graph-STGCNN, ET-GP-Graph-SGCN, ET-Social-Implicit): padded blocks
  of scenes go through the ET facade with the scene axis written out. The
  step loss is the sum over the block's scenes of the three per-scene
  losses (non-finite ones zeroed, padding scenes weighted 0) divided by
  `cfg.batch_size`; the epoch loss is the sum of the step losses over the
  number of scenes. `cfg.micro_batches` > 1 accumulates the gradient over
  chunks of the block; the result equals the whole-block step, the
  masked-BN statistics and the DropEdge draws included.
* collated (ET-PECNet, ET-LB-EBM, ET-AgentFormer): whole scenes are packed
  into flat batches of about `cfg.batch_size` pedestrians, padded to `p_max`
  slots, and go through the facade as one row (B = 1) with a block-diagonal
  scene mask. The step loss is one masked mean over the valid pedestrians
  of the packed batch (non-finite -> 0), with no division by the batch
  size; the epoch loss is the sum of the step losses over the number of
  batches. Training and validation centre the origins over the whole packed
  batch, as the reference's collated training does; `test()` centres them
  per scene.

Every step's gradient goes through the JAX trainer's optimizer chain in the
same order: NaN entries zeroed, global-norm clip as optax writes it, AdamW
with decoupled decay, the learning rate keyed on the epoch.

Evaluation: the coefficients are flattened to one pedestrian axis and
reconstructed, denormalized and scored by the fused kernel of `ops/recon.py`
(the CUDA kernel on the card, its plain version on the CPU), once a block or
packed batch; COL is computed per scene (a packed batch's scenes are
gathered into (G, m) blocks first).

Dropout and DropEdge draw from the trainer's own generator
(`dropout_generator`, seeded from `cfg.seed` on the trainer's device), never
from torch's global stream, so a run is made by its seed and a resumed run
continues it. DropEdge's masks are drawn once a step for the whole block,
one row a scene, as the JAX trainer splits one key a scene from the step's.

`save_model` writes `model_best.msgpack` in the JAX package's format, so
either package loads it. The resume state (`resume.pt`) is the port's own:
an optax state tree and a JAX key mean nothing to `torch.optim`.

Data parallelism (`cfg.mesh_data_axis` = n > 1, in a process group of n
ranks, `parallel.init_process_group`): a run over n ranks computes what the
single-device run computes. Every rank holds the whole split, draws the
same batches and takes its part on the host (`data.batching`):
* sequenced: a contiguous range of each block's scene rows
  (`cfg.batch_size` % n == 0). The step loss already divides by the full
  batch size, so the ranks' losses and gradients add up to the block's;
* collated: whole scenes of each packed batch, in a row of their own,
  centred on the whole batch's origin (`etspace.facade.row_center`) and
  weighted by their share of its valid pedestrians. A predictor whose
  training forward couples the scenes of a row (`ROW_SPLIT = "slots"`:
  ET-AgentFormer's attention spans the packed batch) takes a contiguous
  range of the row's slots instead (`data.batching.shard_slots`, ceil(P /
  n) a rank), centred and weighted the same way, and its forward gets the
  rank's `parallel.SlotShard` in `aux`: its queries stay local and each
  attention gathers every rank's keys (`parallel.all_gather_rows`, whose
  backward sums each rank's part of the gradient over the ranks).
Each rank's gradients, its BN statistics (updated from the pre-step ones,
weighted by its valid scenes, as the micro-batches are) and its loss go
through one all-reduce (`train.all_reduce`) before the optimizer, so NaN
entries are zeroed, the norm clipped and AdamW applied on the global
gradient. DropEdge and Dropout draw what the single process draws: every
rank draws the whole block's masks from the same stream and takes its
rows (ET-AgentFormer's dropouts draw the whole row's token masks and take
the rank's tokens). Only that split training forward makes collectives in
the model: `valid()`, `test()` and a run of one rank go through whole
rows. `valid()` and `test()` split the blocks' rows
(sequenced) or deal the packed batches to the ranks (collated) and sum
(value, count) over the ranks. Rank 0 fits the descriptor and broadcasts
it, and writes the checkpoints and the log; every rank loads.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import metrics as M
from .. import parallel
from ..config import ExpConfig, resolve_dataset_dir
from ..data.batching import (CollatedBatcher, SceneBatcher, max_collated_peds, scene_gather,
                             shard_rows, shard_scenes, shard_slots, shard_width)
from ..data.dataset import augment_trajectory, load_trajectory_data
from ..etspace.descriptor import ETBasis
from ..etspace.facade import ETParams, calculate_parameters, et_forward, row_center
from ..interop import (jax_param_paths, params_from_jax, params_to_jax, read_flax_msgpack,
                       write_flax_msgpack)
from ..models import get_baseline
from ..models.common import draw_edge_keeps, set_dropout_generator, set_edge_keeps
from ..ops.col import fused_col
from ..ops.recon import fused_recon_metrics
from ..utils.profiling import StepTimer, count, span, tracing


class StepPart(NamedTuple):
    """A rank's part of a collated step besides its tensors: its weight in
    the step loss, the whole packed row's centre (None: its own row's), and
    the row's slots where the rank holds a range of them (`shard_slots`;
    None: whole scenes)."""

    weight: float
    center: Optional[torch.Tensor] = None
    slots: Optional[int] = None


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles containers and numbers only: any class lookup raises."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"log.pkl holds {module}.{name}: only a dict of "
                                     f"lists of floats is read")


def read_log(fp) -> Dict[str, List[float]]:
    """The loss log that either package writes as `log.pkl`: a dict of two
    lists of floats ("train_loss", "val_loss"). It is read without admitting
    any class, so a file holding anything else raises."""
    log = _PlainUnpickler(fp).load()
    if not (isinstance(log, dict) and set(log) == {"train_loss", "val_loss"}
            and all(isinstance(v, list) and all(isinstance(x, float) for x in v)
                    for v in log.values())):
        raise pickle.UnpicklingError("log.pkl is not a dict of two lists of floats")
    return log


class ETTorchTrainer:
    """Training and evaluation of one (baseline, dataset) experiment on one
    device, or on one rank of a data-parallel run.

    `datasets` = (train, val, test) TrajectoryData overrides loading the
    splits from `cfg.dataset_dir`. `device` defaults to the card; tests pass
    "cpu". `dtype` is the type of the weights and activations: float32, the
    only type the CUDA kernels take, or float64 on the CPU for a reference
    that f32 rounding does not reach. The initial weights, the k-means draws
    of `init_descriptor` and the dropout draws come from `cfg.seed`.

    `cfg.mesh_data_axis` > 1 needs a process group of that many ranks
    (`parallel.init_process_group`); the rank's device is the group's
    (`device` names only its type). With `mesh_data_axis` 1 the trainer
    runs alone, in a process group or not.
    """

    def __init__(self, cfg: ExpConfig, tag: str = "EigenTrajectory-TPU",
                 datasets=None, device: str = "cuda", dtype: torch.dtype = torch.float32):
        self.rank, self.world = 0, 1
        if cfg.mesh_data_axis > 1:
            group = parallel.current()
            if group is None or group.world != cfg.mesh_data_axis:
                found = "none" if group is None else f"one of {group.world} ranks"
                raise ValueError(
                    f"mesh_data_axis = {cfg.mesh_data_axis} needs a process group of as many "
                    f"ranks (torchrun --nproc_per_node={cfg.mesh_data_axis}, or "
                    f"parallel.init_process_group); found {found}")
            if torch.device(device).type != group.device.type:
                raise ValueError(f"device {device} asked for, the process group runs on "
                                 f"{group.device}")
            self.rank, self.world, device = group.rank, group.world, group.device
        self.cfg = cfg
        self.tag = tag
        self.device = torch.device(device)
        self.dtype = dtype
        self.baseline = get_baseline(cfg.baseline)
        self.collated = self.baseline.BATCHING == "collated"
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
        if self.collated:
            # Slots of a packed train or val batch.
            self.p_max = max(max_collated_peds(self.data_train, cfg.batch_size),
                             max_collated_peds(self.data_val, cfg.batch_size), self.n_max)
            # A rank takes whole scenes, in a row of p_shard slots, or a range
            # of the row's slots where the predictor couples a row's scenes
            # in training.
            self.split_slots = getattr(self.baseline, "ROW_SPLIT", "scenes") == "slots"
            self.p_shard = shard_width(self.p_max, self.n_max, self.world)
        elif cfg.batch_size % self.world:
            raise ValueError(f"the sequenced regime splits a block's scenes over the ranks: "
                             f"batch_size {cfg.batch_size} is not divisible by "
                             f"mesh_data_axis {self.world}")
        self.log: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        # Optional per-step wall-clock meter (set by fit()); it measures the
        # enqueue of a step, not its device time: train() does not wait for
        # the device inside the loop.
        self.step_timer: Optional[StepTimer] = None
        # A CPU generator, whatever the device: see etspace/anchor.py.
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = self.baseline.make_model(cfg)
        # Train mode only inside train(): no evaluation moves the BN statistics.
        self.model = model.to(self.device, dtype).eval()
        set_dropout_generator(self.model, self.dropout_generator)
        self.optimizer = self._make_optimizer()
        # The parameters the JAX tree holds (the layers built and never
        # called have no counterpart there): each gets a gradient every step.
        unused = getattr(self.model, "unused_prefixes", lambda: ())()
        self._called = [p for n, p in self.model.named_parameters() if not n.startswith(unused)]
        self.et: Optional[ETParams] = None

    def _make_optimizer(self) -> torch.optim.AdamW:
        """AdamW as optax.adamw(lr, weight_decay): betas 0.9/0.999, eps 1e-8,
        decoupled decay, no decay on the parameters whose JAX path holds a
        string of `cfg.wd_exclude`."""
        cfg, paths = self.cfg, jax_param_paths(self.model)
        decay, no_decay = [], []
        for name, param in self.model.named_parameters():
            path = paths.get(name, name.replace(".", "/"))
            excluded = any(sub in path for sub in cfg.wd_exclude)
            (no_decay if excluded else decay).append(param)
        groups = [{"params": decay, "weight_decay": cfg.weight_decay}]
        if no_decay:
            groups.append({"params": no_decay, "weight_decay": 0.0})
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)

    def _to_device(self, batch):
        """(obs, pred, ped_valid, scene_valid) of a SceneBatch on the device,
        or (obs, pred, ped_valid, scene_ids) of a CollatedBatch as one row
        (a leading axis of 1)."""
        if self.collated:
            obs, pred = (torch.from_numpy(x[None]).to(self.device, self.dtype)
                         for x in (batch.obs, batch.pred))
            valid, ids = (torch.from_numpy(x[None]).to(self.device)
                          for x in (batch.ped_valid, batch.scene_ids))
            return obs, pred, valid, ids
        obs, pred = (torch.from_numpy(x).to(self.device, self.dtype)
                     for x in (batch.obs, batch.pred))
        valid, scene_valid = (torch.from_numpy(x).to(self.device)
                              for x in (batch.ped_valid, batch.scene_valid))
        return obs, pred, valid, scene_valid

    def step_args(self, batch):
        """This rank's part of a train batch: the arguments of
        `loss_and_grads` / `train_step` on the device (as `_to_device`
        gives them) and its `StepPart` (None, but for a collated rank of a
        data-parallel run)."""
        if self.world == 1:
            return self._to_device(batch), None
        if not self.collated:
            return self._to_device(shard_rows(batch, self.rank, self.world)), None
        if self.split_slots:
            own = shard_slots(batch, self.rank, self.world)
        else:
            own = shard_scenes(batch, self.rank, self.world, self.p_shard)
        obs = torch.from_numpy(batch.obs[None]).to(self.device, self.dtype)
        center = row_center(obs, torch.from_numpy(batch.ped_valid[None]).to(self.device))
        share = int(own.ped_valid.sum()) / max(int(batch.ped_valid.sum()), 1)
        return self._to_device(own), StepPart(share, center,
                                              batch.obs.shape[0] if self.split_slots else None)

    def make_aux(self, valid: torch.Tensor, scene_info: torch.Tensor) -> Dict:
        """The predictor's extra inputs for a (B, N) block with validity
        `valid`, as the JAX trainer's aux template holds them: the number of
        samples, the scene id of each slot (B, N) and the scene mask
        (B, N, N), true where both slots hold the same scene and neither is
        padding (-1). Collated: `scene_info` holds the scene ids. Sequenced:
        it holds the scenes' validity (B,), and each row is one scene (ids
        0)."""
        ids = scene_info if self.collated else torch.zeros_like(valid, dtype=torch.int32)
        return {"num_samples": self.cfg.num_samples, "scene_ids": ids,
                "scene_mask": (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0)}

    # ----------------------------------------------------------- descriptor
    def init_descriptor(self):
        """One-time ET descriptor and anchor fit over the train and val splits
        (flip-augmented); in a data-parallel run rank 0 fits and broadcasts
        the parameters and the k-means generator's state."""
        et = None
        if self.rank == 0:
            obs = np.concatenate([self.data_train.obs_traj, self.data_val.obs_traj], axis=0)
            pred = np.concatenate([self.data_train.pred_traj, self.data_val.pred_traj], axis=0)
            obs, pred = augment_trajectory(obs, pred)
            et = calculate_parameters(self.generator, obs, pred, self.cfg.k,
                                      self.cfg.num_samples, self.cfg.static_dist,
                                      device=self.device)
        if self.world > 1:
            cpu = None if et is None else ETParams(
                ETBasis(*(x.cpu() for x in et.basis_m)), ETBasis(*(x.cpu() for x in et.basis_s)),
                et.anchor_m.cpu(), et.anchor_s.cpu())
            et, state = parallel.broadcast_object((cpu, self.generator.get_state()))
            self.generator.set_state(state)
        self._set_et(et)

    def _set_et(self, et: ETParams):
        to = lambda x: x.to(self.device, self.dtype).contiguous()
        self.et = ETParams(
            basis_m=ETBasis(*map(to, et.basis_m)), basis_s=ETBasis(*map(to, et.basis_s)),
            anchor_m=to(et.anchor_m), anchor_s=to(et.anchor_s))

    # ---------------------------------------------------------- train steps
    def _chunk_loss(self, obs, pred, valid, scene_info,
                    part: Optional[StepPart] = None) -> torch.Tensor:
        """The share of the step loss of one chunk.

        Sequenced (`scene_info` = scene validity (B,)): per-scene losses,
        non-finite ones zeroed, padding scenes weighted 0, summed and divided
        by the FULL cfg.batch_size, so that the chunks' (and the ranks')
        gradients add up to the whole block's. Collated (`scene_info` = scene
        ids (1, P)): the losses of the one packed row, a masked mean over its
        valid pedestrians, non-finite -> 0; a rank's `part` of a packed batch
        is weighted by its share and left as it is (the all-reduce zeroes a
        step whose summed loss is not finite); a part that holds a range of
        the row's slots hands the predictor its `parallel.SlotShard`.
        """
        aux = self.make_aux(valid, scene_info)
        if part is not None and part.center is not None:
            aux["row_center"] = part.center
        if part is not None and part.slots is not None:
            aux["slot_shard"] = parallel.SlotShard(self.rank, self.world, part.slots)
        out = et_forward(self.et, self._predictor_fn, obs, valid, self.cfg.static_dist,
                         pred_traj=pred, aux=aux)
        losses = (out["loss_eigentraj"] + out["loss_euclidean_ade"]
                  + out["loss_euclidean_fde"])                               # (B,)
        if part is not None:
            return losses.sum() * part.weight
        losses = torch.nan_to_num(losses, nan=0.0, posinf=0.0, neginf=0.0)
        if self.collated:
            return losses.sum()
        return (losses * scene_info.to(losses.dtype)).sum() / self.cfg.batch_size

    def _chunk_backward(self, obs, pred, valid, scene_info, part=None) -> torch.Tensor:
        """Add one chunk's gradient to `.grad`; returns its share of the loss."""
        with span("train.forward"):
            loss = self._chunk_loss(obs, pred, valid, scene_info, part)
        with span("train.backward"):
            loss.backward()
        return loss.detach()

    def loss_and_grads(self, obs, pred, valid, scene_info,
                       edge_keeps: Optional[List[torch.Tensor]] = None,
                       part: Optional[StepPart] = None) -> torch.Tensor:
        """Step loss of one block or packed batch, as `_to_device` gives it
        (a 0-dim tensor on the device), with its gradient left in the
        parameters' `.grad` and the BN statistics moved once. The model must
        be in train mode.

        A parameter the forward does not reach (Social-Implicit's `noise_w`)
        gets a zero gradient, as `jax.grad` gives it, not None: the
        optimizer then decays it as optax does.

        A model with DropEdge gets its masks for the whole block, one
        (B, R, T, N, N) mask a DropEdge layer, drawn here once a step from
        `dropout_generator` (`common.draw_edge_keeps`) unless `edge_keeps`
        brings them (on any device), and each chunk takes its rows: a
        scene's draws and the generator's state after the step do not depend
        on `micro_batches`.

        With `cfg.micro_batches` > 1 a sequenced block goes through in
        chunks. Every chunk starts from the pre-step BN statistics, and the
        chunks' updated statistics are averaged by their counts of valid
        scenes. The collated regime ignores `micro_batches`, as the JAX
        trainer does.

        On a rank of a data-parallel run the arguments are its part
        (`step_args`), `edge_keeps` the whole block's masks, and the loss,
        gradients and BN statistics left behind are the whole step's
        (`_all_reduce`).
        """
        m = self.cfg.micro_batches
        self.optimizer.zero_grad(set_to_none=True)
        keeps = []
        if self.model.training:
            # A sequenced rank holds rows [rank * b, (rank + 1) * b) of the block.
            b = obs.shape[0]
            sharded = self.world > 1 and not self.collated
            keeps = draw_edge_keeps(self.model, self.dropout_generator,
                                    b * self.world if sharded else b, obs.shape[1]) \
                if edge_keeps is None else [k.to(self.device) for k in edge_keeps]
            if sharded:
                keeps = [k[self.rank * b:(self.rank + 1) * b] for k in keeps]
        try:
            if m <= 1 or self.collated:
                set_edge_keeps(self.model, keeps)
                loss = self._chunk_backward(obs, pred, valid, scene_info, part)
                self._zero_missing_grads()
                if self.world > 1:
                    weight = torch.ones((), device=self.device) if self.collated else \
                        scene_info.sum()
                    loss = self._all_reduce(loss, weight)
                return loss

            if obs.shape[0] % m:
                raise ValueError("the block's scenes must be divisible by micro_batches")
            stats = list(self.model.buffers())
            pre = [b.clone() for b in stats]
            acc = [torch.zeros_like(b) for b in stats]
            total = wsum = 0.0
            for i, chunk in enumerate(zip(*(x.chunk(m) for x in (obs, pred, valid, scene_info)))):
                for b, p in zip(stats, pre):
                    b.copy_(p)
                set_edge_keeps(self.model, [k.chunk(m)[i] for k in keeps])
                total = total + self._chunk_backward(*chunk)
                n_valid = chunk[3].sum().to(self.dtype)
                for a, b in zip(acc, stats):
                    a.add_(b * n_valid)
                wsum = wsum + n_valid
            for a, b in zip(acc, stats):
                b.copy_(a / torch.clamp_min(wsum, 1.0))
            self._zero_missing_grads()
            return self._all_reduce(total, wsum) if self.world > 1 else total
        finally:
            set_edge_keeps(self.model, None)

    def _zero_missing_grads(self):
        for p in self._called:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def _all_reduce(self, loss: torch.Tensor, n_scenes: torch.Tensor) -> torch.Tensor:
        """Sum the ranks' gradients, losses and BN statistics in one
        all-reduce. A rank's statistics are its update from the pre-step
        ones, weighted by its `n_scenes` valid scenes (0 for a rank of
        padding scenes); the sum is divided by all ranks' valid scenes, as
        one forward over the block weights them. The gradients are summed
        before any NaN entry is zeroed, as the single process zeroes the
        summed entry. A collated step whose summed loss is not finite gets
        zero gradients and loss 0, as the single process's nan_to_num of the
        batch's loss gives. Returns the step's loss."""
        with span("train.all_reduce"):
            grads = [p.grad for p in self._called]
            stats = list(self.model.buffers())
            w = n_scenes.to(loss.dtype).reshape(1)
            flat = torch.cat([g.reshape(-1) for g in grads] + [(b * w).reshape(-1) for b in stats]
                             + [w, loss.detach().reshape(1)])
            parallel.all_reduce_sum_(flat)
            n_grad = sum(g.numel() for g in grads)
            if self.collated:
                keep = torch.isfinite(flat[-1])
                flat[:n_grad] = torch.where(keep, flat[:n_grad], 0.0)
                flat[-1] = torch.where(keep, flat[-1], 0.0)
            parts = flat.split([g.numel() for g in grads] + [b.numel() for b in stats] + [1, 1])
            for g, new in zip(grads, parts):
                g.copy_(new.view_as(g))
            wsum = torch.clamp_min(parts[-2], 1.0)
            for b, new in zip(stats, parts[len(grads):]):
                b.copy_(new.view_as(b) / wsum)
            return parts[-1].reshape(())

    def apply_gradients(self):
        """One optimizer update from the gradients in `.grad`, in optax's
        order: NaN entries -> 0 (NaN only, as optax.zero_nans), global-norm
        clip at cfg.clip_grad as optax.clip_by_global_norm (scaled by
        max_norm / norm only where norm >= max_norm; no epsilon), AdamW."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        for g in grads:
            torch.nan_to_num_(g, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
        max_norm = self.cfg.clip_grad
        if max_norm is not None and grads:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()

    def train_step(self, obs, pred, valid, scene_info,
                   part: Optional[StepPart] = None) -> torch.Tensor:
        """One training step on a block or packed batch on the device (a
        rank's part of it, `step_args`); returns the step loss as a 0-dim
        tensor, without waiting for the device."""
        loss = self.loss_and_grads(obs, pred, valid, scene_info, part=part)
        with span("train.optimizer"):
            self.apply_gradients()
        return loss

    # -------------------------------------------------------------- epochs
    def _epoch_lr(self, epoch: int) -> float:
        """StepLR keyed on the epoch, with a linear warm-up."""
        lr = self.cfg.lr
        if self.cfg.lr_schd:
            lr = lr * (self.cfg.lr_schd_gamma ** (epoch // self.cfg.lr_schd_step))
        if self.cfg.warmup_epochs > 0:
            lr = lr * min(1.0, (epoch + 1) / self.cfg.warmup_epochs)
        return lr

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def train_batches(self, epoch: int):
        """The shuffled train batches of `epoch`: padded blocks of scenes, or
        packed batches with the incomplete last one dropped."""
        cfg = self.cfg
        if self.collated:
            return CollatedBatcher(self.data_train, cfg.batch_size, True, self.p_max,
                                   drop_last=True, seed=cfg.seed + epoch)
        return SceneBatcher(self.data_train, cfg.batch_size, True, self.n_max,
                            seed=cfg.seed + epoch)

    def train(self, epoch: int) -> float:
        """One epoch over the shuffled train split; returns and logs the sum
        of the step losses over the number of scenes (sequenced) or of
        batches (collated). The losses stay on the device and are read once,
        at the end, in step order."""
        if self.et is None:
            raise RuntimeError("no ET parameters: call init_descriptor() first")
        self._set_lr(self._epoch_lr(epoch))
        self.model.train()
        losses = []
        for batch in self.train_batches(epoch):
            with span("train.to_device"):
                args, part = self.step_args(batch)
            ctx = (self.step_timer.measure() if self.step_timer is not None
                   else contextlib.nullcontext())
            with ctx:
                # Alone (part None) the call is the single-device one.
                losses.append(self.train_step(*args) if part is None else
                              self.train_step(*args, part=part))
        self.model.eval()
        total = 0.0
        for loss in torch.stack(losses).cpu().tolist():
            total += loss
        avg = total / max(1, len(losses) if self.collated else self.data_train.num_scenes)
        self.log["train_loss"].append(avg)
        return avg

    @torch.no_grad()
    def valid(self, epoch: int) -> float:
        """Validation loss: sum over the val scenes (packed batches) of (mean
        min-of-S FDE * valid pedestrians) over the split's pedestrians, in
        eval mode. A data-parallel rank takes its rows of each block
        (sequenced) or every world-th packed batch (collated), and the ranks'
        sums are added."""
        self.model.eval()
        parts = []
        cfg = self.cfg
        batches = (CollatedBatcher(self.data_val, cfg.batch_size, False, self.p_max)
                   if self.collated else
                   SceneBatcher(self.data_val, cfg.batch_size, False, self.n_max))
        for batch in self._own(batches):
            obs, pred, valid, scene_info = self._to_device(batch)
            out = et_forward(self.et, self._predictor_fn, obs, valid, cfg.static_dist,
                             pred_traj=pred, aux=self.make_aux(valid, scene_info))
            n = valid.sum(dim=1).to(self.dtype)
            weight = n if self.collated else n * scene_info.to(self.dtype)
            parts.append((out["loss_euclidean_fde"] * weight).sum())
        total = 0.0
        for part in (torch.stack(parts).cpu().tolist() if parts else ()):
            total += part
        if self.world > 1:
            total = self._sum_over_ranks([total])[0]
        val = total / max(1, int(self.data_val.num_peds_in_seq.sum()))
        self.log["val_loss"].append(val)
        return val

    def fit(self, num_epochs: Optional[int] = None, verbose: bool = True,
            resume: bool = False, checkpoint_every: int = 0):
        """Training loop with best-val checkpointing.

        `resume=True` restores the full training state from `resume.pt`
        (starting at epoch 0 where there is none); `checkpoint_every` writes
        that state every so many epochs.
        """
        num_epochs = num_epochs or self.cfg.num_epochs
        verbose = verbose and self.rank == 0
        start_epoch = self.load_resume_state() if resume else 0
        self.epoch_timer = StepTimer()
        self.step_timer = StepTimer()
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            with self.epoch_timer.measure():
                with span("train.epoch"):
                    self.train(epoch)
                with span("valid.epoch"):
                    self.valid(epoch)
            if epoch == 0 or self.log["val_loss"][-1] < min(self.log["val_loss"][:-1]):
                self.save_model()
            if checkpoint_every and (epoch + 1) % checkpoint_every == 0:
                self.save_resume_state(epoch + 1)
            if verbose:
                print(f"[{self.cfg.dataset}/{self.cfg.baseline}] epoch {epoch} "
                      f"train {self.log['train_loss'][-1]:.6f} "
                      f"val {self.log['val_loss'][-1]:.6f} "
                      f"best {min(self.log['val_loss']):.6f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        if verbose and self.epoch_timer.durations:
            ep, st = self.epoch_timer.summary(), self.step_timer.summary()
            print(f"[timing] epochs: mean {ep['mean_s']:.3f}s p50 {ep['p50_s']:.3f}s "
                  f"p90 {ep['p90_s']:.3f}s max {ep['max_s']:.3f}s | "
                  f"train steps ({st.get('count', 0)}): mean {st.get('mean_s', 0):.4f}s "
                  f"p50 {st.get('p50_s', 0):.4f}s p90 {st.get('p90_s', 0):.4f}s",
                  flush=True)

    # ---------------------------------------------------------------- eval
    def _predictor_fn(self, c_obs, obs_ori, aux):
        inputs = self.baseline.prepare(c_obs, obs_ori, aux)
        return self.baseline.finalize(self.model(*inputs), aux)

    def recon_args(self, coef, et: Optional[ETParams] = None):
        """The fused reconstruction's inputs (c_m, c_s, u_m, u_s, ori, rot,
        sca, mask) from `et_forward(..., return_coefficients=True)` over a
        (B, N) block, flattened to one pedestrian axis of B*N (the bases of
        `et`, by default the trainer's)."""
        cfg, et = self.cfg, self.et if et is None else et
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
        with span("eval.et_forward"):
            coef = et_forward(self.et, self._predictor_fn, obs, valid, cfg.static_dist,
                              return_coefficients=True)
        args = (*self.recon_args(coef), pred.reshape(b * n, cfg.pred_len, 2).contiguous())
        with span("eval.recon_metrics"):
            recon, ade, fde, tcc = fused_recon_metrics(*args)          # recon (S, B*N, T, 2)
        with span("eval.col"):
            cols = fused_col(recon, valid)
        return ade.reshape(b, n), fde.reshape(b, n), tcc.reshape(b, n), cols

    @torch.no_grad()
    def packed_eval_step(self, obs: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor,
                         scene_ids: torch.Tensor, gather: torch.Tensor, gmask: torch.Tensor,
                         inv_g: torch.Tensor, inv_i: torch.Tensor):
        """Per-ped metrics of one packed batch (collated regime).

        obs (1, P, obs_len, 2), pred (1, P, pred_len, 2), valid and scene_ids
        (1, P), as `_to_device` gives them, and the scene maps of
        `data.batching.scene_gather` (gather, gmask (G, m); inv_g, inv_i
        (P,)), all on the trainer's device -> (ade, fde, tcc, col), each (P,).

        The reference evaluates one scene a forward, so the origins are
        centred per scene here (`center_scene_ids`), and an attention
        predictor is told to keep to each scene (`isolate_scenes`). COL runs
        on the (G, m) blocks of the batch's scenes (the kernel reads them
        through `gather`), not on the flat (P, P) pairs, and is scattered
        back to the slots.
        """
        cfg = self.cfg
        p = valid.shape[1]
        aux = self.make_aux(valid, scene_ids)
        aux["center_scene_ids"] = scene_ids
        aux["isolate_scenes"] = True
        with span("eval.et_forward"):
            coef = et_forward(self.et, self._predictor_fn, obs, valid, cfg.static_dist,
                              aux=aux, return_coefficients=True)
        args = (*self.recon_args(coef), pred.reshape(p, cfg.pred_len, 2).contiguous())
        with span("eval.recon_metrics"):
            recon, ade, fde, tcc = fused_recon_metrics(*args)          # recon (S, P, T, 2)
        with span("eval.col"):
            col = fused_col(recon, gmask, gather)[inv_g, inv_i]
        return ade, fde, tcc, col

    def _own(self, batches):
        """This rank's part of eval batches: its rows of each block
        (sequenced) or every world-th packed batch (collated)."""
        if self.world == 1:
            return iter(batches)
        if self.collated:
            return itertools.islice(batches, self.rank, None, self.world)
        return (shard_rows(b, self.rank, self.world) for b in batches)

    def _sum_over_ranks(self, values: List[float]) -> List[float]:
        buf = torch.tensor(values, dtype=torch.float64, device=self.device)
        return parallel.all_reduce_sum_(buf).tolist()

    def _test_batches(self, eval_batch: int, eval_ped_batch: Optional[int]):
        if not self.collated:
            return self._own(SceneBatcher(self.data_test, eval_batch, False, self.n_max))
        if eval_ped_batch is None:
            # Attention over every token grows with P^2; such a predictor
            # caps its packed size.
            eval_ped_batch = getattr(self.baseline, "EVAL_PED_CAP", 2048)
        return self._own(CollatedBatcher(self.data_test, eval_ped_batch, False,
                                         max_collated_peds(self.data_test, eval_ped_batch)))

    def test(self, eval_batch: int = 512,
             eval_ped_batch: Optional[int] = None) -> Dict[str, float]:
        """Mean min-of-S ADE/FDE/TCC/COL over the valid peds of the test split:
        `eval_batch` padded scenes at a time (sequenced), or whole scenes
        packed greedily to `eval_ped_batch` pedestrians (collated; by default
        the predictor's `EVAL_PED_CAP`, else 2048). A data-parallel rank
        evaluates its part (`eval_batch` divisible by the ranks), and the
        means are of the sums and counts over all ranks."""
        if self.et is None:
            raise RuntimeError("no ET parameters: call load_model() or init_descriptor() first")
        self.model.eval()
        meters = {k: M.AverageMeter() for k in ("ADE", "FDE", "TCC", "COL")}
        for batch in self._test_batches(eval_batch, eval_ped_batch):
            if tracing():
                count("eval.slots_valid", batch.ped_valid.sum())
                count("eval.slots_padded", batch.ped_valid.size)
            with span("eval.to_device"):
                args = self._to_device(batch)
                if self.collated:
                    args = (*args, *(torch.from_numpy(x).to(self.device)
                                     for x in scene_gather(batch.scene_ids)))
            metrics = self.packed_eval_step(*args) if self.collated else self.eval_step(*args[:3])
            with span("eval.to_host"):
                res = torch.stack(metrics).cpu().numpy()
            with span("eval.meters"):
                for j, name in enumerate(("ADE", "FDE", "TCC", "COL")):
                    meters[name].extend(res[j][batch.ped_valid])
        if self.world == 1:
            return {k: m.mean() for k, m in meters.items()}
        sums = [float(np.concatenate(m.data).astype(np.float64).sum()) if m.data else 0.0
                for m in meters.values()]
        *sums, peds = self._sum_over_ranks(sums + [float(len(meters["ADE"]) if
                                                         meters["ADE"].data else 0)])
        return {k: v / max(peds, 1.0) for k, v in zip(meters, sums)}

    # --------------------------------------------------------- checkpoints
    def save_model(self, filename: str = "model_best.msgpack"):
        """Write the predictor's weights, the BN statistics and the ET
        parameters in the JAX package's checkpoint format (float32), and the
        loss log beside it as `log.pkl`, a dict of two lists of floats (rank
        0 of a data-parallel run; the others wait for it)."""
        if self.rank == 0:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            write_flax_msgpack(os.path.join(self.checkpoint_dir, filename),
                               params_to_jax(self.model, self.et))
            self._save_log()
        self._barrier()

    def _barrier(self):
        if self.world > 1:
            parallel.barrier()

    def _save_log(self):
        with open(os.path.join(self.checkpoint_dir, "log.pkl"), "wb") as fp:
            pickle.dump(self.log, fp)

    def save_resume_state(self, epoch: int, filename: str = "resume.pt"):
        """Full training state for crash recovery: weights, BN statistics, ET
        parameters, optimizer moments and step counts, the states of the
        k-means and the dropout generators, the epoch to go on from and the
        loss log. Rank 0 writes it: the ranks' states are the same."""
        if self.rank != 0:
            self._barrier()
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        state = {
            "model": self.model.state_dict(),
            "et": {"basis_m": tuple(self.et.basis_m), "basis_s": tuple(self.et.basis_s),
                   "anchor_m": self.et.anchor_m, "anchor_s": self.et.anchor_s},
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            "dropout_generator": self.dropout_generator.get_state(),
            "epoch": epoch,
            "log": self.log,
        }
        torch.save(state, os.path.join(self.checkpoint_dir, filename))
        self._save_log()
        self._barrier()

    def load_resume_state(self, filename: str = "resume.pt") -> int:
        """Restore the full training state; returns the epoch to resume from
        (0, and nothing restored, where the file does not exist)."""
        path = os.path.join(self.checkpoint_dir, filename)
        if not os.path.exists(path):
            return 0
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        et = state["et"]
        self._set_et(ETParams(ETBasis(*et["basis_m"]), ETBasis(*et["basis_s"]),
                              et["anchor_m"], et["anchor_s"]))
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())
        if "dropout_generator" in state:
            self.dropout_generator.set_state(state["dropout_generator"].cpu())
        # else: a file written before the dropout stream was saved, by a model
        # that draws no dropout; the freshly seeded generator gives its run.
        self.log = state["log"]
        return int(state["epoch"])

    def load_model(self, filename: str = "model_best.msgpack"):
        """Load predictor weights, BN statistics and ET parameters from the
        checkpoint `checkpoint_dir/tag/dataset/filename`, written by either
        package, and the loss log `log.pkl` beside it where there is one, so
        that a later `fit()` judges its best epoch against the loaded one."""
        self.load_state(*params_from_jax(read_flax_msgpack(
            os.path.join(self.checkpoint_dir, filename))))
        log_path = os.path.join(self.checkpoint_dir, "log.pkl")
        if os.path.exists(log_path):
            with open(log_path, "rb") as fp:
                self.log = read_log(fp)

    def load_state(self, state: Dict[str, torch.Tensor], et: ETParams):
        """Load a predictor state dict that must fill every parameter and
        statistic the model calls, and the ET parameters."""
        missing, unexpected = self.model.load_state_dict(state, strict=False)
        unused = getattr(self.model, "unused_prefixes", lambda: ())()
        missing = [k for k in missing if not k.startswith(unused)]
        if missing or unexpected:
            raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                           f"unexpected {unexpected}")
        self._set_et(et)
