"""The cases of `tests/test_torch_parallel.py`, as every rank of a gloo
group runs them (`spawned`), and as the single process runs them (`run`
with world 1). Imports nothing of JAX: a spawned rank loads the port only.

Each case builds its trainers from the seed (the descriptor fitted on rank
0 and broadcast), takes whole blocks or packed batches, lets the trainer
take this rank's part, and returns what the test compares: the step's
loss, gradients, BN statistics, the DropEdge masks this rank used, the
buffer this rank handed to the all-reduce, `test()`/`valid()` means and
`fit()` logs.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from eigentrajectory_tpu_torch import parallel
from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data.batching import pad_scenes
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from eigentrajectory_tpu_torch.train import trainer as trainer_module


def splits():
    return tuple(make_synthetic_data(n_scenes=n, max_peds=5, seed=seed)
                 for n, seed in ((10, 1), (6, 2), (6, 3)))


def trainer(baseline, world, tmp, tag="p", fit_descriptor=True, **kw):
    cfg = ExpConfig(**{**dict(baseline=baseline, batch_size=4, checkpoint_dir=str(tmp),
                              dataset="synthetic", static_dist=0.3, mesh_data_axis=world),
                       **kw})
    tr = ETTorchTrainer(cfg, tag=f"{tag}-w{world}", datasets=splits(), device="cpu")
    if fit_descriptor:
        tr.init_descriptor()
    return tr


class _Noting:
    """Records what the trainer hands the all-reduce and the DropEdge layers."""

    def __enter__(self):
        self.reduced, self.keeps = [], []
        self._reduce, self._set = parallel.all_reduce_sum_, trainer_module.set_edge_keeps

        def reduce(buf):
            self.reduced.append(buf.clone())
            return self._reduce(buf)

        def set_keeps(model, keeps):
            if keeps:
                self.keeps.append([k.clone() for k in keeps])
            return self._set(model, keeps)

        parallel.all_reduce_sum_, trainer_module.set_edge_keeps = reduce, set_keeps
        return self

    def __exit__(self, *exc):
        parallel.all_reduce_sum_, trainer_module.set_edge_keeps = self._reduce, self._set


def step(tr, batch):
    """One step's loss, gradients and BN statistics on the whole `batch`
    (this rank's part of it), the masks and the all-reduce buffer."""
    tr.model.train()
    with _Noting() as noted:
        args, part = tr.step_args(batch)
        loss = tr.loss_and_grads(*args, part=part)
    tr.model.eval()
    return {"loss": float(loss),
            "grads": {n: p.grad.clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.clone() for k, v in tr.model.state_dict().items() if "running_" in k},
            "reduced": noted.reduced, "keeps": noted.keeps,
            "dropout_state": tr.dropout_generator.get_state()}


def _weights(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


def run(world, tmp, th, chunks=()):
    """Every case at `world` ranks (this process's rank of them); `th` is
    the GP-Graph threshold the test chose on the block. For each k of
    `chunks` the two ET-STGCNN steps also run at micro_batches k
    (`stgcnn_full@k`, `stgcnn_tail@k`): the single process running the
    block in the rows that k ranks hold."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the same sums on every process
    try:
        # ET-STGCNN: a whole block and one whose last two rows are padding
        # (at world 2 rank 1, at world 4 ranks 2 and 3 hold padding alone).
        st = trainer("stgcnn", world, tmp)
        data = st.data_train
        out["stgcnn_full"] = step(st, pad_scenes(data, [0, 1, 2, 3], st.n_max, 4))
        out["stgcnn_tail"] = step(st, pad_scenes(data, [4, 5], st.n_max, 4))
        for k in chunks:
            ck = trainer("stgcnn", world, tmp, tag=f"chunks{k}", micro_batches=k)
            out[f"stgcnn_full@{k}"] = step(ck, pad_scenes(data, [0, 1, 2, 3], ck.n_max, 4))
            out[f"stgcnn_tail@{k}"] = step(ck, pad_scenes(data, [4, 5], ck.n_max, 4))
        out["stgcnn_test"] = st.test(eval_batch=4)
        out["stgcnn_valid"] = st.valid(0)

        # ET-PECNet, collated: whole scenes a rank.
        pe = trainer("pecnet", world, tmp, batch_size=16)
        batch = next(iter(pe.train_batches(0)))
        out["pecnet_step"] = step(pe, batch)
        out["pecnet_test"] = pe.test(eval_ped_batch=16)
        out["pecnet_valid"] = pe.valid(0)

        # ET-AgentFormer, collated and row-coupled, dropout on.
        af = trainer("agentformer", world, tmp, batch_size=16)
        out["agentformer_step"] = step(af, next(iter(af.train_batches(0))))

        # ET-DMRGCN with DropEdge on: a block of 8 rows, the last 3 padding.
        dm = trainer("dmrgcn", world, tmp, batch_size=8)
        out["dmrgcn_step"] = step(dm, pad_scenes(dm.data_train, [0, 1, 2, 3, 4], dm.n_max, 8))

        # ET-GP-Graph-STGCNN at micro_batches 4: 16 rows, the last 6 padding;
        # group_cnn's gradient is NaN and zeroed after the sum.
        gp = trainer("gpgraphstgcnn", world, tmp, batch_size=16, micro_batches=4)
        with torch.no_grad():
            gp.model.group_gen.th.fill_(th)
        out["gpgraph_step"] = step(gp, pad_scenes(gp.data_train, list(range(10)), gp.n_max, 16))
        gp.apply_gradients()
        out["gpgraph_weights"] = _weights(gp)

        # fit(2); fit(1) + resume to 2 at the same world.
        fit = trainer("stgcnn", world, tmp, tag="fit")
        fit.fit(2, verbose=False)
        out["fit_log"] = dict(fit.log)
        out["fit_weights"] = _weights(fit)
        once = trainer("stgcnn", world, tmp, tag="resume")
        once.fit(1, verbose=False, checkpoint_every=1)
        again = trainer("stgcnn", world, tmp, tag="resume", fit_descriptor=False)
        again.fit(2, verbose=False, resume=True)
        out["resume_log"] = dict(again.log)
        out["resume_weights"] = _weights(again)
    finally:
        torch.set_num_threads(threads)
    return out


def spawned(rank, world, init_file, tmp, th):
    """A rank of `torch.multiprocessing.spawn`: joins the gloo group at
    `init_file`, runs every case and saves its results as rank<r>.pt."""
    parallel.init_process_group(rank, world, f"file://{init_file}", device="cpu")
    try:
        torch.save(run(world, tmp, th), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        parallel.destroy()
