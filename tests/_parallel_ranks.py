"""The cases of `tests/test_torch_parallel.py`, as every rank of a gloo
group runs them (`spawned`), and as the single process runs them (`run`
with world 1). Imports nothing of JAX: a spawned rank loads the port only.

Each case builds its trainers from the seed (the descriptor fitted on rank
0 and broadcast), takes whole blocks or packed batches, lets the trainer
take this rank's part, and returns what the test compares: the step's
loss, gradients, BN statistics, the DropEdge masks this rank used, the
buffer this rank handed to the all-reduce, ET-AgentFormer's score tensors'
shapes, `test()`/`valid()` means and `fit()` logs. A spawned rank also
holds `parallel.all_gather_rows` and `SlotShard.gather` against what one
process stacks (`gather_case`), and runs its slots of a small
AgentFormerLight with `conn_dist` on (`model_case`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from eigentrajectory_tpu_torch import parallel
from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data.batching import CollatedBatcher, pad_scenes
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.models.agentformer import AgentAwareAttention, AgentFormerLight
from eigentrajectory_tpu_torch.models.common import set_dropout_generator
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


def step(tr, batch, train=True):
    """One step's loss, gradients and BN statistics on the whole `batch`
    (this rank's part of it), the masks, the all-reduce buffer and the
    shapes (B, H, L, S) of the attention score tensors, in train mode (or
    in eval mode: dropout off)."""
    scores = []
    hooks = [m.dropout.register_forward_hook(lambda mod, inp, out: scores.append(inp[0].shape))
             for m in tr.model.modules() if isinstance(m, AgentAwareAttention)]
    tr.model.train(train)
    start = tr.dropout_generator.get_state()
    try:
        with _Noting() as noted:
            args, part = tr.step_args(batch)
            loss = tr.loss_and_grads(*args, part=part)
    finally:
        tr.model.eval()
        for h in hooks:
            h.remove()
    return {"loss": float(loss), "scores": scores, "slots": args[0].shape[1],
            "valid": int(args[2].sum()),
            "grads": {n: p.grad.clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.clone() for k, v in tr.model.state_dict().items() if "running_" in k},
            "reduced": noted.reduced, "keeps": noted.keeps,
            "dropout_state": tr.dropout_generator.get_state(), "dropout_start": start}


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

        # ET-AgentFormer, the packed row's 19 slots split over the ranks
        # (15 valid: at world 4 rank 3 holds padding alone), dropout on and
        # off; then 7 valid of 19 (world 2: rank 1, world 4: ranks 2 and 3
        # hold padding alone), dropout on.
        af = trainer("agentformer", world, tmp, batch_size=15)
        batch = next(iter(af.train_batches(0)))
        out["agentformer_step"] = step(af, batch)
        out["agentformer_off"] = step(af, batch, train=False)
        few = next(iter(CollatedBatcher(af.data_train, 4, False, af.p_max)))
        out["agentformer_padding"] = step(af, few)

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


GATHER_SLOTS = 5        # at world 4: two slots a rank, rank 3's all past the row's end


def gather_inputs(world, t_len=3, width=4):
    """What every rank draws for `gather_case`: each rank's (2, 5, 3) block
    and its weights on the stacked (world, 2, 5, 3), and a row of
    GATHER_SLOTS slots' time-major tokens (2, t_len * GATHER_SLOTS, width)."""
    rng = np.random.default_rng(7)
    blocks = rng.normal(size=(world, 2, 5, 3)).astype(np.float32)
    weights = rng.normal(size=(world, world, 2, 5, 3)).astype(np.float32)
    row = rng.normal(size=(2, t_len * GATHER_SLOTS, width)).astype(np.float32)
    return blocks, weights, row


def gather_case(rank, world):
    """This rank's stacked blocks and the gradient its block gets from
    sum_r (weights[r] * stacked).sum() over every rank r; and the row's
    tokens gathered from the ranks' slot ranges (the padding past the row's
    end zeros)."""
    blocks, weights, row = (torch.from_numpy(x) for x in gather_inputs(world))
    x = blocks[rank].clone().requires_grad_(True)
    stacked = parallel.all_gather_rows(x)
    (stacked * weights[rank]).sum().backward()
    shard = parallel.SlotShard(rank, world, GATHER_SLOTS)
    t_len = row.shape[1] // GATHER_SLOTS
    mine = row[:, shard.token_rows(t_len, "cpu")].reshape(2, t_len, shard.width, -1)
    mine[:, :, max(0, GATHER_SLOTS - shard.lo):] = 0.0
    return {"stacked": stacked.detach(), "grad": x.grad,
            "row": shard.gather(mine.reshape(2, t_len * shard.width, -1))}


MODEL_SLOTS = 11       # world 2: 6 slots a rank; world 4: 3, rank 3's last past the row


def model_inputs():
    """A row of MODEL_SLOTS slots for `small_model`: pre_motion (1, 4, 11, 1)
    (zero on the three padded slots, 3, 9 and 10, as `prepare` zeroes
    them), validity (1, 11) and the weights (1, 11, 3, 5) of the loss
    sum(weights * output)."""
    rng = np.random.default_rng(11)
    valid = np.ones((1, MODEL_SLOTS), bool)
    valid[0, [3, 9, 10]] = False
    pre = rng.normal(size=(1, 4, MODEL_SLOTS, 1)).astype(np.float32) * valid[:, None, :, None]
    weights = rng.normal(size=(1, MODEL_SLOTS, 3, 5)).astype(np.float32)
    return pre.astype(np.float32), valid, weights


def small_model():
    """AgentFormerLight at k = 2 (4 context, 3 decoder steps), 5 samples,
    conn_dist 0.8 (agents farther apart than that at their last position
    do not attend to each other: -inf lanes), seeded, in train mode with
    its dropouts drawing from a generator seeded 1."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = AgentFormerLight(past_frames=4, future_frames=3, forecast_dim=5, conn_dist=0.8)
    set_dropout_generator(model, torch.Generator().manual_seed(1))
    return model.train()


def model_case(rank, world):
    """`small_model` on this rank's slot range of `model_inputs`' row (the
    padding past the row's end zeros): its output rows, its parameters'
    gradient of the loss over its rows, and the dropout generator's state."""
    pre, valid, weights = (torch.from_numpy(x) for x in model_inputs())
    model = small_model()
    shard = parallel.SlotShard(rank, world, MODEL_SLOTS)
    idx = shard.own_slots("cpu")
    inside = torch.arange(shard.lo, shard.lo + shard.width) < MODEL_SLOTS
    out = model(pre[:, :, idx] * inside[None, None, :, None], valid[:, idx] & inside,
                shard=shard)
    (out * weights[:, idx] * inside[None, :, None, None]).sum().backward()
    return {"out": out.detach(), "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "dropout_state": model.enc_layer_0.self_attn.dropout.generator.get_state()}


def spawned(rank, world, init_file, tmp, th):
    """A rank of `torch.multiprocessing.spawn`: joins the gloo group at
    `init_file`, runs every case and saves its results as rank<r>.pt."""
    parallel.init_process_group(rank, world, f"file://{init_file}", device="cpu")
    try:
        out = run(world, tmp, th)
        out["gather"] = gather_case(rank, world)
        out["model"] = model_case(rank, world)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        parallel.destroy()
