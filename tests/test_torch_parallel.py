"""Data parallelism in the port on the CPU: gloo ranks against the port's
single process, and the single process against the JAX package's mesh.

World 2 and 4 run as `torch.multiprocessing.spawn` ranks of a gloo group
(`tests/_parallel_ranks.py`, one spawn a world for every case) and are held
against the same cases run here at world 1, within the JAX suite's own
tolerances for its mesh (`tests/test_parallel.py`): loss within rtol 1e-5,
gradients within 5e-5 global relative L2 and every tensor within rtol 2e-3 /
atol 1e-5, BN statistics within 1e-6 of their scale (max |s|, at least 1:
an absolute 1e-6 is under two f32 ulps at the statistics' ~8), `test()`
means within rtol 1e-5 / atol 1e-6, `fit(2)` train losses within rtol
2e-3. The ET-STGCNN steps are held both to world 1 running the block in the
rows the ranks hold (micro_batches = world: the same arithmetic) and to the
block in one piece (a convolution over one row rounds otherwise than one
over four). The cases: an ET-STGCNN block and
one whose shards hold only padding (which must hand the all-reduce zeros),
an ET-PECNet packed batch split by scenes, ET-AgentFormer's packed row split
by slots with its attention across the ranks (dropout on, with the single
process's draws, and off; a batch whose last ranks hold padding alone; each
rank's score tensors hold its own query rows alone), a small
AgentFormerLight with `conn_dist` on split the same way, the differentiable
gather against `torch.cat`, ET-DMRGCN's DropEdge masks (bitwise the single
process's rows), ET-GP-Graph-STGCNN at micro_batches 4 with its NaN
gradient, `test()`/`valid()` in both regimes, `fit(2)`, a resume (bitwise)
and a checkpoint from rank 0 that the JAX trainer reads. The single process
is held against the JAX package's 8-device mesh on the same weights
(gradients of both regimes and of ET-AgentFormer, `test()` of both). Then
the host's shard planning, the re-packing invariance the collated split
rests on, the predictor over a mesh of two and three CPU replicas, the
kernel wrappers' device guard, and the refusals.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

try:        # the reference; the machine with the card lacks flax, and runs `-m cuda` alone
    import jax
    import jax.numpy as jnp

    from eigentrajectory_tpu.config import ExpConfig as JaxConfig
    from eigentrajectory_tpu.data.batching import CollatedBatcher as JaxCollatedBatcher
    from eigentrajectory_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from eigentrajectory_tpu.train.trainer import ETJaxTrainer
except ImportError:
    jax = None

from eigentrajectory_tpu_torch import parallel, trainval
from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data.batching import (CollatedBatcher, SceneBatcher, pad_scenes,
                                                     scene_owners, shard_rows, shard_scenes,
                                                     shard_slots, shard_width, slot_width)
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.etspace.facade import et_forward, row_center
from eigentrajectory_tpu_torch.inference import ETPredictor
from eigentrajectory_tpu_torch.models.gpgraph_common import find_group_indices
from eigentrajectory_tpu_torch.ops import attention, col, group, recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer
# By their names in this directory (pytest puts it on sys.path): the
# machine with the card has a `tests` package of its own installed.
import _parallel_ranks as R
from test_torch_gpgraph import assert_groups_form, threshold

with_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (jax, flax, optax)")
WORLDS = (2, 4)
GRAD = dict(rtol=2e-3, atol=1e-5)


def _gpgraph_threshold(tmp):
    """th midway between two adjacent pair distances of the GP-Graph block
    (groups form, no distance within rounding of th)."""
    gp = R.trainer("gpgraphstgcnn", 1, tmp, tag="th", batch_size=16, micro_batches=4)
    block = pad_scenes(gp.data_train, list(range(10)), gp.n_max, 16)
    seen, distances = [], gp.model.group_gen.distances
    gp.model.group_gen.distances = lambda v, valid: seen.append(distances(v, valid)) or seen[-1]
    with torch.no_grad():
        gp._chunk_loss(*gp._to_device(block))
    dist = seen[0].numpy()
    th = threshold(dist, block.ped_valid)
    ranks, _ = find_group_indices(seen[0], torch.tensor(th), torch.from_numpy(block.ped_valid))
    assert_groups_form(ranks.numpy(), block.ped_valid)
    return th


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's results]}: world 1 here, 2 and 4 spawned; and
    {world: checkpoint root}."""
    th = _gpgraph_threshold(tmp_path_factory.mktemp("th"))
    root = tmp_path_factory.mktemp("w1")
    out, dirs = {1: [R.run(1, root, th, chunks=WORLDS)]}, {1: root}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"w{world}")
        mp.spawn(R.spawned, args=(world, str(tmp / "init"), str(tmp), th), nprocs=world)
        out[world] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
        dirs[world] = tmp
    return out, dirs


def _assert_grads_close(want, got, nan_ok=False):
    assert set(want) == set(got)
    v1 = torch.cat([g.double().reshape(-1) for g in want.values()]).nan_to_num()
    v2 = torch.cat([got[n].double().reshape(-1) for n in want]).nan_to_num()
    assert float(v1.norm()) > 0
    assert float((v1 - v2).norm() / v1.norm()) < 5e-5
    for name, g in want.items():
        if not nan_ok:
            assert torch.isfinite(g).all() and torch.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), err_msg=name, **GRAD)


def _assert_step_close(want, got, nan_ok=False):
    """Loss within rtol 1e-5; gradients as `_assert_grads_close`; each BN
    statistic within 1e-6 of its scale, max(max |s|, 1). Relative to scale
    because the statistics reach ~8.75, where one f32 ulp is 9.5e-7: a bare
    absolute 1e-6 allowed under two ulps, and a rank's convolution over its
    own rows rounds otherwise than one over the whole block."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_grads_close(want["grads"], got["grads"], nan_ok)
    assert set(want["stats"]) == set(got["stats"])
    for name, s in want["stats"].items():
        scale = max(float(s.abs().max()), 1.0)
        np.testing.assert_allclose(got["stats"][name].numpy(), s.numpy(), atol=1e-6 * scale,
                                   rtol=0, err_msg=name)


# ------------------------------------------------ world 2 and 4 vs world 1
@pytest.mark.parametrize("world", WORLDS)
def test_sequenced_step_matches_the_single_process(runs, world):
    """Held to world 1 in the ranks' rows (micro_batches = world) and to the
    block in one piece, both at `_assert_step_close`'s tolerances."""
    out, _ = runs
    got = out[world][0]["stgcnn_full"]
    for want in (out[1][0][f"stgcnn_full@{world}"], out[1][0]["stgcnn_full"]):
        assert len(want["stats"]) > 0
        _assert_step_close(want, got)
    for rank in out[world]:            # every rank holds the whole step
        assert rank["stgcnn_full"]["loss"] == got["loss"]
        for name, g in got["grads"].items():
            assert torch.equal(rank["stgcnn_full"]["grads"][name], g)


@pytest.mark.parametrize("world", WORLDS)
def test_shards_of_padding_alone_hand_the_all_reduce_zeros(runs, world):
    """The block's last two rows are padding: at world 2 rank 1, at world 4
    ranks 2 and 3 hold nothing else. They add 0 to the loss, the gradients
    and the BN weight, never NaN, and the step is the single process's."""
    out, _ = runs
    for want in (out[1][0][f"stgcnn_tail@{world}"], out[1][0]["stgcnn_tail"]):
        _assert_step_close(want, out[world][0]["stgcnn_tail"])
    padding = range(world // 2, world)
    for rank, res in enumerate(out[world]):
        (buf,) = res["stgcnn_tail"]["reduced"]
        assert torch.isfinite(buf).all()
        assert (buf == 0).all() == (rank in padding), rank


@pytest.mark.parametrize("world", WORLDS)
def test_collated_step_split_by_scenes_matches_the_single_process(runs, world):
    out, _ = runs
    _assert_step_close(out[1][0]["pecnet_step"], out[world][0]["pecnet_step"])
    # Each rank held a part: the shares it handed in add up to the batch.
    losses = [float(res["pecnet_step"]["reduced"][0][-1]) for res in out[world]]
    assert sum(x != 0 for x in losses) >= 2
    np.testing.assert_allclose(sum(losses), out[1][0]["pecnet_step"]["loss"], rtol=1e-5)


AF_CASES = ("agentformer_step", "agentformer_off", "agentformer_padding")


@pytest.mark.parametrize("case", AF_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_agentformer_step_split_by_slots_matches_the_single_process(runs, world, case):
    """ET-AgentFormer's packed row of 19 slots split into the ranks' slot
    ranges, its attention across the ranks: the step within
    `_assert_step_close` of world 1 and the same on every rank, with
    dropout on (the single process's draws: the generator ends where world
    1's does on every rank) and off (not moved). The ranks' loss shares add
    up to the step's; a rank of padding alone hands the all-reduce zeros."""
    out, _ = runs
    want, got = out[1][0][case], out[world][0][case]
    _assert_step_close(want, got)
    assert torch.equal(want["dropout_state"], want["dropout_start"]) == (case == "agentformer_off")
    assert sum(res[case]["valid"] for res in out[world]) == want["valid"]
    padding = [res[case]["valid"] == 0 for res in out[world]]
    assert any(padding) == (case == "agentformer_padding" or world == 4)
    shares = []
    for res, alone in zip(out[world], padding):
        assert torch.equal(res[case]["dropout_state"], want["dropout_state"])
        assert res[case]["loss"] == got["loss"]
        for name, g in got["grads"].items():
            assert torch.equal(res[case]["grads"][name], g), name
        (buf,) = res[case]["reduced"]
        assert torch.isfinite(buf).all()
        assert (buf[:-2] == 0).all() == alone and (buf[-1] == 0) == alone
        shares.append(float(buf[-1]))
    np.testing.assert_allclose(sum(shares), want["loss"], rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_agentformer_ranks_hold_their_own_query_rows_alone(runs, world):
    """Each of the six attentions (2 encoder, 2 decoder self, 2 cross) of a
    rank scores T * ceil(P / world) query rows (its slots' tokens) against
    all T * P keys; the rows that lie in the row add up to world 1's."""
    out, _ = runs
    for case in AF_CASES:
        want = out[1][0][case]["scores"]
        p = out[1][0][case]["slots"]
        m = slot_width(p, world)
        assert len(want) == 6 and all(s[2] % p == 0 for s in want)
        in_row = [0] * len(want)
        for rank, res in enumerate(out[world]):
            assert res[case]["slots"] == m
            for i, (mine, whole) in enumerate(zip(res[case]["scores"], want)):
                t_len = whole[2] // p
                assert mine[:2] == whole[:2] and mine[3] == whole[3]
                assert mine[2] == t_len * m < whole[2]
                in_row[i] += t_len * min(m, max(0, p - rank * m))
        assert in_row == [s[2] for s in want]


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_rows_is_torch_cat_and_its_backward_sums_over_ranks(runs, world):
    """`parallel.all_gather_rows` on the gloo ranks: forward bitwise
    `torch.cat` of every rank's block, backward each rank's block's gradient
    summed over the ranks' losses as autograd through the `torch.cat` of one
    process gives it; `SlotShard.gather` puts the ranks' slot ranges back in
    the row's token order bitwise."""
    out, _ = runs
    blocks, weights, row = (torch.from_numpy(x) for x in R.gather_inputs(world))
    xs = [b.clone().requires_grad_(True) for b in blocks]
    stacked = torch.cat([x[None] for x in xs])
    sum((stacked * weights[r]).sum() for r in range(world)).backward()
    for rank, res in enumerate(out[world]):
        assert torch.equal(res["gather"]["stacked"], stacked.detach())
        np.testing.assert_allclose(res["gather"]["grad"].numpy(), xs[rank].grad.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(res["gather"]["row"], row)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_agentformer_with_conn_dist_is_the_single_process(runs, world):
    """A small AgentFormerLight with conn_dist 0.8 (some pairs cut apart by
    -inf lanes) and dropout on, its row's slots split over the ranks: the
    ranks' output rows laid end to end are the single process's forward,
    their gradients sum to its gradient, and every rank's dropout stream
    ends where the single process's does."""
    out, _ = runs
    pre, valid, weights = (torch.from_numpy(x) for x in R.model_inputs())
    cur = pre[0, -1, valid[0], 0]
    assert ((cur[:, None] - cur[None, :]).abs() > 0.8).any()        # the cut bites
    model = R.small_model()
    want = model(pre, valid)
    (want * weights).sum().backward()
    ranks = [res["model"] for res in out[world]]
    got = torch.cat([r["out"] for r in ranks], dim=1)[:, :R.MODEL_SLOTS]
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=1e-5, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _assert_grads_close(grads, {n: sum(r["grads"][n] for r in ranks) for n in grads})
    state = model.enc_layer_0.self_attn.dropout.generator.get_state()
    assert all(torch.equal(r["dropout_state"], state) for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_drop_edge_masks_are_the_single_process_rows_bitwise(runs, world):
    out, _ = runs
    want = out[1][0]["dmrgcn_step"]
    (whole,) = want["keeps"]
    assert len(whole) == 2 and all(k.shape[0] == 8 for k in whole)
    for layer in range(len(whole)):
        parts = [res["dmrgcn_step"]["keeps"][0][layer] for res in out[world]]
        assert torch.equal(torch.cat(parts), whole[layer])
    for res in out[world]:
        assert torch.equal(res["dmrgcn_step"]["dropout_state"], want["dropout_state"])
    _assert_step_close(want, out[world][0]["dmrgcn_step"])


@pytest.mark.parametrize("world", WORLDS)
def test_gpgraph_micro_batches_4_zero_nan_after_the_sum(runs, world):
    """ET-GP-Graph-STGCNN, micro_batches 4 inside each rank: gradients and BN
    statistics as the single process's, NaN at the same entries (the whole
    of group_cnn's gradient); after the optimizer group_cnn has only decayed,
    as in the single process, and every weight is finite."""
    out, _ = runs
    want, got = out[1][0]["gpgraph_step"], out[world][0]["gpgraph_step"]
    assert len(want["stats"]) == 6
    _assert_step_close(want, got, nan_ok=True)
    nan = {n for n, g in want["grads"].items() if torch.isnan(g).any()}
    assert nan == {n for n in want["grads"] if n.startswith("group_gen.group_cnn")}
    for name in nan:
        assert torch.isnan(want["grads"][name]).all() and torch.isnan(got["grads"][name]).all()
    w1, wn = out[1][0]["gpgraph_weights"], out[world][0]["gpgraph_weights"]
    for name, w in wn.items():
        assert torch.isfinite(w).all(), name
        if name.startswith("group_gen.group_cnn"):
            assert torch.equal(w, w1[name]), name


@pytest.mark.parametrize("world", WORLDS)
def test_test_and_valid_match_the_single_process(runs, world):
    out, _ = runs
    for model in ("stgcnn", "pecnet"):
        want, got = out[1][0][f"{model}_test"], out[world][0][f"{model}_test"]
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{model} {key}")
        np.testing.assert_allclose(out[world][0][f"{model}_valid"], out[1][0][f"{model}_valid"],
                                   rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_losses_match_and_the_ranks_end_alike(runs, world):
    out, _ = runs
    want, got = out[1][0]["fit_log"], out[world][0]["fit_log"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=2e-3)
    assert got["train_loss"][1] < got["train_loss"][0]
    for res in out[world][1:]:
        assert res["fit_log"] == got
        for name, w in out[world][0]["fit_weights"].items():
            assert torch.equal(res["fit_weights"][name], w), name


@pytest.mark.parametrize("world", WORLDS)
def test_resume_equals_the_straight_run_bitwise(runs, world):
    out, _ = runs
    res = out[world][0]
    assert res["resume_log"] == res["fit_log"]
    for name, w in res["fit_weights"].items():
        assert torch.equal(res["resume_weights"][name], w), name


@with_jax
def test_rank_0_checkpoint_is_read_by_the_jax_trainer(runs):
    """The world-2 fit's model_best.msgpack, written by rank 0 alone: the
    JAX trainer loads it and its test() agrees with the port's on it."""
    _, dirs = runs
    cfg = dict(baseline="stgcnn", batch_size=4, checkpoint_dir=str(dirs[2]),
               dataset="synthetic", static_dist=0.3)
    path = os.path.join(dirs[2], "fit-w2", "synthetic")
    assert sorted(os.listdir(path)) == ["log.pkl", "model_best.msgpack"]
    jtr = ETJaxTrainer(JaxConfig(**cfg), tag="fit-w2", test_mode=True, datasets=R.splits())
    jtr.load_model()
    ttr = ETTorchTrainer(ExpConfig(**cfg), tag="fit-w2", datasets=R.splits(), device="cpu")
    ttr.load_model()
    want, got = jtr.test(eval_batch=4), ttr.test(eval_batch=4)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)


# -------------------------------------- world 1 vs the JAX package's mesh
def _jax_pair(baseline, tmp, batch_size):
    """(JAX trainer, port trainer) with the JAX initialization and descriptor."""
    data = tuple(make_synthetic_data(n_scenes=12, max_peds=5, seed=s) for s in (1, 2, 3))
    kw = dict(baseline=baseline, batch_size=batch_size, checkpoint_dir=str(tmp),
              dataset="synthetic", static_dist=0.3)
    jtr = ETJaxTrainer(JaxConfig(scan_chunks=1, **kw), tag="mesh", test_mode=True, datasets=data)
    jtr.init_descriptor()
    jtr.save_model()
    ttr = ETTorchTrainer(ExpConfig(**kw), tag="mesh", datasets=data, device="cpu")
    ttr.load_model()
    return jtr, ttr


def _jax_mesh_grads(jtr, batch, collated, train=True):
    """The gradient with the batch sharded over the 8-device 'data' axis
    and the parameters replicated, as tests/test_parallel.py takes it
    (`train=False`: dropout off)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax_make_mesh(n_data=8)
    data_sh, rep_sh = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    info = batch.scene_ids if collated else batch.scene_valid
    args = [jax.device_put(jnp.asarray(x), data_sh)
            for x in (batch.obs, batch.pred, batch.ped_valid, info)]

    def loss(p, obs, pred, valid, info):
        if collated:
            aux = jtr._make_aux_template(obs.shape[0], info)
            out = jtr._scene_forward(p, jtr.batch_stats, obs, pred, valid, None, aux, train=train)
            return jnp.nan_to_num(out["loss_eigentraj"] + out["loss_euclidean_ade"]
                                  + out["loss_euclidean_fde"])

        def one(o, g, v):
            out = jtr._scene_forward(p, jtr.batch_stats, o, g, v, None,
                                     jtr._make_aux_template(o.shape[0]), train=True)
            return out["loss_eigentraj"] + out["loss_euclidean_ade"] + out["loss_euclidean_fde"]

        losses = jax.vmap(one)(obs, pred, valid)
        return (jnp.nan_to_num(losses) * info.astype(losses.dtype)).sum() / jtr.cfg.batch_size

    return jax.jit(jax.grad(loss))(jax.device_put(jtr.params, rep_sh), *args)


@with_jax
@pytest.mark.parametrize("baseline", ["stgcnn", "pecnet", "agentformer"])
def test_single_process_gradient_matches_the_jax_mesh(tmp_path, baseline):
    """ET-AgentFormer with dropout off (JAX at train=False, the port in eval
    mode): its packed row's flat pedestrian axis sharded over the mesh, so
    XLA partitions the attention across the 8 devices. Its gradients are
    held by the rule of `tests/test_torch_agentformer.py`'s dropout-off
    step: within 1e-4 of scale of the mesh's where JAX's own f32 gradient
    lies within 1e-4 of scale of its x64 one, else within 32 times JAX's
    f32 error of the x64 gradient."""
    from tests.test_torch_train import _by_torch_name

    collated = baseline != "stgcnn"
    jtr, ttr = _jax_pair(baseline, tmp_path, 16 if collated else 8)
    if collated:
        p_max = -(-jtr.p_max // 8) * 8
        batch = next(iter(JaxCollatedBatcher(jtr.data_train, 16, False, p_max)))
        args = (torch.from_numpy(x[None]) for x in (batch.obs, batch.pred, batch.ped_valid,
                                                    batch.scene_ids))
    else:
        batch = pad_scenes(ttr.data_train, list(range(6)), ttr.n_max, 8)
        args = (torch.from_numpy(x) for x in (batch.obs, batch.pred, batch.ped_valid,
                                              batch.scene_valid))
    train = baseline != "agentformer"
    want = _by_torch_name(ttr, _jax_mesh_grads(jtr, batch, collated, train=train))
    ttr.model.train(train)
    ttr.loss_and_grads(*args)
    ttr.model.eval()
    got = {n: p.grad for n, p in ttr.model.named_parameters() if p.grad is not None}
    assert set(got) == set(want)
    if train:
        # The port's f32 against JAX's f32, sums in another order, as the
        # single-device step is held (tests/test_torch_train.py).
        for name, g in want.items():
            np.testing.assert_allclose(got[name].numpy(), g, atol=1e-5, rtol=1e-4, err_msg=name)
        return
    from tests.test_torch_agentformer import _jax_step

    _, truth = _jax_step(jtr, ttr, batch, x64=True)
    unresolved = []
    for name, ref in truth.items():
        scale = float(np.abs(ref).max())
        g, w = got[name].double().numpy(), np.asarray(want[name], np.float64)
        jax_err = float(np.abs(w - ref).max())
        if jax_err <= 1e-4 * scale:
            assert float(np.abs(g - w).max()) <= 1e-4 * scale, (name, scale)
        else:
            unresolved.append(name)
            assert float(np.abs(g - ref).max()) <= 32 * jax_err, name
    assert len(unresolved) < len(truth) // 4, unresolved


@with_jax
@pytest.mark.parametrize("baseline,kwargs", [("stgcnn", dict(eval_batch=8)),
                                             ("pecnet", dict(eval_ped_batch=16))])
def test_single_process_test_matches_the_jax_mesh(tmp_path, baseline, kwargs):
    jtr, ttr = _jax_pair(baseline, tmp_path, 8)
    jtr_mesh = ETJaxTrainer(dataclasses.replace(jtr.cfg, mesh_data_axis=8),
                            tag="mesh", test_mode=True,
                            datasets=(jtr.data_train, jtr.data_val, jtr.data_test))
    jtr_mesh.load_model()
    want, got = jtr_mesh.test(**kwargs), ttr.test(**kwargs)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)


# ------------------------------------------------------ shard planning
@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_rows_and_scenes_cover_the_batch_once(world):
    data = make_synthetic_data(n_scenes=24, max_peds=9, seed=5)
    block = next(iter(SceneBatcher(data, 8, True, seed=1)))
    parts = [shard_rows(block, r, world) for r in range(world)]
    for name in ("obs", "ped_valid", "scene_valid"):
        assert np.array_equal(np.concatenate([getattr(p, name) for p in parts]),
                              getattr(block, name))
    with pytest.raises(ValueError, match="split"):
        shard_rows(block, 0, 3)
    for packed in CollatedBatcher(data, 40, True, seed=2):
        owner = scene_owners(packed.scene_ids, world)
        valid = packed.ped_valid
        assert (owner[~valid] == -1).all() and set(owner[valid]) <= set(range(world))
        for sid in set(packed.scene_ids[valid]):      # whole scenes a rank
            assert len(set(owner[packed.scene_ids == sid])) == 1
        width = shard_width(packed.obs.shape[0], data.max_peds_per_scene, world)
        rows = [shard_scenes(packed, r, world, width) for r in range(world)]
        assert sum(int(r.ped_valid.sum()) for r in rows) == int(valid.sum())
        for r, row in enumerate(rows):
            n = int(row.ped_valid.sum())
            assert row.ped_valid[:n].all() and not row.ped_valid[n:].any()
            assert np.array_equal(row.obs[:n], packed.obs[owner == r])
            assert np.array_equal(row.scene_ids[:n], packed.scene_ids[owner == r])
        if world == 1:
            assert rows[0].obs.shape == packed.obs.shape
            assert np.array_equal(rows[0].obs, packed.obs)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_slots_cover_the_row_once(world):
    """The ranks' slot ranges of a packed batch, ceil(P / world) slots each,
    laid end to end are the batch, then padding (valid False, scene -1)."""
    data = make_synthetic_data(n_scenes=24, max_peds=9, seed=5)
    for packed in CollatedBatcher(data, 40, True, seed=2):
        p = packed.obs.shape[0]
        m = slot_width(p, world)
        rows = [shard_slots(packed, r, world) for r in range(world)]
        assert all(row.obs.shape == (m,) + packed.obs.shape[1:] for row in rows)
        for name in ("obs", "pred", "ped_valid", "scene_ids", "non_linear"):
            whole = np.concatenate([getattr(row, name) for row in rows])
            assert np.array_equal(whole[:p], getattr(packed, name)), name
        tail = np.concatenate([row.ped_valid for row in rows])[p:]
        ids = np.concatenate([row.scene_ids for row in rows])[p:]
        assert len(tail) == world * m - p and not tail.any() and (ids == -1).all()


# ------------------------------------------------------ re-packing invariance
def _coefficients(tr, row, center=None, isolate=False):
    """c_pred_m of a packed row in training or packed-eval form."""
    obs, _, valid, ids = tr._to_device(row)
    aux = tr.make_aux(valid, ids)
    if center is not None:
        aux["row_center"] = center
    if isolate:
        aux["center_scene_ids"] = ids
        aux["isolate_scenes"] = True
    with torch.no_grad():
        coef = et_forward(tr.et, tr._predictor_fn, obs, valid, tr.cfg.static_dist, aux=aux,
                          return_coefficients=True)
    return coef["c_pred_m"][0]                                   # (k, P, S)


@pytest.mark.parametrize("baseline", ["pecnet", "lbebm", "agentformer"])
def test_a_scene_moved_to_another_row_and_width_keeps_its_outputs(tmp_path, baseline):
    """The collated split rests on it: a scene's outputs do not change when
    it moves to another row of another width, given the whole row's centre
    (training) or its own (the packed eval). ET-AgentFormer holds it in the
    packed eval only; its training attention spans the row."""
    tr = R.trainer(baseline, 1, tmp_path, batch_size=24)
    packed = next(iter(tr.train_batches(0)))
    assert len(set(packed.scene_ids[packed.ped_valid])) >= 4
    width = shard_width(packed.obs.shape[0], tr.n_max, 2) + 5
    moved = shard_scenes(packed, 1, 2, width)
    n = int(moved.ped_valid.sum())
    src = np.flatnonzero(scene_owners(packed.scene_ids, 2) == 1)
    forms = [dict(isolate=True)]
    if baseline != "agentformer":
        obs, valid = (torch.from_numpy(x[None]) for x in (packed.obs, packed.ped_valid))
        forms.append(dict(center=row_center(obs, valid)))
    for form in forms:
        whole = _coefficients(tr, packed, **form)[:, src]
        alone = _coefficients(tr, moved, **form)[:, :n]
        np.testing.assert_allclose(alone.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=str(form))
    if baseline == "agentformer":
        # The training form (no scene isolation), without dropout's draws.
        obs, valid = (torch.from_numpy(x[None]) for x in (packed.obs, packed.ped_valid))
        center = row_center(obs, valid)
        whole = _coefficients(tr, packed, center=center)[:, src]
        alone = _coefficients(tr, moved, center=center)[:, :n]
        assert float((alone - whole).abs().max()) > 1e-3


# ------------------------------------------------------------ predictor mesh
@pytest.mark.parametrize("baseline,replicas", [("stgcnn", 2), ("pecnet", 3)])
def test_predictor_over_a_mesh_matches_one_device(tmp_path, baseline, replicas):
    tr = R.trainer(baseline, 1, tmp_path)
    data = make_synthetic_data(n_scenes=7, max_peds=6, seed=9)
    ids = np.repeat(np.arange(7) * 3, data.num_peds_in_seq)
    order = np.random.default_rng(0).permutation(len(ids))       # scenes interleaved
    obs, ids = data.obs_traj[order], ids[order]
    want = ETPredictor(tr, bucket=8).predict(obs, ids)
    mesh = parallel.make_mesh(devices=["cpu"] * replicas)
    predictor = ETPredictor(tr, bucket=8, mesh=mesh)
    assert len(predictor._replicas) == replicas
    got = predictor.predict(obs, ids)
    assert got.shape == want.shape == (20, len(ids), 12, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    one = predictor.predict(obs[:3], np.zeros(3, np.int64))     # fewer rows than replicas
    np.testing.assert_allclose(one, ETPredictor(tr, bucket=8).predict(obs[:3]), atol=1e-5)


def test_make_mesh_names_devices_and_refuses_cards_it_does_not_have(monkeypatch):
    assert parallel.make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.make_mesh() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="need 2 cards, have 1"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="cuda:1 named"):
        parallel.make_mesh(devices=["cuda:0", "cuda:1"])
    assert parallel.make_mesh(devices=["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2


def test_the_dry_run_prints_the_jax_dry_runs_line_on_two_cpu_ranks():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "eigentrajectory_tpu_torch.parallel.dryrun",
                          "--n", "2", "--device", "cpu"], cwd=repo, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert "backend gloo, world 2" in out
    line = out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): ok, loss=") and "collated_loss=" in line
    assert "eval ADE seq=" in line and " col=" in line


def test_trainval_under_torchrun_trains_and_tests_on_two_cpu_ranks(tmp_path):
    """`torchrun --nproc_per_node=2 -m eigentrajectory_tpu_torch.trainval`
    with mesh_data_axis 2: rank 0 alone prints and writes; its checkpoint
    gives a single process the means the ranks printed."""
    import json
    import subprocess
    import sys

    from tests.test_torch_train import _write_split

    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        _write_split(str(tmp_path / "data" / "toy" / split), rng)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset_dir": str(tmp_path / "data"), "checkpoint_dir": str(tmp_path / "ckpt"),
        "dataset": "toy", "baseline": "stgcnn", "batch_size": 4, "static_dist": 0.3,
        "mesh_data_axis": 2}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "eigentrajectory_tpu_torch.trainval", "--cfg", str(cfg), "--tag", "dp",
         "--device", "cpu", "--epochs", "2"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300, check=True).stdout
    assert "backend gloo, world 2" in out
    scene = [line for line in out.splitlines() if line.startswith("Scene: toy ADE: ")]
    assert len(scene) == 1 and out.count("epoch 1 train") == 1
    assert set(os.listdir(tmp_path / "ckpt" / "dp" / "toy")) == {"model_best.msgpack", "log.pkl"}
    tr = ETTorchTrainer(ExpConfig(**{**json.loads(cfg.read_text()), "mesh_data_axis": 1}),
                        tag="dp", device="cpu")
    tr.load_model()
    words = scene[0].split()                    # Scene: toy ADE: a FDE: b ...
    printed = dict(zip(words[2::2], map(float, words[3::2])))
    for key, value in tr.test().items():
        np.testing.assert_allclose(value, printed[f"{key}:"], rtol=1e-5, atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ refusals
def test_a_rank_without_a_card_raises_and_no_backend_is_swapped(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_process_group(0, 1, f"file://{tmp_path}/init", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for rank in (0, 1):     # every rank of the host refuses, before any waits
        with pytest.raises(RuntimeError, match="2 ranks on this host need a card of its own"):
            parallel.init_process_group(rank, 2, f"file://{tmp_path}/init", device="cuda")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 ranks on this host need a card of its own"):
        parallel.init_from_env(share_card=False)
    assert parallel.current() is None


@pytest.mark.parametrize("world", [None, 4])
def test_the_trainer_refuses_mesh_data_axis_other_than_the_world(tmp_path, monkeypatch, world):
    if world is not None:
        monkeypatch.setattr(parallel, "current", lambda: parallel.Rank(0, world,
                                                                        torch.device("cpu"),
                                                                        "gloo"))
    with pytest.raises(ValueError, match="mesh_data_axis = 2 needs a process group"):
        R.trainer("stgcnn", 2, tmp_path, fit_descriptor=False)


def test_trainval_refuses_a_world_size_other_than_mesh_data_axis(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                       "eigentrajectory-stgcnn-hotel.json")
    with pytest.raises(SystemExit, match="WORLD_SIZE 2 differs from the config's "
                                         "mesh_data_axis 1"):
        trainval.main(["--cfg", cfg, "--device", "cpu"])


# ---------------------------------------------------------- the device guard
class _DeviceContexts:
    """Stands in for torch.cuda.device: notes the devices entered."""

    def __init__(self):
        self.entered, self.active = [], []

    def __call__(self, device):
        @contextlib.contextmanager
        def ctx():
            self.entered.append(torch.device(device))
            self.active.append(torch.device(device))
            try:
                yield
            finally:
                self.active.pop()
        return ctx()


class _Library:
    """A kernel library whose entry points note the device current at the
    call."""

    def __init__(self, contexts):
        self.contexts, self.calls = contexts, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, list(self.contexts.active)))
            return 0
        return entry


def test_each_kernel_wrapper_launches_under_its_tensors_device(monkeypatch):
    """The CUDA runtime launches on the current device: every wrapper makes
    its tensors' device current around the entry point (here with the
    library, the checks and the device context stood in for on the CPU)."""
    contexts = _DeviceContexts()
    lib = _Library(contexts)
    monkeypatch.setattr(torch.cuda, "device", contexts)
    monkeypatch.setattr(recon, "_library", lambda *a: lib)
    monkeypatch.setattr(recon, "_stream", lambda x: 0)
    monkeypatch.setattr(recon, "_check_args", lambda *a: (6, 4, 20, 12))
    monkeypatch.setattr(group, "_library", lambda: lib)
    monkeypatch.setattr(group, "_check_args", lambda merge, valid: valid.shape)
    monkeypatch.setattr(col, "_library", lambda: lib)
    monkeypatch.setattr(col, "_check_args", lambda recon, valid, gather: (20, 6, 2, 3))
    monkeypatch.setattr(attention, "_library", lambda: lib)
    monkeypatch.setattr(attention, "_check_args", lambda *a: (1, 2, 2, 32, 1, 1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    c = torch.zeros(6, 4, 20)
    recon._launch(c, c, *(torch.zeros(1),) * 6, torch.zeros(4, 12, 2))
    recon._launch_reconstruct(c, c, *(torch.zeros(1),) * 6)
    group._launch(torch.zeros(2, 3, 3, dtype=torch.bool), torch.zeros(2, 3, dtype=torch.bool))
    col._launch(torch.zeros(20, 6, 12, 2), torch.zeros(2, 3, dtype=torch.bool), None)
    x = torch.zeros(1, 2, 32)
    attention._launch(x, x, x, x, x, torch.zeros(1, 1, 1), torch.zeros(1, 1), 1, False)
    assert [name for name, _ in lib.calls] == ["et_recon_metrics", "et_reconstruct",
                                               "et_group_relabel", "et_col",
                                               "et_agent_attention"]
    assert all(active == [torch.device("cpu")] for _, active in lib.calls)
    assert contexts.active == []


@pytest.mark.cuda
def test_kernels_run_on_the_second_card_while_the_first_is_current():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(0)
    n = 45
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((6, n, 20), (6, n, 20), (24, 6), (24, 6), (n, 2), (n, 2, 2), (n,))]
    args[6] = args[6].abs() + 0.5
    mask = torch.from_numpy(rng.random(n) < 0.5)
    gt = torch.from_numpy(rng.normal(size=(n, 12, 2)).astype(np.float32))
    merge = torch.from_numpy(np.tril(rng.random((3, 9, 9)) < 0.3, -1))
    valid = torch.ones(3, 9, dtype=torch.bool)
    torch.cuda.set_device(0)
    on1 = [x.to("cuda:1") for x in (*args, mask, gt)]
    want = recon.fused_recon_metrics_plain(*args, mask, gt)
    got = recon.fused_recon_metrics(*on1)
    assert torch.cuda.current_device() == 0
    for w, g in zip(want, got):
        assert g.device == torch.device("cuda", 1)
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4, rtol=1e-4)
    r = recon.fused_reconstruct(*on1[:-1])
    np.testing.assert_allclose(r.cpu().numpy(), want[0].numpy(), atol=1e-4, rtol=1e-4)
    ranks, counts = group.group_ranks(merge.to("cuda:1"), valid.to("cuda:1"))
    want_r, want_c = group.group_ranks_plain(merge, valid)
    assert torch.equal(ranks.cpu(), want_r) and torch.equal(counts.cpu(), want_c)
