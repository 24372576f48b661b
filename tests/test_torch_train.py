"""Port vs JAX package: the sequenced training path of ET-STGCNN and ET-SGCN,
DropEdge's stream on ET-DMRGCN (micro_batches, bitwise resume, masks that
are no checkpoint leaves), and the steps of ET-GP-Graph-STGCNN,
ET-GP-Graph-SGCN and ET-Social-Implicit (the NaN gradient of `group_cnn`,
the zero gradient of `noise_w`, the three streams' BN statistics,
micro_batches) with groups and zones formed.

Both trainers get the same synthetic splits; the JAX trainer fits the
descriptor and writes a checkpoint, the port loads it, so both start from
the same weights, BN statistics and ET parameters. Adam's update is
lr * g / (|g| + eps) on its first step, so two correct f32 runs can move a
weight by 2 * lr where a tiny gradient entry differs in sign: the gradients
(atol 1e-5, rtol 1e-4) and the update rule (injected gradients, <= 1e-6)
are held on their own, and whole steps by their losses (<= 1e-4 relative).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from eigentrajectory_tpu.config import ExpConfig as JaxConfig
from eigentrajectory_tpu.data.batching import SceneBatcher as JaxSceneBatcher
from eigentrajectory_tpu.train.trainer import ETJaxTrainer, _tree_weighted_mean
from eigentrajectory_tpu_torch import trainval
from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data.batching import pad_scenes
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.interop import jax_param_paths, read_flax_msgpack
from eigentrajectory_tpu_torch.models.common import draw_edge_keeps
from eigentrajectory_tpu_torch.train import ETTorchTrainer

BATCH = 4
BASELINES = ("stgcnn", "sgcn")


def _splits():
    return tuple(make_synthetic_data(n_scenes=n, max_peds=5, seed=seed)
                 for n, seed in ((10, 1), (6, 2), (6, 3)))


def _cfg_kw(baseline, tmp, **kw):
    return {**dict(baseline=baseline, batch_size=BATCH, checkpoint_dir=str(tmp),
                   dataset="synthetic", static_dist=0.3), **kw}


def _torch_trainer(baseline, tmp, tag="pair", splits=None, **kw):
    return ETTorchTrainer(ExpConfig(**_cfg_kw(baseline, tmp, **kw)), tag=tag,
                          datasets=splits or _splits(), device="cpu")


def _pair(baseline, tmp, **kw):
    """(JAX trainer, port trainer) with the same weights and ET parameters.
    scan_chunks=1: the unrolled JAX step, whose graph is small at 4 scenes."""
    jtr = ETJaxTrainer(JaxConfig(scan_chunks=1, **_cfg_kw(baseline, tmp, **kw)), tag="pair",
                       test_mode=True, datasets=_splits())
    jtr.init_descriptor()
    jtr.save_model()
    ttr = _torch_trainer(baseline, tmp, **kw)
    ttr.load_model()
    return jtr, ttr


@pytest.fixture(scope="module", params=BASELINES)
def pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory.mktemp(request.param))


def _tail_block(data, n_max):
    """A block whose last two rows are padding scenes."""
    return pad_scenes(data, [0, 1], n_max, BATCH)


def _jax_args(batch):
    return tuple(jnp.asarray(x) for x in
                 (batch.obs, batch.pred, batch.ped_valid, batch.scene_valid))


def _torch_args(batch):
    return tuple(torch.from_numpy(x) for x in
                 (batch.obs, batch.pred, batch.ped_valid, batch.scene_valid))


def _jax_loss_grads_stats(jtr, batch, jit=False):
    """The JAX trainer's batched step loss (trainer.py `batched_loss`), its
    gradient and the weighted BN statistics; `jit` compiles it first (the
    GP-Graph models' eager step takes longer than their compile)."""
    obs, pred, valid, scene_valid = _jax_args(batch)

    def batched_loss(p):
        def one(o, g, v):
            out = jtr._scene_forward(p, jtr.batch_stats, o, g, v, None,
                                     jtr._make_aux_template(o.shape[0]), train=True)
            loss = (out["loss_eigentraj"] + out["loss_euclidean_ade"]
                    + out["loss_euclidean_fde"])
            return loss, out.get("extras", jtr.batch_stats)

        losses, new_bs = jax.vmap(one)(obs, pred, valid)
        w = scene_valid.astype(losses.dtype)
        losses = jnp.nan_to_num(losses, nan=0.0, posinf=0.0, neginf=0.0) * w
        return losses.sum() / jtr.cfg.batch_size, _tree_weighted_mean(new_bs, w)

    grad_fn = jax.value_and_grad(batched_loss, has_aux=True)
    (loss, new_bs), grads = (jax.jit(grad_fn) if jit else grad_fn)(jtr.params)
    return float(loss), grads, new_bs


def _by_torch_name(ttr, jax_tree):
    """A JAX params-shaped tree as {port parameter name: numpy array}, linear
    kernels transposed to the port's (out, in)."""
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, jax_tree), sep="/")
    linear = {f"{p}.weight" for p, m in ttr.model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    out = {}
    for name, path in jax_param_paths(ttr.model).items():
        if path in flat:
            out[name] = flat[path].T if name in linear else flat[path]
    return out


def _bn_stats(ttr):
    return {k: v.clone() for k, v in ttr.model.state_dict().items() if "running_" in k}


def _weights(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


# ------------------------------------------------------------- gradients
def test_step_loss_and_gradients_match_jax_on_a_block_with_padding_scenes(pair):
    jtr, ttr = pair
    batch = _tail_block(jtr.data_train, jtr.n_max)
    want_loss, want_grads, _ = _jax_loss_grads_stats(jtr, batch)
    before = _weights(ttr)
    ttr.model.train()
    loss = ttr.loss_and_grads(*_torch_args(batch))
    ttr.model.eval()
    ttr.model.load_state_dict(before)            # leave the pair as it was
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    want = _by_torch_name(ttr, want_grads)
    got = {n: p.grad.numpy() for n, p in ttr.model.named_parameters() if p.grad is not None}
    # every parameter the JAX model has gets a gradient, and no other
    assert set(got) == set(want)
    assert any(np.abs(g).max() > 1e-3 for g in got.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-4, err_msg=name)


def test_step_loss_divides_by_the_batch_size_not_by_the_real_scenes(pair):
    _, ttr = pair
    batch = _tail_block(ttr.data_train, ttr.n_max)
    obs, pred, valid, scene_valid = _torch_args(batch)
    with torch.no_grad():
        full = ttr._chunk_loss(obs, pred, valid, scene_valid)
        halves = ttr._chunk_loss(obs[:2], pred[:2], valid[:2], scene_valid[:2])
        # the padding rows carry no loss
        np.testing.assert_allclose(float(full), float(halves), rtol=1e-6)
        one = ttr._chunk_loss(obs[:1], pred[:1], valid[:1], scene_valid[:1])
        two = ttr._chunk_loss(obs[1:2], pred[1:2], valid[1:2], scene_valid[1:2])
    np.testing.assert_allclose(float(one + two), float(full), rtol=1e-5)


# --------------------------------------------------------- BN statistics
def test_bn_statistics_after_one_step_match_the_jax_step(tmp_path):
    """On a block whose last rows are padding scenes the running statistics
    must move by the validity-weighted mean (<= 1e-6 against the JAX step's
    new_bs); the plain mean over the block's rows is far from it."""
    jtr, ttr = _pair("stgcnn", tmp_path)
    batch = _tail_block(jtr.data_train, jtr.n_max)
    step = jtr._build_train_step()
    old = jax.tree_util.tree_map(np.asarray, jtr.batch_stats)
    _, new_bs, _, _ = step(jtr.params, jtr.batch_stats, jtr.opt_state, *_jax_args(batch),
                           jax.random.PRNGKey(0), jtr.et, jtr._sd)
    ttr.model.train()
    ttr.loss_and_grads(*_torch_args(batch))
    got = _bn_stats(ttr)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, new_bs), sep=".")
    flat_old = traverse_util.flatten_dict(old, sep=".")
    assert len(flat) == 6
    for key, want in flat.items():
        name = key.replace(".mean", ".running_mean").replace(".var", ".running_var")
        np.testing.assert_allclose(got[name].numpy(), want, atol=1e-6, rtol=1e-6, err_msg=key)
        # What the plain mean over the 4 rows would give: padding rows have
        # mean 0 and variance 0, so it moves half as far from the old value.
        plain = 0.9 * flat_old[key] + 0.5 * (want - 0.9 * flat_old[key])
        assert np.abs(plain - want).max() > 1e-3, key


@pytest.mark.parametrize("baseline", BASELINES)
@pytest.mark.parametrize("m", [2, 4])
def test_micro_batches_equal_the_whole_block(tmp_path, baseline, m):
    """Gradients and BN statistics of micro_batches 2 and 4 equal those of 1
    (f32 sums in another order: atol 1e-6, rtol 1e-5), on a block of 8 rows
    with 3 padding scenes; the chunks start from the pre-step statistics."""
    splits = _splits()
    whole = _torch_trainer(baseline, tmp_path, splits=splits, batch_size=8)
    whole.init_descriptor()
    split = _torch_trainer(baseline, tmp_path, splits=splits, batch_size=8, micro_batches=m)
    split.model.load_state_dict(whole.model.state_dict())
    split.et = whole.et
    batch = pad_scenes(whole.data_train, [0, 1, 2, 3, 4], whole.n_max, 8)
    results = []
    for tr in (whole, split):
        tr.model.train()
        loss = tr.loss_and_grads(*_torch_args(batch))
        results.append((float(loss), {n: p.grad for n, p in tr.model.named_parameters()
                                      if p.grad is not None}, _bn_stats(tr)))
    (l1, g1, s1), (lm, gm, sm) = results
    np.testing.assert_allclose(lm, l1, rtol=1e-6)
    assert set(g1) == set(gm) and (baseline != "stgcnn" or len(s1) == 6)
    for name in g1:
        np.testing.assert_allclose(gm[name].numpy(), g1[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    for name in s1:
        np.testing.assert_allclose(sm[name].numpy(), s1[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)


def test_micro_batches_must_divide_the_block(tmp_path):
    tr = _torch_trainer("stgcnn", tmp_path, micro_batches=3)
    tr.init_descriptor()
    tr.model.train()
    with pytest.raises(ValueError):
        tr.loss_and_grads(*_torch_args(_tail_block(tr.data_train, tr.n_max)))


def test_evaluation_leaves_the_bn_statistics_alone_and_training_moves_them(tmp_path):
    tr = _torch_trainer("stgcnn", tmp_path)
    tr.init_descriptor()
    before = _bn_stats(tr)
    tr.valid(0)
    tr.test()
    assert not tr.model.training
    assert all(torch.equal(v, before[k]) for k, v in _bn_stats(tr).items())
    tr.train(0)
    assert not tr.model.training               # back in eval mode after the epoch
    after = _bn_stats(tr)
    assert all(not torch.equal(v, before[k]) for k, v in after.items())
    tr.valid(1)
    tr.test()
    assert all(torch.equal(v, after[k]) for k, v in _bn_stats(tr).items())


# ------------------------------------------------------------- optimizer
def _injected_gradients(jtr, rng, step):
    """A params-shaped tree of random gradients; step 1 holds a NaN entry and
    step 2 a global norm above the clip of 10."""
    leaves, treedef = jax.tree_util.tree_flatten(jtr.params)
    scale = 50.0 if step == 2 else 0.1
    grads = [rng.normal(size=x.shape).astype(np.float32) * scale for x in leaves]
    if step == 1:
        grads[0].flat[0] = np.nan
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g) for g in grads])


@pytest.mark.parametrize("baseline,wd_exclude", [("stgcnn", ()), ("stgcnn", ("bias", "_bn")),
                                                 ("sgcn", ()), ("sgcn", ("alpha",))])
def test_update_rule_matches_the_jax_optimizer_chain(tmp_path, baseline, wd_exclude):
    """Five updates from injected gradients through jtr.tx (zero_nans, clip,
    AdamW with the wd mask) and through apply_gradients, <= 1e-6, with the
    epoch's learning rate set on both sides."""
    import optax

    jtr, ttr = _pair(baseline, tmp_path, wd_exclude=wd_exclude, weight_decay=0.1)
    rng = np.random.default_rng(0)
    params, opt_state = jtr.params, jtr.opt_state
    for step in range(5):
        lr = ttr._epoch_lr(64 * step)
        grads = _injected_gradients(jtr, rng, step)
        if step == 2:
            assert float(optax.global_norm(grads)) > jtr.cfg.clip_grad
        jtr.opt_state = opt_state
        jtr._set_lr(lr)
        updates, opt_state = jtr.tx.update(grads, jtr.opt_state, params)
        params = optax.apply_updates(params, updates)

        ttr._set_lr(lr)
        ttr.optimizer.zero_grad(set_to_none=True)
        by_name = _by_torch_name(ttr, grads)
        for name, p in ttr.model.named_parameters():
            if name in by_name:
                p.grad = torch.from_numpy(np.array(by_name[name]))
        ttr.apply_gradients()
        want = _by_torch_name(ttr, params)
        got = dict(ttr.model.named_parameters())
        for name in want:
            assert np.isfinite(want[name]).all()
            np.testing.assert_allclose(got[name].detach().numpy(), want[name], atol=1e-6,
                                       rtol=1e-6, err_msg=f"step {step} {name}")


def test_clip_is_optax_clip_not_clip_grad_norm(tmp_path):
    """A norm just under the clip leaves the gradient untouched (torch's
    clip_grad_norm_ would scale it by max_norm / (norm + 1e-6) only above it
    too, but with another factor); a norm above it scales to the clip."""
    tr = _torch_trainer("stgcnn", tmp_path, lr=0.0, weight_decay=0.0)
    p = next(tr.model.parameters())
    for norm, want in ((9.999, 9.999), (10.0, 10.0), (40.0, 10.0)):
        tr.optimizer.zero_grad(set_to_none=True)
        p.grad = torch.full_like(p, norm / p.numel() ** 0.5)
        tr.apply_gradients()
        np.testing.assert_allclose(float(p.grad.norm()), want, rtol=1e-6)
    tr.optimizer.zero_grad(set_to_none=True)
    p.grad = torch.full_like(p, float("inf"))      # only NaN is zeroed, as optax.zero_nans
    p.grad.flatten()[0] = float("nan")
    tr.cfg.clip_grad = None
    tr.apply_gradients()
    assert p.grad.flatten()[0] == 0 and torch.isinf(p.grad.flatten()[1:]).all()


@pytest.mark.parametrize("warmup", [0, 5])
def test_epoch_lr_matches_jax_for_epochs_0_to_255(tmp_path, warmup):
    kw = dict(warmup_epochs=warmup, lr_schd_step=64)
    jtr = ETJaxTrainer(JaxConfig(**_cfg_kw("stgcnn", tmp_path, **kw)), test_mode=True,
                       datasets=_splits())
    ttr = _torch_trainer("stgcnn", tmp_path, **kw)
    assert [ttr._epoch_lr(e) for e in range(256)] == [jtr._epoch_lr(e) for e in range(256)]
    assert ttr._epoch_lr(255) == 1e-3 * 0.5 ** 3
    ttr._set_lr(ttr._epoch_lr(70))
    assert all(g["lr"] == 5e-4 for g in ttr.optimizer.param_groups)


# ----------------------------------------------------------- whole steps
def test_three_whole_steps_match_the_jax_trainer_by_their_losses(pair):
    jtr, ttr = pair
    before = _weights(ttr)
    step = jtr._build_train_step()
    params, bs, opt = jtr.params, jtr.batch_stats, jtr.opt_state
    # the JAX step donates its inputs: give it copies
    params, bs, opt = jax.tree_util.tree_map(jnp.array, (params, bs, opt))
    batches = list(JaxSceneBatcher(jtr.data_train, BATCH, True, jtr.n_max, seed=0))
    assert len(batches) == 3 and not batches[-1].scene_valid.all()
    ttr.model.train()
    ttr._set_lr(ttr._epoch_lr(0))
    for i, batch in enumerate(batches):
        params, bs, opt, want = step(params, bs, opt, *_jax_args(batch),
                                     jax.random.PRNGKey(i), jtr.et, jtr._sd)
        got = ttr.train_step(*_torch_args(batch))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4, err_msg=f"step {i}")
    ttr.model.eval()
    assert any(not torch.equal(v, before[k]) for k, v in _weights(ttr).items())
    ttr.model.load_state_dict(before)
    ttr.optimizer = ttr._make_optimizer()


def test_a_non_finite_scene_loss_is_zeroed_and_the_weights_stay_finite(tmp_path):
    tr = _torch_trainer("stgcnn", tmp_path)
    tr.init_descriptor()
    batch = pad_scenes(tr.data_train, [0, 1, 2, 3], tr.n_max, BATCH)
    obs, pred, valid, scene_valid = _torch_args(batch)
    tr.model.train()                # each scene normalizes with its own statistics
    with torch.no_grad():
        rest = tr._chunk_loss(obs[1:], pred[1:], valid[1:], scene_valid[1:])
    pred[0, 0, 3, 0] = float("inf")
    loss = tr.train_step(obs, pred, valid, scene_valid)
    np.testing.assert_allclose(float(loss), float(rest), rtol=1e-5)
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())


# ------------------------------------------------------------------ fit
@pytest.mark.parametrize("baseline", BASELINES)
def test_fit_lowers_the_loss_and_writes_what_load_model_reads(tmp_path, baseline):
    tr = _torch_trainer(baseline, tmp_path, tag="fit", lr=3e-3)
    tr.init_descriptor()
    tr.fit(num_epochs=6, verbose=False)
    log = tr.log
    assert len(log["train_loss"]) == len(log["val_loss"]) == 6
    assert all(np.isfinite(v) for v in log["train_loss"] + log["val_loss"])
    assert log["train_loss"][-1] < log["train_loss"][0]
    assert tr.step_timer.summary()["count"] == 6 * 3
    with open(os.path.join(tr.checkpoint_dir, "log.pkl"), "rb") as fp:
        saved = pickle.load(fp)
    assert set(saved) == {"train_loss", "val_loss"}
    assert all(type(v) is float for v in saved["train_loss"] + saved["val_loss"])
    assert not os.path.exists(os.path.join(tr.checkpoint_dir, "config.pkl"))
    # the checkpoint is the best-val epoch's: a fresh trainer reads it
    fresh = _torch_trainer(baseline, tmp_path, tag="fit")
    fresh.load_model()
    res = fresh.test()
    assert all(np.isfinite(v) for v in res.values())
    if int(np.argmin(log["val_loss"])) == 5:
        assert res == tr.test()


def test_fit_keeps_the_best_val_rule(tmp_path, monkeypatch):
    """A checkpoint is written at epoch 0 and wherever the val loss is below
    every earlier one (strictly)."""
    tr = _torch_trainer("stgcnn", tmp_path, tag="best")
    tr.init_descriptor()
    script = iter([3.0, 2.0, 2.0, 2.5, 1.0])
    saved = []

    def scripted_valid(epoch):
        tr.log["val_loss"].append(next(script))

    monkeypatch.setattr(tr, "valid", scripted_valid)
    monkeypatch.setattr(tr, "train", lambda epoch: tr.log["train_loss"].append(0.0))
    monkeypatch.setattr(tr, "save_model", lambda: saved.append(len(tr.log["val_loss"]) - 1))
    tr.fit(num_epochs=5, verbose=False)
    assert saved == [0, 1, 4]


def test_fit_prints_the_progress_and_timing_lines(tmp_path, capsys):
    tr = _torch_trainer("stgcnn", tmp_path, tag="lines")
    tr.init_descriptor()
    tr.fit(num_epochs=1)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synthetic/stgcnn] epoch 0 train ") and " best " in out[0]
    assert out[1].startswith("[timing] epochs: mean ") and "train steps (3)" in out[1]


@pytest.mark.parametrize("baseline", BASELINES)
def test_resume_equals_a_straight_run_bitwise(tmp_path, baseline):
    splits = _splits()
    straight = _torch_trainer(baseline, tmp_path, tag="straight", splits=splits)
    straight.init_descriptor()
    straight.fit(num_epochs=4, verbose=False)

    first = _torch_trainer(baseline, tmp_path, tag="resumed", splits=splits)
    first.init_descriptor()
    first.fit(num_epochs=2, verbose=False, checkpoint_every=2)
    assert os.path.exists(os.path.join(first.checkpoint_dir, "resume.pt"))
    second = _torch_trainer(baseline, tmp_path, tag="resumed", splits=splits)
    second.fit(num_epochs=4, verbose=False, resume=True)
    assert len(second.epoch_timer.durations) == 2          # epochs 2 and 3 only
    assert second.log == straight.log
    want = straight.model.state_dict()
    for key, value in second.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    assert torch.equal(second.et.anchor_m, straight.et.anchor_m)
    assert torch.equal(second.generator.get_state(), straight.generator.get_state())
    s1, s2 = straight.optimizer.state_dict()["state"], second.optimizer.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for key in s1:
        assert torch.equal(s1[key]["exp_avg_sq"], s2[key]["exp_avg_sq"])
        assert float(s1[key]["step"]) == float(s2[key]["step"]) == 12.0


def test_resume_from_a_file_without_the_dropout_stream(tmp_path):
    """A resume.pt written before the dropout generator was saved resumes
    with the freshly seeded generator: ET-STGCNN draws no dropout, so the
    run is the straight one."""
    straight = _torch_trainer("stgcnn", tmp_path, tag="straight")
    straight.init_descriptor()
    straight.fit(num_epochs=2, verbose=False)
    first = _torch_trainer("stgcnn", tmp_path, tag="old")
    first.init_descriptor()
    first.fit(num_epochs=1, verbose=False, checkpoint_every=1)
    path = os.path.join(first.checkpoint_dir, "resume.pt")
    state = torch.load(path, weights_only=True)
    del state["dropout_generator"]
    torch.save(state, path)
    second = _torch_trainer("stgcnn", tmp_path, tag="old")
    second.fit(num_epochs=2, verbose=False, resume=True)
    assert len(second.epoch_timer.durations) == 1 and second.log == straight.log
    seeded = torch.Generator().manual_seed(second.cfg.seed).get_state()
    assert torch.equal(second.dropout_generator.get_state(), seeded)


def test_resume_without_a_file_starts_at_epoch_0(tmp_path):
    tr = _torch_trainer("stgcnn", tmp_path, tag="nofile")
    assert tr.load_resume_state() == 0
    tr.init_descriptor()
    tr.fit(num_epochs=1, verbose=False, resume=True)
    assert len(tr.log["train_loss"]) == 1


def test_train_needs_the_descriptor(tmp_path):
    with pytest.raises(RuntimeError):
        _torch_trainer("stgcnn", tmp_path).train(0)


def test_the_seed_makes_the_initial_weights_and_leaves_the_global_stream(tmp_path):
    torch.manual_seed(5)
    state = torch.get_rng_state()
    a = _torch_trainer("stgcnn", tmp_path)
    assert torch.equal(torch.get_rng_state(), state)
    b = _torch_trainer("stgcnn", tmp_path)
    c = _torch_trainer("stgcnn", tmp_path, seed=1)
    assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    assert not torch.equal(a.model.tpcnn_0.weight, c.model.tpcnn_0.weight)


# ------------------------------------------------- DropEdge's stream (ET-DMRGCN)
def _dmrgcn_pair(tmp_path, m):
    """Two ET-DMRGCN trainers, micro_batches 1 and `m`, with the same
    weights, ET parameters and generator states, on a block of 8 rows whose
    last 3 are padding scenes."""
    splits = _splits()
    whole = _torch_trainer("dmrgcn", tmp_path, splits=splits, batch_size=8)
    whole.init_descriptor()
    split = _torch_trainer("dmrgcn", tmp_path, splits=splits, batch_size=8, micro_batches=m)
    split.model.load_state_dict(whole.model.state_dict())
    split.et = whole.et
    batch = pad_scenes(whole.data_train, [0, 1, 2, 3, 4], whole.n_max, 8)
    return whole, split, batch


def test_drop_edge_micro_batches_equal_the_whole_block(tmp_path):
    """DropEdge on: micro_batches 2 gives the loss and gradients of 1 (the
    chunks take their rows of the masks drawn for the whole block; f32 sums
    in another order), and leaves the dropout generator in the same state.
    Torch's global stream is neither read nor moved."""
    whole, split, batch = _dmrgcn_pair(tmp_path, 2)
    global_state = torch.get_rng_state()
    results = []
    for tr in (whole, split):
        tr.model.train()
        loss = tr.loss_and_grads(*_torch_args(batch))
        tr.model.eval()
        results.append((float(loss), {n: p.grad for n, p in tr.model.named_parameters()}))
    assert torch.equal(torch.get_rng_state(), global_state)
    (l1, g1), (l2, g2) = results
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for name, g in g1.items():
        # 1e-6 relative; an entry near 0 is held to 1e-6 of its tensor's scale
        np.testing.assert_allclose(g2[name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(g.abs().max()), err_msg=name)
    start = torch.Generator().manual_seed(whole.cfg.seed).get_state()
    assert not torch.equal(whole.dropout_generator.get_state(), start)
    assert torch.equal(whole.dropout_generator.get_state(), split.dropout_generator.get_state())
    # DropEdge was on: the eval-mode loss (no edges dropped) is another one.
    with torch.no_grad():
        no_drop = whole._chunk_loss(*_torch_args(batch))
    assert abs(float(no_drop) - l1) > 1e-6 * abs(l1)


def test_drop_edge_masks_come_from_the_step_and_can_be_handed_in(tmp_path):
    """A step draws one (B, R, T, N, N) mask a DropEdge layer from the
    trainer's generator; masks handed in give the same step, and none is
    left on the model after it (a train-mode forward outside a step
    raises)."""
    whole, _, batch = _dmrgcn_pair(tmp_path, 2)
    args = _torch_args(batch)
    start = whole.dropout_generator.get_state()
    keeps = draw_edge_keeps(whole.model, whole.dropout_generator, *args[0].shape[:2])
    assert [tuple(k.shape) for k in keeps] == [(8, 5, 8, whole.n_max, whole.n_max)] * 2
    whole.dropout_generator.set_state(start)
    whole.model.train()
    drawn = float(whole.loss_and_grads(*args))
    handed = float(whole.loss_and_grads(*args, edge_keeps=keeps))
    assert drawn == handed
    assert all(m.keep is None for m in whole.model.modules() if hasattr(m, "keep"))
    with pytest.raises(RuntimeError, match="kept-edge mask"):
        whole._chunk_loss(*args)
    whole.model.eval()


def test_drop_edge_masks_are_neither_buffers_nor_checkpoint_leaves(tmp_path):
    tr = _torch_trainer("dmrgcn", tmp_path, tag="leaves")
    tr.init_descriptor()
    tr.fit(num_epochs=1, verbose=False, checkpoint_every=1)
    assert list(tr.model.buffers()) == []
    tree = read_flax_msgpack(os.path.join(tr.checkpoint_dir, "model_best.msgpack"))
    assert tree["batch_stats"] == {}
    leaves = set(traverse_util.flatten_dict(tree["params"], sep="/"))
    assert leaves == set(jax_param_paths(tr.model).values())
    assert not any("drop_edge" in leaf or "keep" in leaf for leaf in leaves)
    state = torch.load(os.path.join(tr.checkpoint_dir, "resume.pt"), weights_only=True)
    assert set(state["model"]) == set(tr.model.state_dict())
    assert not any("keep" in key for key in state["model"])


def test_drop_edge_fit_resumes_bitwise(tmp_path):
    """fit(1) + resume.pt + fit(2) equals fit(2) bit for bit on the CPU: the
    dropout generator's state travels in resume.pt."""
    splits = _splits()
    straight = _torch_trainer("dmrgcn", tmp_path, tag="straight", splits=splits)
    straight.init_descriptor()
    straight.fit(num_epochs=2, verbose=False)
    first = _torch_trainer("dmrgcn", tmp_path, tag="resumed", splits=splits)
    first.init_descriptor()
    first.fit(num_epochs=1, verbose=False, checkpoint_every=1)
    second = _torch_trainer("dmrgcn", tmp_path, tag="resumed", splits=splits)
    second.fit(num_epochs=2, verbose=False, resume=True)
    assert len(second.epoch_timer.durations) == 1 and second.log == straight.log
    want = straight.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in second.model.state_dict().items())
    assert torch.equal(second.dropout_generator.get_state(),
                       straight.dropout_generator.get_state())


# ------------------------------------- groups and zones (GP-Graph, Implicit)
GROUP_ZONE = ("gpgraphstgcnn", "gpgraphsgcn", "implicit")


def _predictor_inputs(ttr, batch):
    """The (c_obs, obs_ori) the port's projection hands its predictor on
    `batch`, as numpy arrays."""
    seen, own = [], ttr._predictor_fn

    def noting(c_obs, obs_ori, aux):
        seen.append((c_obs.detach().numpy().copy(), obs_ori.detach().numpy().copy()))
        return own(c_obs, obs_ori, aux)

    ttr._predictor_fn = noting
    try:
        with torch.no_grad():
            ttr._chunk_loss(*_torch_args(batch))
    finally:
        del ttr._predictor_fn
    return seen[0]


def _groups_and_zones(ttr, batch, jtr=None):
    """Make grouping or zoning happen on `batch`, on the port's trainer and
    on the JAX one alike. GP-Graph: `th` at the midpoint between two
    adjacent distinct pair distances of the JAX `dist_mat` of the block's
    predictor inputs (no distance within rounding of it), asserting a group
    of two or more and a singleton. Implicit: the first column of both
    U_obs scaled by 0.03, which moves the first coefficients (|c_0| ~1-13
    on these splits, all in the last zone) over the middle zones, asserting
    two zones used and one empty; and every cell's global_w and local_w
    drawn in [0.5, 1.5] (the init's 0 gives every conv of the cells a zero
    gradient). Returns Implicit's set of zones used."""
    from tests import test_torch_gpgraph as tg
    from eigentrajectory_tpu_torch.models import implicit as timp

    name = ttr.cfg.baseline
    valid = batch.ped_valid
    if name == "implicit":
        def scaled(et):
            def basis(b):
                u = b.U_obs * 1.0
                u = u.at[:, 0].multiply(0.03) if hasattr(u, "at") else \
                    torch.cat([u[:, :1] * 0.03, u[:, 1:]], dim=1)
                return type(b)(u, b.U_pred)
            return et._replace(basis_m=basis(et.basis_m), basis_s=basis(et.basis_s))

        ttr.et = scaled(ttr.et)
        if jtr is not None:
            jtr.et = scaled(jtr.et)
        rng = np.random.default_rng(5)
        drawn = {f"cell_{i}": {w: rng.uniform(0.5, 1.5, size=(1,)).astype(np.float32)
                               for w in ("global_w", "local_w")} for i in range(len(timp.BINS))}
        with torch.no_grad():
            for cell, ws in drawn.items():
                for w, value in ws.items():
                    ttr.model.get_parameter(f"{cell}.{w}").copy_(torch.from_numpy(value))
        if jtr is not None:
            jtr.params = {**jtr.params, **{cell: {**jtr.params[cell], **{
                w: jnp.asarray(value) for w, value in ws.items()}} for cell, ws in drawn.items()}}
        c_obs, _ = _predictor_inputs(ttr, batch)
        zone = timp.zones(torch.from_numpy(c_obs)[:, None]).numpy()
        edges = np.array(timp.BINS[1:], np.float32)
        assert np.abs(np.abs(c_obs[:, 0][valid])[:, None] - edges).min() > 1e-4
        return _assert_zones_spread(zone, valid)
    jm = {"gpgraphstgcnn": tg.jstgcnn, "gpgraphsgcn": tg.jsgcn}[name]
    gcn = {"kernel": ttr.model.group_gen.group_cnn.weight.detach().numpy(),
           "bias": ttr.model.group_gen.group_cnn.bias.detach().numpy()}
    c_obs, ori = _predictor_inputs(ttr, batch)
    dist = tg.jax_dist_mats(jm, gcn, c_obs, ori, valid)
    th = tg.threshold(dist, valid)
    tg.assert_groups_form(tg.jax_ranks(dist, th, valid)[0], valid)
    with torch.no_grad():
        ttr.model.group_gen.th.fill_(th)
    if jtr is not None:
        jtr.params = {**jtr.params, "group_gen": {**jtr.params["group_gen"],
                                                  "th": jnp.asarray([th], jnp.float32)}}


def _assert_zones_spread(zone, valid):
    used = set(zone[valid].tolist())
    assert 2 <= len(used) < 4, used
    return used


def _assert_cells_learn(grads, used):
    """Implicit: the convs of the cells of the zones used, and of no other,
    have a nonzero gradient."""
    for conv in ("feat", "tpcnn", "ped.feat.conv", "ped.tpcnn.conv"):
        learning = {i for i in range(4) if np.abs(grads[f"cell_{i}.{conv}.weight"]).max() > 0}
        assert learning == used, (conv, learning, used)


@pytest.fixture
def jitted_jax_init(monkeypatch):
    """Have the JAX trainer initialise the group and zone models jitted (an
    eager init of the GP-Graph SGCN takes ~10 s on the CPU); the variables
    are the same."""
    from eigentrajectory_tpu.models import get_baseline as jax_baseline

    for name in GROUP_ZONE:
        module = jax_baseline(name)

        def make_model(cfg, make=module.make_model):
            model = make(cfg)
            init = model.init
            object.__setattr__(model, "init", lambda rngs, *args, train=False: jax.jit(
                lambda r, *a: init(r, *a, train=train))(rngs, *args))
            return model

        monkeypatch.setattr(module, "make_model", make_model)


@pytest.mark.parametrize("baseline", GROUP_ZONE)
def test_group_and_zone_steps_match_jax(tmp_path, baseline, jitted_jax_init):
    """One step on a block of 4 rows, the last two padding scenes, from the
    weights and ET parameters of the JAX trainer's checkpoint: loss within
    1e-5 relative, gradients (atol 1e-5, rtol 1e-4), GP-Graph-STGCNN's BN
    statistics after its three streams within 1e-5 of the JAX step's.
    GP-Graph's `group_cnn` gradient is NaN on both sides (the norm's
    gradient at a zero difference) and Implicit's `noise_w` gets a zero one,
    not None; the optimizer zeroes the NaN as optax.zero_nans does, and
    both tensors move by the weight decay alone, on both sides."""
    jtr, ttr = _pair(baseline, tmp_path)
    batch = _tail_block(jtr.data_train, jtr.n_max)
    used = _groups_and_zones(ttr, batch, jtr)
    want_loss, want_grads, want_bs = _jax_loss_grads_stats(jtr, batch, jit=True)
    ttr.model.train()
    loss = ttr.loss_and_grads(*_torch_args(batch))
    ttr.model.eval()
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    want = _by_torch_name(ttr, want_grads)
    got = {n: p.grad.numpy() for n, p in ttr.model.named_parameters() if p.grad is not None}
    assert set(got) == set(want)
    nan = {n for n in want if np.isnan(want[n]).any()}
    assert nan == ({"group_gen.group_cnn.weight", "group_gen.group_cnn.bias"}
                   if baseline != "implicit" else set())
    if baseline == "implicit":
        _assert_cells_learn(want, used)
    for name in want:
        if name in nan:
            assert np.isnan(want[name]).all() and np.isnan(got[name]).all(), name
        else:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-4,
                                       err_msg=name)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want_bs), sep=".")
    stats = _bn_stats(ttr)
    assert len(flat) == len(stats) == (6 if baseline == "gpgraphstgcnn" else 0)
    for key, value in flat.items():
        name = key.replace(".mean", ".running_mean").replace(".var", ".running_var")
        np.testing.assert_allclose(stats[name].numpy(), value, atol=1e-5, rtol=1e-5,
                                   err_msg=key)

    # The optimizer: JAX's chain on its gradients, the port's on its own.
    watched = {n for n in want if n in nan or "noise_w" in n}
    assert watched
    before = {n: p.detach().clone() for n, p in ttr.model.named_parameters() if n in watched}
    if baseline == "implicit":
        with torch.no_grad():
            for n in watched:
                ttr.model.get_parameter(n).fill_(0.5)
                before[n].fill_(0.5)
        for cell in jtr.params:
            jtr.params = {**jtr.params, cell: {**jtr.params[cell],
                                               "noise_w": jnp.asarray([0.5], jnp.float32)}}
        assert all(not got[n].any() for n in watched)
    updates, _ = jax.jit(jtr.tx.update)(want_grads, jtr.opt_state, jtr.params)
    jax_new = _by_torch_name(ttr, optax_apply(jtr.params, updates))
    ttr.apply_gradients()
    decay = 1.0 - ttr.cfg.lr * ttr.cfg.weight_decay
    for n in watched:
        p = ttr.model.get_parameter(n)
        assert not p.grad.any(), n
        np.testing.assert_allclose(p.detach().numpy(), before[n].numpy() * decay, rtol=1e-6,
                                   err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(), jax_new[n], rtol=1e-6, err_msg=n)


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


@pytest.mark.parametrize("baseline", GROUP_ZONE)
def test_group_and_zone_micro_batches_equal_the_whole_block(tmp_path, baseline):
    """micro_batches 2 gives the loss, gradients and (GP-Graph-STGCNN) BN
    statistics of 1 on a block of 8 rows with 3 padding scenes, groups and
    zones formed: the relabel is per scene, and the three streams' BN
    updates average by valid scenes chunk by chunk (f32 sums in another
    order: 1e-6 relative, 1e-6 of a tensor's scale near 0; NaN where NaN,
    the whole of `group_cnn`'s gradient)."""
    splits = _splits()
    whole = _torch_trainer(baseline, tmp_path, splits=splits, batch_size=8, micro_batches=1)
    whole.init_descriptor()
    batch = pad_scenes(whole.data_train, [0, 1, 2, 3, 4], whole.n_max, 8)
    used = _groups_and_zones(whole, batch)
    split = _torch_trainer(baseline, tmp_path, splits=splits, batch_size=8, micro_batches=2)
    split.model.load_state_dict(whole.model.state_dict())
    split.et = whole.et
    results = []
    for tr in (whole, split):
        tr.model.train()
        loss = tr.loss_and_grads(*_torch_args(batch))
        tr.model.eval()
        results.append((float(loss), {n: p.grad for n, p in tr.model.named_parameters()
                                      if p.grad is not None}, _bn_stats(tr)))
    (l1, g1, s1), (l2, g2, s2) = results
    if baseline == "implicit":
        _assert_cells_learn({n: g.numpy() for n, g in g1.items()}, used)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert set(g1) == set(g2) and len(s1) == (6 if baseline == "gpgraphstgcnn" else 0)
    # A conv bias in front of a BatchNorm has a true gradient of 0 and holds
    # rounding noise of ~1e-8 of the largest entry of any gradient (the
    # chunks sum the BN's terms in another order): a tensor's scale is at
    # least 1e-2 of that entry.
    floor = 1e-2 * max(float(g.abs().max()) for g in g1.values() if torch.isfinite(g).all())
    for name, g in g1.items():
        if torch.isnan(g).any():
            assert torch.isnan(g2[name]).all() and torch.isnan(g).all(), name
            continue
        np.testing.assert_allclose(g2[name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6 * max(float(g.abs().max()), floor), err_msg=name)
    for name in s1:
        np.testing.assert_allclose(s2[name].numpy(), s1[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("baseline", GROUP_ZONE)
def test_group_and_zone_models_fit_test_and_predict_on_the_cpu(tmp_path, baseline):
    """init_descriptor(), fit(2) with micro_batches 2, load_model() + test()
    and ETPredictor.predict() of a two-scene request: finite throughout, a
    fresh trainer on the checkpoint gives the same means."""
    from eigentrajectory_tpu_torch.inference import ETPredictor

    tr = _torch_trainer(baseline, tmp_path, tag="fit", micro_batches=2)
    tr.init_descriptor()
    tr.fit(num_epochs=2, verbose=False)
    assert all(np.isfinite(v) for v in tr.log["train_loss"] + tr.log["val_loss"])
    tr.load_model()
    res = tr.test()
    assert all(np.isfinite(v) for v in res.values())
    fresh = _torch_trainer(baseline, tmp_path, tag="fit")
    fresh.load_model()
    assert fresh.test() == res
    obs = tr.data_test.obs_traj[:7]
    out = ETPredictor(tr, bucket=8).predict(obs, np.repeat([0, 1], [4, 3]))
    assert out.shape == (20, 7, 12, 2) and np.isfinite(out).all()


# ------------------------------------------------------------------ CLI
def _write_split(root, rng, n_frames=26):
    """A raw split directory: one tab-separated `frame ped x y` file."""
    os.makedirs(root)
    t = np.arange(n_frames)[:, None]
    rows = []
    for ped in range(4):
        xy = rng.normal(size=2) * 3 + t * rng.normal(size=2) * 0.4 \
            + 0.05 * np.cumsum(rng.normal(size=(n_frames, 2)), axis=0)
        rows += [(10.0 * f, float(ped), *xy[f]) for f in range(n_frames)]
    rows.sort()
    with open(os.path.join(root, "scene.txt"), "w") as fp:
        fp.writelines("\t".join(f"{v:.4f}" for v in row) + "\n" for row in rows)


def test_trainval_cli_trains_and_tests_on_the_cpu(tmp_path, capsys):
    import json

    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        _write_split(str(tmp_path / "data" / "toy" / split), rng)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset_dir": str(tmp_path / "data"), "checkpoint_dir": str(tmp_path / "ckpt"),
        "dataset": "toy", "baseline": "sgcn", "batch_size": 4, "static_dist": 0.3}))
    args = ["--cfg", str(cfg), "--tag", "cli", "--device", "cpu", "--baseline", "stgcnn"]
    trained = trainval.main(args + ["--epochs", "2", "--ckpt_every", "1"])
    out = capsys.readouterr().out
    assert "Scene: toy ADE: " in out and "epoch 1 train" in out
    files = set(os.listdir(tmp_path / "ckpt" / "cli" / "toy"))
    assert files == {"model_best.msgpack", "log.pkl", "resume.pt"}
    tested = trainval.main(args + ["--test"])
    assert tested == trained and np.isfinite(list(tested.values())).all()
    resumed = trainval.main(args + ["--epochs", "3", "--resume"])
    assert "epoch 2 train" in capsys.readouterr().out and set(resumed) == set(trained)
