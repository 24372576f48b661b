"""Port vs JAX package: the collated regime (packed flat-pedestrian batches
with a block-diagonal scene mask) of ET-PECNet and ET-LB-EBM.

The batcher is held bitwise; the facade's per-scene centring within 1e-5
(f32, same formulas); the packed eval on the committed univ checkpoint, and
the training step, epoch and validation from a JAX initialization carried
across by a checkpoint, within 1e-4 (the forward of a model in f32 with sums
in another order).
"""
import os

import numpy as np
import pytest
import torch

from eigentrajectory_tpu_torch.config import ExpConfig, load_config
from eigentrajectory_tpu_torch.data import batching as tbatching
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.etspace import facade as tfacade
from eigentrajectory_tpu_torch.ops import recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from eigentrajectory_tpu_torch.train import trainer as torch_trainer

try:        # the reference; a machine with the card may lack flax and optax
    import jax
    import jax.numpy as jnp

    from eigentrajectory_tpu.config import ExpConfig as JaxConfig
    from eigentrajectory_tpu.config import load_config as jax_load_config
    from eigentrajectory_tpu.data import batching as jbatching
    from eigentrajectory_tpu.etspace import facade as jfacade
    from eigentrajectory_tpu.train.trainer import ETJaxTrainer
    from tests.test_torch_etspace import _et_params, _jax_predictor, _torch_predictor
except ImportError:
    jax = None

# Every test but the card's holds the port against the JAX package.
with_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (jax, flax, optax)")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
UNIV = os.path.join(REPO, "configs", "eigentrajectory-pecnet-univ.json")
TOL = dict(atol=1e-4, rtol=1e-4)
METRICS = ("ADE", "FDE", "TCC", "COL")


def _test_split():
    return make_synthetic_data(n_scenes=24, max_peds=12, seed=4)


# ------------------------------------------------------------- batching
@with_jax
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_collated_batcher_is_bitwise_the_jax_batcher(shuffle, drop_last):
    data = make_synthetic_data(n_scenes=37, max_peds=9, seed=7)
    assert tbatching.max_collated_peds(data, 20) == jbatching.max_collated_peds(data, 20) == 28
    want = list(jbatching.CollatedBatcher(data, 20, shuffle, drop_last=drop_last, seed=3))
    batcher = tbatching.CollatedBatcher(data, 20, shuffle, drop_last=drop_last, seed=3)
    got = list(batcher)
    assert len(got) == len(want) > 3
    assert len(batcher) == len(jbatching.CollatedBatcher(data, 20, False, drop_last=drop_last))
    for g, w in zip(got, want):
        for field in ("obs", "pred", "ped_valid", "scene_ids", "non_linear"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape == (28,) + a.shape[1:], field
            assert a.tobytes() == b.tobytes(), field
    if drop_last:      # every batch holds at least batch_size pedestrians
        assert all(g.ped_valid.sum() >= 20 for g in got)


def test_scene_gather_maps_slots_to_scene_blocks_and_back():
    ids = np.array([0, 0, 1, 2, 2, 2, 1, -1, -1], np.int32)
    gather, gmask, inv_g, inv_i = tbatching.scene_gather(ids)
    assert gather.shape == gmask.shape == (3, 3)
    np.testing.assert_array_equal(gather[gmask], [0, 1, 2, 6, 3, 4, 5])
    valid = ids >= 0
    np.testing.assert_array_equal(gather[inv_g, inv_i][valid], np.flatnonzero(valid))
    np.testing.assert_array_equal(ids[gather[inv_g, inv_i]][valid], ids[valid])


# --------------------------------------------------------------- facade
def _packed(rng, sizes=(3, 5, 2, 4), pad=3):
    n = sum(sizes) + pad
    obs = np.cumsum(rng.normal(size=(n, 8, 2)) * 0.5, axis=1).astype(np.float32)
    ids = np.repeat(np.arange(len(sizes) + 1), list(sizes) + [pad]).astype(np.int32)
    ids[ids == len(sizes)] = -1
    # scenes far apart, so that a whole-batch centring differs from a per-scene one
    obs += (ids[:, None, None] * 7.0).astype(np.float32)
    obs[ids < 0] = 0.0
    return obs, ids >= 0, ids


@with_jax
def test_et_forward_centres_per_scene_with_center_scene_ids():
    """`center_scene_ids` on a packed row: the coefficients, and the origins
    the predictor sees, within 1e-5 of the JAX facade with the same aux, and
    each scene's origins are those it gets alone. The key is popped: the
    predictor never sees it."""
    rng = np.random.default_rng(5)
    jet, tet = _et_params(rng)
    obs, valid, ids = _packed(rng)
    seen = {}

    def jax_pred(c_obs, obs_ori, aux):
        seen["jax"] = obs_ori
        assert "center_scene_ids" not in aux
        return _jax_predictor(c_obs, obs_ori, aux)

    def torch_pred(c_obs, obs_ori, aux):
        seen["torch"] = obs_ori
        assert "center_scene_ids" not in aux
        return _torch_predictor(c_obs, obs_ori, aux)

    want = jfacade.et_forward(jet, jax_pred, jnp.asarray(obs), jnp.asarray(valid), 0.3,
                              aux={"center_scene_ids": jnp.asarray(ids)},
                              return_coefficients=True)
    aux = {"center_scene_ids": torch.from_numpy(ids)[None]}
    got = tfacade.et_forward(tet, torch_pred, torch.from_numpy(obs)[None],
                             torch.from_numpy(valid)[None], 0.3, aux=aux,
                             return_coefficients=True)
    assert "center_scene_ids" in aux                 # the caller's dict is left alone
    packed = seen["torch"][0].numpy()
    np.testing.assert_allclose(packed, np.asarray(seen["jax"]), atol=1e-5)
    for key in got:
        np.testing.assert_allclose(got[key][0].numpy(), np.asarray(want[key]),
                                   atol=1e-5 * max(1.0, float(np.abs(want[key]).max())),
                                   rtol=1e-5, err_msg=key)
    for sid in range(ids.max() + 1):
        sel = ids == sid
        tfacade.et_forward(tet, torch_pred, torch.from_numpy(obs[sel])[None],
                           torch.ones((1, int(sel.sum())), dtype=torch.bool), 0.3)
        np.testing.assert_allclose(packed[:, sel], seen["torch"][0].numpy(), atol=1e-5)
    # without the key the row is centred as a whole: other numbers
    tfacade.et_forward(tet, torch_pred, torch.from_numpy(obs)[None],
                       torch.from_numpy(valid)[None], 0.3)
    assert np.abs(seen["torch"][0].numpy()[:, valid] - packed[:, valid]).max() > 1.0


# ----------------------------------------------- eval on the univ checkpoint
@pytest.fixture(scope="module")
def univ():
    """(JAX trainer, port trainer), both from the committed univ checkpoint
    (ET-PECNet), on the same small synthetic splits."""
    splits = (_test_split(),) * 3
    jtr = ETJaxTrainer(jax_load_config(UNIV, checkpoint_dir=CKPT, batch_size=32),
                       tag="parity", test_mode=True, datasets=splits)
    jtr.load_model()
    ttr = ETTorchTrainer(load_config(UNIV, checkpoint_dir=CKPT, batch_size=32),
                         tag="parity", datasets=splits, device="cpu")
    ttr.load_model()
    return jtr, ttr


@with_jax
def test_packed_eval_step_per_ped_metrics_match_jax(univ):
    jtr, ttr = univ
    step = jtr._build_eval_step()
    batches = list(tbatching.CollatedBatcher(ttr.data_test, 40, False))
    assert len(batches) > 3 and not batches[0].ped_valid.all()
    for batch in batches:
        maps = tbatching.scene_gather(batch.scene_ids)
        want = step(jtr.params, jtr.batch_stats, *(jnp.asarray(x) for x in
                    (batch.obs, batch.pred, batch.ped_valid, batch.scene_ids)),
                    *(jnp.asarray(x.astype(np.int32) if x.dtype != bool else x) for x in maps),
                    jtr.et, jtr._sd)
        launches = recon.LAUNCHES
        got = ttr.packed_eval_step(*ttr._to_device(batch),
                                   *(torch.from_numpy(x) for x in maps))
        assert recon.LAUNCHES == launches          # the CPU runs the plain version
        v = batch.ped_valid
        for name, g, w in zip(METRICS, got, want):
            assert g.shape == v.shape
            np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], err_msg=name, **TOL)


@with_jax
@pytest.mark.parametrize("eval_ped_batch", [None, 40])
def test_packed_test_means_match_jax(univ, eval_ped_batch):
    jtr, ttr = univ
    want = jtr.test(eval_ped_batch=eval_ped_batch)
    got = ttr.test(eval_ped_batch=eval_ped_batch)
    for key in METRICS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert 0.0 < got["ADE"] < got["FDE"] and got["COL"] > 0.0


@with_jax
def test_packed_test_equals_the_per_scene_test(univ):
    """Many scenes a packed batch give the numbers of one scene a batch (the
    reference's evaluation): per-scene centring and the scene-gathered COL."""
    _, ttr = univ
    packed, per_scene = ttr.test(), ttr.test(eval_ped_batch=1)
    for key in METRICS:
        np.testing.assert_allclose(packed[key], per_scene[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


@with_jax
def test_packed_test_calls_the_kernel_once_a_batch_at_n_p(univ, monkeypatch):
    _, ttr = univ
    calls = []

    def noting(*args):
        calls.append(tuple(args[0].shape))
        return recon.fused_recon_metrics(*args)

    monkeypatch.setattr(torch_trainer, "fused_recon_metrics", noting)
    ttr.test(eval_ped_batch=40)
    p = 40 - 1 + ttr.data_test.max_peds_per_scene
    assert calls == [(6, p, 20)] * len(tbatching.CollatedBatcher(ttr.data_test, 40, False))


@with_jax
def test_collated_trainers_hold_p_max():
    splits = tuple(make_synthetic_data(n_scenes=n, max_peds=m, seed=s)
                   for n, m, s in ((10, 6, 1), (6, 9, 2), (6, 14, 3)))
    for baseline in ("pecnet", "lbebm"):
        tr = ETTorchTrainer(ExpConfig(baseline=baseline, batch_size=16), datasets=splits,
                            device="cpu")
        jtr = ETJaxTrainer(JaxConfig(baseline=baseline, batch_size=16), test_mode=True,
                           datasets=splits)
        assert tr.collated and tr.p_max == jtr.p_max == 16 - 1 + 9
        assert tr.n_max == jtr.n_max == 14


# ------------------------------------------------------------- training
def _splits():
    return tuple(make_synthetic_data(n_scenes=n, max_peds=8, seed=seed)
                 for n, seed in ((16, 1), (8, 2), (10, 3)))


def _pair(baseline, tmp):
    """(JAX trainer, port trainer) with the JAX package's initial weights
    and ET fit, carried across by a checkpoint."""
    kw = dict(baseline=baseline, batch_size=16, checkpoint_dir=str(tmp), dataset="synthetic",
              static_dist=0.3)
    jtr = ETJaxTrainer(JaxConfig(**kw), tag="pair", test_mode=True, datasets=_splits())
    jtr.init_descriptor()
    jtr.save_model()
    ttr = ETTorchTrainer(ExpConfig(**kw), tag="pair", datasets=_splits(), device="cpu")
    ttr.load_model()
    return jtr, ttr


@pytest.fixture(scope="module", params=["pecnet", "lbebm"])
def pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory.mktemp(request.param))


def _jax_collated_loss_and_grads(jtr, batch):
    """The JAX trainer's collated step loss (trainer.py, collated
    `train_step`) and its gradient."""
    obs, pred, valid, ids = (jnp.asarray(x) for x in
                             (batch.obs, batch.pred, batch.ped_valid, batch.scene_ids))

    def loss_fn(p):
        aux = jtr._make_aux_template(obs.shape[0], ids)
        out = jtr._scene_forward(p, jtr.batch_stats, obs, pred, valid, None, aux, train=True)
        loss = out["loss_eigentraj"] + out["loss_euclidean_ade"] + out["loss_euclidean_fde"]
        return jnp.nan_to_num(loss, nan=0.0, posinf=0.0, neginf=0.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jtr.params)
    return float(loss), grads


@with_jax
def test_collated_step_loss_and_gradients_match_jax(pair):
    """One masked mean over the packed batch's valid pedestrians, not divided
    by the batch size: loss within 1e-5 relative, gradients within 1e-5 +
    1e-4 relative of jax.value_and_grad."""
    from tests.test_torch_train import _by_torch_name

    jtr, ttr = pair
    batch = next(iter(tbatching.CollatedBatcher(ttr.data_train, 16, True, ttr.p_max,
                                                drop_last=True, seed=0)))
    assert batch.scene_ids.max() >= 2 and not batch.ped_valid.all()
    want_loss, want_grads = _jax_collated_loss_and_grads(jtr, batch)
    ttr.model.train()
    loss = ttr.loss_and_grads(*ttr._to_device(batch))
    ttr.model.eval()
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert want_loss > 0.1                 # a mean, not a sum over the batch size
    want = _by_torch_name(ttr, want_grads)
    got = {n: p.grad.numpy() for n, p in ttr.model.named_parameters() if p.grad is not None}
    assert set(got) == set(want) and len(got) == len(list(ttr.model.parameters()))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-4, err_msg=name)


@with_jax
def test_collated_valid_matches_jax(pair):
    jtr, ttr = pair
    want, got = jtr.valid(0), ttr.valid(0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jtr.log["val_loss"].clear()
    ttr.log["val_loss"].clear()


@with_jax
def test_collated_epoch_matches_the_jax_epoch(tmp_path):
    """One epoch of whole steps (same shuffle, the short last batch dropped,
    the optimizer chain) from the same start: the epoch loss, the sum of the
    step losses over the number of BATCHES, within 1e-4 relative."""
    jtr, ttr = _pair("pecnet", tmp_path)
    steps = []
    step = ttr.train_step

    def counting(*args):
        steps.append(args[2].sum().item())
        return step(*args)

    ttr.train_step = counting
    want, got = jtr.train(0), ttr.train(0)
    assert len(steps) == len(tbatching.CollatedBatcher(ttr.data_train, 16, False,
                                                       drop_last=True))
    assert all(n >= 16 for n in steps)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@with_jax
def test_collated_fit_trains_and_writes_a_checkpoint_both_packages_read(tmp_path):
    splits = _splits()
    kw = dict(baseline="lbebm", batch_size=16, checkpoint_dir=str(tmp_path),
              dataset="synthetic", static_dist=0.3, lr=3e-3)
    tr = ETTorchTrainer(ExpConfig(**kw), tag="fit", datasets=splits, device="cpu")
    tr.init_descriptor()
    tr.fit(num_epochs=3, verbose=False)
    assert all(np.isfinite(v) for v in tr.log["train_loss"] + tr.log["val_loss"])
    assert tr.log["train_loss"][-1] < tr.log["train_loss"][0]
    jtr = ETJaxTrainer(JaxConfig(**kw), tag="fit", test_mode=True, datasets=splits)
    jtr.load_model()
    fresh = ETTorchTrainer(ExpConfig(**kw), tag="fit", datasets=splits, device="cpu")
    fresh.load_model()
    want, got = jtr.test(), fresh.test()
    for key in METRICS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@with_jax
def test_trainval_cli_runs_a_collated_config_on_the_cpu(tmp_path, capsys):
    import json

    from eigentrajectory_tpu_torch import trainval
    from tests.test_torch_train import _write_split

    rng = np.random.default_rng(1)
    for split in ("train", "val", "test"):
        _write_split(str(tmp_path / "data" / "toy" / split), rng)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset_dir": str(tmp_path / "data"), "checkpoint_dir": str(tmp_path / "ckpt"),
        "dataset": "toy", "baseline": "pecnet", "batch_size": 6, "static_dist": 0.3}))
    args = ["--cfg", str(cfg), "--tag", "cli", "--device", "cpu"]
    trained = trainval.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "Scene: toy ADE: " in out and "[toy/pecnet] epoch 1 train" in out
    tested = trainval.main(args + ["--test"])
    assert tested == trained and np.isfinite(list(tested.values())).all()


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_packed_test_on_the_card_launches_once_a_packed_batch(cuda_device):
    data = make_synthetic_data(n_scenes=60, max_peds=20, seed=0)
    splits = (data,) * 3
    cfg = load_config(UNIV, checkpoint_dir=CKPT)
    card = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cuda")
    card.load_model()
    cpu = ETTorchTrainer(cfg, tag="parity", datasets=splits, device="cpu")
    cpu.load_model()
    recon.LAUNCHES = 0
    got = card.test(eval_ped_batch=128)
    torch.cuda.synchronize()
    assert recon.LAUNCHES == len(tbatching.CollatedBatcher(data, 128, False)) > 1
    want = cpu.test(eval_ped_batch=128)
    for key in METRICS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
