"""Port vs JAX package: the collated predictors ET-PECNet and ET-LB-EBM.

The forward of each predictor within 1e-4 of the JAX module (f32, sums in
another order), on the committed univ checkpoint (ET-PECNet) and on a random
JAX initialization carried across by `params_from_jax`, on a packed batch
of several scenes with padding; the social pool's softmax composition, with
a row where a cross-scene logit dominates; the serving API on the univ
checkpoint; and the univ checkpoint written back byte for byte.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.inference import ETPredictor as JaxPredictor
from eigentrajectory_tpu.models import lbebm as jlbebm
from eigentrajectory_tpu.models import pecnet as jpecnet
from eigentrajectory_tpu_torch.config import ExpConfig, load_config
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.inference import ETPredictor
from eigentrajectory_tpu_torch.interop import (jax_param_paths, params_from_jax,
                                               params_to_jax, read_flax_msgpack,
                                               write_flax_msgpack)
from eigentrajectory_tpu_torch.models import get_baseline
from eigentrajectory_tpu_torch.models import lbebm as tlbebm
from eigentrajectory_tpu_torch.models import pecnet as tpecnet
from eigentrajectory_tpu_torch.models.common import TorchMLP
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from tests.conftest import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
UNIV = os.path.join(CKPT, "parity", "univ", "model_best.msgpack")
UNIV_CFG = os.path.join(REPO, "configs", "eigentrajectory-pecnet-univ.json")
K, S = 6, 20
MODULES = {"pecnet": (jpecnet, tpecnet), "lbebm": (jlbebm, tlbebm)}


def _inputs(rng, sizes=(4, 7, 3, 5), pad=6, far=None):
    """A packed batch: c_obs (k, P), obs_ori (2, P), scene ids (P,) with -1
    on the padding, as the facade hands them to the pre-hook. `far` scales
    the first scene's inputs."""
    p = sum(sizes) + pad
    ids = np.full(p, -1, np.int32)
    ids[:sum(sizes)] = np.repeat(np.arange(len(sizes)), sizes)
    valid = ids >= 0
    c_obs = (rng.normal(size=(K, p)) * valid).astype(np.float32)
    ori = (rng.normal(size=(2, p)) * valid).astype(np.float32)
    if far is not None:
        c_obs[:, ids == 0] *= far
        ori[:, ids == 0] *= far
    return c_obs, ori, ids


def _jax_forward(jmod, params, c_obs, ori, ids):
    ids_j = jnp.asarray(ids)
    aux = {"ped_valid": ids_j >= 0, "num_samples": S,
           "scene_mask": (ids_j[:, None] == ids_j[None, :]) & (ids_j[:, None] >= 0)}
    inputs = jmod.prepare(jnp.asarray(c_obs), jnp.asarray(ori), aux)
    model = jmod.make_model(ExpConfig(k=K, num_samples=S))
    return np.asarray(jmod.finalize(model.apply({"params": params}, *inputs), aux))


def _torch_forward(model, tmod, c_obs, ori, ids):
    ids_t = torch.from_numpy(ids)[None]
    aux = {"ped_valid": ids_t >= 0, "num_samples": S,
           "scene_mask": (ids_t[:, :, None] == ids_t[:, None, :]) & (ids_t[:, :, None] >= 0)}
    with torch.no_grad():
        inputs = tmod.prepare(torch.from_numpy(c_obs)[None], torch.from_numpy(ori)[None], aux)
        return tmod.finalize(model(*inputs), aux)[0].numpy()


def _univ_tree():
    return read_flax_msgpack(UNIV)


def _models(name, init):
    """(JAX params, port model) with the same weights: the univ checkpoint's
    or a JAX initialization from a seed."""
    jmod, tmod = MODULES[name]
    tree = _univ_tree()
    if init == "random":
        c_obs, ori, ids = _inputs(np.random.default_rng(0))
        ids_j = jnp.asarray(ids)
        aux = {"ped_valid": ids_j >= 0, "num_samples": S,
               "scene_mask": ids_j[:, None] == ids_j[None, :]}
        inputs = jmod.prepare(jnp.asarray(c_obs), jnp.asarray(ori), aux)
        model = jmod.make_model(ExpConfig(k=K, num_samples=S))
        params = model.init(jax.random.PRNGKey(3), *inputs)["params"]
        tree = {"params": jax.tree_util.tree_map(np.asarray, params), "et": tree["et"]}
    state, _ = params_from_jax(tree)
    model = tmod.make_model(ExpConfig(k=K, num_samples=S)).eval()
    model.load_state_dict(state)                     # strict: every parameter filled
    return tree["params"], model


@pytest.mark.parametrize("name,init", [("pecnet", "univ"), ("pecnet", "random"),
                                       ("lbebm", "random")])
def test_forward_matches_jax_on_a_packed_batch(name, init):
    jmod, tmod = MODULES[name]
    params, model = _models(name, init)
    c_obs, ori, ids = _inputs(np.random.default_rng(1))
    want = _jax_forward(jmod, params, c_obs, ori, ids)
    got = _torch_forward(model, tmod, c_obs, ori, ids)
    assert got.shape == want.shape == (K, len(ids), S)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(want).max() > 0.01


def _masked_softmax_pool(theta, phi, g, feat, mask):
    """The social pool with a -inf masked softmax: what the reference's
    composition is NOT."""
    f = torch.bmm(theta(feat), phi(feat).transpose(1, 2)).masked_fill(~mask, float("-inf"))
    w = torch.nan_to_num(torch.softmax(f, dim=-1), nan=0.0)
    return torch.bmm(w, g(feat)) + feat


def test_social_pool_is_softmax_over_the_row_then_mask_when_a_cross_scene_logit_dominates(
        monkeypatch):
    """The first scene's inputs are scaled so that in some other scene's row
    a cross-scene logit exceeds every in-scene logit by more than f32's exp
    range: there the in-scene weights underflow to 0 and the pool returns the
    features unchanged, as the JAX module does. A masked softmax would not."""
    params, model = _models("pecnet", "univ")
    c_obs, ori, ids = _inputs(np.random.default_rng(1), far=300.0)
    want = _jax_forward(jpecnet, params, c_obs, ori, ids)
    got = _torch_forward(model, tpecnet, c_obs, ori, ids)
    # the logits of the first pool round: some row is dominated from outside its scene
    ids_t = torch.from_numpy(ids)[None]
    aux = {"ped_valid": ids_t >= 0, "num_samples": S,
           "scene_mask": ids_t[:, :, None] == ids_t[:, None, :]}
    past, dest, mask, init = tpecnet.prepare(torch.from_numpy(c_obs)[None],
                                             torch.from_numpy(ori)[None], aux)
    with torch.no_grad():
        feat = torch.cat([model.encoder_past(past), model.encoder_dest(dest), init], dim=-1)
        f = torch.bmm(model.non_local_theta(feat), model.non_local_phi(feat).transpose(1, 2))[0]
    inside = torch.where(mask[0], f, torch.tensor(float("-inf"))).amax(dim=1)
    dominated = (ids > 0) & ((f.amax(dim=1) - inside) > 110.0).numpy()
    assert dominated.any()
    rows = ids > 0
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=1e-4, rtol=1e-4)
    monkeypatch.setattr(tpecnet, "_social_pool", _masked_softmax_pool)
    other = _torch_forward(model, tpecnet, c_obs, ori, ids)
    assert np.abs(other[:, dominated] - want[:, dominated]).max() > 1e-2


def test_social_pool_of_a_row_with_no_neighbour_is_the_identity():
    _, model = _models("pecnet", "univ")
    feat = torch.randn(2, 5, 34)
    mask = torch.zeros(2, 5, 5, dtype=torch.bool)
    with torch.no_grad():
        out = tpecnet._social_pool(model.non_local_theta, model.non_local_phi,
                                   model.non_local_g, feat, mask)
    assert torch.equal(out, feat)


@pytest.mark.parametrize("name", ["pecnet", "lbebm"])
def test_forward_is_invariant_to_padding(name):
    _, tmod = MODULES[name]
    _, model = _models(name, "random")
    c_obs, ori, ids = _inputs(np.random.default_rng(4), pad=2)
    more = 9
    wide = [np.concatenate([x, np.zeros(x.shape[:-1] + (more,), x.dtype)], axis=-1)
            for x in (c_obs, ori)]
    got = _torch_forward(model, tmod, c_obs, ori, ids)
    got_wide = _torch_forward(model, tmod, *wide, np.concatenate([ids, -np.ones(more, np.int32)]))
    valid = ids >= 0
    np.testing.assert_allclose(got_wide[:, :len(ids)][:, valid], got[:, valid],
                               atol=1e-5, rtol=1e-5)


def test_torch_mlp_layers_map_to_the_jax_paths_and_its_dropout():
    _, model = _models("pecnet", "univ")
    want = set()
    for mlp, layers in _univ_tree()["params"].items():
        want |= {f"{mlp}/{layer}/{leaf}" for layer in layers for leaf in ("kernel", "bias")}
    assert set(jax_param_paths(model).values()) == want
    assert jax_param_paths(model)["encoder_past.layer_0.weight"] == "encoder_past/layer_0/kernel"
    assert model.predictor.layer_3.out_features == K * S
    lb = tlbebm.make_model(ExpConfig(k=K, num_samples=S))
    assert lb.predictor.layer_3.out_features == K * S
    assert lb.encoder_dest.layer_1.out_features == 128
    mlp = TorchMLP(4, (8, 8, 8), 2, dropout=0.3)
    np.testing.assert_allclose([d.rate for d in mlp.drops], [0.3, 0.1, 0.3])
    x = torch.randn(3, 4)
    mlp.eval()
    with torch.no_grad():
        assert torch.equal(mlp(x), mlp(x))
        assert TorchMLP(4, (8,), 2).drops is None
        assert float(TorchMLP(4, (8,), 2, discrim=True)(x).min()) > 0.0


def test_registry_holds_both_collated_predictors():
    for name in ("pecnet", "lbebm"):
        assert get_baseline(name).BATCHING == "collated"


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def predictors():
    data = make_synthetic_data(n_scenes=4, seed=1)
    splits = (data, data, data)
    jp = JaxPredictor.from_checkpoint(jax_load_config(UNIV_CFG, checkpoint_dir=CKPT),
                                      "parity", bucket=16, datasets=splits)
    tp = ETPredictor.from_checkpoint(load_config(UNIV_CFG, checkpoint_dir=CKPT),
                                     "parity", bucket=16, datasets=splits, device="cpu")
    return jp, tp


@pytest.mark.parametrize("kind", ["single", "scenes", "large"])
def test_predict_matches_the_jax_predictor(predictors, kind):
    jp, tp = predictors
    rng = np.random.default_rng(8)
    if kind == "single":
        obs, ids = make_scene(rng, n_ped=5, speed=0.4)[0], None
    else:
        sizes = (3, 6, 2, 7) if kind == "scenes" else (21,)
        obs = np.concatenate([make_scene(rng, n_ped=n, speed=0.4)[0] for n in sizes])
        ids = np.repeat(np.arange(len(sizes)) * 3 + 1, sizes)
        order = rng.permutation(len(obs))          # scenes interleaved in the request
        obs, ids = obs[order], ids[order]
    want, got = jp.predict(obs, ids), tp.predict(obs, ids)
    assert got.shape == want.shape == (S, len(obs), 12, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------- checkpoint
def test_the_univ_checkpoint_is_written_back_byte_for_byte(tmp_path):
    data = make_synthetic_data(n_scenes=3, seed=0)
    tr = ETTorchTrainer(load_config(UNIV_CFG, checkpoint_dir=CKPT), tag="parity",
                        datasets=(data, data, data), device="cpu")
    tr.load_model()
    with open(UNIV, "rb") as f:
        committed = f.read()
    out = tmp_path / "direct.msgpack"
    write_flax_msgpack(str(out), params_to_jax(tr.model, tr.et))
    assert out.read_bytes() == committed
    tr.checkpoint_dir = str(tmp_path / "saved")
    tr.save_model()
    with open(os.path.join(tr.checkpoint_dir, "model_best.msgpack"), "rb") as f:
        assert f.read() == committed
