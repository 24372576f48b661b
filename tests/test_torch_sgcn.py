"""Port vs JAX package: ET-SGCN's zero softmax, its eval forward with the
zara1 checkpoint's weights, padding invariance, and the sequenced eval
(`test()`) of the whole slice on the SGCN (tolerance 1e-4: the forward of a
trained model in f32 with sums in another order)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.data.synthetic import make_synthetic_data
from eigentrajectory_tpu.models import sgcn as jsgcn
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.interop import params_from_jax, read_flax_msgpack
from eigentrajectory_tpu_torch.models import sgcn as tsgcn
from eigentrajectory_tpu_torch.ops import recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "parity", "zara1", "model_best.msgpack")
CFG_PATH = os.path.join(REPO, "configs", "eigentrajectory-sgcn-zara1.json")
K, S = 6, 20
TOL = dict(atol=1e-4, rtol=1e-4)


class CFG:
    k = K
    num_samples = S


def _inputs(rng, b=3, n=9):
    c_obs = rng.normal(size=(b, K, n)).astype(np.float32)
    ori = rng.normal(size=(b, 2, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[0, 6:] = False
    valid[-1, 2:] = False
    return c_obs, ori, valid


def _torch_model():
    model = tsgcn.make_model(CFG)
    state, _ = params_from_jax(read_flax_msgpack(CKPT))
    model.load_state_dict(state)            # strict: every layer is used
    return model.eval()


def _torch_forward(model, c_obs, ori, valid):
    with torch.no_grad():
        aux = {"ped_valid": torch.from_numpy(valid)}
        inputs = tsgcn.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori), aux)
        return tsgcn.finalize(model(*inputs), aux).numpy()


def test_zero_softmax_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 4, 5, 5)).astype(np.float32)
    for axis in (-1, 2):
        got = tsgcn.zero_softmax(torch.from_numpy(x), dim=axis).numpy()
        want = np.asarray(jsgcn.zero_softmax(jnp.asarray(x), axis=axis))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_eval_forward_with_zara1_weights_matches_jax():
    rng = np.random.default_rng(1)
    c_obs, ori, valid = _inputs(rng)
    with open(CKPT, "rb") as f:
        variables = {"params": serialization.msgpack_restore(f.read())["params"]}
    jmodel = jsgcn.make_model(CFG)

    def one(c, o, v):
        aux = {"ped_valid": v}
        return jsgcn.finalize(jmodel.apply(variables, *jsgcn.prepare(c, o, aux),
                                           train=False), aux)

    want = np.asarray(jax.vmap(one)(jnp.asarray(c_obs), jnp.asarray(ori),
                                    jnp.asarray(valid)))
    got = _torch_forward(_torch_model(), c_obs, ori, valid)
    assert got.shape == (3, K, 9, S)
    for b in range(3):
        v = valid[b]
        np.testing.assert_allclose(got[b][:, v], want[b][:, v], err_msg=f"scene {b}", **TOL)


def test_prepare_matches_jax():
    rng = np.random.default_rng(2)
    c_obs, ori, valid = _inputs(rng)
    graph, (eye_n, eye_t), _ = tsgcn.prepare(
        torch.from_numpy(c_obs), torch.from_numpy(ori), {"ped_valid": torch.from_numpy(valid)})
    for b in range(3):
        jg, (jeye_n, jeye_t), _ = jsgcn.prepare(jnp.asarray(c_obs[b]), jnp.asarray(ori[b]),
                                                {"ped_valid": jnp.asarray(valid[b])})
        np.testing.assert_array_equal(graph[b].numpy(), np.asarray(jg)[0])
        np.testing.assert_array_equal(eye_n[b].numpy(), np.asarray(jeye_n)[0])
        np.testing.assert_array_equal(eye_t.numpy(), np.asarray(jeye_t)[0])


@pytest.mark.parametrize("pad", [1, 5])
def test_padding_invariance(pad):
    rng = np.random.default_rng(3)
    c_obs, ori, _ = _inputs(rng, b=2, n=6)
    valid = np.ones((2, 6), bool)
    model = _torch_model()
    base = _torch_forward(model, c_obs, ori, valid)
    c_p = np.concatenate([c_obs, np.full((2, K, pad), 7, np.float32)], axis=2)
    o_p = np.concatenate([ori, np.full((2, 2, pad), 7, np.float32)], axis=2)
    v_p = np.concatenate([valid, np.zeros((2, pad), bool)], axis=1)
    np.testing.assert_allclose(_torch_forward(model, c_p, o_p, v_p)[:, :, :6], base,
                               atol=2e-5)


def test_test_means_match_jax():
    ckpt = os.path.join(REPO, "checkpoints")
    data = make_synthetic_data(n_scenes=10, max_peds=8, seed=6)
    splits = (data, data, data)
    jtr = ETJaxTrainer(jax_load_config(CFG_PATH, checkpoint_dir=ckpt, n_max_peds=8),
                       tag="parity", test_mode=True, datasets=splits)
    jtr.load_model()
    ttr = ETTorchTrainer(load_config(CFG_PATH, checkpoint_dir=ckpt, n_max_peds=8),
                         tag="parity", datasets=splits, device="cpu")
    ttr.load_model()
    want = jtr.test(eval_batch=4)
    launches = recon.LAUNCHES
    got = ttr.test(eval_batch=4)
    assert recon.LAUNCHES == launches           # the CPU runs the plain version
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert 0.0 < got["ADE"] < got["FDE"]


def test_sgcn_has_no_statistics_and_trains_as_it_evaluates():
    """ET-SGCN holds no normalisation layer (no buffer: its checkpoint's
    batch_stats are empty) and its dropout rate is 0, so a train-mode forward
    is the eval-mode forward, in the port as in the JAX package."""
    rng = np.random.default_rng(6)
    c_obs, ori, valid = _inputs(rng)
    model = _torch_model()
    assert list(model.buffers()) == []
    assert read_flax_msgpack(CKPT)["batch_stats"] == {}
    base = _torch_forward(model, c_obs, ori, valid)
    np.testing.assert_array_equal(_torch_forward(model.train(), c_obs, ori, valid), base)
    with open(CKPT, "rb") as f:
        params = serialization.msgpack_restore(f.read())["params"]
    jmodel = jsgcn.make_model(CFG)
    jout = jax.vmap(lambda c, o, v: jsgcn.finalize(jmodel.apply(
        {"params": params}, *jsgcn.prepare(c, o, {"ped_valid": v}), train=True), {}))(
            jnp.asarray(c_obs), jnp.asarray(ori), jnp.asarray(valid))
    np.testing.assert_allclose(base, np.asarray(jout), **TOL)
