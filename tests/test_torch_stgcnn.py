"""Port vs JAX package: ET-STGCNN adjacency, the eval forward with the hotel
checkpoint's weights, the train-mode masked BatchNorm statistics, and
padding invariance."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from eigentrajectory_tpu.models import stgcnn as jstgcnn
from eigentrajectory_tpu_torch.interop import params_from_jax, read_flax_msgpack
from eigentrajectory_tpu_torch.models import stgcnn as tstgcnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "parity", "hotel", "model_best.msgpack")
K, S = 6, 20


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


def _torch_model(train=False):
    model = tstgcnn.make_model(CFG)
    state, _ = params_from_jax(read_flax_msgpack(CKPT))
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected
    assert all(k.startswith(model.unused_prefixes()) for k in missing)
    return model.train(train)


def _jax_variables():
    with open(CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def _jax_prepare(c_obs, ori, valid):
    return jax.vmap(lambda c, o, v: jstgcnn.prepare(c, o, {"ped_valid": v}))(
        jnp.asarray(c_obs), jnp.asarray(ori), jnp.asarray(valid))


def test_adjacency_matches_jax_and_isolates_padding():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1, 8, 8)).astype(np.float32)
    x[0, 0, :, 3] = x[0, 0, :, 1]            # |c_i - c_j| == 0 guard
    valid = np.ones((2, 8), bool)
    valid[1, 5:] = False
    got = tstgcnn.generate_adjacency_matrix(torch.from_numpy(x), torch.from_numpy(valid))
    for b in range(2):
        want = jstgcnn.generate_adjacency_matrix(jnp.asarray(x[b:b + 1]),
                                                 jnp.asarray(valid[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=1e-5)
    base = tstgcnn.generate_adjacency_matrix(
        torch.from_numpy(x[1:2, :, :, :5]), torch.ones(1, 5, dtype=torch.bool))
    np.testing.assert_allclose(got[1, :, :5, :5].numpy(), base[0].numpy(), atol=1e-6)
    assert np.allclose(got[1, :, 5:, :5], 0) and np.allclose(got[1, :, :5, 5:], 0)


def test_eval_forward_with_hotel_weights_matches_jax():
    rng = np.random.default_rng(1)
    c_obs, ori, valid = _inputs(rng)
    jv, ja, _ = _jax_prepare(c_obs, ori, valid)
    jmodel = jstgcnn.make_model(CFG)
    jout = jax.vmap(lambda v, a, m: jstgcnn.finalize(
        jmodel.apply(_jax_variables(), v, a, m, train=False), {}))(
            jv, ja, jnp.asarray(valid))

    tv, ta, tvalid = tstgcnn.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori),
                                     {"ped_valid": torch.from_numpy(valid)})
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv)[:, 0], atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    with torch.no_grad():
        tout = tstgcnn.finalize(_torch_model()(tv, ta, tvalid), {})
    assert tout.shape == (3, K, 9, S)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def test_train_mode_batch_stats_match_jax_update():
    rng = np.random.default_rng(2)
    c_obs, ori, valid = _inputs(rng)
    jv, ja, _ = _jax_prepare(c_obs, ori, valid)
    jmodel = jstgcnn.make_model(CFG)
    jout, upd = jax.vmap(lambda v, a, m: jmodel.apply(
        _jax_variables(), v, a, m, train=True, mutable=["batch_stats"]))(
            jv, ja, jnp.asarray(valid))
    # The JAX trainer averages the per-scene updates over the block.
    jstats = jax.tree_util.tree_map(lambda x: np.asarray(x).mean(0), upd["batch_stats"])

    model = _torch_model(train=True)
    with torch.no_grad():
        tv, ta, tvalid = tstgcnn.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori),
                                         {"ped_valid": torch.from_numpy(valid)})
        tout = model(tv, ta, tvalid)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout)[:, 0], atol=1e-4, rtol=1e-4)
    block = jstats["st_gcn_0"]
    for bn in ("res_bn", "tcn_bn1", "tcn_bn2"):
        layer = getattr(model.st_gcn_0, bn)
        np.testing.assert_allclose(layer.running_mean.numpy(), block[bn]["mean"], atol=1e-5)
        np.testing.assert_allclose(layer.running_var.numpy(), block[bn]["var"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pad", [1, 4])
def test_padding_invariance(pad):
    rng = np.random.default_rng(3)
    c_obs, ori, _ = _inputs(rng, b=2, n=6)
    valid = np.ones((2, 6), bool)
    model = _torch_model()

    def run(c, o, v):
        with torch.no_grad():
            aux = {"ped_valid": torch.from_numpy(v)}
            inputs = tstgcnn.prepare(torch.from_numpy(c), torch.from_numpy(o), aux)
            return tstgcnn.finalize(model(*inputs), aux).numpy()

    base = run(c_obs, ori, valid)
    c_p = np.concatenate([c_obs, np.ones((2, K, pad), np.float32)], axis=2)
    o_p = np.concatenate([ori, np.ones((2, 2, pad), np.float32)], axis=2)
    v_p = np.concatenate([valid, np.zeros((2, pad), bool)], axis=1)
    np.testing.assert_allclose(run(c_p, o_p, v_p)[:, :, :6], base, atol=1e-5)


def test_masked_bn_weights_the_running_statistics_by_scene_validity():
    """A block whose last rows are padding scenes: the running statistics
    move to the mean of the real scenes' updates, as the JAX trainer's
    `_tree_weighted_mean` gives (<= 1e-6), not to the plain mean over the
    rows, which the padding rows' zeros would pull down."""
    from eigentrajectory_tpu.models.common import MaskedBatchNorm2d as JaxBN
    from eigentrajectory_tpu.train.trainer import _tree_weighted_mean
    from eigentrajectory_tpu_torch.models.common import MaskedBatchNorm2d

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(5, 3, 4, 6)) * 2 + 1).astype(np.float32)
    valid = np.zeros((5, 6), bool)
    valid[0, :6], valid[1, :2], valid[2, :1] = True, True, True   # rows 3, 4: padding
    jbn = JaxBN(3)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), jnp.asarray(valid[0]))
    _, upd = jax.vmap(lambda xi, vi: jbn.apply(variables, xi[None], vi,
                                               mutable=["batch_stats"]))(
        jnp.asarray(x), jnp.asarray(valid))
    w = jnp.asarray(valid.any(axis=1), jnp.float32)
    want = _tree_weighted_mean(upd["batch_stats"], w)
    plain = jax.tree_util.tree_map(lambda s: s.mean(axis=0), upd["batch_stats"])

    layer = MaskedBatchNorm2d(3).train()
    layer(torch.from_numpy(x), torch.from_numpy(valid))
    for name, got in (("mean", layer.running_mean), ("var", layer.running_var)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]), atol=1e-6, rtol=1e-6)
        assert np.abs(got.numpy() - np.asarray(plain[name])).max() > 1e-2
    # a scene with one pedestrian and one time step would divide by cnt - 1 = 0:
    # the guard keeps the unbiased factor finite
    one = MaskedBatchNorm2d(3).train()
    one(torch.from_numpy(x[:1, :, :1]), torch.from_numpy(valid[2:3]))
    assert torch.isfinite(one.running_var).all()


def test_masked_bn_without_a_mask_counts_every_scene():
    from eigentrajectory_tpu_torch.models.common import MaskedBatchNorm2d

    x = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 2, 3, 5)).astype(np.float32))
    layer = MaskedBatchNorm2d(2).train()
    layer(x)
    want = 0.1 * x.mean(dim=(2, 3)).mean(dim=0)
    np.testing.assert_allclose(layer.running_mean.numpy(), want.numpy(), atol=1e-6)
