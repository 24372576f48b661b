"""The port's serving API against the JAX package's: ETPredictor from the
committed checkpoints on the CPU, for a single scene, a multi-scene request
with scene ids, and a scene larger than the bucket (tolerance 1e-4: the
forward of a trained model in f32 with sums in another order); and a dense
scene in float64 against the JAX package in x64 mode."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.data.synthetic import make_synthetic_data
from eigentrajectory_tpu.inference import ETPredictor as JaxPredictor
from eigentrajectory_tpu_torch import inference as torch_inference
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.inference import ETPredictor
from eigentrajectory_tpu_torch.ops import recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from tests.conftest import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
MODELS = {"stgcnn": "eigentrajectory-stgcnn-hotel.json",
          "sgcn": "eigentrajectory-sgcn-zara1.json"}
TOL = dict(atol=1e-4, rtol=1e-4)
BUCKET = 16


def _splits():
    data = make_synthetic_data(n_scenes=4, seed=1)
    return data, data, data


@pytest.fixture(scope="module", params=sorted(MODELS))
def predictors(request):
    cfg_path = os.path.join(REPO, "configs", MODELS[request.param])
    splits = _splits()
    jp = JaxPredictor.from_checkpoint(jax_load_config(cfg_path, checkpoint_dir=CKPT),
                                      "parity", bucket=BUCKET, datasets=splits)
    tp = ETPredictor.from_checkpoint(load_config(cfg_path, checkpoint_dir=CKPT),
                                     "parity", bucket=BUCKET, datasets=splits, device="cpu")
    return jp, tp


def _scene(rng, n_ped):
    # Walkers as slow as make_synthetic_data's, so the wiggle keeps their
    # normalized shapes apart. STGCNN's inverse-distance adjacency amplifies
    # f32 rounding where two peds' coefficients nearly coincide: on dense
    # scenes of near-straight walkers two f32 implementations differ by more
    # than 1e-4, whichever is right (the float64 test below shows it).
    return make_scene(rng, n_ped=n_ped, speed=0.4)[0]


def _request(kind):
    rng = np.random.default_rng(7)
    if kind == "single":
        return _scene(rng, 5), None
    if kind == "larger_than_bucket":
        return _scene(rng, BUCKET + 4), None
    # Three scenes, their peds interleaved and their ids not 0..2.
    obs = np.concatenate([_scene(rng, n) for n in (5, 3, 4)])
    ids = np.repeat([7, 2, 5], (5, 3, 4))
    perm = rng.permutation(len(ids))
    return obs[perm], ids[perm]


@pytest.mark.parametrize("kind", ["single", "multi_scene", "larger_than_bucket"])
def test_predict_matches_jax(predictors, kind):
    jp, tp = predictors
    obs, ids = _request(kind)
    launches = recon.RECONSTRUCT_LAUNCHES
    got = tp.predict(obs, ids)
    assert recon.RECONSTRUCT_LAUNCHES == launches      # the CPU runs the plain version
    want = jp.predict(obs, ids)
    assert got.shape == want.shape == (20, len(obs), 12, 2)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["single", "multi_scene", "larger_than_bucket"])
def test_predict_reconstructs_only_the_requested_rows(predictors, kind, monkeypatch):
    """predict() gathers the request's pedestrians out of the padded block
    before the reconstruction: fused_reconstruct gets exactly those rows, in
    request order, and what it returns is the answer as it stands."""
    jp, tp = predictors
    obs, ids = _request(kind)
    n, calls = len(obs), []

    def noting(*args):
        out = recon.fused_reconstruct(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(torch_inference, "fused_reconstruct", noting)
    got = tp.predict(obs, ids)
    assert len(calls) == 1
    (c_m, c_s, u_m, u_s, ori, rot, sca, mask), out = calls[0]
    assert c_m.shape == c_s.shape == (6, n, 20)
    assert u_m.shape == u_s.shape == (24, 6)
    assert (ori.shape, rot.shape, sca.shape, mask.shape) == ((n, 2), (n, 2, 2), (n,), (n,))
    assert all(x.is_contiguous() for x in (c_m, c_s, ori, rot, sca, mask))
    # Request order: each row's origin is that pedestrian's last observed point.
    np.testing.assert_array_equal(ori.numpy(), obs[:, -1])
    np.testing.assert_array_equal(got, out.numpy())
    np.testing.assert_allclose(got, jp.predict(obs, ids), **TOL)


def _jax_predict_x64(cfg_path, obs):
    """The JAX predictor's forward on one scene with its parameters, its ET
    descriptor and the observations in float64 (x64 mode)."""
    jp = JaxPredictor.from_checkpoint(jax_load_config(cfg_path, checkpoint_dir=CKPT),
                                      "parity", bucket=BUCKET, datasets=_splits())
    n = len(obs)
    n_slots = -(-n // BUCKET) * BUCKET
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)

        tr = jp.trainer
        tr.params, tr.batch_stats, tr.et = f64(tr.params), f64(tr.batch_stats), f64(tr.et)
        padded = np.zeros((1, n_slots) + obs.shape[1:])
        padded[0, :n] = obs
        out = jp._build(n_slots)(tr.params, tr.batch_stats, jnp.asarray(padded),
                                 jnp.asarray(np.arange(n_slots)[None] < n))
        assert out.dtype == jnp.float64
        return np.asarray(out)[0, :, :n]


def test_dense_scene_float64_matches_jax_x64(predictors):
    """A dense scene of fast walkers, where two f32 runs part by more than
    1e-4: in float64 the port and the JAX package agree to 1e-8, so the f32
    gap is the model's conditioning, not a fault of the port. On ET-STGCNN
    the JAX package's own f32 run lies more than 1e-4 from its x64 run."""
    jp, tp = predictors
    cfg_path = os.path.join(REPO, "configs", MODELS[tp.cfg.baseline])
    obs = make_scene(np.random.default_rng(7), n_ped=150)[0]
    want = _jax_predict_x64(cfg_path, obs)
    tr = ETTorchTrainer(load_config(cfg_path, checkpoint_dir=CKPT), tag="parity",
                        datasets=_splits(), device="cpu", dtype=torch.float64)
    tr.load_model()
    got = ETPredictor(tr, bucket=BUCKET).predict(obs)
    assert got.dtype == np.float64 and got.shape == (20, 150, 12, 2)
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-8)
    if tp.cfg.baseline == "stgcnn":
        assert np.abs(jp.predict(obs) - want).max() > 1e-4


def test_scene_alone_equals_its_rows_in_a_batch(predictors):
    _, tp = predictors
    rng = np.random.default_rng(11)
    obs, obs2 = _scene(rng, 5), _scene(rng, 3)
    both = tp.predict(np.concatenate([obs, obs2]), np.array([0] * 5 + [1] * 3))
    np.testing.assert_allclose(both[:, :5], tp.predict(obs), atol=1e-5)
    np.testing.assert_allclose(both[:, 5:], tp.predict(obs2), atol=1e-5)
