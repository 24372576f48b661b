"""The whole ported slice: ETTorchTrainer's sequenced eval against
ETJaxTrainer's, both loaded from the committed hotel checkpoint, on the same
small synthetic splits (tolerance 1e-4: the forward of a trained model in
f32 with sums in another order)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.data.batching import SceneBatcher
from eigentrajectory_tpu.data.synthetic import make_synthetic_data
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.ops import recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from eigentrajectory_tpu_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "eigentrajectory-stgcnn-hotel.json")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def trainers():
    ckpt = os.path.join(REPO, "checkpoints")
    data = make_synthetic_data(n_scenes=12, max_peds=8, seed=4)
    splits = (data, data, data)
    jtr = ETJaxTrainer(jax_load_config(CFG, checkpoint_dir=ckpt, n_max_peds=8),
                       tag="parity", test_mode=True, datasets=splits)
    jtr.load_model()
    ttr = ETTorchTrainer(load_config(CFG, checkpoint_dir=ckpt, n_max_peds=8),
                         tag="parity", datasets=splits, device="cpu")
    ttr.load_model()
    return jtr, ttr


def test_eval_step_per_ped_metrics_match(trainers):
    jtr, ttr = trainers
    step = jtr._build_eval_step()
    for batch in SceneBatcher(jtr.data_test, 5, False, jtr.n_max):
        want = step(jtr.params, jtr.batch_stats, jnp.asarray(batch.obs),
                    jnp.asarray(batch.pred), jnp.asarray(batch.ped_valid),
                    jnp.asarray(batch.scene_valid), jtr.et, jtr._sd)
        launches = recon.LAUNCHES
        got = ttr.eval_step(*(torch.from_numpy(x) for x in
                              (batch.obs, batch.pred, batch.ped_valid)))
        assert recon.LAUNCHES == launches       # the CPU runs the plain version
        v = batch.ped_valid
        for name, g, w in zip(("ADE", "FDE", "TCC", "COL"), got, want):
            np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], err_msg=name, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_step_calls_fused_recon_metrics_whatever_use_pallas(trainers, use_pallas,
                                                                 monkeypatch):
    """The config's `use_pallas` picks nothing in the port: eval_step always
    calls fused_recon_metrics (whose tensors' device picks kernel or plain
    version), and the metrics are the JAX package's either way."""
    jtr, ttr = trainers
    calls = []

    def noting(*args):
        calls.append(args[0].shape)
        return recon.fused_recon_metrics(*args)

    monkeypatch.setattr(torch_trainer, "fused_recon_metrics", noting)
    monkeypatch.setattr(ttr, "cfg", dataclasses.replace(ttr.cfg, use_pallas=use_pallas))
    batch = next(iter(SceneBatcher(jtr.data_test, 5, False, jtr.n_max)))
    got = ttr.eval_step(*(torch.from_numpy(x) for x in
                          (batch.obs, batch.pred, batch.ped_valid)))
    assert calls == [(6, 5 * jtr.n_max, 20)]
    want = jtr._build_eval_step()(jtr.params, jtr.batch_stats, jnp.asarray(batch.obs),
                                  jnp.asarray(batch.pred), jnp.asarray(batch.ped_valid),
                                  jnp.asarray(batch.scene_valid), jtr.et, jtr._sd)
    v = batch.ped_valid
    for name, g, w in zip(("ADE", "FDE", "TCC", "COL"), got, want):
        np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], err_msg=name, **TOL)


def test_test_means_match(trainers):
    jtr, ttr = trainers
    want = jtr.test(eval_batch=5)
    got = ttr.test(eval_batch=5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert 0.0 < got["ADE"] < got["FDE"]


def test_test_needs_loaded_parameters():
    data = make_synthetic_data(n_scenes=2, seed=0)
    tr = ETTorchTrainer(load_config(CFG), datasets=(data, data, data), device="cpu")
    with pytest.raises(RuntimeError):
        tr.test()
