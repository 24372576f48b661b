"""The frozen reference held against the program on the CPU at small sizes:
the checkpoint reader, ET-STGCNN's `test()` per pedestrian and
ET-AgentFormer's and ET-STGCNN's `predict()` futures, the program run in
float64 (the exact comparison: 1e-9) and in float32 (its rounding: 1e-4)."""

import numpy as np
import pytest
import torch

from conftest import ROOT
from etbench import generator, judge, program
from etbench.reference.checkpoint import read_checkpoint
from etbench.reference.pipeline import Reference, checkpoint_path, scene_futures, scene_metrics
from etbench.run import load_json

CONFIGS = ("et-stgcnn-hotel", "et-agentformer-zara2")
SIZES = {"scenes": 8, "min_peds": 2, "max_peds": 7, "counts_seed": 0}


def _config(name):
    return load_json("etbench", "configs", f"{name}.json")


def _trainer(config, scenes, dtype, **overrides):
    from eigentrajectory_tpu_torch.train import ETTorchTrainer

    data = program.trajectory_data(scenes)
    tr = ETTorchTrainer(program.exp_config(config, ROOT, **overrides), tag=config["tag"],
                        datasets=(data, data, data), device="cpu", dtype=dtype)
    tr.load_model()
    return tr


@pytest.mark.parametrize("name", CONFIGS)
def test_checkpoint_reader_matches_the_programs(name):
    from eigentrajectory_tpu_torch.interop import read_flax_msgpack

    path = checkpoint_path(_config(name), ROOT)
    ours, theirs = read_checkpoint(path), read_flax_msgpack(path)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    a, b = dict(flat(ours)), dict(flat(theirs))
    assert a.keys() == b.keys() and len(a) > 10
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("name,dtype,tol", [
    (n, d, t) for n in CONFIGS for d, t in ((torch.float64, 1e-9), (torch.float32, 1e-4))])
def test_predict_futures_match_the_reference(name, dtype, tol):
    from eigentrajectory_tpu_torch.inference import ETPredictor

    config = _config(name)
    scenes = generator.make_scenes(SIZES, seed=2 ** 31 + 5)
    predictor = ETPredictor(_trainer(config, scenes, dtype), bucket=8)
    order = [3, 0, 6, 1]
    peds = scenes.peds(order)
    ids = np.repeat(np.arange(len(order)), scenes.counts[order])
    got = predictor.predict(scenes.obs[peds], ids)
    ref = Reference(config, ROOT, torch.float64, "cpu")
    want = np.concatenate(scene_futures(ref, scenes.obs, scenes.starts, scenes.counts, order), 1)
    assert got.shape == want.shape == (20, len(peds), 12, 2)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_stgcnn_test_metrics_match_the_reference(dtype, tol):
    config = _config("et-stgcnn-hotel")
    scenes = generator.make_scenes(dict(SIZES, max_peds=5), seed=17)
    tr = _trainer(config, scenes, dtype, n_max_peds=9)
    kept = []
    step = tr.eval_step
    tr.eval_step = lambda *a: kept.append(step(*a)) or kept[-1]
    tr.test(eval_batch=10)
    rows = np.repeat(np.arange(len(scenes.counts)), scenes.counts)
    slots = np.arange(len(rows)) - scenes.starts[rows]
    got = dict(zip(("ade", "fde", "tcc", "col"),
                   (t.numpy().astype(np.float64)[rows, slots] for t in kept[0])))
    ref = Reference(config, ROOT, torch.float64, "cpu")
    per_scene = scene_metrics(ref, scenes.obs, scenes.pred, scenes.starts, scenes.counts,
                              list(range(len(scenes.counts))))
    want = {k: np.concatenate([m[k] for m in per_scene], axis=-1) for k in per_scene[0]}
    for key in ("ade", "fde", "tcc", "col"):
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=key)
    numbers = judge.metric_numbers([got], want)
    assert numbers["metric_off_pct"] == 0.0 and numbers["ade_gap_m"] <= tol
