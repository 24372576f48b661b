"""The harness driven on the CPU at a small size, the card's look skipped:
a sound run is correct and reports its cell's metrics; each fault a cell
can have, planted in the timed path, makes `correct` false; a loaded JAX
module stops the run without a result."""
import sys
import types

import numpy as np
import pytest
import torch

from conftest import SMALL
from etbench import generator
from etbench.run import applies, run_cell

SEED = 2 ** 31 + 11     # more than 32 signed bits hold


def _run(bench, cells, name, hook=None, trace=0):
    return run_cell(bench, cells[name], SEED, 0.4, trace, device="cpu",
                    traffic_overrides=SMALL[name], hook=hook)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(bench, cells, name):
    r = _run(bench, cells, name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    e2e = {m["name"] for m in bench["end_to_end"] if applies(m, name)}
    assert set(r["metrics"]) == e2e and "setup_s" in e2e
    assert list(r)[-1] == "checks" and r["checks"]
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_traced_run_reads_no_device_metric_off_the_card(bench, cells, name):
    r = _run(bench, cells, name, trace=1)
    assert r["correct"] and r["metrics"] == {}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _serve_fault(kind):
    def hook(cell):
        predict = cell.predictor.predict

        def broken(obs, ids):
            out = predict(obs, ids).copy()
            if kind == "altered":
                out[0, -1, -1, 0] += 0.5
            else:                      # half the batch left out
                out[:, out.shape[1] // 2:] = 0.0
            return out
        cell.predictor.predict = broken
    return hook


def _eval_fault(kind):
    """Planted under the harness's note of each call's per-pedestrian
    metrics, in the program's `eval_step`."""
    def hook(cell):
        step = cell.step

        def broken(obs, pred, valid):
            if kind == "altered":
                ade, fde, tcc, col = step(obs, pred, valid)
                ade = ade.clone()
                ade[0, 0] += 0.5
                return ade, fde, tcc, col
            half = obs.shape[0] // 2   # half the batch left out: its rows never run
            out = step(obs[:half], pred[:half], valid[:half])
            return tuple(torch.cat([o, torch.zeros_like(o)[:obs.shape[0] - half]]) for o in out)
        cell.step = broken
    return hook


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_serve_faults_are_not_correct(bench, cells, kind):
    r = _run(bench, cells, "agentformer-zara2.serve", hook=_serve_fault(kind))
    assert r["correct"] is False


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_eval_faults_are_not_correct(bench, cells, kind):
    r = _run(bench, cells, "stgcnn-hotel.eval", hook=_eval_fault(kind))
    assert r["correct"] is False


@pytest.mark.parametrize("module", ["jax", "eigentrajectory_tpu", "flax.core"])
def test_a_loaded_jax_module_stops_the_run(bench, cells, module, monkeypatch):
    def hook(cell):
        monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert _run(bench, cells, "stgcnn-hotel.eval", hook=hook) is None


def test_the_program_does_not_count_as_the_jax_package(bench, cells, monkeypatch):
    import eigentrajectory_tpu_torch  # noqa: F401

    assert "eigentrajectory_tpu_torch" in sys.modules
    assert _run(bench, cells, "stgcnn-hotel.eval") is not None


def test_a_seed_gives_the_same_inputs_and_every_seed_the_same_sizes():
    sizes = SMALL["stgcnn-hotel.eval"]["split"]
    a, b = generator.make_scenes(sizes, SEED), generator.make_scenes(sizes, SEED)
    c = generator.make_scenes(sizes, 3)
    np.testing.assert_array_equal(a.obs, b.obs)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert sorted(a.counts) == sorted(c.counts) and not np.array_equal(a.obs, c.obs)
    traffic = {"scenes_per_request": [16, 301], "schedule_seed": 0}
    np.testing.assert_array_equal(generator.request_sizes(traffic, 50),
                                  generator.request_sizes(traffic, 60)[:50])
