"""The port's flax msgpack reader and writer against flax itself, the mapping
of a checkpoint onto the port's modules and back, and a checkpoint written by
the port read by the JAX trainer."""
import os
import pickle

import numpy as np
import pytest
import torch
from flax import serialization

from eigentrajectory_tpu.config import ExpConfig as JaxConfig
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.interop import (jax_param_paths, params_from_jax,
                                               params_to_jax, read_flax_msgpack,
                                               write_flax_msgpack)
from eigentrajectory_tpu_torch.models import sgcn, stgcnn
from eigentrajectory_tpu_torch.train import ETTorchTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOTEL = os.path.join(REPO, "checkpoints", "parity", "hotel", "model_best.msgpack")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("split", ["hotel", "univ", "zara1", "zara2"])
def test_reader_matches_flax_leaf_for_leaf(split):
    path = os.path.join(REPO, "checkpoints", "parity", split, "model_best.msgpack")
    with open(path, "rb") as f:
        want = dict(_leaves(serialization.msgpack_restore(f.read())))
    got = dict(_leaves(read_flax_msgpack(path)))
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


def test_reader_scalars_and_containers(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "c": np.float32(1.5) * np.ones((), np.float32),
            "d": np.zeros((0, 4), np.float64)}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = dict(_leaves(read_flax_msgpack(str(path))))
    for key, value in _leaves(serialization.msgpack_restore(path.read_bytes())):
        np.testing.assert_array_equal(got[key], value)
        assert got[key].dtype == value.dtype


def test_params_from_jax_fills_every_used_layer():
    state, et = params_from_jax(read_flax_msgpack(HOTEL))

    class CFG:
        k, num_samples = 6, 20

    model = stgcnn.make_model(CFG)
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected
    assert sorted(missing) == ["prelu_4.weight", "tpcnn_4.bias", "tpcnn_4.weight"]
    tree = read_flax_msgpack(HOTEL)
    np.testing.assert_array_equal(
        model.st_gcn_0.tcn_bn1.running_var.numpy(),
        tree["batch_stats"]["st_gcn_0"]["tcn_bn1"]["var"])
    np.testing.assert_array_equal(model.tpcnn_0.weight.detach().numpy(),
                                  tree["params"]["tpcnn_0"]["kernel"])
    assert et.basis_m.U_pred.shape == (24, 6) and et.anchor_s.shape == (6, 20)
    assert all(x.dtype == torch.float32 for x in (*et.basis_m, *et.basis_s))


def test_params_from_jax_transposes_linear_kernels_only():
    path = os.path.join(REPO, "checkpoints", "parity", "zara1", "model_best.msgpack")
    tree = read_flax_msgpack(path)
    state, _ = params_from_jax(tree)
    query = tree["params"]["sparse_adjacency"]["spatial_attention"]["query"]
    np.testing.assert_array_equal(
        state["sparse_adjacency.spatial_attention.query.weight"].numpy(), query["kernel"].T)
    np.testing.assert_array_equal(state["fusion.weight"].numpy(),
                                  tree["params"]["fusion"]["kernel"])      # OIHW as is
    # The port's linear layer then computes the JAX layer's x @ kernel + bias.
    layer = torch.nn.Linear(64, 64)
    layer.load_state_dict({"weight": state["sparse_adjacency.spatial_attention.query.weight"],
                           "bias": state["sparse_adjacency.spatial_attention.query.bias"]})
    x = np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x @ query["kernel"] + query["bias"], atol=1e-5)


@pytest.mark.parametrize("split", ["hotel", "univ", "zara1", "zara2"])
def test_writer_reproduces_the_committed_checkpoints_byte_for_byte(split, tmp_path):
    path = os.path.join(REPO, "checkpoints", "parity", split, "model_best.msgpack")
    out = tmp_path / "copy.msgpack"
    write_flax_msgpack(str(out), read_flax_msgpack(path))
    with open(path, "rb") as f:
        assert out.read_bytes() == f.read()


def test_writer_matches_flax_on_scalars_and_containers(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.int32).reshape(2, 3)}, "c": np.float32(1.5),
            "d": np.zeros((0, 4), np.float64), "e": 7, "f": -200, "g": 2.5, "h": None,
            "i": True, "j": "x" * 40, "k": [1, 70000, -5], "l": np.arange(300),
            "m": {f"{i:02d}": i for i in range(20)}, "n": np.zeros((), np.float32)}
    path = tmp_path / "t.msgpack"
    write_flax_msgpack(str(path), tree)
    # flax writes the keys sorted (this tree's are); the writer keeps the tree's order
    assert path.read_bytes() == serialization.msgpack_serialize(tree)
    with pytest.raises(TypeError):
        write_flax_msgpack(str(path), {"a": object()})


class _CFG:
    k, num_samples = 6, 20


@pytest.mark.parametrize("split,module", [("hotel", stgcnn), ("zara1", sgcn)])
def test_params_to_jax_inverts_params_from_jax(split, module):
    """The tree that comes back has the checkpoint's keys in the checkpoint's
    order and its arrays bit for bit; the built-but-unused layers of the
    STGCNN are left out."""
    tree = read_flax_msgpack(
        os.path.join(REPO, "checkpoints", "parity", split, "model_best.msgpack"))
    state, et = params_from_jax(tree)
    model = module.make_model(_CFG)
    model.load_state_dict(state, strict=False)
    back = params_to_jax(model, et)
    want, got = list(_leaves(tree)), list(_leaves(back))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert list(back) == ["params", "batch_stats", "et"]
    for (key, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), key
    paths = jax_param_paths(model)
    assert not any(name.startswith(("tpcnn_4", "prelu_4")) for name in paths)
    assert len(paths) == len(want) - 6               # all but the six ET arrays


@pytest.mark.parametrize("baseline", ["stgcnn", "sgcn"])
def test_checkpoint_written_by_the_port_loads_into_the_jax_trainer(baseline, tmp_path):
    """save_model() of a trained port trainer -> ETJaxTrainer.load_model() and
    the port's own load_model(): both test() results within 1e-4."""
    splits = tuple(make_synthetic_data(n_scenes=n, max_peds=5, seed=seed)
                   for n, seed in ((10, 1), (6, 2), (8, 3)))
    kw = dict(baseline=baseline, batch_size=4, checkpoint_dir=str(tmp_path),
              dataset="synthetic", static_dist=0.3)
    tr = ETTorchTrainer(ExpConfig(**kw), tag="port", datasets=splits, device="cpu")
    tr.init_descriptor()
    tr.fit(num_epochs=2, verbose=False)
    jtr = ETJaxTrainer(JaxConfig(**kw), tag="port", test_mode=True, datasets=splits)
    jtr.load_model()
    # log.pkl, two lists of floats, is written with the best checkpoint
    n_logged = len(jtr.log["val_loss"])
    assert n_logged == int(np.argmin(tr.log["val_loss"])) + 1
    assert jtr.log == {k: v[:n_logged] for k, v in tr.log.items()}
    fresh = ETTorchTrainer(ExpConfig(**kw), tag="port", datasets=splits, device="cpu")
    fresh.load_model()
    assert fresh.log == jtr.log                      # the loss log, reloaded as JAX does
    want, got = jtr.test(eval_batch=8), fresh.test(eval_batch=8)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    # the port trained BN statistics and they arrived
    if baseline == "stgcnn":
        var = np.asarray(jtr.batch_stats["st_gcn_0"]["tcn_bn1"]["var"])
        np.testing.assert_array_equal(var, tr.model.st_gcn_0.tcn_bn1.running_var.numpy())
        assert not np.allclose(var, 1.0)


def _splits():
    return tuple(make_synthetic_data(n_scenes=n, max_peds=5, seed=seed)
                 for n, seed in ((10, 1), (6, 2), (8, 3)))


def test_fit_after_load_model_keeps_a_better_loaded_checkpoint(tmp_path):
    """After load_model() the reloaded log takes part in the best-val test:
    the new run's epoch 0 is saved (as in the JAX trainer), and a later
    epoch that beats epoch 0 but not the loaded log's best leaves
    model_best.msgpack's bytes as they were."""
    kw = dict(baseline="sgcn", batch_size=4, checkpoint_dir=str(tmp_path),
              dataset="synthetic")
    splits = _splits()
    tr = ETTorchTrainer(ExpConfig(**kw), tag="port", datasets=splits, device="cpu")
    tr.init_descriptor()
    tr.fit(num_epochs=1, verbose=False)
    log_path = os.path.join(tr.checkpoint_dir, "log.pkl")
    # The loaded checkpoint's log claims a best epoch no new epoch beats.
    with open(log_path, "wb") as f:
        pickle.dump({"train_loss": [1.0], "val_loss": [1e-9]}, f)

    fresh = ETTorchTrainer(ExpConfig(**kw), tag="port", datasets=splits, device="cpu")
    fresh.load_model()
    assert fresh.log == {"train_loss": [1.0], "val_loss": [1e-9]}
    saved = []
    save_model = fresh.save_model

    def spy():
        save_model()
        with open(os.path.join(fresh.checkpoint_dir, "model_best.msgpack"), "rb") as f:
            saved.append(f.read())

    fresh.save_model = spy
    fresh.fit(num_epochs=2, verbose=False)
    val = fresh.log["val_loss"]
    assert len(val) == 3 and val[2] < val[1]         # epoch 1 beats epoch 0 of this run
    assert len(saved) == 1                           # epoch 0 only
    with open(os.path.join(fresh.checkpoint_dir, "model_best.msgpack"), "rb") as f:
        assert f.read() == saved[0]


def test_log_is_read_without_admitting_any_class(tmp_path):
    from eigentrajectory_tpu_torch.train.trainer import read_log

    path = tmp_path / "log.pkl"
    good = {"train_loss": [0.5, 0.25], "val_loss": [0.75, 0.5]}
    path.write_bytes(pickle.dumps(good))
    with open(path, "rb") as f:
        assert read_log(f) == good
    for bad in ({"train_loss": [np.float64(0.5)], "val_loss": []},   # a numpy scalar: a class
                {"train_loss": [0.5]},
                [0.5, 0.25]):
        path.write_bytes(pickle.dumps(bad))
        with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError):
            read_log(f)
