"""The port's flax msgpack reader against flax itself, and the mapping of a
checkpoint onto the port's modules."""
import os

import numpy as np
import pytest
import torch
from flax import serialization

from eigentrajectory_tpu_torch.interop import params_from_jax, read_flax_msgpack
from eigentrajectory_tpu_torch.models import stgcnn

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
