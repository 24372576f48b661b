"""Port vs JAX package: ET-Graph-TERN (the live `GraphTERNLight` path).

`clamp_to_valid` and the four-relation adjacency bitwise on a block of
scenes with 1, 3 and N valid slots; the normalized adjacency-tilde,
`ReplicateConv2d` and `EPCNN` in each of its four residual cases; the eval
forward on the weights of the reference's eth checkpoint
(`benchmarks/ref_resume/graphtern-eth.pt`) within 1e-4 in float32 and 1e-8
in float64 against x64; padding invariance; DropEdge's draws; the converter
leaving out `tp_mrgcns.0.prelu` as the JAX one does; one train step with
DropEdge off; and `test()` from a checkpoint the JAX trainer wrote.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu import interop as jinterop
from eigentrajectory_tpu.models import graphtern as jgraphtern
from eigentrajectory_tpu_torch.interop import _PARAM_NAMES, _flatten, import_state_dict
from eigentrajectory_tpu_torch.models import graphtern as tgraphtern
from eigentrajectory_tpu_torch.models.common import drop_edge_layers
from tests.test_torch_dmrgcn import (K, check_block_of_different_counts, check_drop_edge_draws,
                                     check_eval_forward, check_float64_forward,
                                     check_padding_invariance, check_step_with_drop_edge_off,
                                     check_test_means, reference_sd, torch_model)

COUNTS = [1, 3, 7]                       # valid slots of each row; N = 7


def _state(params):
    """A JAX params tree as a port state dict."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            _flatten(jax.tree_util.tree_map(np.asarray, params), _PARAM_NAMES)}


def _valid(n=7):
    return np.arange(n)[None, :] < np.array(COUNTS)[:, None]


def test_clamp_to_valid_counts_the_slots_of_each_row():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 6, 4, 7)).astype(np.float32)
    valid = _valid()
    got = tgraphtern.clamp_to_valid(torch.from_numpy(x), torch.from_numpy(valid), 3).numpy()
    for b in range(3):
        want = np.asarray(jgraphtern.clamp_to_valid(jnp.asarray(x[b:b + 1]),
                                                    jnp.asarray(valid[b]), 3))
        np.testing.assert_array_equal(got[b:b + 1], want)
        np.testing.assert_array_equal(got[b, ..., COUNTS[b]:],
                                      np.repeat(x[b, ..., COUNTS[b] - 1:COUNTS[b]],
                                                7 - COUNTS[b], axis=-1))
    # A row without a valid slot keeps slot 0 everywhere, as the JAX floor of 1 does.
    empty = tgraphtern.clamp_to_valid(torch.from_numpy(x[:1]), torch.zeros(1, 7, dtype=bool), 3)
    np.testing.assert_array_equal(empty.numpy(), np.repeat(x[:1, ..., :1], 7, axis=-1))


def test_adjacency_is_bitwise_jax_on_a_block_of_different_counts():
    rng = np.random.default_rng(1)
    c_obs = rng.normal(size=(3, K, 7)).astype(np.float32)
    ori = rng.normal(size=(3, 2, 7)).astype(np.float32)
    c_obs[2, :, 4] = c_obs[2, :, 1]                      # a distance of exactly 0
    ori[2, :, 4] = ori[2, :, 1]
    valid = _valid()
    s_obs, v_out = tgraphtern.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori),
                                      {"ped_valid": torch.from_numpy(valid)})
    a = tgraphtern.generate_adjacency(s_obs, v_out).numpy()
    assert a.shape == (3, 4, K + 2, 7, 7)
    for b in range(3):
        js, jv = jgraphtern.prepare(jnp.asarray(c_obs[b]), jnp.asarray(ori[b]),
                                    {"ped_valid": jnp.asarray(valid[b])})
        np.testing.assert_array_equal(s_obs[b:b + 1].numpy(), np.asarray(js))
        np.testing.assert_array_equal(a[b:b + 1],
                                      np.asarray(jgraphtern.generate_adjacency(js, jv)))
        assert not a[b][..., COUNTS[b]:, :].any()
    assert (a[2, 2, :, 1, 4] == 0).all() and (a[2, 0, :, 1, 4] == 0).all()


def test_adjacency_tilde_matches_jax():
    rng = np.random.default_rng(2)
    a = np.abs(rng.normal(size=(3, 4, 8, 7, 7))).astype(np.float32)
    a *= (_valid()[:, :, None] & _valid()[:, None, :])[:, None, None]
    got = tgraphtern.normalized_adjacency_tilde(torch.from_numpy(a)).numpy()
    want = np.asarray(jgraphtern.normalized_adjacency_tilde(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)


def test_replicate_conv_matches_jax_and_keeps_the_checkpoint_path():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 16, 7)).astype(np.float32)
    jconv = jgraphtern.ReplicateConv2d(6, 6, 3)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    conv = tgraphtern.ReplicateConv2d(6, 6, 3)
    conv.load_state_dict(_state(params))                 # strict: conv.weight, conv.bias
    assert sorted(conv.state_dict()) == ["conv.bias", "conv.weight"]
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jconv.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,leaves", [
    ((8, 6, 16, 16), {"restconv"}), ((6, 6, 16, 20), {"rescconv"}),
    ((6, 6, 16, 16), set()), ((8, 6, 16, 20), {"restconv", "rescconv"})])
def test_epcnn_matches_jax_in_each_residual_case(shape, leaves):
    obs, pred, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(3, obs, cin, 7)).astype(np.float32)
    x *= _valid()[:, None, None, :]
    valid = _valid()
    jm = jgraphtern.EPCNN(*shape)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]), jnp.asarray(valid[0]))["params"]
    assert set(params) - {"tpcn", "tpcn_prelu", "cpcn", "cpcn_prelu"} == leaves
    # A non-trivial slope, so the PReLUs are exercised on both sides.
    params = jax.tree_util.tree_map(lambda a: a * 1.7 if a.shape == (1,) else a, params)
    model = tgraphtern.EPCNN(*shape)
    model.load_state_dict(_state(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    assert got.shape == (3, pred, cout, 7)
    for b in range(3):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x[b:b + 1]),
                                   jnp.asarray(valid[b])))
        v = valid[b]
        np.testing.assert_allclose(got[b:b + 1][..., v], want[..., v], atol=1e-5, rtol=1e-5,
                                   err_msg=f"row {b}")


def test_the_converter_leaves_out_the_unused_output_prelu():
    sd = reference_sd("graphtern")
    assert len(sd) == 54 and "baseline_model.tp_mrgcns.0.prelu.weight" in sd
    state, _ = import_state_dict("graphtern", sd)
    params, _, _ = jinterop.import_state_dict("graphtern", sd)
    jax_leaves = jax.tree_util.tree_leaves(params)
    assert len(state) == len(jax_leaves) == 47
    assert sum(v.numel() for v in state.values()) == sum(x.size for x in jax_leaves) == 17939
    assert not any("prelu" in k and k.startswith("tp_mrgcn_0.") and "tcn" not in k
                   for k in state)
    model = tgraphtern.make_model(type("C", (), {"k": K, "num_samples": 20}))
    assert sorted(model.state_dict()) == sorted(state)


def test_eval_forward_with_the_eth_weights_matches_jax():
    check_eval_forward("graphtern")


def test_eval_forward_in_float64_matches_jax_x64():
    check_float64_forward("graphtern")


@pytest.mark.parametrize("pad", [2, 9])
def test_padding_invariance(pad):
    check_padding_invariance("graphtern", pad)


def test_a_block_of_scenes_with_different_counts_is_each_scene_alone():
    check_block_of_different_counts("graphtern")


def test_drop_edge_draws_only_from_the_generator_it_is_given():
    check_drop_edge_draws("graphtern")


def test_graphtern_has_one_drop_edge_site_and_no_buffers():
    model = torch_model("graphtern")
    assert [(m.relation, m.seq_len) for m in drop_edge_layers(model)] == [(4, K + 2)]
    assert list(model.buffers()) == []


def test_step_loss_and_gradients_with_drop_edge_off_match_jax(tmp_path):
    check_step_with_drop_edge_off("graphtern", tmp_path)


def test_test_means_match_jax(tmp_path):
    check_test_means("graphtern", tmp_path)
