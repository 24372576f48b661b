"""Port vs JAX package: ET-DMRGCN.

The scale bands, the Laplacian-tilde and the adjacency bitwise (band edges
and zeros included); the eval forward on the weights of the reference's eth
checkpoint (`benchmarks/ref_resume/dmrgcn-eth.pt`, its `best_model` field)
within 1e-4 in float32 and within 1e-8 in float64 against x64; padding
invariance, also across a block of scenes with different counts; DropEdge's
semantics and its draws; one train step with DropEdge off; and `test()` from
a checkpoint the JAX trainer wrote.

The helpers serve `tests/test_torch_graphtern.py` too.
"""
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from eigentrajectory_tpu import interop as jinterop
from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.models import dmrgcn as jdmrgcn
from eigentrajectory_tpu.models import graphtern as jgraphtern
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.data.batching import pad_scenes
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.interop import import_state_dict, jax_param_paths
from eigentrajectory_tpu_torch.models import dmrgcn as tdmrgcn
from eigentrajectory_tpu_torch.models import graphtern as tgraphtern
from eigentrajectory_tpu_torch.models.common import (DropEdge, draw_edge_keeps,
                                                     drop_edge_layers, set_edge_keeps)
from eigentrajectory_tpu_torch.ops import recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S = 6, 20
TOL = dict(atol=1e-4, rtol=1e-4)
MODULES = {"dmrgcn": (jdmrgcn, tdmrgcn), "graphtern": (jgraphtern, tgraphtern)}


class CFG:
    k = K
    num_samples = S


def cfg_path(name):
    return os.path.join(REPO, "configs", f"eigentrajectory-{name}-eth.json")


def snapshot_bytes(name) -> bytes:
    """The reference's model_best.pth inside the committed eth snapshot (the
    snapshot also holds numpy RNG states, which the restricted unpickler
    refuses; it is a file of this repository)."""
    path = os.path.join(REPO, "benchmarks", "ref_resume", f"{name}-eth.pt")
    return torch.load(path, map_location="cpu", weights_only=False)["best_model"]


@functools.lru_cache(maxsize=None)
def reference_sd(name):
    return torch.load(io.BytesIO(snapshot_bytes(name)), map_location="cpu", weights_only=True)


def torch_model(name, dtype=torch.float32):
    state, _ = import_state_dict(name, reference_sd(name))
    model = MODULES[name][1].make_model(CFG)
    model.load_state_dict(state)                  # strict: every parameter filled
    return model.to(dtype).eval()


def inputs(rng, counts, n):
    """Coefficients (B, k, n), origins (B, 2, n) and front-contiguous
    validity with `counts[b]` valid slots in row b; the padded slots hold
    junk that the pre-hook must zero."""
    b = len(counts)
    c_obs = rng.normal(size=(b, K, n)).astype(np.float32)
    ori = (3 * rng.normal(size=(b, 2, n))).astype(np.float32)
    valid = np.arange(n)[None, :] < np.asarray(counts)[:, None]
    c_obs[~np.repeat(valid[:, None], K, 1)] = 7.0
    return c_obs, ori, valid


def jax_forward(name, c_obs, ori, valid, x64=False):
    """The JAX model on the reference's weights, one scene at a time under
    vmap, train=False: (B, k, N, s)."""
    jm = MODULES[name][0]
    model = jm.make_model(CFG)
    params, _, _ = jinterop.import_state_dict(name, reference_sd(name))

    def run(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)

        def one(c, o, v):
            aux = {"ped_valid": v}
            return jm.finalize(model.apply({"params": p}, *jm.prepare(c, o, aux),
                                           train=False), aux)

        out = jax.vmap(one)(jnp.asarray(c_obs, dtype), jnp.asarray(ori, dtype),
                            jnp.asarray(valid))
        assert out.dtype == dtype
        return np.asarray(out)

    if x64:
        with jax.enable_x64(True):
            return run(jnp.float64)
    return run(jnp.float32)


def torch_forward(name, model, c_obs, ori, valid):
    tm = MODULES[name][1]
    dtype = next(model.parameters()).dtype
    with torch.no_grad():
        aux = {"ped_valid": torch.from_numpy(valid)}
        inp = tm.prepare(torch.from_numpy(c_obs).to(dtype), torch.from_numpy(ori).to(dtype), aux)
        return tm.finalize(model(*inp), aux).numpy()


def assert_valid_close(got, want, valid, **tol):
    assert got.shape == want.shape
    for b in range(len(valid)):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]],
                                   err_msg=f"scene {b}", **tol)


def check_eval_forward(name):
    rng = np.random.default_rng(1)
    c_obs, ori, valid = inputs(rng, [9, 6, 2], 9)
    got = torch_forward(name, torch_model(name), c_obs, ori, valid)
    assert got.shape == (3, K, 9, S)
    assert_valid_close(got, jax_forward(name, c_obs, ori, valid), valid, **TOL)


def check_float64_forward(name):
    rng = np.random.default_rng(2)
    c_obs, ori, valid = inputs(rng, [12, 5], 12)
    got = torch_forward(name, torch_model(name, torch.float64), c_obs, ori, valid)
    assert got.dtype == np.float64
    assert_valid_close(got, jax_forward(name, c_obs, ori, valid, x64=True), valid,
                       atol=1e-8, rtol=1e-8)


def check_padding_invariance(name, pad):
    rng = np.random.default_rng(3)
    model = torch_model(name)
    c_obs, ori, valid = inputs(rng, [6, 6], 6)
    base = torch_forward(name, model, c_obs, ori, valid)
    c_p = np.concatenate([c_obs, np.full((2, K, pad), 7, np.float32)], axis=2)
    o_p = np.concatenate([ori, np.full((2, 2, pad), -7, np.float32)], axis=2)
    v_p = np.concatenate([valid, np.zeros((2, pad), bool)], axis=1)
    np.testing.assert_allclose(torch_forward(name, model, c_p, o_p, v_p)[:, :, :6], base,
                               atol=2e-5)


def check_block_of_different_counts(name):
    """Each scene of a block whose rows hold 1, 3, 7 and 9 valid slots gives
    what it gives alone, at its own width."""
    rng = np.random.default_rng(4)
    model = torch_model(name)
    counts = [1, 3, 7, 9]
    c_obs, ori, valid = inputs(rng, counts, 9)
    block = torch_forward(name, model, c_obs, ori, valid)
    for b, n in enumerate(counts):
        alone = torch_forward(name, model, c_obs[b:b + 1, :, :n], ori[b:b + 1, :, :n],
                              valid[b:b + 1, :n])
        np.testing.assert_allclose(block[b:b + 1, :, :n], alone, atol=2e-5,
                                   err_msg=f"row {b} ({n} valid)")


def check_drop_edge_draws(name):
    """Train mode: the output depends on the kept-edge masks, the same masks
    give the same output bitwise, the masks come from the generator alone
    (torch's global stream is neither read nor moved), and a train-mode
    forward without masks raises."""
    rng = np.random.default_rng(5)
    model = torch_model(name).train()
    c_obs, ori, valid = inputs(rng, [8, 5], 8)
    gen = torch.Generator().manual_seed(0)
    start = gen.get_state()
    state = torch.get_rng_state()
    outs = []
    for reset in (False, False, True):
        if reset:
            gen.set_state(start)
        set_edge_keeps(model, draw_edge_keeps(model, gen, 2, 8))
        outs.append(torch_forward(name, model, c_obs, ori, valid))
    assert torch.equal(torch.get_rng_state(), state)
    assert not np.allclose(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    set_edge_keeps(model, None)
    with pytest.raises(RuntimeError, match="kept-edge mask"):
        torch_forward(name, model, c_obs, ori, valid)
    eval_out = torch_forward(name, model.eval(), c_obs, ori, valid)
    assert not np.allclose(eval_out, outs[0])


# ----------------------------------------------- trainers on small splits
def splits():
    return tuple(make_synthetic_data(n_scenes=n, max_peds=6, seed=seed)
                 for n, seed in ((9, 1), (5, 2), (7, 3)))


def imported_pair(name, tmp):
    """(JAX trainer, port trainer) holding the reference's eth weights and
    ET parameters, at a batch of 4 scenes."""
    data = splits()
    kw = dict(checkpoint_dir=str(tmp), batch_size=4)
    jtr = ETJaxTrainer(jax_load_config(cfg_path(name), **kw), tag="eth", test_mode=True,
                       datasets=data)
    jtr.params, jtr.batch_stats, jtr.et = jinterop.import_state_dict(name, reference_sd(name))
    ttr = ETTorchTrainer(load_config(cfg_path(name), **kw), tag="eth", datasets=data,
                         device="cpu")
    ttr.load_state(*import_state_dict(name, reference_sd(name)))
    return jtr, ttr


def check_step_with_drop_edge_off(name, tmp):
    """One step's loss and gradients on a block of 4 rows, the last two of
    them padding scenes, against jax.value_and_grad at train=False (neither
    model has batch statistics: that is the train loss without DropEdge)."""
    jtr, ttr = imported_pair(name, tmp)
    batch = pad_scenes(ttr.data_train, [0, 1], ttr.n_max, 4)
    obs, pred, valid, scene_valid = (jnp.asarray(x) for x in
                                     (batch.obs, batch.pred, batch.ped_valid, batch.scene_valid))

    def batched_loss(p):
        def one(o, g, v):
            out = jtr._scene_forward(p, {}, o, g, v, None, jtr._make_aux_template(o.shape[0]),
                                     train=False)
            return out["loss_eigentraj"] + out["loss_euclidean_ade"] + out["loss_euclidean_fde"]

        losses = jnp.nan_to_num(jax.vmap(one)(obs, pred, valid)) * scene_valid
        return losses.sum() / jtr.cfg.batch_size

    want_loss, want_grads = jax.value_and_grad(batched_loss)(jtr.params)
    assert not ttr.model.training
    loss = ttr.loss_and_grads(*(torch.from_numpy(x) for x in
                                (batch.obs, batch.pred, batch.ped_valid, batch.scene_valid)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want_grads), sep="/")
    got = {n: p.grad.numpy() for n, p in ttr.model.named_parameters() if p.grad is not None}
    paths = jax_param_paths(ttr.model)
    assert set(flat) == {paths[n] for n in got} and len(got) == len(list(ttr.model.parameters()))
    assert any(np.abs(g).max() > 1e-3 for g in got.values())
    for n, g in got.items():
        np.testing.assert_allclose(g, flat[paths[n]], atol=1e-5, rtol=1e-4, err_msg=n)


def check_test_means(name, tmp):
    """test() of a checkpoint that the JAX trainer wrote (its own descriptor
    fit and initial weights), read by load_model(): the means within 1e-4,
    the plain version of the kernel on the CPU."""
    data = splits()
    kw = dict(checkpoint_dir=str(tmp), batch_size=4, static_dist=0.3)
    jtr = ETJaxTrainer(jax_load_config(cfg_path(name), **kw), tag="jax", test_mode=True,
                       datasets=data)
    jtr.init_descriptor()
    jtr.save_model()
    ttr = ETTorchTrainer(load_config(cfg_path(name), **kw), tag="jax", datasets=data,
                         device="cpu")
    ttr.load_model()
    want = jtr.test(eval_batch=4)
    launches = recon.LAUNCHES
    got = ttr.test(eval_batch=4)
    assert recon.LAUNCHES == launches
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert np.isfinite(list(got.values())).all() and 0.0 < got["ADE"]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("r", [0, 1])
def test_disentangle_is_bitwise_jax_with_values_on_the_band_edges(r):
    rng = np.random.default_rng(10 + r)
    a = np.abs(rng.normal(size=(3, 8, 7, 7)) * 2).astype(np.float32)
    edges = np.array(list(tdmrgcn.SPLIT[r]) + [1e10], np.float32)
    a.reshape(-1)[::5][:200] = np.resize(edges, 200)          # 0 is the first edge
    a[:, :, np.arange(7), np.arange(7)] = 0.0
    got = tdmrgcn.disentangle(torch.from_numpy(a), tdmrgcn.SPLIT[r]).numpy()
    want = np.concatenate([np.asarray(jdmrgcn.disentangle(jnp.asarray(a[b:b + 1]),
                                                          jdmrgcn.SPLIT[r]))
                           for b in range(3)])
    assert got.shape == (3, 5, 8, 7, 7)
    np.testing.assert_array_equal(got, want)
    on_edge = np.isin(a, edges)
    assert on_edge.sum() > 100 and not got.transpose(0, 2, 3, 4, 1)[on_edge].any()
    assert (got.sum(axis=1) <= 1).all()


def test_laplacian_tilde_is_bitwise_jax_and_zero_on_padded_rows():
    rng = np.random.default_rng(12)
    valid = np.arange(9)[None] < np.array([9, 4, 1])[:, None]
    a = (rng.random(size=(3, 5, 8, 9, 9)) < 0.4).astype(np.float32)
    a *= (valid[:, :, None] & valid[:, None, :])[:, None, None]
    a[..., np.arange(9), np.arange(9)] = 0.0
    got = tdmrgcn.normalized_laplacian_tilde(torch.from_numpy(a)).numpy()
    want = np.asarray(jdmrgcn.normalized_laplacian_tilde(jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)
    assert not got[1][..., 4:, :].any() and not got[2][..., 1:, :].any()


def test_adjacency_is_bitwise_jax_on_a_block_of_different_counts():
    rng = np.random.default_rng(13)
    c_obs, ori, valid = inputs(rng, [7, 3, 1, 0], 7)
    c_obs[0, :, 2] = c_obs[0, :, 5]                       # a distance of exactly 0
    c_obs[1, 1, 1] = c_obs[1, 1, 0] + 0.25
    v, a, v_out = tdmrgcn.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori),
                                  {"ped_valid": torch.from_numpy(valid)})
    assert not a.requires_grad and v_out is not None
    for b in range(4):
        jv, ja, _ = jdmrgcn.prepare(jnp.asarray(c_obs[b]), jnp.asarray(ori[b]),
                                    {"ped_valid": jnp.asarray(valid[b])})
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(jv)[0])
        np.testing.assert_array_equal(a[b].numpy(), np.asarray(ja)[0])
    assert not a[1][..., 3:, :].any() and not a[3].any()


def test_eval_forward_with_the_eth_weights_matches_jax():
    check_eval_forward("dmrgcn")


def test_eval_forward_in_float64_matches_jax_x64():
    check_float64_forward("dmrgcn")


@pytest.mark.parametrize("pad", [2, 9])
def test_padding_invariance(pad):
    check_padding_invariance("dmrgcn", pad)


def test_a_block_of_scenes_with_different_counts_is_each_scene_alone():
    check_block_of_different_counts("dmrgcn")


def test_drop_edge_keeps_four_in_five_without_rescaling():
    layer = DropEdge(5, 8)
    assert drop_edge_layers(layer) == [layer] and list(layer.buffers()) == []
    gen = torch.Generator().manual_seed(0)
    (keep,) = draw_edge_keeps(layer, gen, 16, 20)
    assert keep.shape == (16, 5, 8, 20, 20) and keep.dtype == torch.bool
    a = torch.rand((16, 5, 8, 20, 20), generator=torch.Generator().manual_seed(1),
                   dtype=torch.float64) + 0.5
    layer.keep = keep
    out = layer.train()(a)
    kept = float((out != 0).double().mean())
    assert abs(kept - 0.8) <= 0.01
    assert torch.equal(out[keep], a[keep]) and not out[~keep].any()
    assert layer.eval()(a) is a
    with pytest.raises(ValueError):
        layer.train()(a[:8])
    layer.keep = None
    with pytest.raises(RuntimeError):
        layer(a)


def test_drop_edge_draws_only_from_the_generator_it_is_given():
    check_drop_edge_draws("dmrgcn")


def test_dmrgcn_has_two_drop_edge_sites_and_no_buffers():
    model = torch_model("dmrgcn")
    sites = drop_edge_layers(model)
    assert [(m.relation, m.seq_len) for m in sites] == [(5, K + 2), (5, K + 2)]
    assert list(model.buffers()) == []


def test_step_loss_and_gradients_with_drop_edge_off_match_jax(tmp_path):
    check_step_with_drop_edge_off("dmrgcn", tmp_path)


def test_test_means_match_jax(tmp_path):
    check_test_means("dmrgcn", tmp_path)
