"""Port vs JAX package: ET-Social-Implicit (`SocialImplicitLight`).

The zones bitwise (values on the bin edges included), the per-scene
compaction bitwise against the JAX model's stable argsort, the cells and
`Conv1dTorch`, the eval forward on a block of scenes against `vmap` of the
JAX model with the JAX init carried across (<= 1e-4), and `test()` from a
checkpoint the JAX trainer wrote.

The JAX init sets `global_w` and `local_w` to 0, which makes every output
0; the forward tests draw them anew (the same values on both sides), so
that both streams of every cell count. The first coefficients are spread
over the bins so that at least two zones hold pedestrians and one is empty;
each test asserts it.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.models import implicit as jimp
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.interop import params_from_jax
from eigentrajectory_tpu_torch.models import implicit as timp
from eigentrajectory_tpu_torch.ops import recon
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from tests.test_torch_gpgraph import ET_DUMMY, inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S = 6, 20
TOL = dict(atol=1e-4, rtol=1e-4)


class CFG:
    k = K
    num_samples = S


def spread_c0(rng, c_obs, valid, zones=(1, 2, 3)):
    """Put each valid pedestrian's first coefficient in one of `zones`,
    away from the edges, with a random sign."""
    bins = np.array(jimp.BINS + (10.0,), np.float32)
    pick = rng.choice(zones, size=valid.shape)
    lo, hi = bins[pick], bins[pick + 1]
    value = lo + (hi - lo) * rng.uniform(0.2, 0.8, size=valid.shape)
    c_obs[:, 0, :] = np.where(valid, value * rng.choice([-1, 1], size=valid.shape),
                              c_obs[:, 0, :]).astype(np.float32)
    return c_obs


def assert_zones_spread(zone, valid, at_least=2):
    used = set(np.asarray(zone)[valid].tolist())
    assert len(used) >= at_least and len(used) < len(jimp.BINS), used


@functools.lru_cache(maxsize=None)
def _jax_init(n=6):
    model = jimp.make_model(CFG)
    inputs_ = jimp.prepare(jnp.ones((K, n)), jnp.zeros((2, n)), {"ped_valid": jnp.ones(n, bool)})
    variables = jax.jit(lambda key, *a: model.init(key, *a, train=False))(
        jax.random.PRNGKey(5), *inputs_)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _drawn_weights(seed=0):
    """The JAX init with global_w, local_w and noise_w of every cell drawn."""
    rng = np.random.default_rng(seed)
    params = {name: {**cell, **{w: rng.uniform(0.5, 1.5, size=(1,)).astype(np.float32)
                                for w in ("global_w", "local_w", "noise_w")}}
              for name, cell in _jax_init()["params"].items()}
    return {"params": params}


def _torch_model(variables):
    state, _ = params_from_jax({**variables, "et": ET_DUMMY})
    model = timp.make_model(CFG)
    model.load_state_dict(state)                 # strict: every parameter filled
    return model.eval()


# --------------------------------------------------------- zones, order
def test_zones_are_bitwise_jax_with_values_on_the_bin_edges():
    edges = np.array(jimp.BINS, np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                           np.nextafter(edges, np.float32(2)), -edges, [5.0, 0.05, 0.5]])
    v = np.zeros((3, 1, 8, len(near)), np.float32)
    v[:, 0, 0, :] = near[None] * np.array([[1.0], [-1.0], [1.0]], np.float32)
    got = timp.zones(torch.from_numpy(v)).numpy()
    for b in range(3):
        norm = jnp.abs(jnp.asarray(v[b, 0, 0]))
        want = jnp.clip(jnp.sum(norm[None, :] >= jnp.asarray(jimp.BINS, jnp.float32)[:, None],
                                axis=0) - 1, 0, len(jimp.BINS) - 1)
        np.testing.assert_array_equal(got[b], np.asarray(want))
    assert set(got.reshape(-1).tolist()) == {0, 1, 2, 3}


def test_compaction_is_bitwise_the_jax_stable_argsort():
    rng = np.random.default_rng(1)
    sel = rng.random((5, 13)) < np.array([[0.0], [0.2], [0.5], [0.9], [1.0]])
    order, inverse = timp.compaction(torch.from_numpy(sel))
    for b in range(5):
        want = np.asarray(jnp.argsort(~jnp.asarray(sel[b]), stable=True))
        np.testing.assert_array_equal(order[b].numpy(), want)
        np.testing.assert_array_equal(inverse[b].numpy(), np.argsort(want, kind="stable"))


# ---------------------------------------------------------------- cells
def test_conv1d_and_the_local_cell_match_jax():
    rng = np.random.default_rng(2)
    cell = _drawn_weights()["params"]["cell_1"]["ped"]
    v = rng.normal(size=(3, 1, K + 2, 5)).astype(np.float32)
    local = timp.SocialCellLocal(1, S, K + 2, K)
    local.load_state_dict(params_from_jax({"params": cell, "et": ET_DUMMY})[0])
    got = local(torch.from_numpy(v)).detach().numpy()
    want = np.asarray(jax.vmap(lambda x: jimp.SocialCellLocal(1, S, K + 2, K).apply(
        {"params": cell}, x[None])[0])(jnp.asarray(v)))
    assert got.shape == (3, S, K, 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_the_global_cell_on_a_masked_row_matches_jax():
    rng = np.random.default_rng(3)
    cell = _drawn_weights()["params"]["cell_2"]
    v = rng.normal(size=(3, 1, K + 2, 6)).astype(np.float32)
    valid = np.arange(6)[None] < np.array([[6], [4], [1]])
    glob = timp.SocialCellGlobal(1, S, K + 2, K)
    glob.load_state_dict(params_from_jax({"params": cell, "et": ET_DUMMY})[0])
    got = glob(torch.from_numpy(v), torch.from_numpy(valid)).detach().numpy()
    want = np.asarray(jax.vmap(lambda x, m: jimp.SocialCellGlobal(1, S, K + 2, K).apply(
        {"params": cell}, x[None], m)[0])(jnp.asarray(v), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, **TOL)


# -------------------------------------------------------------- forward
def test_eval_forward_on_a_block_matches_vmap_of_the_jax_model():
    """Four scenes of 8, 6, 3 and 1 in 8 slots, zones 1-3 used and zone 0
    empty; (B, k, N, s) within 1e-4 on the valid slots, and each scene alone
    in its own width gives its rows of the block."""
    rng = np.random.default_rng(4)
    c_obs, ori, valid = inputs(rng, [8, 6, 3, 1], 8)
    c_obs = spread_c0(rng, c_obs, valid)
    variables = _drawn_weights()
    model = jimp.make_model(CFG)

    def one(c, o, v):
        aux = {"ped_valid": v}
        return jimp.finalize(model.apply(variables, *jimp.prepare(c, o, aux), train=False), aux)

    want = np.asarray(jax.vmap(one)(jnp.asarray(c_obs), jnp.asarray(ori), jnp.asarray(valid)))
    tmodel = _torch_model(variables)

    def run(c, o, v):
        aux = {"ped_valid": torch.from_numpy(v)}
        with torch.no_grad():
            inp = timp.prepare(torch.from_numpy(c), torch.from_numpy(o), aux)
            return timp.finalize(tmodel(*inp), aux).numpy(), timp.zones(inp[0]).numpy()

    got, zone = run(c_obs, ori, valid)
    assert_zones_spread(zone, valid, at_least=3)
    assert got.shape == (4, K, 8, S) and np.abs(got).max() > 1e-2
    for b in range(4):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]],
                                   err_msg=f"scene {b}", **TOL)
    m = int(valid[1].sum())
    alone, _ = run(c_obs[1:2, :, :m], ori[1:2, :, :m], valid[1:2, :m])
    np.testing.assert_allclose(alone[0], got[1][:, :m], atol=2e-5)


def test_all_cells_run_and_an_empty_zone_gets_zero_gradients():
    """Zone 0 holds nobody: its cell's parameters get gradients of exactly
    0 (not None); the used zones' do not."""
    rng = np.random.default_rng(5)
    c_obs, ori, valid = inputs(rng, [7, 5], 7)
    c_obs = spread_c0(rng, c_obs, valid)
    model = _torch_model(_drawn_weights()).train()
    aux = {"ped_valid": torch.from_numpy(valid)}
    inp = timp.prepare(torch.from_numpy(c_obs), torch.from_numpy(ori), aux)
    assert_zones_spread(timp.zones(inp[0]).numpy(), valid)
    model(*inp).square().sum().backward()
    grads = dict(model.named_parameters())
    assert all(p.grad is not None and not p.grad.any()
               for n, p in grads.items() if n.startswith("cell_0.") and "noise_w" not in n)
    assert all(p.grad is None for n, p in grads.items() if "noise_w" in n)
    assert grads["cell_3.feat.weight"].grad.abs().max() > 0


# ---------------------------------------------------------------- test()
def test_test_means_from_a_jax_checkpoint_match_jax(tmp_path):
    """test() of a checkpoint the JAX trainer wrote (its descriptor fit and
    initial weights), read by load_model(): the means within 1e-4."""
    data = tuple(make_synthetic_data(n_scenes=n, max_peds=6, seed=seed)
                 for n, seed in ((9, 1), (5, 2), (7, 3)))
    path = os.path.join(REPO, "configs", "eigentrajectory-implicit-hotel.json")
    kw = dict(checkpoint_dir=str(tmp_path), batch_size=4, static_dist=0.3)
    jtr = ETJaxTrainer(jax_load_config(path, **kw), tag="jax", test_mode=True, datasets=data)
    jtr.init_descriptor()
    jtr.save_model()
    ttr = ETTorchTrainer(load_config(path, **kw), tag="jax", datasets=data, device="cpu")
    ttr.load_model()
    want = jtr.test(eval_batch=4)
    launches = recon.LAUNCHES
    got = ttr.test(eval_batch=4)
    assert recon.LAUNCHES == launches
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert np.isfinite(list(got.values())).all()
