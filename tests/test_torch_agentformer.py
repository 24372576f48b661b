"""Port vs JAX package: ET-AgentFormer (collated).

The forward within 1e-4 of the JAX module (f32, sums in another order): the
positional table bitwise; one attention (self and cross, with padded lanes
and -inf lanes), one encoder and one decoder layer from a JAX initialization
carried across by `params_from_jax`; the whole model from the committed
zara2 checkpoint, and from a random initialization with `conn_dist` on. Then
the trainer on small synthetic splits: the packed `test()` against
`ETJaxTrainer.test()` and against one scene a batch, `predict()` against the
JAX predictor and at two buckets, one step's loss and gradients with
dropout off against the JAX loss at `train=False` (in float32, and in
float64 against JAX's x64 mode), the dropout stream (the
trainer's own: different states give other losses, the global stream none;
`fit` resumes bitwise), the zara2 checkpoint written back byte for byte, and
a `mesh_data_axis` other than the process group's world refused.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.config import load_config as jax_load_config
from eigentrajectory_tpu.inference import ETPredictor as JaxPredictor
from eigentrajectory_tpu.models import agentformer as jaf
from eigentrajectory_tpu.train.trainer import ETJaxTrainer
from eigentrajectory_tpu_torch.config import ExpConfig, load_config
from eigentrajectory_tpu_torch.data.batching import CollatedBatcher
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.inference import ETPredictor
from eigentrajectory_tpu_torch.interop import (params_from_jax, params_to_jax,
                                               read_flax_msgpack, write_flax_msgpack)
from eigentrajectory_tpu_torch.models import agentformer as taf
from eigentrajectory_tpu_torch.models import get_baseline
from eigentrajectory_tpu_torch.models.common import Dropout
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from tests.conftest import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
ZARA2 = os.path.join(CKPT, "parity", "zara2", "model_best.msgpack")
ZARA2_CFG = os.path.join(REPO, "configs", "eigentrajectory-agentformer-zara2.json")
K, S, E = 6, 20, 256
TOL = dict(atol=1e-4, rtol=1e-4)
METRICS = ("ADE", "FDE", "TCC", "COL")


def _state(params):
    """The port's state dict of a JAX params tree."""
    tree = {"params": jax.tree_util.tree_map(np.asarray, params),
            "et": read_flax_msgpack(ZARA2)["et"]}
    return params_from_jax(tree)[0]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------- modules
def test_positional_encoding_is_bitwise_the_jax_table():
    got, want = taf.positional_encoding(13, E), jaf.positional_encoding(13, E)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


def _attention_inputs(rng, lq, ls, n):
    q = rng.normal(size=(lq, E)).astype(np.float32)
    k = rng.normal(size=(ls, E)).astype(np.float32)
    same = (np.arange(lq)[:, None] % n) == (np.arange(ls)[None, :] % n)
    bias = np.zeros((lq, ls), np.float32)
    bias[:, np.arange(ls) % n == n - 1] = -1e9           # a padded agent's lanes
    bias[np.arange(lq) % n == 0, 1::n] = -np.inf         # agent 0 cut off from agent 1
    return q, k, same, bias


@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_jax_with_padded_and_cut_lanes(cross):
    rng = np.random.default_rng(0)
    n = 4
    q, k, same, bias = _attention_inputs(rng, 3 * n, (5 if cross else 3) * n, n)
    if not cross:
        k = q
    jmod = jaf.AgentAwareAttention()
    jq = jnp.asarray(q)
    jk = jq if not cross else jnp.asarray(k)
    params = jmod.init(jax.random.PRNGKey(1), jq, jk, jnp.asarray(same), jnp.asarray(bias))["params"]
    assert ("in_proj_kernel" in params) == cross
    want = jmod.apply({"params": params}, jq, jk, jnp.asarray(same), jnp.asarray(bias))
    mod = taf.AgentAwareAttention(cross=cross).eval()
    mod.load_state_dict(_state(params))                # strict: every parameter filled
    with torch.no_grad():
        tq = torch.from_numpy(q)[None]
        got = mod(tq, tq if not cross else torch.from_numpy(k)[None],
                  torch.from_numpy(same), torch.from_numpy(bias)[None])[0]
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_encoder_and_decoder_layers_match_jax():
    rng = np.random.default_rng(1)
    n = 3
    src, mem, same, bias = _attention_inputs(rng, 2 * n, 4 * n, n)
    same_t = (np.arange(2 * n)[:, None] % n) == (np.arange(2 * n)[None, :] % n)
    bias_t = np.where(np.arange(2 * n)[:, None] // n >= np.arange(2 * n)[None, :] // n,
                      0.0, -np.inf).astype(np.float32)
    j = {x: jnp.asarray(v) for x, v in dict(src=src, mem=mem, same=same, bias=bias,
                                            same_t=same_t, bias_t=bias_t).items()}
    t = {x: torch.from_numpy(np.array(v)) for x, v in j.items()}

    enc = jaf.EncoderLayer()
    p_enc = enc.init(jax.random.PRNGKey(2), j["src"], j["same_t"], j["bias_t"], False)["params"]
    dec = jaf.DecoderLayer()
    p_dec = dec.init(jax.random.PRNGKey(3), j["src"], j["mem"], j["same_t"], j["bias_t"],
                     j["same"], j["bias"], False)["params"]
    want_enc = enc.apply({"params": p_enc}, j["src"], j["same_t"], j["bias_t"], False)
    want_dec = dec.apply({"params": p_dec}, j["src"], j["mem"], j["same_t"], j["bias_t"],
                         j["same"], j["bias"], False)
    t_enc, t_dec = taf.EncoderLayer().eval(), taf.DecoderLayer().eval()
    t_enc.load_state_dict(_state(p_enc))
    t_dec.load_state_dict(_state(p_dec))
    assert t_enc.norm1.eps == 1e-6                      # flax's epsilon, not torch's
    with torch.no_grad():
        got_enc = t_enc(t["src"][None], t["same_t"], t["bias_t"][None])[0]
        got_dec = t_dec(t["src"][None], t["mem"][None], t["same_t"], t["bias_t"][None],
                        t["same"], t["bias"][None])[0]
    _close(got_enc, want_enc)
    _close(got_dec, want_dec)


# ------------------------------------------------------------ whole model
def _packed_inputs(rng, sizes=(3, 5, 2), pad=4):
    p = sum(sizes) + pad
    ids = np.full(p, -1, np.int32)
    ids[:sum(sizes)] = np.repeat(np.arange(len(sizes)), sizes)
    valid = ids >= 0
    c_obs = (rng.normal(size=(K, p)) * valid).astype(np.float32)
    ori = (rng.normal(size=(2, p)) * valid).astype(np.float32)
    return c_obs, ori, ids


def _jax_forward(cfg, params, c_obs, ori, ids, isolate):
    aux = {"ped_valid": jnp.asarray(ids >= 0), "scene_ids": jnp.asarray(ids),
           "isolate_scenes": isolate, "num_samples": S}
    inputs = jaf.prepare(jnp.asarray(c_obs), jnp.asarray(ori), aux)
    out = jaf.make_model(cfg).apply({"params": params}, *inputs, train=False)
    return np.asarray(jaf.finalize(out, aux))


def _torch_forward(model, c_obs, ori, ids, isolate):
    ids_t = torch.from_numpy(ids)[None]
    aux = {"ped_valid": ids_t >= 0, "scene_ids": ids_t, "isolate_scenes": isolate}
    with torch.no_grad():
        inputs = taf.prepare(torch.from_numpy(c_obs)[None], torch.from_numpy(ori)[None], aux)
        assert len(inputs) == (3 if isolate else 2)
        return taf.finalize(model(*inputs), aux)[0].numpy()


@pytest.mark.parametrize("isolate", [False, True])
def test_forward_from_the_zara2_checkpoint_matches_jax(isolate):
    """Whole packed row, padded slots included in the sequence; with
    `isolate_scenes` the scenes do not see each other."""
    cfg = ExpConfig(baseline="agentformer")
    tree = read_flax_msgpack(ZARA2)
    model = taf.make_model(cfg).eval()
    model.load_state_dict(params_from_jax(tree)[0])
    c_obs, ori, ids = _packed_inputs(np.random.default_rng(2))
    want = _jax_forward(cfg, jax.tree_util.tree_map(jnp.asarray, tree["params"]),
                        c_obs, ori, ids, isolate)
    got = _torch_forward(model, c_obs, ori, ids, isolate)
    valid = ids >= 0
    assert got.shape == want.shape == (K, len(ids), S)
    _close(got[:, valid], want[:, valid])
    if isolate:          # scene 0 alone gives its numbers
        sel = ids == 0
        alone = _torch_forward(model, c_obs[:, sel], ori[:, sel], ids[sel], True)
        np.testing.assert_allclose(got[:, sel], alone, atol=1e-5)


def test_forward_with_conn_dist_matches_jax_from_a_jax_init():
    """conn_dist < 1000 cuts agents apart by their last position; the random
    JAX initialization carried across."""
    cfg = ExpConfig(baseline="agentformer", baseline_config={"conn_dist": 0.8})
    c_obs, ori, ids = _packed_inputs(np.random.default_rng(3))
    aux = {"ped_valid": jnp.asarray(ids >= 0)}
    jmodel = jaf.make_model(cfg)
    assert jmodel.conn_dist == 0.8
    inputs = jaf.prepare(jnp.asarray(c_obs), jnp.asarray(ori), aux)
    params = jmodel.init(jax.random.PRNGKey(4), *inputs)["params"]
    model = get_baseline("agentformer").make_model(cfg).eval()
    assert model.conn_dist == 0.8
    model.load_state_dict(_state(params))
    want = _jax_forward(cfg, params, c_obs, ori, ids, False)
    got = _torch_forward(model, c_obs, ori, ids, False)
    valid = ids >= 0
    _close(got[:, valid], want[:, valid])
    model.conn_dist = 1e5                         # the cut changes the numbers
    assert np.abs(_torch_forward(model, c_obs, ori, ids, False) - got)[:, valid].max() > 1e-4


@torch.no_grad()
def test_initial_weights_follow_the_jax_distributions():
    model = taf.make_model(ExpConfig(baseline="agentformer"))
    attn = model.dec_layer_0.multihead_attn
    bound = (6.0 / (E + 3 * E)) ** 0.5               # xavier-uniform
    for w in (model.enc_layer_0.self_attn.in_proj.weight, attn.in_proj_kernel):
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert float(attn.in_proj_bias.abs().max()) == 0.0
    assert 0.008 < float(model.out_fc_kernel.std()) < 0.012
    assert float(model.out_fc_bias.abs().max()) == 0.0
    assert model.out_fc_kernel.shape == (E, S)
    linear = model.enc_layer_0.linear1.weight         # torch's default: U(+-1/sqrt(in))
    assert float(linear.abs().max()) <= E ** -0.5
    names = [n for n, _ in model.named_buffers()]
    assert names == []                                 # the positional table is no leaf


# ------------------------------------------------------------------ trainer
def _test_split():
    return make_synthetic_data(n_scenes=14, max_peds=9, seed=4)


@pytest.fixture(scope="module")
def zara2():
    """(JAX trainer, port trainer) from the committed zara2 checkpoint on the
    same small synthetic splits."""
    splits = (_test_split(),) * 3
    jtr = ETJaxTrainer(jax_load_config(ZARA2_CFG, checkpoint_dir=CKPT, batch_size=16),
                       tag="parity", test_mode=True, datasets=splits)
    jtr.load_model()
    ttr = ETTorchTrainer(load_config(ZARA2_CFG, checkpoint_dir=CKPT, batch_size=16),
                         tag="parity", datasets=splits, device="cpu")
    ttr.load_model()
    return jtr, ttr


def test_load_model_fills_every_leaf_of_the_zara2_checkpoint(zara2):
    _, ttr = zara2
    tree = read_flax_msgpack(ZARA2)
    state, _ = params_from_jax(tree)
    assert set(state) == set(ttr.model.state_dict())
    for name, value in ttr.model.state_dict().items():
        assert torch.equal(value, state[name]), name


def test_packed_test_matches_jax_and_one_scene_a_batch(zara2):
    """P <= 128 a packed batch (the cap), scenes isolated; ADE, FDE, COL
    within 1e-4 of the JAX trainer, and the same scenes one a batch."""
    jtr, ttr = zara2
    batches = CollatedBatcher(ttr.data_test, 40, False)
    assert len(batches) > 1
    want, got = jtr.test(eval_ped_batch=40), ttr.test(eval_ped_batch=40)
    for key in ("ADE", "FDE", "COL"):
        _close(got[key], want[key])
    assert abs(got["TCC"] - want["TCC"]) < 1e-3
    per_scene = ttr.test(eval_ped_batch=1)
    for key in METRICS:
        np.testing.assert_allclose(got[key], per_scene[key], rtol=1e-4, atol=1e-5, err_msg=key)
    assert 0.0 < got["ADE"] < got["FDE"]
    assert taf.EVAL_PED_CAP == 128 and ttr.baseline.EVAL_PED_CAP == 128


def test_make_aux_carries_the_scene_ids(zara2):
    _, ttr = zara2
    batch = next(iter(CollatedBatcher(ttr.data_test, 40, False)))
    obs, pred, valid, ids = ttr._to_device(batch)
    aux = ttr.make_aux(valid, ids)
    assert torch.equal(aux["scene_ids"], ids) and aux["num_samples"] == S
    assert aux["scene_mask"].shape == (1, ids.shape[1], ids.shape[1])


@pytest.fixture(scope="module")
def predictors(zara2):
    jtr, ttr = zara2
    return JaxPredictor(jtr, bucket=16), ETPredictor(ttr, bucket=16)


def _request():
    rng = np.random.default_rng(8)
    sizes = (3, 6, 2, 7)
    obs = np.concatenate([make_scene(rng, n_ped=n, speed=0.4)[0] for n in sizes])
    ids = np.repeat(np.arange(len(sizes)) * 3 + 1, sizes)
    order = rng.permutation(len(obs))                # scenes interleaved in the request
    return obs[order], ids[order]


def test_predict_matches_the_jax_predictor(predictors):
    jp, tp = predictors
    obs, ids = _request()
    want, got = jp.predict(obs, ids), tp.predict(obs, ids)
    assert got.shape == want.shape == (S, len(obs), 12, 2)
    _close(got, want)


def test_predict_does_not_depend_on_the_bucket(predictors):
    """The padded lanes are masked with -1e9: 32 and 128 slots a scene give
    the same futures."""
    _, tp = predictors
    obs, ids = _request()
    small = ETPredictor(tp.trainer, bucket=32).predict(obs, ids)
    large = ETPredictor(tp.trainer, bucket=128).predict(obs, ids)
    np.testing.assert_allclose(small, large, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- training
def _splits():
    return tuple(make_synthetic_data(n_scenes=n, max_peds=6, seed=seed)
                 for n, seed in ((10, 1), (4, 2), (4, 3)))


def _kw(tmp, **kw):
    return {**dict(baseline="agentformer", batch_size=12, checkpoint_dir=str(tmp),
                   dataset="synthetic", static_dist=0.3), **kw}


def _trainer(tmp, tag="af", **kw):
    return ETTorchTrainer(ExpConfig(**_kw(tmp, **kw)), tag=tag, datasets=_splits(), device="cpu")


def _jax_step(jtr, ttr, batch, x64):
    """JAX loss and gradients of one packed batch at train=False, in float32
    or in x64 mode with every float of the model and the ET parameters in
    float64; the gradients as {port parameter name: array}."""
    from tests.test_torch_train import _by_torch_name

    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32

        def cast(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dtype)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)

        params, stats, et = cast(jtr.params), cast(jtr.batch_stats), jtr.et
        obs, pred = (jnp.asarray(x, dtype) for x in (batch.obs, batch.pred))
        valid, ids = jnp.asarray(batch.ped_valid), jnp.asarray(batch.scene_ids)

        def loss_fn(p):
            aux = jtr._make_aux_template(obs.shape[0], ids)
            out = jtr._scene_forward(p, stats, obs, pred, valid, None, aux, train=False)
            loss = out["loss_eigentraj"] + out["loss_euclidean_ade"] + out["loss_euclidean_fde"]
            return jnp.nan_to_num(loss, nan=0.0, posinf=0.0, neginf=0.0)

        jtr.et = cast(et)
        try:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        finally:
            jtr.et = et
        assert loss.dtype == dtype
        return float(loss), {n: np.asarray(g, np.float64)
                             for n, g in _by_torch_name(ttr, grads).items()}


def _port_step(tr, batch, probes=()):
    """The port's loss and gradients of one packed batch, dropout off, and
    the gradients at the outputs of the modules named in `probes` (and the
    largest entry of each output, under `name + ":out"`)."""
    seen, hooks = {}, []
    modules = dict(tr.model.named_modules())
    for name in probes:
        def hook(module, inputs, out, name=name):
            seen[name + ":out"] = float(out.detach().abs().max())
            out.register_hook(lambda g: seen.__setitem__(name, g.detach().double().numpy()))
        hooks.append(modules[name].register_forward_hook(hook))
    tr.model.eval()                                   # no BN here: eval is dropout off
    try:
        loss = float(tr.loss_and_grads(*tr._to_device(batch)))
    finally:
        for h in hooks:
            h.remove()
    grads = {n: p.grad.double().numpy() for n, p in tr.model.named_parameters()
             if p.grad is not None}
    assert len(grads) == len(list(tr.model.parameters()))
    return loss, grads, seen


def test_step_loss_and_gradients_with_dropout_off_match_jax(zara2):
    """One packed batch's loss from the zara2 weights (a masked mean,
    training's scope: the scenes see each other), dropout off, against
    jax.value_and_grad at train=False. Each tensor's scale is its own
    largest entry of the x64 gradient.

    In float64 the port's loss and every gradient tensor are JAX's x64 ones
    within 1e-8 of scale. In float32 the loss is within 1e-5 relative and
    every gradient tensor within 1e-4 of scale of JAX's f32 one, where f32
    resolves it: where JAX's own f32 gradient lies within 1e-4 of scale of
    its x64 one. The tensors it does not resolve are decoder parameters whose
    gradients come out of the decoder attentions' softmax backward, orders of
    magnitude below the gradients around them, and tensors whose gradient
    lies below f32's smallest normal number; there the port's f32 must lie
    within 32 times JAX's own f32 error of the x64 gradient."""
    jtr, ttr = zara2
    batch = next(iter(ttr.train_batches(0)))
    assert batch.scene_ids.max() >= 1 and not batch.ped_valid.all()
    want_loss, want = _jax_step(jtr, ttr, batch, x64=False)
    true_loss, truth = _jax_step(jtr, ttr, batch, x64=True)
    t64 = ETTorchTrainer(ttr.cfg, tag="parity", datasets=(ttr.data_test,) * 3, device="cpu",
                         dtype=torch.float64)
    t64.load_model()
    probes = ("dec_layer_0.self_attn", "dec_pos_encoder")
    loss, grads, seen = _port_step(ttr, batch, probes)
    loss64, grads64, seen64 = _port_step(t64, batch, probes)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(loss64, true_loss, rtol=1e-12)
    assert set(grads) == set(grads64) == set(want) == set(truth)

    def gap(a, b):
        return float(np.abs(a - b).max())

    unresolved = {}
    for name, ref in truth.items():
        scale = float(np.abs(ref).max())
        assert gap(grads64[name], ref) <= 1e-8 * scale, (name, gap(grads64[name], ref), scale)
        jax_err = gap(want[name], ref)
        if jax_err <= 1e-4 * scale:
            assert gap(grads[name], want[name]) <= 1e-4 * scale, (name, scale)
        else:
            unresolved[name] = (gap(grads[name], ref) / scale, jax_err / scale, scale)
            assert gap(grads[name], ref) <= 32 * jax_err, (name, unresolved[name])
    tiny = float(np.finfo(np.float32).tiny)
    assert unresolved and all(n.startswith("dec_") or r[2] < tiny
                              for n, r in unresolved.items()), unresolved
    # Where f32 loses the digits: the gradient reaching the first decoder
    # self-attention from its post-LN norm, against the one it passes on.
    lost = {p: gap(seen[p], seen64[p]) / float(np.abs(seen64[p]).max()) for p in probes}
    assert lost["dec_layer_0.self_attn"] <= 1e-4, lost
    print(f"f32 leaves unresolved by JAX's own f32 (|port - x64|, |JAX - x64| of scale, "
          f"scale): "
          f"{ {n: tuple(f'{v:.2e}' for v in r) for n, r in sorted(unresolved.items())} }; "
          f"f32 vs f64 gradient at the output of {', '.join(f'{p} {v:.2e}' for p, v in lost.items())}; "
          f"gradient scales {float(np.abs(seen64[probes[0]]).max()):.3e}, "
          f"{float(np.abs(seen64[probes[1]]).max()):.3e}; largest output entries "
          f"{seen64[probes[0] + ':out']:.3e}, {seen64[probes[1] + ':out']:.3e}")


def test_dropout_draws_from_the_trainer_generator(zara2):
    """Train mode: two steps from different states of the trainer's own
    generator give different losses, the same state the same loss bitwise,
    and torch's global stream is neither read nor moved."""
    _, ttr = zara2
    args = ttr._to_device(next(iter(ttr.train_batches(0))))
    assert all(m.generator is ttr.dropout_generator
               for m in ttr.model.modules() if isinstance(m, Dropout))
    ttr.model.train()
    try:
        start = ttr.dropout_generator.get_state()
        global_state = torch.get_rng_state()
        with torch.no_grad():
            first = ttr._chunk_loss(*args)
            second = ttr._chunk_loss(*args)
            ttr.dropout_generator.set_state(start)
            torch.manual_seed(123)
            again = ttr._chunk_loss(*args)
        assert torch.equal(torch.get_rng_state(), torch.manual_seed(123).get_state())
        torch.set_rng_state(global_state)
    finally:
        ttr.model.eval()
    assert float(first) != float(second)
    assert torch.equal(first, again)


def test_dropout_keeps_nine_in_ten_and_scales_them():
    drop = Dropout(0.1)
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(100_000, dtype=torch.float64)
    y = drop.train()(x)
    kept = float((y != 0).double().mean())
    assert abs(kept - 0.9) < 0.01 * 0.9
    assert torch.all((y == 0) | (y == 1 / 0.9))
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(RuntimeError):
        Dropout(0.1).train()(x)


def test_fit_resumes_bitwise_and_ignores_the_global_stream(tmp_path):
    """fit(2) straight, under two global seeds, and fit(1) + resume + fit(2):
    the same losses bit for bit, and the dropout generator restored."""
    logs = []
    for global_seed in (0, 99):
        torch.manual_seed(global_seed)
        tr = _trainer(tmp_path, tag=f"straight{global_seed}")
        tr.init_descriptor()
        tr.fit(num_epochs=2, verbose=False)
        logs.append(tr.log)
    assert logs[0] == logs[1]
    first = _trainer(tmp_path, tag="resumed")
    first.init_descriptor()
    first.fit(num_epochs=1, verbose=False, checkpoint_every=1)
    second = _trainer(tmp_path, tag="resumed")
    second.fit(num_epochs=2, verbose=False, resume=True)
    assert len(second.epoch_timer.durations) == 1
    assert second.log == logs[0]
    assert torch.equal(second.dropout_generator.get_state(), tr.dropout_generator.get_state())
    assert all(np.isfinite(logs[0]["train_loss"]))


# ------------------------------------------------------------ checkpoints
def test_the_zara2_checkpoint_is_written_back_byte_for_byte(zara2, tmp_path):
    _, ttr = zara2
    with open(ZARA2, "rb") as f:
        committed = f.read()
    out = tmp_path / "direct.msgpack"
    write_flax_msgpack(str(out), params_to_jax(ttr.model, ttr.et))
    assert out.read_bytes() == committed


def test_mesh_data_axis_above_one_is_refused(tmp_path, monkeypatch):
    """mesh_data_axis must equal the process group's world: refused with no
    group, and in a group of another size."""
    from eigentrajectory_tpu_torch import parallel

    with pytest.raises(ValueError, match="mesh_data_axis = 2 needs a process group .* none"):
        _trainer(tmp_path, mesh_data_axis=2)
    monkeypatch.setattr(parallel, "current",
                        lambda: parallel.Rank(0, 4, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="mesh_data_axis = 2 .* one of 4 ranks"):
        _trainer(tmp_path, mesh_data_axis=2)
    assert _trainer(tmp_path, mesh_data_axis=1).p_max > 0
