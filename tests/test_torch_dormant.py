"""Port vs JAX package: the dormant stochastic modules that no pipeline calls
(PECNet CVAE, LB-EBM CVAE with its Langevin prior sampler and ReplayMemory,
the full Social-Implicit, Graph-TERN's GMM sampling, pruning, guided
sampling and full model). Parameters come from the JAX module's `init`
through `interop.module_state_from_jax`; the draws (`eps`, `z_e_0`, the
noise, the endpoint set) are injected on both sides, as
tests/test_dormant_stochastic.py injects them against the reference.

Tolerances: forwards 1e-5, gradients and the Langevin chain 1e-4 of the
largest entry of the JAX value, prune_select's choice and ReplayMemory
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.models import graphtern as jgt
from eigentrajectory_tpu.models import implicit as jimp
from eigentrajectory_tpu.models import lbebm as jlb
from eigentrajectory_tpu.models import pecnet as jpec
from eigentrajectory_tpu_torch.interop import module_state_from_jax
from eigentrajectory_tpu_torch.models import graphtern as tgt
from eigentrajectory_tpu_torch.models import implicit as timp
from eigentrajectory_tpu_torch.models import lbebm as tlb
from eigentrajectory_tpu_torch.models import pecnet as tpec
from eigentrajectory_tpu_torch.models.common import zero_invalid

K, S = 6, 20


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _load(module, variables, missing_prefixes=()):
    """JAX variables into the port's module; every leaf of the tree has a
    home there and every parameter left unfilled is of a layer the JAX
    module never built."""
    missing, unexpected = module.load_state_dict(module_state_from_jax(variables),
                                                 strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith(missing_prefixes) for k in missing) if missing_prefixes \
        else not missing, missing
    return module.eval()


def _close(got, want, rel, what="", floor=1e-6):
    """|got - want| <= rel * max(max |want|, floor)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _grads_close(t_model, j_grads, rel):
    """Every parameter's gradient within rel of its scale: its largest
    entry, and at least a thousandth of the largest entry of any gradient
    (a tensor whose true gradient is 0, such as the bias of the social
    pool's phi under the row softmax, holds rounding noise)."""
    want = module_state_from_jax({"params": j_grads})
    got = dict(t_model.named_parameters())
    assert set(want) <= set(got)
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert got[name].grad is not None, name
        _close(got[name].grad, g.numpy(), rel, name, floor)


# --------------------------------------------------------------- PECNet CVAE
def _pecnet(rng, n):
    future_length = K * S // 2 + 1
    jm = jpec.PECNetCVAE(future_length=future_length)
    past, ip, dest = (rng.normal(size=(n, w)).astype(np.float32) for w in (K, 2, 2))
    mask = np.ones((n, n), bool)
    mask[0, 2:] = mask[2:, 0] = False
    eps = rng.normal(size=(n, 16)).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                        past, ip, mask, dest, eps=eps, train=True)
    tm = _load(tpec.PECNetCVAE(K, future_length), variables)
    return jm, variables, tm, (past, ip, mask, dest, eps)


def test_pecnet_cvae_eval_branch(rng):
    jm, variables, tm, (past, ip, _, _, eps) = _pecnet(rng, 7)
    want = jm.apply(variables, past, ip, eps=eps, train=False)
    got = tm(_t(past), _t(ip), eps=_t(eps), train=False)
    _close(got, want, 1e-5)


def test_pecnet_cvae_train_branch_and_gradients(rng):
    jm, variables, tm, (past, ip, mask, dest, eps) = _pecnet(rng, 6)
    want = jm.apply(variables, past, ip, mask, dest, eps=eps, train=True)
    got = tm(_t(past), _t(ip), _t(mask), _t(dest), eps=_t(eps), train=True)
    for g, w, name in zip(got, want, ("generated_dest", "mu", "logvar", "pred_future")):
        _close(g, w, 1e-5, name)

    def loss(params):
        return jm.apply({"params": params}, past, ip, mask, dest, eps=eps,
                        train=True)[3].sum()

    j_grads = jax.grad(loss)(variables["params"])
    got[3].sum().backward()
    _grads_close(tm, j_grads, 1e-4)


def test_pecnet_cvae_train_needs_dest_and_mask(rng):
    torch.manual_seed(0)
    tm = tpec.PECNetCVAE(K, K * S // 2 + 1).eval()
    past, ip, dest, eps = (rng.normal(size=(4, w)).astype(np.float32) for w in (K, 2, 2, 16))
    mask = np.ones((4, 4), bool)
    with pytest.raises(ValueError, match="dest"):
        tm(_t(past), _t(ip), _t(mask), eps=_t(eps), train=True)
    g = torch.Generator().manual_seed(0)
    out = tm(_t(past), _t(ip), generator=g)                 # eps drawn
    assert out.shape == (4, 2) and torch.isfinite(out).all()


# ------------------------------------------------------------------- LB-EBM
def _lbebm(rng, n):
    future_length = K * S // 2
    jm = jlb.LBEBMCVAE(future_length=future_length)
    past, dest = (rng.normal(size=(n, w)).astype(np.float32) for w in (K, 2))
    z0 = (rng.normal(size=(n, 16)) * 2.0).astype(np.float32)
    eps = rng.normal(size=(n, 16)).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                        past, dest, z_e_0=z0, eps=eps, train=True, langevin_noise=False)
    tm = _load(tlb.LBEBMCVAE(K, future_length), variables, missing_prefixes=("non_local_",))
    return jm, variables, tm, (past, dest, z0, eps)


def test_lbebm_energy_head_names_and_layout(rng):
    _, variables, tm, _ = _lbebm(rng, 3)
    p = variables["params"]
    for i, shape in enumerate(((32, 200), (200, 200), (200, 1))):
        kernel = getattr(tm, f"EBM_layers_{i}_kernel")
        assert tuple(kernel.shape) == shape
        np.testing.assert_array_equal(kernel.detach().numpy(), p[f"EBM_layers_{i}_kernel"])


def test_lbebm_langevin_sampler(rng):
    jm, variables, tm, (_, _, z0, _) = _lbebm(rng, 5)
    p = variables["params"]
    params_ebm = {f"layers_{i}": {"kernel": p[f"EBM_layers_{i}_kernel"],
                                  "bias": p[f"EBM_layers_{i}_bias"]} for i in range(3)}
    cond = rng.normal(size=(5, 16)).astype(np.float32)
    want = jm.sample_langevin_prior_z(params_ebm, z0, cond, with_noise=False)
    got = tm.sample_langevin_prior_z(_t(z0), _t(cond), with_noise=False)
    assert not got.requires_grad
    _close(got, want, 1e-4)
    assert np.abs(np.asarray(want) - z0).max() > 1e-2      # the chain moved


@pytest.mark.parametrize("train", [False, True])
def test_lbebm_cvae_forward(rng, train):
    jm, variables, tm, (past, dest, z0, eps) = _lbebm(rng, 5)
    want = jm.apply(variables, past, dest, z_e_0=z0, eps=eps, train=train,
                    langevin_noise=False)
    got = tm(_t(past), _t(dest), z_e_0=_t(z0), eps=_t(eps), train=train,
             langevin_noise=False)
    if not train:
        _close(got, want, 1e-4)
        return
    names = ("generated_dest", "mu", "logvar", "pred_future", "cd", "en_pos", "en_neg")
    energy_scale = max(abs(float(want[5])), abs(float(want[6])))
    for g, w, name in zip(got, want, names):
        if name == "cd":        # a difference of two energies: their scale
            assert abs(g.item() - float(w)) <= 1e-4 * energy_scale, (g.item(), float(w))
        else:
            _close(g, w, 1e-4, name)


def test_lbebm_gradients_reach_the_ebm_through_the_energies_only(rng):
    """cd's gradient flows into the EBM head through en_pos and en_neg (the
    sampler's chain is detached), as jax.grad of the same loss gives it."""
    jm, variables, tm, (past, dest, z0, eps) = _lbebm(rng, 4)

    def loss(params):
        out = jm.apply({"params": params}, past, dest, z_e_0=z0, eps=eps, train=True,
                       langevin_noise=False)
        return out[4] + out[3].sum()

    j_grads = jax.grad(loss)(variables["params"])
    out = tm(_t(past), _t(dest), z_e_0=_t(z0), eps=_t(eps), train=True, langevin_noise=False)
    (out[4] + out[3].sum()).backward()
    _grads_close(tm, j_grads, 1e-4)


def test_lbebm_noise_and_draws_come_from_the_generator(rng):
    torch.manual_seed(0)
    tm = tlb.LBEBMCVAE(K, K * S // 2).eval()
    past, dest = (rng.normal(size=(4, w)).astype(np.float32) for w in (K, 2))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tm(_t(past), _t(dest), train=True, generator=g)

    a, b, c = run(1), run(1), run(2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_lbebm_social_pooling_with_a_mask(rng):
    """With a mask the past features go through three social-pool rounds
    (the JAX module builds the non-local MLPs only then)."""
    n = 5
    jm = jlb.LBEBMCVAE(future_length=K * S // 2)
    past = rng.normal(size=(n, K)).astype(np.float32)
    z0 = rng.normal(size=(n, 16)).astype(np.float32)
    mask = np.ones((n, n), bool)
    mask[1, 3:] = mask[3:, 1] = False
    variables = jm.init({"params": jax.random.PRNGKey(2), "latent": jax.random.PRNGKey(3)},
                        past, mask=mask, z_e_0=z0, train=False, langevin_noise=False)
    tm = _load(tlb.LBEBMCVAE(K, K * S // 2), variables,
               missing_prefixes=("encoder_latent", "encoder_dest", "predictor"))
    want = jm.apply(variables, past, mask=mask, z_e_0=z0, train=False, langevin_noise=False)
    got = tm(_t(past), mask=_t(mask), z_e_0=_t(z0), train=False, langevin_noise=False)
    _close(got, want, 1e-4)


def test_replay_memory_ring_and_sample_are_jax_bitwise():
    ours, theirs = tlb.ReplayMemory(capacity=5), jlb.ReplayMemory(capacity=5)
    rows = np.random.default_rng(4).normal(size=(8, 1, 3)).astype(np.float32)
    for row in rows:
        ours.push(row)
        theirs.push(row)
    assert len(ours) == len(theirs) == 5 and ours.position == theirs.position == 3
    for a, b in zip(ours.memory, theirs.memory):
        np.testing.assert_array_equal(a, b)
    got = ours.sample(np.random.default_rng(7), n=4)
    want = theirs.sample(np.random.default_rng(7), n=4)
    assert got.shape == (4, 3)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- Social-Implicit
def _implicit_inputs(rng, n=6):
    v = rng.normal(size=(1, 2, 8, n)).astype(np.float32)
    # inf-norms at t = 0 spread over zones 0, 1, 2 and 3
    v[0, :, 0, :] = np.asarray([[0.0, 0.005, 0.05, -0.5, 2.0, 0.03],
                                [0.001, -0.002, 0.03, 0.2, 1.5, 0.5]], np.float32)[:, :n]
    valid = np.ones(n, bool)
    valid[-1] = False
    return v, valid


def test_social_implicit_full_forward(rng):
    v, valid = _implicit_inputs(rng)
    noise = rng.normal(size=(3, 2)).astype(np.float32)
    jm = jimp.SocialImplicit()
    variables = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(0), v, valid, noise=noise)))
    draws = np.random.default_rng(1)
    params = {name: {**cell, **{w: draws.uniform(0.5, 1.5, size=(1,)).astype(np.float32)
                                for w in ("global_w", "local_w", "noise_w")}}
              for name, cell in variables["params"].items()}
    want = jm.apply({"params": params}, v, valid, noise=noise)
    tm = _load(timp.SocialImplicit(), {"params": params})
    with torch.no_grad():
        got = tm(_t(v), _t(valid), noise=_t(noise))
    assert got.shape == (3, 2, 12, 6)
    _close(got, want, 1e-5)
    assert float(got[..., -1].abs().max()) == 0.0            # the padded slot
    zones = timp.zones(_t(v))[0].numpy()
    assert set(zones[valid].tolist()) == {0, 1, 2, 3}
    g = torch.Generator().manual_seed(3)
    drawn = tm(_t(v), _t(valid), ksteps=4, generator=g)
    assert drawn.shape == (4, 2, 12, 6) and torch.isfinite(drawn).all()


def _light_before(model, v, valid):
    """SocialImplicitLight's forward as it was written before the noise
    term and the shared routing: the reference for 'unchanged'."""
    b, c, t, n = v.shape
    zone = timp.zones(v)
    out = v.new_zeros((b, *model.out_shape, n))
    for i in range(len(timp.BINS)):
        sel = (zone == i) & valid
        order, inverse = timp.compaction(sel)
        sel_sorted = torch.gather(sel, 1, order)
        v_i = torch.gather(v, 3, order[:, None, None, :].expand(b, c, t, n))
        out_i = getattr(model, f"cell_{i}")(zero_invalid(v_i, sel_sorted, 3), sel_sorted)
        out_i = torch.gather(out_i, 3, inverse[:, None, None, :].expand(out.shape))
        out = torch.where(sel[:, None, None, :], out_i, out)
    return out


def test_social_implicit_light_is_unchanged_bitwise(rng):
    torch.manual_seed(0)
    model = timp.SocialImplicitLight(1, S, K + 2, K).eval()
    with torch.no_grad():
        for i in range(4):
            cell = getattr(model, f"cell_{i}")
            for w in (cell.global_w, cell.local_w, cell.noise_w):
                w.uniform_(0.5, 1.5)
    v = torch.from_numpy(rng.normal(size=(3, 1, K + 2, 6)).astype(np.float32))
    v[:, 0, 0, :] = torch.tensor([0.0, 0.005, 0.05, -0.5, 2.0, 0.03])
    valid = torch.ones(3, 6, dtype=torch.bool)
    valid[1, 4:] = False
    assert torch.equal(model(v, valid), _light_before(model, v, valid))


# --------------------------------------------------------------- Graph-TERN
def test_prune_select_picks_the_jax_rounds(rng):
    sets = rng.normal(size=(7, 6, 5, 2)).astype(np.float32)
    sets[4] = sets[1]                                        # a tie: the first round wins
    got = tgt.prune_select(_t(sets)).numpy()
    want = np.asarray(jgt.prune_select(jnp.asarray(sets)))
    np.testing.assert_array_equal(got, want)
    diff = sets[:, None] - sets[:, :, None]
    nearest = np.sort(np.sqrt((diff ** 2).sum(-1)), axis=2)[:, :, 1].sum(1)   # (R, V)
    picked = [int(np.flatnonzero((sets[:, :, v] == got[None, :, v]).all((1, 2)))[0])
              for v in range(5)]
    assert picked == np.argmax(nearest, axis=0).tolist()


def _collapsing_heads(rng, m, v, ways, top_logit=15.0):
    v_init = rng.normal(size=(1, m, v, 5 * ways)).astype(np.float32)
    tops = []
    for w in range(ways):
        v_init[..., 5 * w + 2:5 * w + 4] = -20.0            # std ~ 2e-9
        logits = np.full((m, v), -5.0, np.float32)
        top = rng.integers(0, m, size=v)
        logits[top, np.arange(v)] = top_logit
        v_init[0, :, :, 5 * w + 4] = logits
        tops.append(top)
    means = np.mean([v_init[0, tops[w], np.arange(v), 5 * w:5 * w + 2] for w in range(ways)],
                    axis=0)
    return v_init, means


def test_gmm_endpoint_sample_collapses_to_the_chosen_means(rng):
    v_init, means = _collapsing_heads(rng, 8, 5, 3)
    got = tgt.gmm_endpoint_sample(_t(v_init), 6, 3, generator=torch.Generator().manual_seed(0))
    want = np.asarray(jgt.gmm_endpoint_sample(jax.random.PRNGKey(0), jnp.asarray(v_init), 6, 3))
    assert got.shape == (6, 5, 2) and not got.requires_grad
    _close(got, np.broadcast_to(means, got.shape), 1e-5)
    _close(got, want, 1e-5)


def test_gmm_pruning_keeps_the_highest_pi_component(rng):
    m, v, ways = 8, 4, 3
    v_init = rng.normal(size=(1, m, v, 5 * ways)).astype(np.float32)
    tops = []
    for w in range(ways):
        v_init[..., 5 * w + 2:5 * w + 4] = -20.0
        logits = rng.normal(size=(m, v)).astype(np.float32)
        v_init[0, :, :, 5 * w + 4] = logits
        tops.append(np.argmax(logits, axis=0))
    expect = np.mean([v_init[0, tops[w], np.arange(v), 5 * w:5 * w + 2] for w in range(ways)],
                     axis=0)
    g = torch.Generator().manual_seed(1)
    got = tgt.gmm_endpoint_sample(_t(v_init), 16, ways, prune=m - 1, generator=g)
    _close(got, np.broadcast_to(expect, got.shape), 1e-5)
    free = tgt.gmm_endpoint_sample(_t(v_init), 16, ways, generator=g)
    assert float((free - torch.from_numpy(expect)).abs().max()) > 1e-3


def test_guided_endpoint_sample_with_injected_uniforms(rng):
    n_smpl, v = 6, 5
    dest = rng.normal(size=(v, 2)).astype(np.float32)
    gamma = rng.uniform(0.1, 1.0, size=(v,)).astype(np.float32)
    eps_r = (rng.uniform(size=(n_smpl, v)) * gamma).astype(np.float32)
    eps_t = rng.uniform(size=(n_smpl, v)).astype(np.float32)
    want = jgt.guided_endpoint_sample(None, jnp.asarray(dest), jnp.asarray(gamma), n_smpl,
                                      eps_r=jnp.asarray(eps_r), eps_t=jnp.asarray(eps_t))
    got = tgt.guided_endpoint_sample(_t(dest), _t(gamma), n_smpl, eps_r=_t(eps_r),
                                     eps_t=_t(eps_t))
    _close(got, want, 1e-5)
    drawn = tgt.guided_endpoint_sample(_t(dest), _t(gamma), n_smpl,
                                       generator=torch.Generator().manual_seed(0))
    radius = torch.linalg.vector_norm(drawn - _t(dest), dim=-1)
    assert (radius <= _t(gamma) * (1 + 1e-6)).all()


def _graphtern(rng, n, n_smpl):
    obs = rng.normal(size=(1, 8, n, 2)).astype(np.float32)
    rel = np.concatenate([np.zeros_like(obs[:, :1]), obs[:, 1:] - obs[:, :-1]], axis=1)
    s_obs = np.stack([obs, rel], axis=1)                      # (1, 2, 8, n, 2)
    valid = np.ones(n, bool)
    valid[-1] = False
    s_obs[..., -1, :] = 0.0
    endpoint = rng.normal(size=(n_smpl, n, 2)).astype(np.float32)
    want, variables = jgt.GraphTERNFull(n_smpl=n_smpl).init_with_output(
        jax.random.PRNGKey(0), s_obs, valid, endpoint_set=endpoint, train=False)
    tm = _load(tgt.GraphTERNFull(n_smpl=n_smpl), variables)
    return want, tm, (s_obs, valid, endpoint)


def test_graphtern_full_forward_with_an_injected_endpoint_set(rng):
    want, tm, (s_obs, valid, endpoint) = _graphtern(rng, 6, 4)
    with torch.no_grad():
        got = tm(_t(s_obs), _t(valid), endpoint_set=_t(endpoint))
    for g, w, name in zip(got, want, ("v_init", "v_pred", "v_refi")):
        _close(g, w, 1e-4, name)
    assert tuple(got[0].shape) == (1, 8, 6, 15) and tuple(got[2].shape) == (4, 12, 6, 2)


def test_graphtern_full_pruning_selects_one_of_the_rounds_drawn(rng):
    torch.manual_seed(0)
    tm = tgt.GraphTERNFull(n_smpl=6).eval()
    obs = rng.normal(size=(1, 8, 5, 2)).astype(np.float32)
    rel = np.concatenate([np.zeros_like(obs[:, :1]), obs[:, 1:] - obs[:, :-1]], axis=1)
    s_obs, valid = np.stack([obs, rel], axis=1), np.ones(5, bool)
    with torch.no_grad():
        v_init, v_pred, v_refi = tm(_t(s_obs), _t(valid), pruning=2,
                                    generator=torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(3)
        rounds = torch.stack([tgt.gmm_endpoint_sample(v_init, 6, 3, prune=2, generator=g)
                              for _ in range(6)])
    assert tuple(v_refi.shape) == (6, 12, 5, 2) and torch.isfinite(v_refi).all()
    assert torch.equal(v_pred[:, 0], tgt.prune_select(rounds))
    for v in range(5):
        assert any(torch.equal(v_pred[:, 0, v], rounds[r, :, v]) for r in range(6))
