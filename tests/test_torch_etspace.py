"""Port vs JAX package: normalizer, descriptor, anchor refine and the ET
facade over padded scene blocks (tolerance 1e-5: f32, same formulas,
different summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from eigentrajectory_tpu.etspace import anchor as janchor
from eigentrajectory_tpu.etspace import descriptor as jdesc
from eigentrajectory_tpu.etspace import facade as jfacade
from eigentrajectory_tpu.etspace import normalizer as jnorm
from eigentrajectory_tpu_torch.etspace import anchor as tanchor
from eigentrajectory_tpu_torch.etspace import descriptor as tdesc
from eigentrajectory_tpu_torch.etspace import facade as tfacade
from eigentrajectory_tpu_torch.etspace import normalizer as tnorm

TOL = dict(atol=1e-5, rtol=1e-5)
K, S = 6, 20


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), **(tol or TOL))


def _traj(rng, n=9, t=8):
    traj = np.cumsum(rng.normal(size=(n, t, 2)), axis=1).astype(np.float32)
    traj[0, -3:] = traj[0, -3]          # exactly static ped: scale guard
    traj[1] = 0.0                       # a padded slot
    return traj


def test_norm_params_and_round_trip():
    rng = np.random.default_rng(0)
    obs = _traj(rng)
    pred = np.cumsum(rng.normal(size=(9, 12, 2)), axis=1).astype(np.float32)
    jp = jnorm.compute_norm_params(jnp.asarray(obs), eps=1e-8)
    tp = tnorm.compute_norm_params(torch.from_numpy(obs), eps=1e-8)
    for a, b in zip(tp, jp):
        _close(a, b)
    for sca in (True, False):
        jn = jnorm.normalize(jnp.asarray(pred), jp, sca=sca)
        tn = tnorm.normalize(torch.from_numpy(pred), tp, sca=sca)
        _close(tn, jn, atol=1e-5, rtol=1e-4)
        _close(tnorm.denormalize(tn, tp, sca=sca), jnorm.denormalize(jn, jp, sca=sca),
               atol=1e-4, rtol=1e-5)


def test_project_reconstruct_refine():
    rng = np.random.default_rng(1)
    traj = rng.normal(size=(7, 12, 2)).astype(np.float32)
    evec = rng.normal(size=(24, K)).astype(np.float32)
    c = rng.normal(size=(K, 7, S)).astype(np.float32)
    anchor = rng.normal(size=(K, S)).astype(np.float32)
    _close(tdesc.project(torch.from_numpy(traj), torch.from_numpy(evec)),
           jdesc.project(jnp.asarray(traj), jnp.asarray(evec)))
    _close(tdesc.reconstruct_norm(torch.from_numpy(c), torch.from_numpy(evec)),
           jdesc.reconstruct_norm(jnp.asarray(c), jnp.asarray(evec)))
    obs = _traj(rng, n=7)
    jp = jnorm.compute_norm_params(jnp.asarray(obs), eps=1e-8)
    tp = tnorm.compute_norm_params(torch.from_numpy(obs), eps=1e-8)
    _close(tdesc.reconstruct(torch.from_numpy(c), torch.from_numpy(evec), tp, False),
           jdesc.reconstruct(jnp.asarray(c), jnp.asarray(evec), jp, False), atol=1e-4)
    _close(tanchor.refine(torch.from_numpy(anchor), torch.from_numpy(c)),
           janchor.refine(jnp.asarray(anchor), jnp.asarray(c)))


def test_moving_mask():
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(3, 10, 8, 2)).astype(np.float32)
    got = tfacade.moving_mask(torch.from_numpy(obs), 0.6).numpy()
    want = np.asarray(jax.vmap(lambda o: jfacade.moving_mask(o, 0.6))(jnp.asarray(obs)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def _et_params(rng):
    arrays = [rng.normal(size=shape).astype(np.float32) * 0.3
              for shape in ((16, K), (24, K), (16, K), (24, K), (K, S), (K, S))]
    j = jfacade.ETParams(jdesc.ETBasis(*map(jnp.asarray, arrays[0:2])),
                         jdesc.ETBasis(*map(jnp.asarray, arrays[2:4])),
                         jnp.asarray(arrays[4]), jnp.asarray(arrays[5]))
    t = tfacade.ETParams(tdesc.ETBasis(*map(torch.from_numpy, arrays[0:2])),
                         tdesc.ETBasis(*map(torch.from_numpy, arrays[2:4])),
                         torch.from_numpy(arrays[4]), torch.from_numpy(arrays[5]))
    return j, t


def _scene_block(rng, b=3, n=7):
    obs = np.cumsum(rng.normal(size=(b, n, 8, 2)) * 0.5, axis=2).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[0, 5:] = False
    valid[2, 3:] = False
    obs[~valid] = 0.0
    obs[1, 2, -3:] = obs[1, 2, -3]      # exactly static ped
    return obs, valid


W = np.linspace(-1.0, 1.0, S).astype(np.float32)


def _jax_predictor(c_obs, obs_ori, aux):     # one scene: (k, N), (2, N)
    return c_obs[:, :, None] * jnp.asarray(W) + obs_ori.sum(0)[None, :, None]


def _torch_predictor(c_obs, obs_ori, aux):   # a block: (B, k, N), (B, 2, N)
    return c_obs[..., None] * torch.from_numpy(W) + obs_ori.sum(1)[:, None, :, None]


def test_et_forward_coefficients_and_recon_match_vmapped_jax():
    rng = np.random.default_rng(3)
    jet, tet = _et_params(rng)
    obs, valid = _scene_block(rng)
    for coef in (True, False):
        want = jax.vmap(lambda o, v: jfacade.et_forward(
            jet, _jax_predictor, o, v, 0.3, return_coefficients=coef))(
                jnp.asarray(obs), jnp.asarray(valid))
        got = tfacade.et_forward(tet, _torch_predictor, torch.from_numpy(obs),
                                 torch.from_numpy(valid), 0.3,
                                 return_coefficients=coef)
        assert set(got) == set(want)
        for key in got:                      # padded slots included
            if key == "moving_mask":
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
            else:
                scale = max(1.0, float(np.abs(np.asarray(want[key])).max()))
                _close(got[key], want[key], atol=1e-5 * scale, rtol=1e-5)


def test_losses_match_vmapped_jax_per_scene():
    """The three losses are per-scene masked means over the valid pedestrians
    (<= 1e-5 against the JAX facade under vmap); a scene with no valid
    pedestrian divides by 1 and gives 0."""
    rng = np.random.default_rng(5)
    jet, tet = _et_params(rng)
    obs, valid = _scene_block(rng, b=4)
    valid[3] = False
    obs[3] = 0.0
    pred = (obs[:, :, -1:, :] + np.cumsum(rng.normal(size=(4, 7, 12, 2)) * 0.5, axis=2)
            ).astype(np.float32)
    pred[~valid] = 0.0
    want = jax.vmap(lambda o, g, v: jfacade.et_forward(
        jet, _jax_predictor, o, v, 0.3, pred_traj=g))(
            jnp.asarray(obs), jnp.asarray(pred), jnp.asarray(valid))
    got = tfacade.et_forward(tet, _torch_predictor, torch.from_numpy(obs),
                             torch.from_numpy(valid), 0.3, pred_traj=torch.from_numpy(pred))
    assert set(got) == set(want)
    for key in ("loss_eigentraj", "loss_euclidean_ade", "loss_euclidean_fde"):
        assert got[key].shape == (4,)
        _close(got[key], want[key], atol=1e-5, rtol=1e-5)
        assert got[key][3] == 0 and (got[key][:3] > 0).all()
    _close(got["recon_traj"], want["recon_traj"], atol=1e-4, rtol=1e-5)


def test_loss_gradient_flows_through_the_predictor_output_alone():
    rng = np.random.default_rng(6)
    _, tet = _et_params(rng)
    tet = tfacade.ETParams(*(type(x)(*(t.requires_grad_() for t in x)) if isinstance(x, tuple)
                             else x.requires_grad_() for x in tet))
    obs, valid = _scene_block(rng)
    pred = np.cumsum(rng.normal(size=(3, 7, 12, 2)), axis=2).astype(np.float32)
    obs_t = torch.from_numpy(obs).requires_grad_()
    scale = torch.ones((), requires_grad=True)
    seen = {}

    def predictor(c_obs, obs_ori, aux):
        seen["c_obs"] = c_obs.requires_grad
        return _torch_predictor(c_obs, obs_ori.detach(), aux) * scale

    out = tfacade.et_forward(tet, predictor, obs_t, torch.from_numpy(valid), 0.3,
                             pred_traj=torch.from_numpy(pred))
    total = sum(out[k].sum() for k in out if k.startswith("loss_"))
    grads = torch.autograd.grad(total, [scale, tet.anchor_m, tet.anchor_s, tet.basis_m.U_obs,
                                        tet.basis_s.U_obs], allow_unused=True)
    assert seen["c_obs"] is False                 # C_obs reaches the predictor detached
    assert grads[0] is not None and grads[0].abs() > 0
    assert all(g is None for g in grads[1:])      # anchors and obs bases: no gradient
