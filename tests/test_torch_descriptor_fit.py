"""Port vs JAX package: the flip augmentation (bitwise), the truncated-SVD
basis fit (<= 1e-5, same signs) and `calculate_parameters` (bases <= 1e-5;
the anchors come from other random draws and are held by shape and by the
inertia tests of test_torch_anchor.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.data import dataset as jdataset
from eigentrajectory_tpu.etspace import descriptor as jdesc
from eigentrajectory_tpu.etspace import facade as jfacade
from eigentrajectory_tpu_torch.data import dataset as tdataset
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.etspace import descriptor as tdesc
from eigentrajectory_tpu_torch.etspace import facade as tfacade

K, S = 6, 20
TOL = 1e-5


def _flat_split(seed, n_scenes=60):
    data = make_synthetic_data(n_scenes=n_scenes, max_peds=6, seed=seed)
    return data.obs_traj, data.pred_traj


@pytest.mark.parametrize("flip,reverse", [(True, True), (False, True), (False, False),
                                          (True, False)])
def test_augment_trajectory_bitwise(flip, reverse):
    obs, pred = _flat_split(0, n_scenes=5)
    want = jdataset.augment_trajectory(obs, pred, flip=flip, reverse=reverse)
    got = tdataset.augment_trajectory(obs, pred, flip=flip, reverse=reverse)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    # the flip branch short-circuits reverse: one doubling at most
    assert len(got[0]) == len(obs) * (2 if flip or reverse else 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_truncated_svd_matches_jax_with_the_same_signs(seed):
    rng = np.random.default_rng(seed)
    traj = np.cumsum(rng.normal(size=(200, 12, 2)), axis=1).astype(np.float32)
    want = jdesc.truncated_svd(jnp.asarray(traj), K)
    got = tdesc.truncated_svd(torch.from_numpy(traj), K)
    for g, w, shape in zip(got, want, ((24, K), (K,), (200, K))):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    u = got[0].numpy()
    np.testing.assert_array_equal(np.sign(u), np.sign(np.asarray(want[0])))
    # each column's largest-magnitude entry is positive, and U is orthonormal
    assert (u[np.abs(u).argmax(axis=0), np.arange(K)] > 0).all()
    np.testing.assert_allclose(u.T @ u, np.eye(K), atol=TOL)


def test_truncated_svd_sign_fix_flips_a_negative_column():
    """A rank-1 matrix whose left vector has its largest entry negative in
    LAPACK's answer or not: the fixed sign makes it positive either way, and
    U S V^T is unchanged by the joint flip."""
    left = np.array([0.1, -0.9, 0.2, 0.3], np.float32)
    right = np.arange(1.0, 6.0, dtype=np.float32)
    traj = (right[:, None] * left[None, :]).reshape(5, 2, 2)
    u, s, v = tdesc.truncated_svd(torch.from_numpy(traj), 1)
    assert u[:, 0].abs().argmax() == 1 and u[1, 0] > 0
    np.testing.assert_allclose((u * s) @ v.T, traj.reshape(5, 4).T, atol=TOL)


@pytest.mark.parametrize("norm_sca,eps", [(True, 1e-8), (False, 0.0)])
def test_fit_basis_matches_jax(norm_sca, eps):
    obs, pred = _flat_split(3)
    jb, jpred = jdesc.fit_basis(jnp.asarray(obs), jnp.asarray(pred), K, norm_sca, eps=eps)
    tb, tpred = tdesc.fit_basis(torch.from_numpy(obs), torch.from_numpy(pred), K, norm_sca,
                                eps=eps)
    np.testing.assert_allclose(tb.U_obs.numpy(), np.asarray(jb.U_obs), atol=TOL)
    np.testing.assert_allclose(tb.U_pred.numpy(), np.asarray(jb.U_pred), atol=TOL)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-4, rtol=TOL)
    assert tb.U_obs.shape == (16, K) and tb.U_pred.shape == (24, K)


def test_calculate_parameters_bases_match_jax_and_anchors_are_fitted():
    obs, pred = tdataset.augment_trajectory(*_flat_split(4))
    static_dist = 0.3
    jet = jfacade.calculate_parameters(jax.random.PRNGKey(0), obs, pred, K, S, static_dist)
    tet = tfacade.calculate_parameters(torch.Generator().manual_seed(0), obs, pred, K, S,
                                       static_dist)
    for branch in ("basis_m", "basis_s"):
        for g, w in zip(getattr(tet, branch), getattr(jet, branch)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    for g in (tet.anchor_m, tet.anchor_s):
        assert g.shape == (K, S) and g.dtype == torch.float32
        assert torch.isfinite(g).all()
    # the moving and the static branch are fitted on their own pedestrians
    assert not torch.allclose(tet.basis_m.U_pred, tet.basis_s.U_pred, atol=1e-3)
    # no tensor carries a gradient
    assert not any(x.requires_grad for x in (*tet.basis_m, *tet.basis_s, tet.anchor_m))
