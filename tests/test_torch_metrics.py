"""Port vs JAX package: ADE/FDE/TCC/COL with a leading scene axis, including
a deliberate FDE tie between samples and a constant-GT pedestrian
(tolerance 1e-5: f32, same formulas, different summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from eigentrajectory_tpu import metrics as jm
from eigentrajectory_tpu_torch import metrics as tm

B, S, N, T = 2, 20, 7, 12


def _case(seed=0):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(size=(B, N, T, 2)) * 0.3, axis=2).astype(np.float32)
    pred = (gt[:, None] + rng.normal(size=(B, S, N, T, 2)) * 0.4).astype(np.float32)
    # Sample 9 ties sample 4 on the last step but differs before it, so only
    # the first of the two minima gives the JAX TCC.
    pred[:, 4, 0, -1] = gt[:, 0, -1]
    pred[:, 9, 0, -1] = gt[:, 0, -1]
    pred[:, 9, 0, :-1] = gt[:, 0, :-1] + 1.5 * rng.normal(size=(B, T - 1, 2))
    gt[:, 1] = 0.5                           # constant GT: TCC denominator 0
    # Two peds on near-identical paths collide in some samples.
    pred[:, :, 3] = pred[:, :, 2] + np.float32(0.15) * (
        rng.random(size=(B, S, 1, 1)) > 0.5)
    valid = np.ones((B, N), bool)
    valid[1, 5:] = False
    return pred, gt, valid


def test_ade_fde_tcc_match_jax():
    pred, gt, _ = _case()
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    for name in ("ade", "fde", "tcc"):
        want = jax.vmap(getattr(jm, name))(jnp.asarray(pred), jnp.asarray(gt))
        got = getattr(tm, name)(tp, tg)
        assert got.shape == (B, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    tcc = tm.tcc(tp, tg).numpy()
    assert np.all(tcc[:, 1] == 0.0)
    # The tie resolves to sample 4: its TCC is not sample 9's.
    t4 = tm.tcc(tp[:, 4:5], tg).numpy()[:, 0]
    t9 = tm.tcc(tp[:, 9:10], tg).numpy()[:, 0]
    np.testing.assert_allclose(tcc[:, 0], t4, atol=1e-6)
    assert np.all(np.abs(t4 - t9) > 1e-3)


def test_col_and_dense_window_match_jax():
    pred, _, valid = _case(1)
    want_w = jax.vmap(jm._dense_window)(jnp.asarray(pred))
    np.testing.assert_allclose(tm._dense_window(torch.from_numpy(pred)).numpy(),
                               np.asarray(want_w), atol=1e-5)
    want = jax.vmap(jm.col)(jnp.asarray(pred), jnp.asarray(valid))
    got = tm.col(torch.from_numpy(pred), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got[:, 2].min() > 0                # the collision case is exercised
    # Short trajectories: the window shrinks instead of failing.
    short = pred[..., :3, :]
    np.testing.assert_allclose(
        tm.col(torch.from_numpy(short), torch.from_numpy(valid)).numpy(),
        np.asarray(jax.vmap(jm.col)(jnp.asarray(short), jnp.asarray(valid))), atol=1e-5)


def test_average_meter_matches_jax():
    a, b = jm.AverageMeter(), tm.AverageMeter()
    for meter in (a, b):
        meter.extend(np.arange(5.0))
        meter.append(2.5)
    assert (b.mean(), b.sum(), len(b)) == (a.mean(), a.sum(), len(a))
