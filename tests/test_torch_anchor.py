"""Port vs JAX package: k-means. `_lloyd` from injected centres agrees value
by value (<= 1e-5, same labels); a whole fit draws other random numbers than
`jax.random`, so it is held by its inertia (within 2% of the JAX fit's) and
by recovering well-separated blobs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.etspace import anchor as janchor
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.etspace import anchor as tanchor
from eigentrajectory_tpu_torch.etspace import descriptor as tdesc

TOL = 1e-5


def _blobs(rng, n_clusters=20, per=100, d=6, spread=0.1):
    centers = rng.normal(size=(n_clusters, d)) * 3
    pts = centers[:, None, :] + rng.normal(size=(n_clusters, per, d)) * spread
    return pts.reshape(-1, d).astype(np.float32), centers


def _inertia(x, centers):
    d2 = ((x[:, None] - np.asarray(centers)[None]) ** 2).sum(-1)
    return d2.min(axis=1).sum()


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_pairwise_sq_dist_matches_jax():
    rng = np.random.default_rng(0)
    x, c = rng.normal(size=(50, 6)).astype(np.float32), rng.normal(size=(7, 6)).astype(np.float32)
    got = tanchor._pairwise_sq_dist(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        janchor._pairwise_sq_dist(jnp.asarray(x), jnp.asarray(c))), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), ((x[:, None] - c[None]) ** 2).sum(-1), atol=1e-4)


@pytest.mark.parametrize("seed,spread", [(1, 0.1), (2, 1.0)])
def test_lloyd_from_injected_centres_matches_jax(seed, spread):
    rng = np.random.default_rng(seed)
    x, _ = _blobs(rng, n_clusters=8, per=60, spread=spread)
    c0 = x[rng.choice(len(x), 8, replace=False)]
    jc, ji = janchor._lloyd(jnp.asarray(x), jnp.asarray(c0), 300, 1e-6)
    tc, ti = tanchor._lloyd(torch.from_numpy(x), torch.from_numpy(c0), 300, 1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(ti), float(ji), rtol=TOL)
    np.testing.assert_array_equal(
        tanchor.kmeans_predict(tc, torch.from_numpy(x)).numpy(),
        np.asarray(janchor.kmeans_predict(jc, jnp.asarray(x))))


def test_lloyd_stops_at_max_iter_and_recomputes_the_inertia():
    x, _ = _blobs(np.random.default_rng(3), n_clusters=5, per=40, spread=1.0)
    c0 = x[:5]
    jc, ji = janchor._lloyd(jnp.asarray(x), jnp.asarray(c0), 2, 1e-6)
    tc, ti = tanchor._lloyd(torch.from_numpy(x), torch.from_numpy(c0), 2, 1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    # the inertia is that of the returned centres, not of the ones before
    np.testing.assert_allclose(float(ti), _inertia(x, tc.numpy()), rtol=1e-4)
    np.testing.assert_allclose(float(ti), float(ji), rtol=TOL)


def test_empty_cluster_keeps_its_centre_and_ties_go_to_the_lower_index():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 2)).astype(np.float32)
    far = np.array([[100.0, 100.0]], np.float32)
    dup = x[:1]
    c0 = np.concatenate([dup, dup, far])          # two equal centres and an empty one
    for max_iter in (1, 300):
        tc, _ = tanchor._lloyd(torch.from_numpy(x), torch.from_numpy(c0), max_iter, 1e-6)
        jc, _ = janchor._lloyd(jnp.asarray(x), jnp.asarray(c0), max_iter, 1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
        np.testing.assert_array_equal(tc[2].numpy(), far[0])   # empty: unchanged
    tc, _ = tanchor._lloyd(torch.from_numpy(x), torch.from_numpy(c0), 1, 1e-6)
    np.testing.assert_array_equal(tc[1].numpy(), dup[0])       # lost every tie: unchanged
    np.testing.assert_allclose(tc[0].numpy(), x.mean(0), atol=TOL)
    labels = tanchor.kmeans_predict(torch.from_numpy(c0), torch.from_numpy(x))
    assert (labels == 0).all()


def test_kmeans_fit_recovers_well_separated_blobs():
    x, true_centers = _blobs(np.random.default_rng(7))
    centers = tanchor.kmeans_fit(_gen(), torch.from_numpy(x), 20).numpy()
    assert centers.shape == (20, 6)
    d = np.linalg.norm(true_centers[:, None] - centers[None], axis=-1)
    assert d.min(axis=1).max() < 0.5


def test_kmeans_fit_inertia_within_2_percent_of_jax_on_blobs():
    x, _ = _blobs(np.random.default_rng(42), spread=1.0)
    theirs = _inertia(x, janchor.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x), 20))
    ours = _inertia(x, tanchor.kmeans_fit(_gen(), torch.from_numpy(x), 20).numpy())
    assert abs(ours - theirs) <= 0.02 * theirs, (ours, theirs)


def test_generate_anchors_inertia_within_2_percent_of_jax_on_coefficients():
    """Projected coefficients have no separated clusters, and one fit's
    inertia moves by about 2.5% with its seed in either package, so the
    medians over five seeds are compared."""
    data = make_synthetic_data(n_scenes=150, max_peds=6, seed=5)
    obs, pred = torch.from_numpy(data.obs_traj), torch.from_numpy(data.pred_traj)
    basis, pred_norm = tdesc.fit_basis(obs, pred, 6, norm_sca=False)
    coef = (pred_norm.flatten(1) @ basis.U_pred).numpy()
    ours, theirs = [], []
    for seed in range(5):
        got = tanchor.generate_anchors(_gen(seed), pred_norm, basis.U_pred, 20)
        want = janchor.generate_anchors(jax.random.PRNGKey(seed), jnp.asarray(pred_norm.numpy()),
                                        jnp.asarray(basis.U_pred.numpy()), 20)
        assert got.shape == (6, 20) and got.dtype == torch.float32
        ours.append(_inertia(coef, got.numpy().T))
        theirs.append(_inertia(coef, np.asarray(want).T))
    ours, theirs = np.median(ours), np.median(theirs)
    assert abs(ours - theirs) <= 0.02 * theirs, (ours, theirs)


def test_kmeans_fit_takes_the_restart_of_least_inertia():
    x, _ = _blobs(np.random.default_rng(8), n_clusters=6, per=50, spread=1.0)
    xt = torch.from_numpy(x)
    best = tanchor.kmeans_fit(_gen(3), xt, 6, n_init=5)
    g = _gen(3)
    runs = [tanchor._lloyd(xt, tanchor._kmeanspp_init(g, xt, 6), 300, 1e-6) for _ in range(5)]
    inertias = [float(i) for _, i in runs]
    np.testing.assert_array_equal(best.numpy(), runs[int(np.argmin(inertias))][0].numpy())


def test_draws_come_from_the_generator_alone():
    x = torch.from_numpy(_blobs(np.random.default_rng(9), n_clusters=5, per=30)[0])
    a = tanchor.kmeans_fit(_gen(1), x, 5, n_init=2)
    torch.manual_seed(123)                       # the global stream plays no part
    b = tanchor.kmeans_fit(_gen(1), x, 5, n_init=2)
    assert torch.equal(a, b)
    g = _gen(1)
    first = tanchor._kmeanspp_init(g, x, 5)
    second = tanchor._kmeanspp_init(g, x, 5)     # the generator moves on
    assert not torch.equal(first, second)


def test_kmeanspp_init_draws_distinct_points_and_is_uniform_on_duplicates():
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(12, 3)).astype(np.float32))
    for seed in range(20):
        c = tanchor._kmeanspp_init(_gen(seed), x, 12)
        # a chosen point has D^2 = 0 and is never drawn again
        assert len({tuple(row) for row in c.tolist()}) == 12
    same = torch.ones(30, 3)
    assert torch.equal(tanchor._kmeanspp_init(_gen(0), same, 4), torch.ones(4, 3))
