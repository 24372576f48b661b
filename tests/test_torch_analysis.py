"""Port vs JAX package: `batch_kmeans_fit`, `metrics.compute_all` and
`col_scene_masked`, `utils.misc.print_arguments`, `analysis.curves`,
`analysis.descriptor_evaluation` on seeded split files, and the plots of
`analysis.visualization` (which need matplotlib and sklearn)."""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu import metrics as jmetrics
from eigentrajectory_tpu.analysis import curves as jcurves
from eigentrajectory_tpu.analysis import descriptor_evaluation as jdesc
from eigentrajectory_tpu.data.dataset import load_trajectory_data as jax_load
from eigentrajectory_tpu.etspace import anchor as janchor
from eigentrajectory_tpu.utils.misc import print_arguments as jprint
from eigentrajectory_tpu_torch import metrics as tmetrics
from eigentrajectory_tpu_torch.analysis import curves as tcurves
from eigentrajectory_tpu_torch.analysis import descriptor_evaluation as tdesc
from eigentrajectory_tpu_torch.etspace import anchor as tanchor
from eigentrajectory_tpu_torch.utils import print_arguments as tprint
from tests.test_torch_native_loader import write_split


# ------------------------------------------------------------ batch k-means
def _inertia(x, centers):
    return float(((x[:, None] - centers[None]) ** 2).sum(-1).min(1).sum())


def test_batch_kmeans_fit_inertia_within_2_percent_of_jax():
    rng = np.random.default_rng(11)
    b, n_clusters = 3, 5
    true = rng.normal(size=(b, n_clusters, 4)) * 6
    x = (true[:, rng.integers(0, n_clusters, 300)] + rng.normal(size=(b, 300, 4)) * 0.5)
    x = x.astype(np.float32)
    ours = tanchor.batch_kmeans_fit(torch.Generator().manual_seed(0), torch.from_numpy(x),
                                    n_clusters).numpy()
    theirs = np.asarray(janchor.batch_kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 n_clusters))
    assert ours.shape == theirs.shape == (b, n_clusters, 4)
    for i in range(b):
        mine, jax_ = _inertia(x[i], ours[i]), _inertia(x[i], theirs[i])
        assert abs(mine - jax_) <= 0.02 * jax_, (i, mine, jax_)


def test_batch_kmeans_fit_is_one_seeded_fit_per_problem():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 50, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    got = tanchor.batch_kmeans_fit(gen, x, 4, n_init=2)
    seeds = torch.randint(2 ** 62, (2,), generator=torch.Generator().manual_seed(4))
    for i in range(2):
        want = tanchor.kmeans_fit(torch.Generator().manual_seed(int(seeds[i])), x[i], 4, n_init=2)
        assert torch.equal(got[i], want)
    again = tanchor.batch_kmeans_fit(torch.Generator().manual_seed(4), x, 4, n_init=2)
    assert torch.equal(got, again)


# ------------------------------------------------------------------ metrics
def _metric_case(rng, n=7, s=5, t=12):
    # pedestrians 10 apart, each wandering by ~0.3, but for two close pairs
    pred = (rng.normal(size=(s, n, t, 2)) * 0.3 + 10.0 * np.arange(n)[:, None, None])
    pred = pred.astype(np.float32)
    pred[:, 1] = pred[:, 0] + 0.05                # a close pair in every sample
    pred[:2, 3] = pred[:2, 4] + 0.1               # in two samples only
    gt = rng.normal(size=(n, t, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-1] = False
    scene = np.array([0, 0, 0, 1, 1, 2, 2])
    return pred, gt, valid, scene[:, None] == scene[None, :]


def test_compute_all_equals_jax(rng):
    pred, gt, valid, _ = _metric_case(rng)
    got = tmetrics.compute_all(torch.from_numpy(pred), torch.from_numpy(gt),
                               torch.from_numpy(valid))
    want = jmetrics.compute_all(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid))
    for g, w, name in zip(got, want, ("ade", "fde", "tcc", "col")):
        if name == "col":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    assert got[3].numpy()[:2].tolist() == [100.0, 100.0]


def test_col_scene_masked_equals_jax(rng):
    pred, _, valid, same = _metric_case(rng)
    same[0, 1] = same[1, 0] = False               # the close pair in two scenes: no collision
    got = tmetrics.col_scene_masked(torch.from_numpy(pred), torch.from_numpy(valid),
                                    torch.from_numpy(same)).numpy()
    want = np.asarray(jmetrics.col_scene_masked(jnp.asarray(pred), jnp.asarray(valid),
                                                jnp.asarray(same)))
    np.testing.assert_array_equal(got, want)
    assert got[3] == got[4] == 40.0 and got[0] == 0.0
    # every pair in one scene: COL itself
    everyone = torch.ones(7, 7, dtype=torch.bool)
    np.testing.assert_array_equal(
        tmetrics.col_scene_masked(torch.from_numpy(pred), torch.from_numpy(valid),
                                  everyone).numpy(),
        tmetrics.col(torch.from_numpy(pred), torch.from_numpy(valid)).numpy())


# --------------------------------------------------------- print_arguments
@pytest.mark.parametrize("args", [
    {"alpha": 1, "beta": "two", "gamma": [3]},
    {f"option_{i}": "x" * (i * 3) for i in range(12)},
    argparse.Namespace(cfg="configs/a.json", tag="T", epochs=8, test=False),
])
def test_print_arguments_prints_what_jax_prints(capsys, args):
    jprint(args)
    want = capsys.readouterr().out
    tprint(args)
    assert capsys.readouterr().out == want
    tprint(args, length=30, sep="=", delim=", ")
    mine = capsys.readouterr().out
    jprint(args, length=30, sep="=", delim=", ")
    assert capsys.readouterr().out == mine


# ------------------------------------------------------------------- curves
def test_curve_bases_and_fits_equal_jax():
    for deg, step in [(2, 8), (3, 12), (5, 13)]:
        np.testing.assert_allclose(tcurves.bezier_basis(deg, step),
                                   jcurves.bezier_basis(deg, step), atol=1e-12)
    for cp, deg, step in [(3, 2, 8), (5, 3, 12), (4, 1, 13)]:
        np.testing.assert_allclose(tcurves.bspline_basis(cp, deg, step),
                                   jcurves.bspline_basis(cp, deg, step), atol=1e-12)
    np.testing.assert_allclose(tcurves.linear_basis(12), jcurves.linear_basis(12), atol=1e-12)
    traj = np.random.default_rng(0).normal(size=(20, 12, 2))
    basis = tcurves.bezier_basis(3, 12)
    np.testing.assert_allclose(tcurves.curve_fit_lstsq(traj, basis),
                               jcurves.curve_fit_lstsq(traj, basis), atol=1e-12)


# ----------------------------------------------------- descriptor evaluation
@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(21)
    for split in ("train", "test"):
        for i in range(2):
            write_split(root / "synthetic" / split, rng, 120, 30, name=f"part{i}.txt")
    return str(root / "synthetic")


def test_eval_dataset_within_1e5_of_jax(split_dir, monkeypatch):
    # The JAX side reads the files through its Python loader (bitwise its
    # native one) and so never builds `native/libetloader.so` here.
    monkeypatch.setattr(jdesc, "load_trajectory_data",
                        lambda d, *a: jax_load(d, *a, use_native=False))
    want = jdesc.eval_dataset(split_dir)
    got = tdesc.eval_dataset(split_dir, device="cpu")
    assert len(got) == len(want) == 1 + 4 + 9 + 12
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if "error" not in k} == \
            {k: v for k, v in w.items() if "error" not in k}
        for key in ("obs_error", "pred_error"):
            assert abs(g[key] - w[key]) <= 1e-5, (g, w)
    svd = [r["pred_error"] for r in got if r["method"] == "svd"]
    assert svd == sorted(svd, reverse=True) and svd[-1] < 1e-4   # k = 12 of 24 dims


def test_descriptor_evaluation_cli(split_dir, tmp_path, capsys):
    out = tmp_path / "rows.json"
    tdesc.main(["--dataset_dir", os.path.dirname(split_dir), "--datasets", "synthetic",
                "--device", "cpu", "--json", str(out)])
    printed = capsys.readouterr().out
    assert printed.startswith("Scene: synthetic") and "svd" in printed
    with open(out) as f:
        rows = json.load(f)["synthetic"]
    assert len(rows) == 26 and rows[0]["method"] == "linear"


# ------------------------------------------------------------ visualization
def test_plot_fig3_writes_a_figure(split_dir, tmp_path):
    pytest.importorskip("matplotlib")
    from eigentrajectory_tpu_torch.analysis.visualization import plot_fig3

    out = plot_fig3(split_dir, str(tmp_path / "fig3.png"), k=4, device="cpu")
    assert os.path.getsize(out) > 1000


def test_plot_coeff_tsne_writes_a_figure(split_dir, tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    from eigentrajectory_tpu_torch.analysis.visualization import plot_coeff_tsne

    out = plot_coeff_tsne(split_dir, str(tmp_path / "tsne.png"), k=4, s=5, device="cpu")
    assert os.path.getsize(out) > 1000
