"""Port vs JAX package: configuration loading and the data layer (bitwise)."""
import dataclasses
import glob
import os

import numpy as np
import pytest

from eigentrajectory_tpu import config as jcfg
from eigentrajectory_tpu.data import batching as jbatching
from eigentrajectory_tpu.data import dataset as jdataset
from eigentrajectory_tpu.data import synthetic as jsynthetic
from eigentrajectory_tpu_torch import config as tcfg
from eigentrajectory_tpu_torch.data import batching as tbatching
from eigentrajectory_tpu_torch.data import dataset as tdataset
from eigentrajectory_tpu_torch.data import synthetic as tsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "eigentrajectory-*.json")))


def _assert_data_equal(a, b):
    for f in ("obs_traj", "pred_traj", "non_linear_ped", "loss_mask", "num_peds_in_seq"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.seq_start_end == b.seq_start_end


def test_config_fields_match():
    assert tcfg.STATIC_DIST == jcfg.STATIC_DIST
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.ExpConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.ExpConfig)]
    assert tf == jf


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_to_equal_fields(path):
    j = jcfg.load_config(path, checkpoint_dir="./ckpt", n_max_peds=57)
    t = tcfg.load_config(path, checkpoint_dir="./ckpt", n_max_peds=57)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_resolve_dataset_dir_matches(tmp_path):
    (tmp_path / "hotel").mkdir()
    for name in ("hotel", "missing"):
        assert (tcfg.resolve_dataset_dir(str(tmp_path), name)
                == jcfg.resolve_dataset_dir(str(tmp_path), name))


def test_synthetic_data_bitwise():
    for seed in (0, 3):
        _assert_data_equal(tsynthetic.make_synthetic_data(9, 7, seed=seed),
                           jsynthetic.make_synthetic_data(9, 7, seed=seed))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_scene_batcher_bitwise(shuffle, drop_last):
    data = jsynthetic.make_synthetic_data(11, 6, seed=1)
    jb = list(jbatching.SceneBatcher(data, 4, shuffle, n_max=8, drop_last=drop_last, seed=5))
    tb = list(tbatching.SceneBatcher(data, 4, shuffle, n_max=8, drop_last=drop_last, seed=5))
    assert len(jb) == len(tb) == len(tbatching.SceneBatcher(data, 4, shuffle, 8, drop_last))
    for a, b in zip(jb, tb):
        for f in ("obs", "pred", "ped_valid", "scene_valid", "non_linear"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_pad_scenes_bitwise():
    data = jsynthetic.make_synthetic_data(6, 5, seed=2)
    a = jbatching.pad_scenes(data, [4, 0, 2], 7, 5)
    b = tbatching.pad_scenes(data, [4, 0, 2], 7, 5)
    for f in ("obs", "pred", "ped_valid", "scene_valid", "non_linear"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _write_split(root, rng):
    """Two tab-separated `frame ped x y` files with peds entering/leaving."""
    for fi in range(2):
        rows = []
        for ped in range(7):
            start = int(rng.integers(0, 15))
            length = int(rng.integers(12, 35))
            xy = rng.normal(size=2) * 3
            vel = rng.normal(size=2) * 0.3
            for f in range(start, start + length):
                xy = xy + vel + 0.05 * rng.normal(size=2)
                rows.append((f * 10, ped + 100 * fi, xy[0], xy[1]))
        rows.sort()
        with open(os.path.join(root, f"scene_{fi}.txt"), "w") as fp:
            for r in rows:
                fp.write(f"{r[0]:.1f}\t{r[1]:.1f}\t{r[2]:.5f}\t{r[3]:.5f}\n")


def test_load_trajectory_data_bitwise(tmp_path):
    _write_split(str(tmp_path), np.random.default_rng(7))
    j = jdataset.load_trajectory_data(str(tmp_path), use_native=False)
    t = tdataset.load_trajectory_data(str(tmp_path))
    assert t.num_scenes > 3
    _assert_data_equal(t, j)
    assert t.max_peds_per_scene == j.max_peds_per_scene
