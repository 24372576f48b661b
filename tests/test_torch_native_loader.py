"""The port's native loader (`eigentrajectory_tpu_torch/data/native_loader.py`):
its output bitwise the port's Python loader's and the JAX package's
(`load_trajectory_data(use_native=False)`) on seeded split files in the
ETH-UCY text format; its library built into the port's `_build/` and never
into `native/libetloader.so`; a failed build raises; the trainer's own load
takes the native route."""
import os

import numpy as np
import pytest

from eigentrajectory_tpu.data.dataset import load_trajectory_data as jax_load
from eigentrajectory_tpu_torch.config import ExpConfig
from eigentrajectory_tpu_torch.data import dataset as tdataset
from eigentrajectory_tpu_torch.data import native_loader
from eigentrajectory_tpu_torch.ops import build as ops_build
from eigentrajectory_tpu_torch.train import ETTorchTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(REPO, "native", "libetloader.so")
FIELDS = ("obs_traj", "pred_traj", "non_linear_ped", "loss_mask", "num_peds_in_seq")


def write_split(directory, rng, n_frames=80, n_peds=15, name="synthetic.txt"):
    """One file of `frame ped x y` rows, tab-separated and sorted, in the
    ETH-UCY format: each pedestrian walks a straight line from a random
    start for a random stretch of consecutive frames (numbered in tens)."""
    rows = []
    for ped in range(n_peds):
        t0 = int(rng.integers(0, 30))
        length = int(rng.integers(10, n_frames - t0))
        x0, y0 = rng.normal(size=2) * 5
        vx, vy = rng.normal(size=2)
        for i in range(length):
            f = (t0 + i) * 10
            rows.append((f, ped + 1, x0 + vx * i * 0.4, y0 + vy * i * 0.4))
    rows.sort()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, name), "w") as f:
        for r in rows:
            f.write("\t".join(str(v) for v in r) + "\n")
    return str(directory)


def assert_same_data(got, want):
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.seq_start_end == want.seq_start_end


def test_writer_emits_the_eth_ucy_format(tmp_path):
    path = os.path.join(write_split(tmp_path / "s", np.random.default_rng(3)), "synthetic.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    assert all(len(line.split("\t")) == 4 for line in lines)
    rows = np.loadtxt(path)
    assert [tuple(r) for r in rows] == sorted(tuple(r) for r in rows)
    assert (rows[:, 0] % 10 == 0).all()
    assert set(rows[:, 1].astype(int)) == set(range(1, 16))
    for ped in range(1, 16):
        frames = rows[rows[:, 1] == ped, 0]
        assert len(frames) >= 10 and (np.diff(frames) == 10).all()


@pytest.mark.parametrize("n_frames,n_peds,n_files", [(80, 15, 1), (120, 25, 1), (90, 20, 3)])
def test_native_load_is_bitwise_the_python_and_jax_loaders(tmp_path, n_frames, n_peds,
                                                           n_files):
    rng = np.random.default_rng(n_frames + n_peds)
    for i in range(n_files):
        write_split(tmp_path / "split", rng, n_frames, n_peds, name=f"part{i}.txt")
    data_dir = str(tmp_path / "split")
    native = native_loader.load_trajectory_data_native(data_dir)
    assert native.num_scenes > 10
    assert_same_data(tdataset.load_trajectory_data(data_dir), native)   # the default route
    assert_same_data(native, tdataset.load_trajectory_data(data_dir, use_native=False))
    assert_same_data(native, jax_load(data_dir, use_native=False))


def test_other_window_settings_match(tmp_path):
    data_dir = write_split(tmp_path / "split", np.random.default_rng(9), 120, 25)
    kw = dict(obs_len=6, pred_len=9, skip=2, threshold=0.5, min_ped=2)
    assert_same_data(tdataset.load_trajectory_data(data_dir, **kw),
                     jax_load(data_dir, use_native=False, **kw))


def test_library_is_built_into_the_port_build_dir_only(tmp_path, monkeypatch):
    """A fresh build writes `_build/libetloader-<hash>.so` and leaves the
    JAX package's `native/libetloader.so` alone."""
    before = os.stat(JAX_LIB) if os.path.exists(JAX_LIB) else None
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "_build"))
    outs = []

    def spy(command, out, what):
        outs.append(out)
        return ops_build.compile_library(command, out, what)

    monkeypatch.setattr(native_loader, "compile_library", spy)
    monkeypatch.setattr(native_loader, "_lib", None)
    assert native_loader.native_available()
    path = native_loader.library_path()
    assert outs == [path] and os.path.dirname(path) == str(tmp_path / "_build")
    name = os.path.basename(path)
    assert name.startswith("libetloader-") and name.endswith(".so") and len(name) == 31
    assert sorted(os.listdir(tmp_path / "_build")) == [name[:-3] + ".log", name]
    data_dir = write_split(tmp_path / "split", np.random.default_rng(1))
    assert_same_data(native_loader.load_trajectory_data_native(data_dir),
                     tdataset.load_trajectory_data(data_dir, use_native=False))
    native_loader.build()                                # built already: no second compile
    assert outs == [path]
    if before is not None:
        after = os.stat(JAX_LIB)
        assert (after.st_mtime_ns, after.st_size) == (before.st_mtime_ns, before.st_size)
    # the port's own build directory, by default
    assert os.path.dirname(native_loader.SOURCE) == os.path.join(REPO, "native")
    assert ops_build.BUILD_DIR == os.path.join(REPO, "eigentrajectory_tpu_torch", "_build")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "_build"))
    broken = tmp_path / "etloader.cpp"
    with open(native_loader.SOURCE) as f:
        broken.write_text(f.read() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on etloader.cpp(.|\n)*error"):
        native_loader.build(str(broken))
    assert os.listdir(tmp_path / "_build") == []           # no half-written library
    # a library's name changes with its source
    assert native_loader.library_path(str(broken)) != native_loader.library_path()


def test_trainer_loads_split_files_natively(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    for split in ("train", "val", "test"):
        write_split(tmp_path / "ds" / "hotel" / split, rng, 90, 18)
    calls = []
    native = native_loader.load_trajectory_data_native

    def spy(*args, **kw):
        calls.append(args[0])
        return native(*args, **kw)

    monkeypatch.setattr(native_loader, "load_trajectory_data_native", spy)
    cfg = ExpConfig(baseline="stgcnn", dataset="hotel", dataset_dir=str(tmp_path / "ds"),
                    checkpoint_dir=str(tmp_path / "ckpt"), batch_size=4)
    tr = ETTorchTrainer(cfg, tag="native", device="cpu")
    assert [os.path.basename(c) for c in calls] == ["train", "val", "test"]
    for split, data in zip(("train", "val", "test"), (tr.data_train, tr.data_val, tr.data_test)):
        assert_same_data(data, jax_load(str(tmp_path / "ds" / "hotel" / split),
                                        use_native=False))
