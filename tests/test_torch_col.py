"""The port's fused_col: on CPU tensors (its plain version, `metrics.col` on
the rows gathered out of the trajectories) against the JAX package's
`metrics.col` and `col_scene_masked`, on the block layout (S, B*N, T, 2)
and on the packed layout through a scene map; the wrapper's refusals; and on
the card the CUDA kernel against the plain version (within 1e-5: COL is a
count of samples, so the two agree but where a distance lies within
rounding of 0.2) and its launch once an eval step."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu import metrics as jm
from eigentrajectory_tpu_torch import metrics as M
from eigentrajectory_tpu_torch.config import load_config
from eigentrajectory_tpu_torch.data.batching import scene_gather
from eigentrajectory_tpu_torch.data.synthetic import make_synthetic_data
from eigentrajectory_tpu_torch.ops import col
from eigentrajectory_tpu_torch.train import ETTorchTrainer
from eigentrajectory_tpu_torch.train import trainer as trainer_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
S, T = 20, 12
TOL = dict(atol=1e-5, rtol=1e-5)


def _walkers(n, seed, spread=1.0):
    """(S, n, T, 2) float32 futures of n walkers that start within `spread`
    of each other, so that some pairs pass within 0.2 in some samples."""
    rng = np.random.default_rng(seed)
    start = rng.random(size=(1, n, 1, 2)) * spread
    vel = rng.normal(size=(1, n, 1, 2)) * 0.2
    noise = 0.05 * np.cumsum(rng.normal(size=(S, n, T, 2)), axis=2)
    return (start + vel * np.arange(T)[None, None, :, None] + noise).astype(np.float32)


def _block(rows, slots, sizes, seed):
    """The block layout: recon (S, rows*slots, T, 2) with each row's first
    sizes[r] slots valid, valid (rows, slots); padded slots hold walkers too."""
    recon = _walkers(rows * slots, seed).reshape(S, rows, slots, T, 2)
    for r in range(rows):                  # a row's walkers share a neighbourhood
        recon[:, r] += np.float32(10.0 * r)
    valid = np.arange(slots)[None, :] < np.asarray(sizes)[:, None]
    return recon.reshape(S, rows * slots, T, 2), valid


def _packed(sizes, seed, pad=3):
    """The packed layout: recon (S, P, T, 2) of scenes of `sizes` walkers,
    their slots interleaved, `pad` padded slots at the end; scene_ids (P,)."""
    p = sum(sizes) + pad
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)])
    ids = np.concatenate([rng.permutation(ids), np.full(pad, -1)])
    recon = _walkers(p, seed)
    recon += np.where(ids >= 0, 10.0 * ids, -50.0).astype(np.float32)[None, :, None, None]
    return recon, ids


def _jax_col(recon, valid):
    """The JAX package's COL of the block layout, (rows, slots)."""
    rows, slots = valid.shape
    pred = recon.reshape(S, rows, slots, T, 2).transpose(1, 0, 2, 3, 4)
    return np.asarray(jax.vmap(jm.col)(jnp.asarray(pred), jnp.asarray(valid)))


def _edge_case(name):
    """(recon, valid) of three cases, at the shape of the block tests (one
    compilation of the JAX reference serves them all)."""
    if name == "all_invalid_row":
        recon, valid = _block(6, 9, [4, 0, 5, 9, 2, 3], seed=7)
    elif name == "nan_sample":
        recon, valid = _block(6, 9, [3, 4, 2, 9, 5, 1], seed=8)
        # Slots 0 and 1 of row 0 walk together 0.1 apart in every sample but
        # sample 3, where slot 0's second position is NaN: its window is NaN
        # from there on, so its distances are; amin is NaN, no collision.
        recon[:, 1] = recon[:, 0] + np.float32(0.1)
        recon[:, 2] += np.float32(5.0)      # far from both
        recon[3, 0, 1] = np.nan
        recon[:, 8] = np.nan                # a padded slot: read by no pair
    else:
        # The near-identical pair of tests/test_torch_metrics.py::_case:
        # slot 3 is slot 2 shifted by 0.15 (0.21 away) or not at all.
        recon, valid = _block(6, 9, [7, 5, 9, 2, 3, 4], seed=9)
        rng = np.random.default_rng(1)
        recon[:, 3] = recon[:, 2] + np.float32(0.15) * (rng.random(size=(S, 1, 1)) > 0.5)
    return recon, valid


def _hold_edge_case(name, got):
    if name == "all_invalid_row":
        assert np.all(got[1] == 0.0)
    elif name == "nan_sample":
        assert got[0, :2] == pytest.approx([100.0 * (S - 1) / S] * 2, abs=1e-5)
    else:
        assert got[0, 2] > 0 and got[0, 3] > 0


# --- CPU: the plain version -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_on_the_block_layout(seed):
    recon, valid = _block(6, 9, [2, 9, 0, 5, 1, 7], seed)
    launches = col.LAUNCHES
    got = col.fused_col(torch.from_numpy(recon), torch.from_numpy(valid))
    assert col.LAUNCHES == launches             # CPU tensors: plain version
    assert got.shape == valid.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_col(recon, valid), **TOL)
    assert got.numpy()[valid].max() > 0         # collisions are exercised
    assert np.all(got.numpy()[~valid] == 0.0)


def test_plain_matches_jax_on_the_packed_layout():
    recon, ids = _packed([4, 1, 6, 3], seed=4)
    gather, gmask, inv_g, inv_i = (torch.from_numpy(x) for x in scene_gather(ids))
    got = col.fused_col(torch.from_numpy(recon), gmask, gather)[inv_g, inv_i].numpy()
    valid = ids >= 0
    want = np.asarray(jm.col_scene_masked(jnp.asarray(recon), jnp.asarray(valid),
                                          jnp.asarray(ids[:, None] == ids[None, :])))
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    assert got[valid].max() > 0


@pytest.mark.parametrize("name", ["all_invalid_row", "nan_sample", "near_pair"])
def test_plain_edge_cases_give_the_col_answer(name):
    recon, valid = _edge_case(name)
    got = col.fused_col(torch.from_numpy(recon), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, _jax_col(recon, valid), **TOL)
    _hold_edge_case(name, got)


def _refused(kind):
    recon, valid = _block(2, 4, [2, 3], seed=0)
    recon, valid, gather = torch.from_numpy(recon), torch.from_numpy(valid), None
    if kind == "T":
        recon = recon[:, :, :8].contiguous()
    elif kind == "dtype":
        recon = recon.double()
    elif kind == "peds":
        recon = recon[:, :7]
    elif kind == "valid":
        valid = valid.to(torch.uint8)
    elif kind == "gather":
        gather = torch.zeros(2, 4, dtype=torch.int32)
    elif kind == "slots":
        valid = torch.zeros(1, col.MAX_SLOTS + 1, dtype=torch.bool)
        recon = torch.zeros(S, col.MAX_SLOTS + 1, T, 2)
    return recon, valid, gather


@pytest.mark.parametrize("kind,error,match", [
    ("T", ValueError, "T=12"), ("dtype", TypeError, "float32"),
    ("peds", ValueError, "pedestrians"), ("valid", ValueError, "bool"),
    ("gather", ValueError, "int64"), ("slots", ValueError, "slots a row"),
    ("cpu", ValueError, "CUDA or CPU")])
def test_launch_refuses_what_the_kernel_does_not_take(kind, error, match):
    with pytest.raises(error, match=match):
        col._launch(*_refused(kind))


def test_cpu_eval_step_runs_the_plain_col(monkeypatch):
    """On CPU tensors `eval_step` hands fused_col the kernels' layout and
    gets `metrics.col` of its rows, as before the kernel."""
    split = make_synthetic_data(n_scenes=3, max_peds=5, seed=2)
    cfg = load_config(os.path.join(REPO, "configs", "eigentrajectory-stgcnn-hotel.json"),
                      checkpoint_dir=CKPT, n_max_peds=5)
    tr = ETTorchTrainer(cfg, tag="parity", datasets=(split,) * 3, device="cpu")
    tr.load_model()
    noted = []

    def noting(recon, valid, gather=None):
        noted.append((recon, valid))
        return col.fused_col(recon, valid, gather)

    monkeypatch.setattr(trainer_module, "fused_col", noting)
    launches = col.LAUNCHES
    means = tr.test(eval_batch=4)
    assert col.LAUNCHES == launches and len(noted) == 1
    recon, valid = noted[0]
    assert recon.shape == (S, 4 * 5, T, 2) and valid.shape == (4, 5)
    want = M.col(recon.reshape(S, 4, 5, T, 2).transpose(0, 1), valid)[valid].mean()
    assert means["COL"] == pytest.approx(float(want), rel=1e-6)


# --- the card: the kernel against the plain version ---------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _on_card(recon, valid, gather=None):
    return (torch.from_numpy(recon).cuda(), torch.from_numpy(valid).cuda(),
            None if gather is None else torch.from_numpy(gather).cuda())


def _hold_kernel(recon, valid, gather=None):
    """The kernel against the plain version on the card; returns the kernel's."""
    args = _on_card(recon, valid, gather)
    launches = col.LAUNCHES
    got = col.fused_col(*args)
    torch.cuda.synchronize()
    assert col.LAUNCHES == launches + 1
    torch.testing.assert_close(got, col.fused_col_plain(*args), **TOL)
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_kernel_matches_plain_at_the_cell_shape(cuda_device, seed):
    """320 rows of 57 slots, 2-5 valid walkers a row (the evaluation
    cell's block)."""
    rng = np.random.default_rng(seed)
    recon, valid = _block(320, 57, rng.integers(2, 6, size=320), seed)
    got = _hold_kernel(recon, valid)
    assert got[valid].max() > 0 and np.all(got[~valid] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,slots,dense", [(4, 57, 57), (2, 300, 300), (2, 500, 480),
                                              (1, col.MAX_SLOTS, 700), (3, 1, 1)])
def test_cuda_kernel_matches_plain_on_dense_and_long_rows(cuda_device, rows, slots, dense):
    """Rows of up to `dense` valid walkers close together (a scene of 57,
    rows longer than the block's 256 threads, rows past the 48 KB of shared
    memory a block gets without asking, the most slots a row, a row of one)."""
    recon = _walkers(rows * slots, seed=slots, spread=3.0)
    valid = np.zeros((rows, slots), bool)
    valid[:, :dense] = True
    valid[-1, dense // 2:] = False
    got = _hold_kernel(recon, valid)
    if dense > 1:
        assert got[valid].max() > 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_packed_layout(cuda_device):
    recon, ids = _packed([5, 2, 20, 9, 57, 1], seed=6)
    gather, gmask, _, _ = scene_gather(ids)
    got = _hold_kernel(recon, gmask, gather)
    assert got[gmask].max() > 0 and np.all(got[~gmask] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["all_invalid_row", "nan_sample", "near_pair"])
def test_cuda_edge_cases_give_the_col_answer(cuda_device, name):
    recon, valid = _edge_case(name)
    _hold_edge_case(name, _hold_kernel(recon, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("path,kw", [("eigentrajectory-stgcnn-hotel.json", dict(n_max_peds=5)),
                                     ("eigentrajectory-pecnet-univ.json", {})])
def test_cuda_eval_steps_launch_the_kernel_once(cuda_device, monkeypatch, path, kw):
    """One launch a sequenced eval step (ET-STGCNN, hotel checkpoint) and a
    packed one (ET-PECNet, univ checkpoint), with the plain version's COL."""
    split = make_synthetic_data(n_scenes=6, max_peds=5, seed=3)
    cfg = load_config(os.path.join(REPO, "configs", path), checkpoint_dir=CKPT, **kw)
    tr = ETTorchTrainer(cfg, tag="parity", datasets=(split,) * 3, device="cuda")
    tr.load_model()
    batch = next(iter(tr._test_batches(8, None)))
    args = tr._to_device(batch)
    if tr.collated:
        args = (*args, *(torch.from_numpy(x).cuda() for x in scene_gather(batch.scene_ids)))
    else:
        args = args[:3]
    step = tr.packed_eval_step if tr.collated else tr.eval_step
    launches = col.LAUNCHES
    got = step(*args)
    torch.cuda.synchronize()
    assert col.LAUNCHES == launches + 1
    monkeypatch.setattr(trainer_module, "fused_col", col.fused_col_plain)
    want = step(*args)
    assert col.LAUNCHES == launches + 1
    torch.testing.assert_close(got[3], want[3], **TOL)
