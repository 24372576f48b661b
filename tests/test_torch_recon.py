"""The port's fused_recon_metrics and fused_reconstruct: on CPU tensors
(their plain versions) against the JAX package's Pallas kernels run in
interpret mode, and on the card the CUDA kernels against the plain versions
(tolerance 1e-4: f32 sums in another order, as tests/test_pallas_recon.py
allows)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigentrajectory_tpu.ops.pallas_recon import fused_recon_metrics as jax_recon_metrics
from eigentrajectory_tpu.ops.pallas_recon import fused_reconstruct as jax_reconstruct
from eigentrajectory_tpu_torch.ops import recon

TOL = dict(atol=1e-4, rtol=1e-4)


TILE = 32          # pedestrians of a block in both CUDA kernels


def _case(n, seed=0, special=True, k=6, s=20, t=12, moving=None):
    """Inputs at the shapes of tests/test_pallas_recon.py. `special` adds a
    moving ped of sca == 0 (ped 0), a ped whose samples all end at the same
    point so the FDE ties across samples (ped 1), and a constant-GT ped
    (ped 2). `moving` True or False makes every ped moving or static."""
    rng = np.random.default_rng(seed)
    c_m = rng.normal(size=(k, n, s)).astype(np.float32)
    c_s = rng.normal(size=(k, n, s)).astype(np.float32)
    u_m = rng.normal(size=(t * 2, k)).astype(np.float32)
    u_s = rng.normal(size=(t * 2, k)).astype(np.float32)
    ang = rng.normal(size=(n,)).astype(np.float32)
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], 1),
                    np.stack([np.sin(ang), np.cos(ang)], 1)], 1).astype(np.float32)
    ori = rng.normal(size=(n, 2)).astype(np.float32)
    sca = (2.0 / (0.5 + np.abs(rng.normal(size=(n,))))).astype(np.float32)
    mask = rng.random(n) > 0.4
    gt = rng.normal(size=(n, t, 2)).astype(np.float32)
    if moving is not None:
        mask[:] = moving
    if not special:
        return dict(c_m=c_m, c_s=c_s, u_m=u_m, u_s=u_s, ori=ori, rot=rot, sca=sca,
                    mask=mask, gt=gt)
    mask[:2] = True
    sca[0] = 0.0
    u_m[-2:, 1:] = 0.0                       # last step depends on c[0] only
    u_s[-2:, 1:] = 0.0
    c_m[0, 1, :] = c_m[0, 1, 0]
    gt[2] = 0.5
    return dict(c_m=c_m, c_s=c_s, u_m=u_m, u_s=u_s, ori=ori, rot=rot, sca=sca,
                mask=mask, gt=gt)


def _torch_args(case, device="cpu"):
    return [torch.from_numpy(case[key]).to(device) for key in
            ("c_m", "c_s", "u_m", "u_s", "ori", "rot", "sca", "mask", "gt")]


@pytest.mark.parametrize("n", [45, 130])
def test_plain_matches_pallas_interpret(n):
    case = _case(n)
    launches = recon.LAUNCHES
    got = recon.fused_recon_metrics(*_torch_args(case))
    assert recon.LAUNCHES == launches          # CPU tensors: plain version
    want = jax_recon_metrics(*(jnp.asarray(case[key]) for key in
                               ("c_m", "c_s", "u_m", "u_s", "ori", "rot", "sca",
                                "mask", "gt")), interpret=True)
    for name, g, w in zip(("recon", "ade", "fde", "tcc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    recon_traj, _, fde, tcc = got
    # sca == 0 on the moving branch reconstructs to the origin.
    np.testing.assert_allclose(recon_traj[:, 0].numpy(),
                               np.broadcast_to(case["ori"][0], (20, 12, 2)), atol=1e-6)
    # All samples of ped 1 tie on FDE: the first one is scored.
    final = recon_traj[:, 1, -1].numpy()
    assert np.all(final == final[0])
    first = recon.fused_recon_metrics_plain(*[x[..., :1] if i < 2 else x for i, x in
                                              enumerate(_torch_args(case))])
    np.testing.assert_allclose(tcc[1].numpy(), first[3][1].numpy(), atol=1e-6)
    assert tcc[2] == 0.0


@pytest.mark.parametrize("special", [False, True])
def test_reconstruct_plain_matches_pallas_interpret(special):
    case = _case(37, seed=5, special=special)
    args = _torch_args(case)[:-1]
    launches = recon.RECONSTRUCT_LAUNCHES
    got = recon.fused_reconstruct(*args)
    assert recon.RECONSTRUCT_LAUNCHES == launches   # CPU tensors: plain version
    assert got.shape == (20, 37, 12, 2) and got.dtype == torch.float32
    want = jax_reconstruct(*(jnp.asarray(case[key]) for key in
                             ("c_m", "c_s", "u_m", "u_s", "ori", "rot", "sca", "mask")),
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The same trajectories as the metrics kernel's.
    np.testing.assert_array_equal(got.numpy(),
                                  recon.fused_recon_metrics_plain(*_torch_args(case))[0].numpy())
    if special:
        # sca == 0 on the moving branch reconstructs exactly to the origin.
        assert torch.equal(got[:, 0], torch.from_numpy(case["ori"][0]).expand(20, 12, 2))


def test_launch_rejects_non_cuda_tensors():
    args = _torch_args(_case(8))
    with pytest.raises(ValueError):
        recon._launch(*args)
    with pytest.raises(ValueError):
        recon._launch_reconstruct(*args[:-1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _unambiguous(recon_traj, gt, rel=1e-5):
    """Peds whose best-FDE sample wins by more than f32 rounding: only there
    must two implementations pick the same sample for TCC."""
    fde = torch.linalg.vector_norm(recon_traj[:, :, -1] - gt[None, :, -1], dim=-1)
    two = fde.topk(2, dim=0, largest=False).values
    return (two[1] - two[0]) > rel * (1.0 + two[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,special", [(45, True), (18240, False)])
def test_cuda_kernel_matches_plain(cuda_device, n, special):
    args = _torch_args(_case(n, seed=n, special=special), cuda_device)
    launches = recon.LAUNCHES
    got = recon.fused_recon_metrics(*args)
    torch.cuda.synchronize()
    assert recon.LAUNCHES == launches + 1
    want = recon.fused_recon_metrics_plain(*args)
    for name, g, w in zip(("recon", "ade", "fde"), got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL)
    clear = _unambiguous(want[0], args[-1])
    assert clear.float().mean() > 0.9        # ties are rare outside peds 0-1
    torch.testing.assert_close(got[3][clear], want[3][clear], msg="tcc", **TOL)
    if special:
        # The FDE tie of ped 1 scores sample 0; the constant GT of ped 2 gives 0.
        first = recon.fused_recon_metrics(*[x[..., :1].contiguous() if i < 2 else x
                                            for i, x in enumerate(args)])
        torch.testing.assert_close(got[3][1], first[3][1], atol=1e-6, rtol=0)
        assert got[3][2] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,special", [(45, True), (38528, False)])
def test_cuda_reconstruct_matches_plain(cuda_device, n, special):
    args = _torch_args(_case(n, seed=n, special=special), cuda_device)[:-1]
    launches = recon.RECONSTRUCT_LAUNCHES
    got = recon.fused_reconstruct(*args)
    torch.cuda.synchronize()
    assert recon.RECONSTRUCT_LAUNCHES == launches + 1
    torch.testing.assert_close(got, recon.fused_reconstruct_plain(*args), **TOL)
    if special:
        assert torch.equal(got[:, 0], args[4][0].expand(20, 12, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("moving", [None, True, False])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 13])
def test_cuda_kernels_at_the_tile_edges(cuda_device, n, moving):
    """Both kernels against their plain versions where the last tile of
    pedestrians is ragged, full or a single pedestrian, with a mixed, an
    all-moving and an all-static mask; and the same trajectories, bit for
    bit, from both kernels."""
    args = _torch_args(_case(n, seed=100 + n, special=False, moving=moving), cuda_device)
    got = recon.fused_recon_metrics(*args)
    rgot = recon.fused_reconstruct(*args[:-1])
    torch.cuda.synchronize()
    want = recon.fused_recon_metrics_plain(*args)
    for name, g, w in zip(("recon", "ade", "fde"), got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL)
    clear = _unambiguous(want[0], args[-1])
    torch.testing.assert_close(got[3][clear], want[3][clear], msg="tcc", **TOL)
    assert torch.equal(got[0], rgot)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [45, 18240])
def test_cuda_kernels_give_the_same_trajectories(cuda_device, n):
    """The two kernels share their reconstruction: identical bits on
    identical inputs, the sca == 0 / FDE-tie / constant-GT case included,
    and the tie still scores sample 0."""
    args = _torch_args(_case(n, seed=n, special=True), cuda_device)
    got = recon.fused_recon_metrics(*args)
    assert torch.equal(got[0], recon.fused_reconstruct(*args[:-1]))
    final = got[0][:, 1, -1]
    assert torch.equal(final, final[:1].expand_as(final))      # ped 1 ties on FDE
    first = recon.fused_recon_metrics(*[x[..., :1].contiguous() if i < 2 else x
                                        for i, x in enumerate(args)])
    torch.testing.assert_close(got[3][1], first[3][1], atol=1e-6, rtol=0)
