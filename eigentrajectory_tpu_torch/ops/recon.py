"""Fused ET reconstruction, with and without per-ped metrics: the CUDA
kernels, their wrappers and their plain PyTorch versions.

The counterparts of `fused_reconstruct` and `fused_recon_metrics` in
`eigentrajectory_tpu/ops/pallas_recon.py`. Each wrapper dispatches on where
its tensors lie: CUDA tensors go to its hand-written kernel
(`csrc/reconstruct.cu`, `csrc/recon_metrics.cu`, which share their tile of
pedestrians and their reconstruction in `csrc/recon_tile.cuh`; built at first
use, see `build.py`) or raise; CPU tensors go to its plain version, the einsum +
denormalize (+ metrics) path of the JAX package's non-TPU branch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import metrics as M
from ..etspace.descriptor import reconstruct_norm
from ..etspace.normalizer import NormParams, denormalize
from . import build

SOURCE = "recon_metrics.cu"
RECONSTRUCT_SOURCE = "reconstruct.cu"
# The kernels are instantiated for these widths (the configs' k and pred_len).
SUPPORTED_K, SUPPORTED_T = 6, 12

# Kernel launches made by `fused_recon_metrics` and `fused_reconstruct`, for
# showing that a run went through each kernel. Callers may reset them to 0.
LAUNCHES = 0
RECONSTRUCT_LAUNCHES = 0

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_reconstruct_plain(c_m, c_s, u_m, u_s, ori, rot, sca, mask) -> torch.Tensor:
    """Plain version: trajectories (S, N, T, 2) in world coordinates.

    c_m, c_s (k, N, S); u_m, u_s (2T, k); ori (N, 2); rot (N, 2, 2);
    sca (N,); mask (N,) bool moving. The moving branch is divided by `sca`,
    giving 0 where sca == 0 as the kernels do.
    """
    safe_sca = torch.where(sca != 0, sca, torch.inf)
    p = NormParams(ori=ori[:, None, :], rot=rot, sca=safe_sca[:, None, None])
    r_m = denormalize(reconstruct_norm(c_m, u_m), p, sca=True)
    r_s = denormalize(reconstruct_norm(c_s, u_s), p, sca=False)
    return torch.where(mask.bool()[None, :, None, None], r_m, r_s)


def fused_reconstruct(c_m, c_s, u_m, u_s, ori, rot, sca, mask) -> torch.Tensor:
    """Same signature and output as `fused_reconstruct_plain`; runs the CUDA
    kernel on CUDA tensors and the plain version on CPU tensors."""
    if c_m.device.type == "cpu":
        return fused_reconstruct_plain(c_m, c_s, u_m, u_s, ori, rot, sca, mask)
    return _launch_reconstruct(c_m, c_s, u_m, u_s, ori, rot, sca, mask)


def fused_recon_metrics_plain(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt) -> Outputs:
    """Plain version: (recon (S, N, T, 2), ade (N,), fde (N,), tcc (N,)),
    with the inputs of `fused_reconstruct_plain` and gt (N, T, 2)."""
    recon = fused_reconstruct_plain(c_m, c_s, u_m, u_s, ori, rot, sca, mask)
    return recon, M.ade(recon, gt), M.fde(recon, gt), M.tcc(recon, gt)


def fused_recon_metrics(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt) -> Outputs:
    """Same signature and outputs as `fused_recon_metrics_plain`; runs the
    CUDA kernel on CUDA tensors and the plain version on CPU tensors."""
    if c_m.device.type == "cpu":
        return fused_recon_metrics_plain(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt)
    return _launch(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt)


def _check(name: str, x: torch.Tensor, shape, device, dtypes=(torch.float32,)):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {x.dtype}, expected one of {dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt=None):
    """Check the kernels' inputs on a CUDA device; returns (k, N, S, T)."""
    device = c_m.device
    if device.type != "cuda":
        raise ValueError(f"the recon kernels run on CUDA or CPU tensors, got {device}")
    if c_m.dim() != 3 or u_m.dim() != 2:
        raise ValueError("c_m must be (k, N, S) and u_m (2T, k)")
    k, n, s = c_m.shape
    t = u_m.shape[0] // 2
    if (k, t) != (SUPPORTED_K, SUPPORTED_T):
        raise ValueError(f"the CUDA kernels are built for k={SUPPORTED_K}, "
                         f"T={SUPPORTED_T}; got k={k}, T={t}")
    _check("c_m", c_m, (k, n, s), device)
    _check("c_s", c_s, (k, n, s), device)
    _check("u_m", u_m, (2 * t, k), device)
    _check("u_s", u_s, (2 * t, k), device)
    _check("ori", ori, (n, 2), device)
    _check("rot", rot, (n, 2, 2), device)
    _check("sca", sca, (n,), device)
    _check("mask", mask, (n,), device, (torch.bool, torch.uint8))
    if gt is not None:
        _check("gt", gt, (n, t, 2), device)
    return k, n, s, t


def _launch(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt) -> Outputs:
    global LAUNCHES
    k, n, s, t = _check_args(c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt)
    device = c_m.device
    recon = torch.empty((s, n, t, 2), dtype=torch.float32, device=device)
    ade, fde, tcc = torch.empty((3, n), dtype=torch.float32, device=device)
    lib = _library(SOURCE, "et_recon_metrics", 13)
    # The runtime launches on the current device (and sets the kernel's
    # shared-memory attribute there): make it the tensors' card.
    with torch.cuda.device(device):
        _raise_on(lib, lib.et_recon_metrics(
            c_m.data_ptr(), c_s.data_ptr(), u_m.data_ptr(), u_s.data_ptr(),
            ori.data_ptr(), rot.data_ptr(), sca.data_ptr(), mask.data_ptr(),
            gt.data_ptr(), recon.data_ptr(), ade.data_ptr(), fde.data_ptr(),
            tcc.data_ptr(), k, n, s, t, _stream(c_m)), "recon_metrics")
    LAUNCHES += 1
    return recon, ade, fde, tcc


def _launch_reconstruct(c_m, c_s, u_m, u_s, ori, rot, sca, mask) -> torch.Tensor:
    global RECONSTRUCT_LAUNCHES
    k, n, s, t = _check_args(c_m, c_s, u_m, u_s, ori, rot, sca, mask)
    out = torch.empty((s, n, t, 2), dtype=torch.float32, device=c_m.device)
    lib = _library(RECONSTRUCT_SOURCE, "et_reconstruct", 9)
    with torch.cuda.device(c_m.device):
        _raise_on(lib, lib.et_reconstruct(
            c_m.data_ptr(), c_s.data_ptr(), u_m.data_ptr(), u_s.data_ptr(),
            ori.data_ptr(), rot.data_ptr(), sca.data_ptr(), mask.data_ptr(),
            out.data_ptr(), k, n, s, t, _stream(c_m)), "reconstruct")
    RECONSTRUCT_LAUNCHES += 1
    return out


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(lib: ctypes.CDLL, err: int, name: str):
    if err != 0:
        msg = lib.et_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _library(source: str, entry: str, n_ptrs: int) -> ctypes.CDLL:
    """The library of `source` with `entry` (n_ptrs pointers, then k, n, s, t
    and the stream) typed for ctypes."""
    lib = build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.et_cuda_error_string.argtypes = [ctypes.c_int]
        lib.et_cuda_error_string.restype = ctypes.c_char_p
    return lib
