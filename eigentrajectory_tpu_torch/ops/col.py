"""COL over each scene row's valid pairs: the CUDA kernel, its wrapper and
its plain PyTorch version.

`fused_col` scores the trajectories `fused_recon_metrics` leaves, in its
(S, P, T, 2) layout, by rows of slots: row r's slots are pedestrians
r*m .. r*m + m - 1 (the sequenced regime's (B, N) block), or the row's
entries of a `gather` map (the packed regime's (G, m) scene blocks of
`data.batching.scene_gather`). CUDA tensors go to the hand-written kernel
(`csrc/col.cu`, a block a row, over the row's valid pairs only; built at
first use, see `build.py`) or raise; CPU tensors go to the plain version,
`metrics.col` on the rows gathered out of the trajectories.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import metrics as M
from . import build

SOURCE = "col.cu"
# The kernel is built for the configs' pred_len (as the recon kernels are).
SUPPORTED_T = 12
# The most slots a row whose items for one sample (a padded 14-point window
# and a flag, 31 words a slot), valid-slot list and counts (2 words a slot)
# and the 8 warps' counts fit in a block's 227 KB of shared memory.
MAX_SLOTS = (227 * 1024 // 4 - 8) // 33

# Kernel launches made by `fused_col`, for showing that a run went through
# the kernel. Callers may reset it to 0.
LAUNCHES = 0


def fused_col_plain(recon: torch.Tensor, valid: torch.Tensor,
                    gather: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: recon (S, P, T, 2), valid (R, m) bool, gather (R, m)
    int64 or None (then P = R * m and row r holds pedestrians r*m ..
    r*m + m - 1) -> COL (R, m), 0 on a padded slot."""
    if gather is None:
        rows = recon.reshape(recon.shape[0], *valid.shape, *recon.shape[2:]).transpose(0, 1)
    else:
        rows = recon[:, gather].transpose(0, 1)                  # (R, S, m, T, 2)
    return M.col(rows, valid)


def fused_col(recon: torch.Tensor, valid: torch.Tensor,
              gather: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same signature and output as `fused_col_plain`; runs the CUDA kernel
    on CUDA tensors and the plain version on CPU tensors."""
    if valid.device.type == "cpu":
        return fused_col_plain(recon, valid, gather)
    return _launch(recon, valid, gather)


def _check_args(recon: torch.Tensor, valid: torch.Tensor,
                gather: Optional[torch.Tensor]) -> Tuple[int, int, int, int]:
    """Check the kernel's inputs on a CUDA device; returns (S, P, R, m)."""
    if valid.dim() != 2 or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool (R, m) tensor, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if recon.dim() != 4 or recon.shape[-1] != 2:
        raise ValueError(f"recon must be (S, P, T, 2), got {tuple(recon.shape)}")
    if recon.dtype != torch.float32:
        raise TypeError(f"recon has dtype {recon.dtype}, expected torch.float32")
    s, p, t, _ = recon.shape
    r, m = valid.shape
    if t != SUPPORTED_T:
        raise ValueError(f"the COL kernel is built for T={SUPPORTED_T}; got T={t}")
    if m > MAX_SLOTS:
        raise ValueError(f"the COL kernel holds at most {MAX_SLOTS} slots a row, got {m}")
    if gather is None:
        if p != r * m:
            raise ValueError(f"recon holds {p} pedestrians, valid {r} x {m} slots")
    elif gather.dtype != torch.int64 or tuple(gather.shape) != (r, m):
        raise ValueError(f"gather must be an int64 {(r, m)} tensor, got {gather.dtype} "
                         f"{tuple(gather.shape)}")
    device = valid.device
    if device.type != "cuda":
        raise ValueError(f"the COL kernel runs on CUDA or CPU tensors, got {device}")
    for name, x in (("recon", recon), ("valid", valid), ("gather", gather)):
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return s, p, r, m


def _launch(recon: torch.Tensor, valid: torch.Tensor,
            gather: Optional[torch.Tensor]) -> torch.Tensor:
    global LAUNCHES
    s, p, r, m = _check_args(recon, valid, gather)
    device = valid.device
    out = torch.empty((r, m), dtype=torch.float32, device=device)
    lib = _library()
    # The runtime launches on the current device (and sets the kernel's
    # shared-memory attribute there): make it the tensors' card.
    with torch.cuda.device(device):
        err = lib.et_col(recon.data_ptr(), valid.data_ptr(),
                         None if gather is None else gather.data_ptr(), out.data_ptr(),
                         r, m, p, s, SUPPORTED_T, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"col kernel launch failed: "
                           f"{lib.et_cuda_error_string(err).decode()} ({err})")
    LAUNCHES += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.et_col.argtypes is None:
        lib.et_col.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.et_col.restype = ctypes.c_int
        lib.et_cuda_error_string.argtypes = [ctypes.c_int]
        lib.et_cuda_error_string.restype = ctypes.c_char_p
    return lib
