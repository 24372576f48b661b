"""GP-Graph's group relabel: the CUDA kernel, its wrapper and its plain
PyTorch version.

The counterpart of the relabel loop of `find_group_indices` in
`eigentrajectory_tpu/models/gpgraph_common.py`, which the JAX package runs
on the device as a `lax.fori_loop` over the row-major pairs of one scene.
The caller builds the merge mask (`dist <= th`, strictly below the
diagonal, both slots valid); `group_ranks` relabels and ranks every scene of
a block. CUDA tensors go to the hand-written kernel (`csrc/group_relabel.cu`,
one warp a scene, built at first use, see `build.py`) or raise; CPU tensors
go to the plain version. The results are integers: kernel and plain version
agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

SOURCE = "group_relabel.cu"
# The most slots whose labels (4 bytes a slot), 2N-bit presence map with
# its prefix counts and one staged row of merge bits (with its last column
# and the row bits) fit in a block's 227 KB of shared memory: the largest N
# with N + 2 * ceil(N / 32) + 2 * ceil(N / 16) + 1 <= 227 * 1024 / 4 words.
MAX_SLOTS = 48_933

# Kernel launches made by `group_ranks`, for showing that a run went through
# the kernel. Callers may reset it to 0.
LAUNCHES = 0


def group_ranks_plain(merge: torch.Tensor, valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: merge (B, N, N) bool, set only strictly below the
    diagonal between valid slots; valid (B, N) bool -> (ranks (B, N) int32,
    n_groups (B,) int32).

    The pairs (r, c), c < r, in row-major order, all scenes at once; a pair
    that merges in no scene of the block changes nothing and is skipped.
    Where merge[b, r, c] is set, every label of scene b equal to its
    labels[r] becomes c. Labels start at the slot index, + N for a padded
    slot; the labels present are ranked in ascending order."""
    b, n = valid.shape
    slots = torch.arange(n, device=valid.device, dtype=torch.int32)
    labels = torch.where(valid, slots, slots + n)
    for r, c in merge.any(dim=0).nonzero().tolist():
        lab_r = labels[:, r:r + 1]
        hit = merge[:, r, c:c + 1] & (labels == lab_r)
        labels = torch.where(hit, torch.full_like(labels, c), labels)
    presence = torch.zeros((b, 2 * n), dtype=torch.int32, device=valid.device)
    presence.scatter_(1, labels.long(), 1)
    rank_of = torch.cumsum(presence, dim=1, dtype=torch.int32) - 1
    ranks = torch.gather(rank_of, 1, labels.long())
    return ranks, presence.sum(dim=1, dtype=torch.int32)


def group_ranks(merge: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same signature and outputs as `group_ranks_plain`; runs the CUDA
    kernel on CUDA tensors and the plain version on CPU tensors."""
    if valid.device.type == "cpu":
        return group_ranks_plain(merge, valid)
    return _launch(merge, valid)


def _check_args(merge: torch.Tensor, valid: torch.Tensor) -> Tuple[int, int]:
    """Check the kernel's inputs on a CUDA device; returns (B, N)."""
    device = valid.device
    if valid.dim() != 2:
        raise ValueError(f"valid must be (B, N), got {tuple(valid.shape)}")
    b, n = valid.shape
    if n > MAX_SLOTS:
        raise ValueError(f"the group relabel kernel holds at most {MAX_SLOTS} slots, got {n}")
    if device.type != "cuda":
        raise ValueError(f"the group relabel runs on CUDA or CPU tensors, got {device}")
    for name, x, shape in (("merge", merge, (b, n, n)), ("valid", valid, (b, n))):
        if x.device != device or x.dtype != torch.bool or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bool tensor {shape} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return b, n


def _launch(merge: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    b, n = _check_args(merge, valid)
    device = valid.device
    ranks = torch.empty((b, n), dtype=torch.int32, device=device)
    n_groups = torch.empty((b,), dtype=torch.int32, device=device)
    lib = _library()
    # The runtime launches on the current device: make it the tensors' card.
    with torch.cuda.device(device):
        err = lib.et_group_relabel(merge.data_ptr(), valid.data_ptr(), ranks.data_ptr(),
                                   n_groups.data_ptr(), b, n,
                                   torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_relabel kernel launch failed: "
                           f"{lib.et_cuda_error_string(err).decode()} ({err})")
    LAUNCHES += 1
    return ranks, n_groups


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.et_group_relabel.argtypes is None:
        lib.et_group_relabel.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        lib.et_group_relabel.restype = ctypes.c_int
        lib.et_cuda_error_string.argtypes = [ctypes.c_int]
        lib.et_cuda_error_string.restype = ctypes.c_char_p
    return lib
