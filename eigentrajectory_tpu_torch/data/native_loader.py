"""ctypes bindings for the native C++ trajectory preprocessor.

The counterpart of `eigentrajectory_tpu/data/native_loader.py`, over the
repository's shared source `native/etloader.cpp`. The source is compiled by
g++ at first use, with the flags of `native/Makefile`, into
`eigentrajectory_tpu_torch/_build/libetloader-<hash>.so` (git-ignored; the
hash covers the source and the flags) and loaded with ctypes. A failed build
raises with the compiler's output; nothing falls back to the Python loader,
which `load_trajectory_data(..., use_native=False)` asks for explicitly. Its
output is bitwise the Python loader's (tests/test_torch_native_loader.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import threading

import numpy as np

from ..ops.build import BUILD_DIR, compile_library
from .dataset import TrajectoryData

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "etloader.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


class _ETLoadResult(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_double)),
        ("loss_mask", ctypes.POINTER(ctypes.c_double)),
        ("nonlinear", ctypes.POINTER(ctypes.c_double)),
        ("peds_per_scene", ctypes.POINTER(ctypes.c_int32)),
        ("n_peds", ctypes.c_int32),
        ("n_scenes", ctypes.c_int32),
    ]


_lock = threading.Lock()
_lib = None


def library_path(source: str = SOURCE) -> str:
    """Where the library of `source` is built: the name holds a hash of the
    source and the flags, so an edit to either builds anew."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as f:
        digest.update(b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libetloader-{digest.hexdigest()[:16]}.so")


def build(source: str = SOURCE) -> str:
    """Compile `source` unless its library exists; return the library path."""
    out = library_path(source)
    if not os.path.exists(out):
        compile_library(["g++", *CXX_FLAGS, source, "-o"], out, os.path.basename(source))
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.et_load_split.restype = ctypes.c_int
            lib.et_load_split.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                ctypes.POINTER(_ETLoadResult),
            ]
            lib.et_free_result.restype = None
            lib.et_free_result.argtypes = [ctypes.POINTER(_ETLoadResult)]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


def load_trajectory_data_native(
    data_dir: str,
    obs_len: int = 8,
    pred_len: int = 12,
    skip: int = 1,
    threshold: float = 0.02,
    min_ped: int = 1,
) -> TrajectoryData:
    """The native route of `dataset.load_trajectory_data` (tab-separated
    files)."""
    lib = _load_lib()
    files = sorted(os.listdir(data_dir))
    paths = [os.path.join(data_dir, f).encode() for f in files]
    arr = (ctypes.c_char_p * len(paths))(*paths)
    res = _ETLoadResult()
    rc = lib.et_load_split(arr, len(paths), obs_len, pred_len, skip,
                           threshold, min_ped, ctypes.byref(res))
    if rc != 0:
        lib.et_free_result(ctypes.byref(res))
        raise RuntimeError(f"et_load_split failed with code {rc} on {data_dir}")
    try:
        seq_len = obs_len + pred_len
        n = int(res.n_peds)
        s = int(res.n_scenes)
        seq = np.ctypeslib.as_array(res.seq, shape=(n, 2, seq_len)).copy()
        loss_mask = np.ctypeslib.as_array(res.loss_mask, shape=(n, seq_len)).copy()
        nl = np.ctypeslib.as_array(res.nonlinear, shape=(n,)).copy()
        npis = np.ctypeslib.as_array(res.peds_per_scene, shape=(s,)).copy()
    finally:
        lib.et_free_result(ctypes.byref(res))

    obs = np.ascontiguousarray(seq[:, :, :obs_len].transpose(0, 2, 1), np.float32)
    pred = np.ascontiguousarray(seq[:, :, obs_len:].transpose(0, 2, 1), np.float32)
    cum = [0] + np.cumsum(npis).tolist()
    return TrajectoryData(
        obs_traj=obs, pred_traj=pred,
        non_linear_ped=nl.astype(np.float32),
        loss_mask=loss_mask.astype(np.float32),
        num_peds_in_seq=npis.astype(np.int64),
        seq_start_end=[(int(a), int(b)) for a, b in zip(cum, cum[1:])],
    )
