"""Build the CUDA sources of `ops/csrc/` at first use and load them.

Each source is compiled by `nvcc` into a shared library with a plain C
interface, named by a hash of the source, the headers it includes from
`ops/csrc/` and the flags, under `eigentrajectory_tpu_torch/_build/`
(git-ignored), and loaded with ctypes. A failed build raises; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of eigentrajectory_tpu_torch "
                       "are built from source at first use and need the CUDA toolkit")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(source: str) -> List[str]:
    """`source` (a file name under csrc/) and every header it includes with
    quotes, directly or through another header, as paths; the source first."""
    paths, todo = [], [os.path.join(CSRC_DIR, source)]
    while todo:
        path = todo.pop()
        if path in paths:
            continue
        paths.append(path)
        with open(path, "rb") as f:
            names = _INCLUDE.findall(f.read())
        todo += [os.path.normpath(os.path.join(os.path.dirname(path), name.decode()))
                 for name in reversed(names)]
    return paths


def library_path(source: str) -> str:
    """Where the library for `source` (a file name under csrc/) is built: the
    name holds a hash of the source, its headers and the flags, so an edit to
    any of them builds anew."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(source):
        with open(path, "rb") as f:
            digest.update(b"\0" + os.path.basename(path).encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def compile_library(command: List[str], out: str, what: str) -> None:
    """Run the compiler `command` with the output path appended, write its
    report beside `out` as `<name>.log`, then move the library to `out` in
    one step, so that concurrent builds (threads, xdist workers) never load
    a half-written file. Raises with the compiler's output when it fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        proc = subprocess.run([*command, tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(command[0])} failed on {what} "
                               f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)   # atomic: a concurrent build sees a whole file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build(source: str) -> str:
    """Compile `source` unless its library exists; return the library path.

    The compiler's report (registers, shared memory, spills) is written
    beside the library as `<name>.log`.
    """
    out = library_path(source)
    if os.path.exists(out):
        return out
    compile_library([_nvcc(), *NVCC_FLAGS, os.path.join(CSRC_DIR, source), "-o"], out, source)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `source`, once per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _loaded[source] = lib
        return lib
