"""How `ops/build.py` names what it builds: a library's file name holds a
hash of its source, of the headers the source includes from csrc/ (directly
or through another header) and of the compiler's flags, so that an edit to
any of them builds anew and no stale library is loaded. Needs no nvcc."""
import ctypes
import os
import re
import types

import pytest

from eigentrajectory_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "inner.cuh").write_text("#define INNER 1\n")
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\n#define TILE 32\n')
    (tmp_path / "unrelated.cuh").write_text("#define OTHER 1\n")
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n  #  include "tile.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cuda_runtime.h>\nint b;\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    return tmp_path


def test_source_files_follow_quoted_includes(csrc):
    assert [os.path.basename(p) for p in build.source_files("a.cu")] == [
        "a.cu", "tile.cuh", "inner.cuh"]
    assert [os.path.basename(p) for p in build.source_files("b.cu")] == ["b.cu"]


@pytest.mark.parametrize("edited", ["a.cu", "tile.cuh", "inner.cuh"])
def test_hash_changes_with_the_source_and_every_included_header(csrc, edited):
    before_a, before_b = build.library_path("a.cu"), build.library_path("b.cu")
    assert os.path.dirname(before_a) == build.BUILD_DIR
    assert os.path.basename(before_a).startswith("a-") and before_a.endswith(".so")
    assert build.library_path("a.cu") == before_a            # stable
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert build.library_path("a.cu") != before_a
    assert build.library_path("b.cu") == before_b


def test_hash_ignores_headers_not_included(csrc):
    before = build.library_path("a.cu")
    with open(csrc / "unrelated.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("a.cu") == before


def test_hash_changes_with_the_flags(csrc, monkeypatch):
    before = build.library_path("a.cu")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("a.cu") != before


def test_the_kernels_share_one_header():
    """Both kernels take their reconstruction from recon_tile.cuh, so the
    hash of each covers it."""
    for source in ("reconstruct.cu", "recon_metrics.cu"):
        names = [os.path.basename(p) for p in build.source_files(source)]
        assert names == [source, "recon_tile.cuh"]


@pytest.mark.parametrize("source,headers", [("reconstruct.cu", ["recon_tile.cuh"]),
                                            ("recon_metrics.cu", ["recon_tile.cuh"]),
                                            ("group_relabel.cu", []), ("col.cu", []),
                                            ("agent_attention.cu", [])])
def test_each_kernel_source_is_hashed_with_its_headers(source, headers):
    """Every source the wrappers build: the files its hash covers, and a
    library of its own name."""
    names = [os.path.basename(p) for p in build.source_files(source)]
    assert names == [source, *headers]
    stem = os.path.splitext(source)[0]
    assert os.path.basename(build.library_path(source)).startswith(stem + "-")


def test_the_wrappers_build_every_source_under_csrc():
    from eigentrajectory_tpu_torch.ops import attention, col, group, recon

    built = {recon.SOURCE, recon.RECONSTRUCT_SOURCE, group.SOURCE, col.SOURCE, attention.SOURCE}
    assert built == {name for name in os.listdir(build.CSRC_DIR) if name.endswith(".cu")}


def _c_parameters(source, fn):
    """The C types of the parameters of `extern "C" int fn(...)` in `source`."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        found = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", f.read())
    return [" ".join(p.split()).rsplit(" ", 1)[0] for p in found.group(1).split(",")]


@pytest.mark.parametrize("module,fn", [("attention", "et_agent_attention"), ("col", "et_col")])
def test_the_wrappers_declare_the_c_signatures(monkeypatch, module, fn):
    """The ctypes argument types a wrapper sets are the C entry point's, one
    for one (pointers as void pointers); checked without nvcc."""
    import importlib

    wrapper = importlib.import_module(f"eigentrajectory_tpu_torch.ops.{module}")
    entry = lambda: types.SimpleNamespace(argtypes=None, restype=None)
    lib = types.SimpleNamespace(**{fn: entry(), "et_cuda_error_string": entry()})
    monkeypatch.setattr(build, "load", lambda source: lib)
    wrapper._library()
    c_type = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if t.endswith("*") else c_type[t]
            for t in _c_parameters(wrapper.SOURCE, fn)]
    assert getattr(lib, fn).argtypes == want
    assert getattr(lib, fn).restype == ctypes.c_int
