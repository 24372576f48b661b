"""Profiling and tracing utilities (the counterpart of
`eigentrajectory_tpu/utils/profiling.py`, over `torch.profiler`).

* span: a named range in torch.profiler traces, opened only while a
  profiler records; otherwise a shared no-op context (a flag check, where a
  bare `record_function` costs some 12 us on a CPU with no profiler).
  A detail span (`detail=True`) opens only where the environment sets
  ET_TRACE_DETAIL=1 besides.
* count / counters: named counts of the running trace (trace data, like the
  spans): `count` adds only while a profiler records, `counters()` gives
  the counts of the running or the last trace.
* StepTimer: wall-clock meter for steps and epochs with percentile summaries
  (a copy of the JAX package's).

Detail spans are the ones nested inside a span whose device-side twin is
read as that span's device time (`serve.et_forward`, `eval.et_forward`):
the profiler gives each kernel to the innermost span open at its launch, so
a span nested there takes its kernels out of the outer span's twin.

A trace's counts start from zero: the first span or count that finds a
profiler recording after one found none clears them. A trace with no span
and no count of its own, started right after another with nothing of the
program run between them, leaves the earlier trace's counts in place.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_NULL = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_fresh = True       # no profiler seen since the counts were last cleared


def tracing() -> bool:
    """Whether a profiler records; the first call that finds one recording
    after a call that found none clears the counts."""
    global _fresh
    if not _profiler_enabled():
        _fresh = True
        return False
    if _fresh:
        _counts.clear()
        _fresh = False
    return True


def span(name: str, detail: bool = False):
    """Context manager: `record_function(name)` while a profiler records
    (a detail span: and ET_TRACE_DETAIL=1), else a shared no-op."""
    if not tracing() or (detail and os.environ.get("ET_TRACE_DETAIL") != "1"):
        return _NULL
    return record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the count `name` of the running trace; nothing while no
    profiler records."""
    if tracing():
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of the counts of the running trace, or of the last one."""
    tracing()
    return dict(_counts)


class StepTimer:
    """Wall-clock step timer with summary statistics."""

    def __init__(self):
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.durations.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        ds = sorted(self.durations)
        n = len(ds)
        return {
            "count": n,
            "mean_s": sum(ds) / n,
            "p50_s": ds[n // 2],
            "p90_s": ds[min(n - 1, int(n * 0.9))],
            "max_s": ds[-1],
        }
