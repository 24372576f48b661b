"""Profiling and tracing utilities (the counterpart of
`eigentrajectory_tpu/utils/profiling.py`, over `torch.profiler`).

* trace_annotation: a named range that shows in torch.profiler traces.
* StepTimer: wall-clock meter for steps and epochs with percentile summaries
  (a copy of the JAX package's).
* start_trace / stop_trace: an on-demand CPU + CUDA trace, written as a
  Chrome trace file into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_active: Optional[tuple] = None     # (profiler, log_dir) between start and stop


def trace_annotation(name: str):
    """Context manager annotating a region in profiler traces."""
    return record_function(name)


def start_trace(log_dir: str):
    """Start tracing the host and, where there is one, the card."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, log_dir)


def stop_trace() -> str:
    """Stop the running trace and write `log_dir/trace.json`; returns the path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is running")
    prof, log_dir = _active
    _active = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


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
