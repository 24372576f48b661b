"""The traced window: the profiler's raw events read into device operations,
the device-side extent of the program's spans and the host's spans, all on
the profiler's clock (ns).

The profiler links a kernel launched through ctypes (the program's CUDA
kernels) to no operator, so a span's device time is read from the span's
device-side twin: with CUDA activity on, each host range `record_function`
opens has a twin on the device timeline, and the device operations inside
the twin's interval are the span's. Host and device twins are never summed.
Spans are told from operations by the event's kind (a user annotation),
whatever their name, so a span the program adds never counts as device work.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NAME_CHARS = 100       # device operations are named by their first characters


class Trace:
    def __init__(self, events, window_s: float):
        """`events`: the profiler's `kineto_results.events()`."""
        from torch.autograd import DeviceType

        ops: List[Tuple[str, int, int]] = []
        self.dev_spans: Dict[str, List[Tuple[int, int]]] = {}
        self.host_spans: Dict[str, List[Tuple[int, int]]] = {}
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            on_device = e.device_type() == DeviceType.CUDA
            if e.is_user_annotation():
                (self.dev_spans if on_device else self.host_spans).setdefault(name, []).append(
                    (start, end))
            elif on_device:
                ops.append((name, start, end))
        ops.sort(key=lambda op: op[1])
        self.op_names = [op[0] for op in ops]
        self.op_start = np.array([op[1] for op in ops], np.int64)
        self.op_end = np.array([op[2] for op in ops], np.int64)
        self.window_s = window_s

    # -- device operations ------------------------------------------------
    def busy(self) -> np.ndarray:
        """The device's busy intervals: the union of its operations, (M, 2)."""
        if not len(self.op_start):
            return np.zeros((0, 2), np.int64)
        ends = np.maximum.accumulate(self.op_end)
        new = np.concatenate([[True], self.op_start[1:] > ends[:-1]])
        first = np.flatnonzero(new)
        last = np.concatenate([first[1:] - 1, [len(ends) - 1]])
        return np.stack([self.op_start[first], ends[last]], axis=1)

    def busy_s(self) -> float:
        b = self.busy()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match(name)` accepts."""
        dur = self.op_end - self.op_start
        return float(sum(int(d) for n, d in zip(self.op_names, dur) if match(n))) * 1e-9

    def op_count(self, match) -> int:
        return sum(1 for n in self.op_names if match(n))

    def span_device_s(self, *names: str) -> float:
        """Device seconds of the operations inside the device-side twins of
        the spans `names`."""
        total = 0
        for name in names:
            for s, e in self.dev_spans.get(name, ()):
                lo = np.searchsorted(self.op_start, s, side="left")
                hi = np.searchsorted(self.op_start, e, side="left")
                total += int(np.minimum(self.op_end[lo:hi], e).sum() - self.op_start[lo:hi].sum())
        return total * 1e-9

    def busy_within(self, intervals: List[Tuple[int, int]]) -> Tuple[float, float]:
        """(device busy seconds, seconds) inside the union of `intervals`."""
        busy = self.busy()
        covered = total = 0
        for s, e in _union(intervals):
            total += e - s
            lo = np.searchsorted(busy[:, 1], s, side="right")
            hi = np.searchsorted(busy[:, 0], e, side="left")
            seg = busy[lo:hi]
            if len(seg):
                covered += int((np.minimum(seg[:, 1], e) - np.maximum(seg[:, 0], s)).sum())
        return covered * 1e-9, total * 1e-9

    # -- the breakdown ------------------------------------------------------
    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, by name: [name, s]."""
        dur = self.op_end - self.op_start
        by: Dict[str, int] = {}
        for name, d in zip(self.op_names, dur):
            key = name[:NAME_CHARS]
            by[key] = by.get(key, 0) + int(d)
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """The device's idle time between its first and last operation, by
        the innermost host span open at each gap's middle: [name, s]."""
        busy = self.busy()
        if len(busy) < 2:
            return []
        gs, ge = busy[:-1, 1], busy[1:, 0]
        mid = (gs + ge) // 2
        label = np.full(len(mid), -1)
        spans = sorted(((s, e, name) for name, v in self.host_spans.items() for s, e in v),
                       key=lambda x: x[0])
        names = [x[2] for x in spans]
        order = np.argsort(mid)
        mid_sorted = mid[order]
        for i, (s, e, _) in enumerate(spans):    # later-starting spans are inner ones
            lo, hi = np.searchsorted(mid_sorted, [s, e])
            label[order[lo:hi]] = i
        by: Dict[str, int] = {}
        for lab, d in zip(label, ge - gs):
            key = names[lab] if lab >= 0 else "(no span open)"
            by[key] = by.get(key, 0) + int(d)
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
