"""Serving under an open loop: `ETPredictor.predict(obs, scene_ids)` offered
requests at a fixed rate, one due every 1 / `rate_per_s` seconds whether or
not the last has finished, served in turn by one predictor.

Each request holds `scenes_per_request` scenes of the seed's pool, drawn
without replacement; the sequence of sizes is the same for every seed.
A request's latency runs from when it was due to when its futures are in
hand as NumPy, so it counts the wait behind an earlier one.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import generator, judge, program
from ..reference.pipeline import Reference, scene_flops, scene_futures


class Cell:
    def __init__(self, config: Dict, traffic: Dict, root: str, device: str, seed: int,
                 seconds: float):
        from eigentrajectory_tpu_torch.inference import ETPredictor

        self.config, self.traffic, self.root, self.device = config, traffic, root, device
        self.rate = float(traffic["rate_per_s"])
        self.pool = generator.make_scenes(traffic["pool"], seed)
        n = max(1, math.ceil(seconds * self.rate))          # requests due in the window
        self.sizes = generator.request_sizes(traffic, n)
        self.scenes = generator.request_scenes(self.sizes, len(self.pool.counts), seed)
        exp = config["experiment"]
        moving = program.moving(self.pool.obs, exp["static_dist"])
        flops = np.array([scene_flops(config, int(c)) for c in self.pool.counts], np.int64)
        self.requests, self.work = [], []
        for scenes in self.scenes:
            peds = self.pool.peds(scenes)
            ids = np.repeat(np.arange(len(scenes)), self.pool.counts[scenes])
            self.requests.append((np.ascontiguousarray(self.pool.obs[peds]), ids))
            self.work.append({"peds": len(peds), "moving": int(moving[peds].sum()),
                              "flops": int(flops[scenes].sum())})
        g = generator.rng(seed, generator.STREAM_CHECKS)
        sizes = np.array([w["peds"] for w in self.work])
        checked = g.choice(n, min(int(traffic["checked_requests"]), n), replace=False)
        self.checked = sorted(set(int(i) for i in checked) | {int(sizes.argmax())})
        cfg = program.exp_config(config, root)
        data = program.trajectory_data(self.pool)
        self.predictor = ETPredictor.from_checkpoint(cfg, config["tag"], bucket=traffic["bucket"],
                                                     datasets=(data, data, data), device=device)
        self.outputs: Dict[int, np.ndarray] = {}

    def warm(self):
        """One request of each size the window sends (a size is a shape:
        one row a scene)."""
        first = {}
        for i, s in enumerate(self.sizes):
            first.setdefault(int(s), i)
        for i in first.values():
            self.predictor.predict(*self.requests[i])
        if self.device != "cpu":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Dict:
        """Every request due in [0, seconds), each sent at its time or, if
        the predictor is busy, as soon as it is free."""
        due, start, end, ok = [], [], [], []
        period = 1.0 / self.rate
        t0 = time.perf_counter()
        for i, (obs, ids) in enumerate(self.requests):
            d = t0 + i * period
            wait = d - time.perf_counter()
            if wait > 0:
                with record_function("bench.wait"):
                    time.sleep(wait)
            s = time.perf_counter()
            try:
                with record_function("bench.request"):
                    out = self.predictor.predict(obs, ids)
                good = out.shape[1] == len(ids) and bool(np.isfinite(out).all())
            except Exception as exc:          # a failed request is counted, the loop goes on
                print(f"request {i} failed: {exc!r}", file=sys.stderr, flush=True)
                out, good = None, False
            e = time.perf_counter()
            if i in self.checked:
                self.outputs[i] = out
            due.append(d - t0), start.append(s - t0), end.append(e - t0), ok.append(good)
        return {"t_end": max(end), "due": np.array(due), "start": np.array(start),
                "end": np.array(end), "ok": np.array(ok), "work": self.work,
                "attempted": len(ok), "failed": int(len(ok) - sum(ok)), "unit": "request"}

    def release(self):
        del self.predictor
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict[str, float]:
        """The checked requests' futures against the reference's in float64;
        with `control`, the reference's own in float32 with TF32 on, in the
        program's place."""
        want = self._futures(torch.float64)
        if control:
            got = self._futures(torch.float32, tf32=True)
        else:
            got = [self.outputs.get(i) for i in self.checked]
        pairs = [(g if g is not None else np.full_like(w, np.nan), w) for g, w in zip(got, want)]
        return judge.future_numbers(pairs)

    def _futures(self, dtype: torch.dtype, tf32: bool = False) -> List[np.ndarray]:
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            ref = Reference(self.config, self.root, dtype, self.device)
            out = []
            for i in self.checked:
                per_scene = scene_futures(ref, self.pool.obs, self.pool.starts, self.pool.counts,
                                          self.scenes[i])
                out.append(np.concatenate(per_scene, axis=1))
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
