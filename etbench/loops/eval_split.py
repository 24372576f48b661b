"""Evaluation of a test split: `ETTorchTrainer.test(eval_batch)` called back
to back over the seed's split, each call scoring every pedestrian of it.

`test()` returns means alone, so the harness wraps the trainer's
`eval_step` on its instance and keeps the per-pedestrian ADE/FDE/TCC/COL of
a sample of the calls (drawn from the seed), the first call and the last,
to judge them once the window has closed.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import generator, judge, program
from ..reference.pipeline import Reference, scene_flops, scene_metrics

# Calls a second the sample of checked calls is drawn over (more than the
# program makes, so that a sample index may fall past the window's last call).
SAMPLE_CALLS_PER_S = 100


class Cell:
    def __init__(self, config: Dict, traffic: Dict, root: str, device: str, seed: int,
                 seconds: float):
        from eigentrajectory_tpu_torch.train import ETTorchTrainer

        self.config, self.traffic, self.root, self.device = config, traffic, root, device
        self.split = generator.make_scenes(traffic["split"], seed)
        self.eval_batch, self.n_max = traffic["eval_batch"], traffic["n_max_peds"]
        if len(self.split.counts) > self.eval_batch:
            raise ValueError("the split must fit one block of eval_batch scenes")
        g = generator.rng(seed, generator.STREAM_CHECKS)
        horizon = max(2, math.ceil(seconds * SAMPLE_CALLS_PER_S))
        self.sampled = set(int(i) for i in g.choice(horizon, min(traffic["checked_calls"], horizon),
                                                    replace=False)) | {0}
        exp = config["experiment"]
        peds = int(self.split.counts.sum())
        self.work = {"peds": peds, "slots": self.eval_batch * self.n_max,
                     "moving": int(program.moving(self.split.obs, exp["static_dist"]).sum()),
                     "flops": sum(scene_flops(config, int(c)) for c in self.split.counts)}
        cfg = program.exp_config(config, root, n_max_peds=self.n_max)
        data = program.trajectory_data(self.split)
        self.trainer = ETTorchTrainer(cfg, tag=config["tag"], datasets=(data, data, data),
                                      device=device)
        self.trainer.load_model()
        self.calls = 0
        self.kept: Dict[int, tuple] = {}
        self.last = None
        self.step = self.trainer.eval_step        # the program's, noted below

        def noted(obs, pred, valid):
            out = self.step(obs, pred, valid)
            if self.calls in self.sampled:
                self.kept[self.calls] = out
            self.last = (self.calls, out)
            return out

        self.trainer.eval_step = noted

    def warm(self):
        for _ in range(3):
            self.trainer.test(eval_batch=self.eval_batch)
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.kept.clear()

    def window(self, seconds: float) -> Dict:
        """`test()` calls one after another while the window is open."""
        start, end, ok = [], [], []
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            if s - t0 >= seconds:
                break
            try:
                means = self.trainer.test(eval_batch=self.eval_batch)
                good = all(math.isfinite(v) for v in means.values())
            except Exception as exc:          # a failed call is counted, the loop goes on
                print(f"test() call {self.calls} failed: {exc!r}", file=sys.stderr, flush=True)
                good = False
            e = time.perf_counter()
            self.calls += 1
            start.append(s - t0), end.append(e - t0), ok.append(good)
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        return {"t_end": max(end), "start": np.array(start), "end": np.array(end),
                "ok": np.array(ok), "work": [self.work] * len(ok),
                "attempted": len(ok), "failed": int(len(ok) - sum(ok)), "unit": "call"}

    def release(self):
        self.kept = {i: tuple(t.cpu().numpy().astype(np.float64) for t in out)
                     for i, out in self.kept.items()}
        self.last = None
        del self.trainer
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict[str, float]:
        """The kept calls' per-pedestrian metrics against the reference's in
        float64; with `control`, the reference's own in float32 with TF32 on,
        in the program's place."""
        want = self._metrics(torch.float64)
        if control:
            got = self._metrics(torch.float32, tf32=True)
            calls = [{k: got[k] for k in ("ade", "fde", "tcc", "col")}]
        else:
            rows = np.repeat(np.arange(len(self.split.counts)), self.split.counts)
            slots = np.arange(len(rows)) - self.split.starts[rows]
            calls = [dict(zip(("ade", "fde", "tcc", "col"), (m[rows, slots] for m in out)))
                     for _, out in sorted(self.kept.items())]
        return judge.metric_numbers(calls, want)

    def _metrics(self, dtype: torch.dtype, tf32: bool = False) -> Dict[str, np.ndarray]:
        """The reference's metrics of every pedestrian of the split, in scene
        order: (N,) and, per sample, (S, N)."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            ref = Reference(self.config, self.root, dtype, self.device)
            s = self.split
            per_scene = scene_metrics(ref, s.obs, s.pred, s.starts, s.counts,
                                      list(range(len(s.counts))))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return {k: np.concatenate([m[k] for m in per_scene], axis=-1) for k in per_scene[0]}
