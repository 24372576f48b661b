"""What decides `correct`: the program's answers held against the
reference's, as numbers each cell's `workloads/<cell>.json` gives a limit.

Futures are compared value by value. Per-pedestrian metrics are compared
value by value where they are continuous (ADE, FDE) and against the set of
answers the reference admits where a rounding can flip them: TCC is the
best-FDE sample's, and any sample within TIE_M (plus twice the pedestrian's
own FDE gap) of the best could be it; COL counts samples that pass within
0.2 m of another pedestrian, and a sample within COL_M of that threshold
may count either way.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

OFF_M = 1e-4        # a future or an ADE/FDE further off than this is off (metres)
TCC_OFF = 1e-3      # a TCC further than this from every admitted sample's is off
COL_OFF = 1e-3      # a COL further than this outside its admitted range is off (% points;
                    # the program's percentages of S samples carry float32 rounding)
TIE_M = 1e-3        # FDE within this of the best: the sample may be the best
COL_M = 1e-3        # approach within this of the COL threshold: either way


def _max(x: np.ndarray) -> float:
    if x.size == 0:
        return 0.0
    return float("inf") if not np.isfinite(x).all() else float(x.max())


def future_numbers(pairs: List) -> Dict[str, float]:
    """pairs of (program futures, reference futures), each (S, N, T, 2):
    the widest gap (m) and the share of pedestrians off by more than
    OFF_M (%)."""
    gaps = []
    for got, want in pairs:
        got = np.asarray(got, np.float64)
        if got.shape != want.shape:
            return {"future_gap_m": float("inf"), "future_off_pct": 100.0}
        gaps.append(np.nan_to_num(np.abs(got - want), nan=np.inf).max(axis=(0, 2, 3)))
    gaps = np.concatenate(gaps)
    return {"future_gap_m": _max(gaps), "future_off_pct": float(100.0 * (gaps > OFF_M).mean())}


def metric_gaps(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per pedestrian gaps of one call's ade, fde, tcc, col (N,) from the
    reference's (`reference.metrics.evaluate`, flattened to N pedestrians)."""
    d_ade = np.abs(got["ade"] - ref["ade"])
    d_fde = np.abs(got["fde"] - ref["fde"])
    admitted = ref["fde_s"] <= ref["fde_s"].min(axis=0) + TIE_M + 2 * np.nan_to_num(d_fde, nan=0.0)
    d_tcc = np.where(admitted, np.abs(got["tcc"][None] - ref["tcc_s"]), np.inf).min(axis=0)
    lo = 100.0 * (ref["approach_s"] < 0.2 - COL_M).mean(axis=0)
    hi = 100.0 * (ref["approach_s"] < 0.2 + COL_M).mean(axis=0)
    d_col = np.maximum(np.maximum(lo - got["col"], got["col"] - hi), 0.0)
    out = {"ade": d_ade, "fde": d_fde, "tcc": d_tcc, "col": d_col}
    return {k: np.nan_to_num(v, nan=np.inf) for k, v in out.items()}


def metric_numbers(calls: List[Dict[str, np.ndarray]], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The widest ADE, FDE, TCC and COL gaps over the checked calls, and
    the share of checked pedestrians off in any of them (%)."""
    gaps = [metric_gaps(c, ref) for c in calls]
    cat = {k: np.concatenate([g[k] for g in gaps]) for k in ("ade", "fde", "tcc", "col")}
    off = ((cat["ade"] > OFF_M) | (cat["fde"] > OFF_M) | (cat["tcc"] > TCC_OFF)
           | (cat["col"] > COL_OFF))
    return {"ade_gap_m": _max(cat["ade"]), "fde_gap_m": _max(cat["fde"]),
            "tcc_gap": _max(cat["tcc"]), "col_gap_pct": _max(cat["col"]),
            "metric_off_pct": float(100.0 * off.mean())}
