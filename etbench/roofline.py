"""The card's peaks and the least time of each hand-written kernel: a frozen
copy of the program's bound arithmetic (`chip_smoke.py`: `_bound`,
`_recon_bytes_in`, `_recon_metrics_bound_ms`, `_reconstruct_bound_ms`),
written over a launch's sizes rather than its tensors.

Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 at
3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s. The
configurations state float32 with TF32 off, so the f32 rate is the peak.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def bound_ms(read: float, write: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the f32 operations
    over the f32 rate, in ms."""
    return max((read + write) / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3


def recon_bytes_in(n: int, moving: int, k: int, samples: int, t: int) -> int:
    """Input bytes the trajectories need: the coefficients of the branch each
    pedestrian uses, the bases of the branches in use, ori, rot, sca and
    the moving mask."""
    return k * samples * 4 * n + 2 * t * k * 4 * (2 if 0 < moving < n else 1) + n * (8 + 16 + 4 + 1)


def reconstruct_bound_ms(n: int, moving: int, k: int = 6, samples: int = 20, t: int = 12) -> float:
    """`fused_reconstruct` over n pedestrians: the recon bytes in, the
    (S, n, T, 2) trajectories out; per pedestrian, sample and step 2*2*k
    FMAs, the scale and the rotate + translate."""
    return bound_ms(recon_bytes_in(n, moving, k, samples, t), samples * n * t * 2 * 4,
                    n * samples * t * (2 * 2 * k + 2 + 6))


def recon_metrics_bound_ms(n: int, moving: int, k: int = 6, samples: int = 20,
                           t: int = 12) -> float:
    """`fused_recon_metrics` over n pedestrians: also the ground truth in,
    ADE/FDE/TCC out; per pedestrian and sample the distance (5 a step), per
    pedestrian TCC (~8 a step)."""
    read = recon_bytes_in(n, moving, k, samples, t) + n * t * 2 * 4
    write = samples * n * t * 2 * 4 + 3 * n * 4
    return bound_ms(read, write, n * samples * t * (2 * 2 * k + 2 + 6 + 5) + n * t * 8)
