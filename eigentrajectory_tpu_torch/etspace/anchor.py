"""Anchor refinement (the counterpart of `refine` in
`eigentrajectory_tpu/etspace/anchor.py`)."""
from __future__ import annotations

import torch


def refine(c_anchor: torch.Tensor, c_pred_refine: torch.Tensor) -> torch.Tensor:
    """Broadcast add with frozen anchors.

    c_anchor (k, s), c_pred_refine (..., k, N, s) -> (..., k, N, s).
    """
    return c_anchor.detach()[:, None, :] + c_pred_refine
