"""Curve bases and least-squares fits for the descriptor evaluation.

A copy of `eigentrajectory_tpu/analysis/curves.py` (NumPy and SciPy only):
Bernstein (Bézier) bases from log-gamma binomials, B-spline bases from
scipy, the two-endpoint linear basis, and the control-point fit, solved in
closed form through the pseudo-inverse (the reference approaches the same
minimizer with a long Adam loop).
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln


def binom(n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Binomial coefficients via lgamma; 0 where n < k."""
    mask = n >= k
    n, k = mask * n, mask * k
    a = gammaln(n + 1) - gammaln(n - k + 1) - gammaln(k + 1)
    return np.exp(a) * mask


def bezier_basis(degree: int = 3, step: int = 13) -> np.ndarray:
    """Bernstein basis polynomials, (step, degree+1)."""
    t = np.linspace(0.0, 1.0, step)[:, None]
    i = np.arange(0, degree + 1, dtype=float)[None, :]
    coef = binom(np.full(degree + 1, float(degree)), np.arange(degree + 1, dtype=float))
    # NOTE: the reference raises (1-t) to i.flip(0) == degree - i.
    return coef[None, :] * (t ** i) * ((1 - t) ** (degree - i))


def bspline_basis(cpoint: int = 7, degree: int = 2, step: int = 13) -> np.ndarray:
    """B-spline basis via scipy, (step, cpoint+1): clamped knots, NaN -> 0."""
    from scipy.interpolate import BSpline

    cpoint = cpoint + 1
    steps = np.linspace(0.0, 1.0, step)
    knot = cpoint - degree + 1
    knots_qu = np.concatenate([np.zeros(degree), np.linspace(0, 1, knot), np.ones(degree)])
    bs = np.zeros([step, cpoint])
    for i in range(cpoint):
        bs[:, i] = BSpline(knots_qu, (np.arange(cpoint) == i).astype(float),
                           degree, extrapolate=False)(steps)
    return np.nan_to_num(bs)


def linear_basis(step: int) -> np.ndarray:
    """Two-endpoint linear basis, (step, 2)."""
    return np.stack([np.linspace(0, 1, step), np.linspace(1, 0, step)], axis=1)


def curve_fit_lstsq(traj: np.ndarray, basis: np.ndarray) -> np.ndarray:
    """Least-squares control-point fit + reconstruction.

    traj: (N, T, dim); basis: (T, n_cp). Returns recon (N, T, dim), the
    exact optimum of the squared reconstruction error.
    """
    pinv = np.linalg.pinv(basis)                 # (n_cp, T)
    cp = np.einsum("ct,ntd->ncd", pinv, traj)
    return np.einsum("tc,ncd->ntd", basis, cp)
