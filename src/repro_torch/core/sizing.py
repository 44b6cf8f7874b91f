"""Hot-vocab sizing model (paper §5.4, Eq. 10–12).

* affine hot-path cost fit  T_cpu(H) = c·H + c0      (least squares)
* expected decision cost    F(H) = c0 + c·(ᾱ(H)·H + (1−ᾱ(H))·(V−H))
* first-order condition     2ᾱ(H*) + (2H*−V)·ᾱ'(H*) = 1   (Eq. 12)

``optimal_h`` solves Eq. 12 numerically on the interpolated ᾱ curve and then
(as the paper does in deployment) enumerates the discrete neighbourhood and
returns argmin_H F(H).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np


def fit_affine_cost(hs: Sequence[float], times: Sequence[float]) -> Tuple[float, float]:
    """Least-squares fit of T(H) = c*H + c0. Returns (c0, c)."""
    hs = np.asarray(hs, np.float64)
    ts = np.asarray(times, np.float64)
    A = np.stack([np.ones_like(hs), hs], axis=1)
    (c0, c), *_ = np.linalg.lstsq(A, ts, rcond=None)
    return float(c0), float(c)


@dataclass
class SizingModel:
    """Composes the affine cost model with an empirical ᾱ(H) curve."""

    c0: float
    c: float
    vocab_size: int
    alpha_hs: np.ndarray      # grid of H values where ᾱ was measured
    alpha_vals: np.ndarray    # ᾱ(H) at those values (monotone, saturating)

    @classmethod
    def from_measurements(cls, vocab_size: int, cost_hs, cost_times,
                          alpha_hs, alpha_vals) -> "SizingModel":
        c0, c = fit_affine_cost(cost_hs, cost_times)
        return cls(c0=c0, c=c, vocab_size=vocab_size,
                   alpha_hs=np.asarray(alpha_hs, np.float64),
                   alpha_vals=np.asarray(alpha_vals, np.float64))

    # -- ᾱ interpolation ------------------------------------------------------
    def alpha(self, h) -> np.ndarray:
        return np.interp(np.asarray(h, np.float64), self.alpha_hs, self.alpha_vals)

    def alpha_prime(self, h) -> np.ndarray:
        h = np.asarray(h, np.float64)
        eps = np.maximum(1.0, 1e-3 * h)
        return (self.alpha(h + eps) - self.alpha(h - eps)) / (2 * eps)

    # -- Eq. 10 ---------------------------------------------------------------
    def expected_cost(self, h) -> np.ndarray:
        h = np.asarray(h, np.float64)
        a = self.alpha(h)
        return self.c0 + self.c * (a * h + (1.0 - a) * (self.vocab_size - h))

    def predicted_throughput(self, h) -> np.ndarray:
        return 1.0 / self.expected_cost(h)

    # -- Eq. 11/12 -------------------------------------------------------------
    def foc_residual(self, h) -> np.ndarray:
        """dF/dH / c = −1 + 2ᾱ(H) + (2H−V)ᾱ'(H); zero at H*."""
        h = np.asarray(h, np.float64)
        return -1.0 + 2.0 * self.alpha(h) + (2.0 * h - self.vocab_size) * \
            self.alpha_prime(h)

    def optimal_h(self, lo: int = 1, hi: int | None = None,
                  neighborhood: int = 2048) -> int:
        """H* = argmin F(H): bisection on the first-order condition, then
        discrete enumeration around the continuous optimum (paper §5.4)."""
        hi = hi or self.vocab_size
        # bisection for a sign change of the FOC residual
        grid = np.unique(np.linspace(lo, hi, 512).astype(np.int64))
        res = self.foc_residual(grid)
        sign_change = np.where(np.diff(np.sign(res)) != 0)[0]
        if len(sign_change):
            a, b = grid[sign_change[0]], grid[sign_change[0] + 1]
            for _ in range(60):
                mid = 0.5 * (a + b)
                if np.sign(self.foc_residual(mid)) == np.sign(self.foc_residual(a)):
                    a = mid
                else:
                    b = mid
            h_cont = int(round(0.5 * (a + b)))
        else:  # no interior stationary point: pick the grid minimum
            h_cont = int(grid[np.argmin(self.expected_cost(grid))])
        lo_n = max(lo, h_cont - neighborhood)
        hi_n = min(hi, h_cont + neighborhood)
        cand = np.arange(lo_n, hi_n + 1, dtype=np.int64)
        return int(cand[np.argmin(self.expected_cost(cand))])
