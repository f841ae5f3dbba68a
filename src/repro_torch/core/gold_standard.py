"""The paper's Gold Standard (Section III): objectives + eqns (1)/(2).
A copy of `repro.core.gold_standard`; the fit is numpy's `lstsq` on
the host, as in the reference.

Three objectives:
  1. Ideal clocking  — f_sys == f_BRAM (memory is the only clock limit).
  2. Ideal scaling   — peak perf scales linearly to 100% of BRAMs.
  3. Ideal reduction — array-level reduction latency follows

         L(N, P) = a * N * log2(P) + b * P + c          (1)
         L_block(N, k) = a * N * log2(k)                 (2)

     with implementation parameters in the gold ranges (Table III):

         1/N <= a <= 2,    0 <= b <= 1,    0 <= c.

The curve-fit of (1) against a design's measured reduction cycles is the
paper's diagnostic instrument (Table IX): `a` exposes slow adds, `b` slow
data movement, `c` overhead outside the reduction network.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Eqns (1) and (2)
# ---------------------------------------------------------------------------

def array_reduction_gold(n_bits: float, p: float, a: float, b: float, c: float) -> float:
    """Eqn (1): array-level reduction latency (cycles)."""
    if p < 1:
        raise ValueError("P must be >= 1")
    return a * n_bits * math.log2(max(p, 1.0)) + b * p + c


def inblock_reduction_gold(n_bits: float, k: float, a: float) -> float:
    """Eqn (2): in-block reduction latency (cycles)."""
    return a * n_bits * math.log2(max(k, 1.0))


@dataclasses.dataclass(frozen=True)
class GoldRange:
    """Ideal parameter ranges (Table III)."""

    n_bits: int

    @property
    def a_min(self) -> float:
        return 1.0 / self.n_bits

    a_max: float = 2.0
    b_min: float = 0.0
    b_max: float = 1.0
    c_min: float = 0.0

    def classify(self, a: float, b: float, c: float, tol: float = 0.05) -> Dict[str, str]:
        """Map fitted parameters to the paper's speed interpretations."""
        def speed(v, lo, hi):
            if v < lo - tol:
                return "Fast"          # below ideal floor: faster than standard
            if v <= hi + tol:
                return "Standard"
            if v <= 4 * hi:
                return "Slow"
            return "Very Slow"

        out = {
            "addition": speed(a, self.a_min, self.a_max),
            "movement": speed(b, self.b_min, self.b_max),
        }
        # paper-style verdicts: near-smallest values are "Fast"
        if a <= 2 * self.a_min + tol:
            out["addition"] = "Fast"
        if 0.0 <= b <= 0.1:
            out["movement"] = "Fast"
        out["in_gold_range"] = str(
            (self.a_min - tol <= a <= self.a_max + tol)
            and (self.b_min - tol <= b <= self.b_max + tol)
            and (c >= self.c_min - tol)
        )
        return out


# ---------------------------------------------------------------------------
# Curve fitting (Table IX)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReductionFit:
    a: float
    b: float
    c: float
    rmse: float
    n_bits: int

    def interpretation(self) -> Dict[str, str]:
        return GoldRange(self.n_bits).classify(self.a, self.b, self.c)


def fit_reduction_model(
    latency_fn: Callable[[int, int], float],
    n_bits: int,
    p_values: Sequence[int] = (2, 4, 8, 16, 32, 64, 128, 256),
    nonneg: bool = True,
) -> ReductionFit:
    """Least-squares fit of eqn (1) to measured/modelled reduction cycles.

    `latency_fn(n_bits, p)` returns total reduction cycles for `p` partial
    sums at `n_bits` precision. Linear in (a, b, c): solve the normal
    equations, then clamp to the non-negative orthant (the paper's ranges
    never use negative parameters) with re-projection.
    """
    ps = np.asarray([p for p in p_values if p >= 2], dtype=np.float64)
    y = np.asarray([latency_fn(n_bits, int(p)) for p in ps], dtype=np.float64)
    X = np.stack([n_bits * np.log2(ps), ps, np.ones_like(ps)], axis=1)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    if nonneg:
        coef = _nonneg_lstsq(X, y, coef)
    resid = X @ coef - y
    rmse = float(np.sqrt(np.mean(resid**2)))
    return ReductionFit(float(coef[0]), float(coef[1]), float(coef[2]), rmse, n_bits)


def _nonneg_lstsq(X: np.ndarray, y: np.ndarray, coef: np.ndarray) -> np.ndarray:
    """Tiny active-set projection: clamp negative coords to 0 and re-solve
    over the remaining columns until all coefficients are >= 0."""
    active = [True] * X.shape[1]
    coef = coef.copy()
    for _ in range(X.shape[1] + 1):
        neg = [i for i in range(X.shape[1]) if active[i] and coef[i] < 0]
        if not neg:
            break
        for i in neg:
            active[i] = False
            coef[i] = 0.0
        cols = [i for i in range(X.shape[1]) if active[i]]
        if not cols:
            break
        sub, *_ = np.linalg.lstsq(X[:, cols], y, rcond=None)
        for j, i in enumerate(cols):
            coef[i] = sub[j]
    return np.maximum(coef, 0.0)


# ---------------------------------------------------------------------------
# Objective scoring (the "absolute metric")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GoldScore:
    """Absolute Gold-Standard score of a PIM design (paper §III).

    clock_fraction    f_sys / f_BRAM          (1.0 = ideal clocking)
    scaling_fraction  BRAMs used as PIM / all (1.0 = ideal scaling)
    bandwidth_fraction = product — fraction of the device's internal BRAM
                        bandwidth the design actually exploits.
    """

    name: str
    clock_fraction: float
    scaling_fraction: float
    reduction_fit: Optional[ReductionFit] = None

    @property
    def bandwidth_fraction(self) -> float:
        return self.clock_fraction * self.scaling_fraction

    @property
    def is_gold(self) -> bool:
        ok = self.clock_fraction >= 0.999 and self.scaling_fraction >= 0.999
        if self.reduction_fit is not None:
            ok = ok and self.reduction_fit.interpretation()["in_gold_range"] == "True"
        return ok


def score_published(name: str) -> GoldScore:
    """Score a published design from the Table I/VIII registry."""
    from .fpga_devices import PUBLISHED

    p = PUBLISHED[name]
    return GoldScore(
        name=name,
        clock_fraction=p.rel_f_sys if p.rel_f_sys is not None else float("nan"),
        scaling_fraction=p.bram_util if p.bram_util is not None else float("nan"),
    )
