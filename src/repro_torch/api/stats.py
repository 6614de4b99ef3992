"""Nonparametric statistics for multi-seed experiment comparisons.

The paper validates its headline claim with a Mann-Whitney U test over
repeated runs (Table VII: ours vs each baseline, H1 "ours stochastically
larger", α=0.05). This module is the dependency-free implementation
``run_sweep``'s :class:`SweepResult` reports are built on:

``mann_whitney_u``   — asymptotic U test with average-rank ties, tie
                       variance correction and continuity correction;
                       matches ``scipy.stats.mannwhitneyu(
                       method="asymptotic")`` (pinned in tests when
                       scipy is importable).
``median_iqr`` et al — the median/IQR summaries the paper's tables use
                       (medians, not means: run distributions are small
                       and skewed).

Pure numpy on purpose: the tier-1 suite and the sweep path must not
depend on scipy (benchmarks may still use it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

ALTERNATIVES = ("two-sided", "greater", "less")


@dataclasses.dataclass(frozen=True)
class MannWhitneyResult:
    u: float                  # U statistic of sample a
    p_value: float
    alternative: str
    n_a: int
    n_b: int

    def significant(self, alpha: float = 0.05) -> bool:
        return self.p_value < alpha

    def __str__(self):
        return (f"U={self.u:.1f} p={self.p_value:.4g} "
                f"({self.alternative}, n={self.n_a}/{self.n_b})")


def rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based), ties sharing their mean rank."""
    x = np.asarray(x, dtype=np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def _normal_sf(z: float) -> float:
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def mann_whitney_u(a: Sequence[float], b: Sequence[float],
                   alternative: str = "two-sided") -> MannWhitneyResult:
    """Mann-Whitney U test of sample ``a`` vs ``b``.

    ``alternative="greater"`` tests H1 "a stochastically larger than b"
    (the paper's direction for ours-vs-baseline). Asymptotic normal
    p-value with tie and continuity corrections — exact enough for the
    >= 5-seed sweeps this repo runs, and dependency-free.
    """
    if alternative not in ALTERNATIVES:
        raise ValueError(f"unknown alternative {alternative!r}; "
                         f"expected one of {ALTERNATIVES}")
    a = np.asarray(list(a), np.float64)
    b = np.asarray(list(b), np.float64)
    n1, n2 = len(a), len(b)
    if n1 == 0 or n2 == 0:
        raise ValueError(f"both samples need data (got n={n1}/{n2})")
    combined = np.concatenate([a, b])
    ranks = rankdata(combined)
    r1 = float(ranks[:n1].sum())
    u1 = r1 - n1 * (n1 + 1) / 2.0       # U of sample a

    n = n1 + n2
    mean = n1 * n2 / 2.0
    _, counts = np.unique(combined, return_counts=True)
    tie_term = float((counts.astype(np.float64) ** 3 - counts).sum())
    var = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1.0)))
    if var <= 0:                         # all observations identical
        p = 1.0
    else:
        sd = math.sqrt(var)
        if alternative == "greater":
            p = _normal_sf((u1 - mean - 0.5) / sd)
        elif alternative == "less":
            p = _normal_sf((mean - u1 - 0.5) / sd)
        else:
            p = min(1.0, 2.0 * _normal_sf((abs(u1 - mean) - 0.5) / sd))
    return MannWhitneyResult(u=u1, p_value=float(np.clip(p, 0.0, 1.0)),
                             alternative=alternative, n_a=n1, n_b=n2)


# ---------------------------------------------------------------------------
# summaries (the paper's tables report medians over repeated runs)
# ---------------------------------------------------------------------------

def median_iqr(x: Iterable[float]) -> Tuple[float, float, float]:
    """(median, q1, q3) with linear interpolation."""
    arr = np.asarray(list(x), np.float64)
    if arr.size == 0:
        return (float("nan"),) * 3
    q1, med, q3 = np.percentile(arr, [25.0, 50.0, 75.0])
    return float(med), float(q1), float(q3)


def summarize(samples: Dict[str, Sequence[float]]) -> List[List]:
    """[group, n, median, q1, q3] rows for a dict of sample arrays."""
    rows = []
    for name, vals in samples.items():
        med, q1, q3 = median_iqr(vals)
        rows.append([name, len(list(vals)), med, q1, q3])
    return rows
