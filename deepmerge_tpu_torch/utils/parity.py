"""Label-map parity metrics.

BASELINE.md's acceptance bar is "≤0.5% label disagreement vs the reference
pipeline on CPU test tiles". Cluster ids are arbitrary on both sides, so
disagreement is measured on the PARTITION, two ways:

  * ``label_disagreement`` — fraction of pixels NOT covered by the OPTIMAL
    1:1 cluster matching (Hungarian assignment on the contingency table —
    what "percent of differing labels" means once ids are aligned);
  * ``pair_disagreement`` — Rand-style: probability that a random pixel pair
    is grouped differently by the two maps (id-free, sensitive to
    splits/merges).
"""

from __future__ import annotations

import numpy as np


def _contingency(a: np.ndarray, b: np.ndarray):
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    assert a.shape == b.shape
    na = int(a.max()) + 1 if a.size else 0
    nb = int(b.max()) + 1 if b.size else 0
    pair = a.astype(np.int64) * nb + b.astype(np.int64)
    counts = np.bincount(pair, minlength=na * nb).reshape(na, nb)
    return counts


def label_disagreement(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of pixels outside the OPTIMAL 1:1 cluster matching.

    Hungarian assignment maximizing matched pixels — greedy
    largest-cell-first can lock out a better pairing and overstate
    disagreement (e.g. contingency [[5,4],[4,0]]: greedy matches 5/13,
    optimal matches 8/13), which matters against a ≤0.5% acceptance bar.
    """
    counts = _contingency(a, b)
    total = counts.sum()
    if total == 0:
        return 0.0
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(counts, maximize=True)
    matched = int(counts[rows, cols].sum())
    return 1.0 - matched / total


def pair_disagreement(a: np.ndarray, b: np.ndarray) -> float:
    """P(random pixel pair grouped differently) — 1 − Rand index."""
    counts = _contingency(a, b).astype(np.float64)
    n = counts.sum()
    if n < 2:
        return 0.0
    sum_sq = (counts ** 2).sum()
    sum_a = (counts.sum(1) ** 2).sum()
    sum_b = (counts.sum(0) ** 2).sum()
    same_both = sum_sq - n
    same_a = sum_a - n
    same_b = sum_b - n
    agree = same_both + ((n * n - n) - same_a - same_b + same_both)
    return float(1.0 - agree / (n * n - n))
