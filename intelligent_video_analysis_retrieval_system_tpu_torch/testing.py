"""Comparison helpers shared by the parity tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["ATOL_TOPK", "tie_aware_equal"]

# bf16/f32 search: summation order differs between programs, so top-k lists
# are compared by candidate set and sorted scores within this tolerance
ATOL_TOPK = 5e-4


def tie_aware_equal(ids_a, scores_a, ids_b, scores_b, atol: float = ATOL_TOPK) -> None:
    """Raise ``AssertionError`` unless two top-k lists agree: the sorted
    scores are allclose, and every id in one list but not the other scores
    within ``atol`` of the k-th score (a near-tie at the boundary)."""
    sa = np.sort(np.asarray(scores_a, np.float64))[::-1]
    sb = np.sort(np.asarray(scores_b, np.float64))[::-1]
    if sa.shape != sb.shape:
        raise AssertionError(f"top-k sizes differ: {sa.shape} vs {sb.shape}")
    if sa.size == 0:
        return
    err = float(np.max(np.abs(sa - sb)))
    if err > atol:
        raise AssertionError(f"sorted scores differ by {err} > {atol}")
    ia = [int(i) for i in np.asarray(ids_a)]
    ib = [int(i) for i in np.asarray(ids_b)]
    kth = min(sa[-1], sb[-1])
    score_of = dict(zip(ia, np.asarray(scores_a, np.float64)))
    score_of.update(zip(ib, np.asarray(scores_b, np.float64)))
    for row in set(ia) ^ set(ib):
        if score_of[row] - kth > atol:
            raise AssertionError(
                f"row {row} (score {score_of[row]}) is in one top-k only and "
                f"not tied with the k-th score {kth}")
