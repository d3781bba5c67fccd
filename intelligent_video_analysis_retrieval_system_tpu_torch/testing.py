"""Comparison helpers shared by the parity tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["ATOL_TOPK", "tie_aware_equal", "ivf_candidate_reference"]

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


def ivf_candidate_reference(x, state, q, k: int, nprobe: int, n_valid: int, deleted=None,
                            x_scales=None):
    """Plain top-k of each query over its IVF candidate set, independent of
    ``ops.ann``'s selection: the rows of its ``nprobe`` nearest buckets
    (equal centroid scores lowest bucket first) and of the tail, live and
    untombstoned, all scored (the int8 metric ``(q_i8 . x_i8) * s_row * s_q``
    for int8 rows, f32 products with the f32 query for float rows) and
    sorted, equal scores lowest row first. Returns (scores, ids) lists of
    numpy arrays, one per query."""
    import torch

    from .ops.quant import symmetric_int8

    dead = None if deleted is None else deleted.reshape(-1)
    tail = state.tail_ids[:int(state.tail_count)]
    scores_out, ids_out = [], []
    for i in range(q.shape[0]):
        qf = q[i:i + 1].to(x.device, torch.float32)
        cs = (qf @ state.centroids.T)[0]
        probes = torch.sort(cs, descending=True, stable=True).indices[:nprobe]
        ids = torch.cat([state.bucket_ids[probes].reshape(-1), tail]).long()
        ids = ids[(ids >= 0) & (ids < n_valid)]
        if dead is not None:
            ids = ids[dead[ids] == 0]
        ids = torch.sort(ids).values
        if x_scales is not None:
            q_i8, q_s = symmetric_int8(qf, dim=-1)
            s = (x[ids].float() @ q_i8.float()[0]) * x_scales.reshape(-1)[ids] * q_s[0, 0]
        else:
            s = x[ids].float() @ qf[0]
        v, pos = torch.sort(s, descending=True, stable=True)
        scores_out.append(v[:k].cpu().numpy())
        ids_out.append(ids[pos[:k]].cpu().numpy())
    return scores_out, ids_out
