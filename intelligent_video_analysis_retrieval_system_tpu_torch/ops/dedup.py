"""Embedding-based keyframe deduplication (port of ``ops/dedup.py``).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/dedup.py``:

- keep a frame iff its cosine to the previously *kept* frame is below a
  threshold (sequential: what is kept depends on earlier decisions), over
  one batch, carried across batches, or with an ``active`` row mask;
- drop a frame that is at least ``threshold`` similar to any of the last
  ``window`` kept frames (in-scene dedup);
- single-linkage clusters within a cosine distance ``eps``, one
  centroid-nearest representative each.

The reference's ``lax.scan`` is a Python loop here over rows of a device
tensor: the carry stays on the embeddings' device, each step is a few small
launches, and nothing is read back per frame. The caller reads the (B,)
mask once per batch, as the reference fetches it once. The union-find of
the clustering runs on the host, as in the reference; its similarity matrix
is one product on the device. Torch operations, no kernel of their own.
"""

from __future__ import annotations

import numpy as np
import torch

from .normalize import l2_normalize

__all__ = [
    "sequential_dedup",
    "sequential_dedup_carry",
    "sequential_dedup_carry_masked",
    "windowed_dedup_mask",
    "cluster_representatives_mask",
]


def _scan_last_kept(
    emb: torch.Tensor,
    carry: torch.Tensor,
    threshold: float,
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep row i iff cos(row i, last kept) < threshold (and ``active[i]``);
    a kept row becomes the carry. ``emb`` rows are L2-normalized f32."""
    thr = torch.tensor(threshold, dtype=torch.float32, device=emb.device)
    last = carry.float()
    keeps = []
    for i in range(emb.shape[0]):
        e = emb[i]
        keep = torch.dot(last, e) < thr
        if active is not None:
            keep = keep & active[i]
        last = torch.where(keep, e, last)
        keeps.append(keep)
    return torch.stack(keeps), last


def sequential_dedup(embeddings: torch.Tensor, threshold: float = 0.98) -> torch.Tensor:
    """Keep mask over time-ordered embeddings: frame i is kept iff
    cos(e_i, e_last_kept) < threshold; frame 0 is always kept."""
    if embeddings.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=embeddings.device)
    emb = l2_normalize(embeddings.float())
    first = torch.ones((1,), dtype=torch.bool, device=emb.device)
    if emb.shape[0] == 1:
        return first
    keeps, _ = _scan_last_kept(emb[1:], emb[0], threshold)
    return torch.cat([first, keeps])


def sequential_dedup_carry(
    embeddings: torch.Tensor, carry: torch.Tensor, threshold: float = 0.98
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming variant: dedup a batch given the last-kept embedding of the
    previous batch. Returns (keep mask, new carry). A zero ``carry`` keeps
    the first frame (cosine 0 is below any positive threshold)."""
    if embeddings.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=embeddings.device), carry
    return _scan_last_kept(l2_normalize(embeddings.float()), carry, threshold)


def sequential_dedup_carry_masked(
    embeddings: torch.Tensor,
    carry: torch.Tensor,
    active: torch.Tensor,
    threshold: float = 0.98,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sequential_dedup_carry` with an ``active`` row mask: inactive
    rows (padding, phash-prefiltered) are never kept and never touch the
    carry, as if absent from the stream."""
    if embeddings.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=embeddings.device), carry
    return _scan_last_kept(l2_normalize(embeddings.float()), carry, threshold,
                           active=active.bool())


def windowed_dedup_mask(
    embeddings: torch.Tensor, threshold: float = 0.95, window: int = 5
) -> torch.Tensor:
    """Keep mask: drop frame i if it is >= ``threshold`` similar to ANY of
    the last ``window`` kept frames (a ring buffer of kept embeddings,
    zeros at the start)."""
    n = embeddings.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=embeddings.device)
    emb = l2_normalize(embeddings.float())
    dev = emb.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    buf = torch.zeros((window, emb.shape[1]), dtype=torch.float32, device=dev)
    pos = torch.zeros((1,), dtype=torch.int64, device=dev)
    keeps = []
    for i in range(n):
        e = emb[i]
        keep = torch.amax(buf @ e) < thr
        buf = torch.where(keep, buf.index_copy(0, pos % window, e[None]), buf)
        pos = pos + keep
        keeps.append(keep)
    return torch.stack(keeps)


def cluster_representatives_mask(embeddings, eps: float = 0.05,
                                 min_cluster: int = 1) -> np.ndarray:
    """Density-style dedup: single-linkage components of cosine distance
    <= ``eps`` (the neighbourhoods DBSCAN(eps, min_samples=2) merges), one
    representative each, the member nearest the cluster centroid.

    ``embeddings`` is a tensor (the product runs on its device) or an array
    (on the CPU). Returns a numpy keep mask."""
    n = int(embeddings.shape[0])
    if n == 0:
        return np.zeros((0,), bool)
    if n == 1:
        return np.ones((1,), bool)
    emb = l2_normalize(torch.as_tensor(embeddings, dtype=torch.float32))
    sims = (emb @ emb.T).cpu().numpy()
    adj = (1.0 - sims) <= eps

    # union-find over the adjacency
    parent = list(range(n))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    rows, cols = np.nonzero(np.triu(adj, k=1))
    for a, b in zip(rows.tolist(), cols.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    clusters: dict[int, list[int]] = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(i)

    keep = np.zeros(n, bool)
    emb_np = emb.cpu().numpy()
    for members in clusters.values():
        if len(members) < min_cluster:
            continue
        if len(members) == 1:
            keep[members[0]] = True
            continue
        sub = emb_np[members]
        centroid = sub.mean(axis=0)
        centroid /= max(np.linalg.norm(centroid), 1e-12)
        rep = members[int(np.argmax(sub @ centroid))]
        keep[rep] = True
    return keep
