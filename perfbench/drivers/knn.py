"""Batched k-NN of keyframe vectors: ``UnifiedIndex.search_vectors``,
exact, closed loop, a fixed number of query vectors a call.

Set-up: the configuration's int8 rows and their scales on the device behind
a ``UnifiedIndex``, a pool of query blocks (noisy copies of indexed rows, as
when newly ingested keyframes are checked against the archive) on the
host, and every shape a call takes warmed. The window runs calls back to
back until ``--seconds`` have passed; the rate is the vectors answered over
the time from the first call's start to the last call's end. Of each call's
answers a few rows drawn from the seed are kept (so the window holds no
growing heap of answers); after the window the program is freed and a
sample of those, drawn from the seed, is compared with an exact search
under the int8 metric.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import data
from ..reference import compare, search
from . import common


def _kept_rows(seed: int, call: int, per_call: int, keep: int) -> np.ndarray:
    """The rows of call ``call`` whose answers are kept for the check."""
    rng = np.random.default_rng([data.seed64(seed), call])
    return np.sort(rng.choice(per_call, min(keep, per_call), replace=False))


def run(ctx: common.Context) -> common.Outcome:
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    k, per_call = int(tr["top_k"]), int(tr["queries_per_call"])
    keep = int(tr["kept_per_call"])
    n, dim = int(cfg["index"]["rows"]), int(cfg["index"]["dim"])
    rows, scales = data.rows_int8(common.padded(n), dim, ctx.seed + 1, dev)
    ctx.log("index rows made")
    index = common.index_over(ctx, rows, n, scales)
    pool_q, _ = data.noisy_queries(rows, scales, n, per_call * int(tr["pool_calls"]),
                                   float(tr["noise"]), ctx.seed)
    blocks = pool_q.reshape(int(tr["pool_calls"]), per_call, dim)
    unwrap = ctx.tracer.wrap(index, "search_vectors", "search_vectors")
    for _ in range(int(tr["warm_calls"])):
        index.search_vectors(blocks[-1], top_k=k, exact=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.log("shapes warmed")
    ctx.setup_done()

    kept: dict[int, tuple[np.ndarray, list]] = {}
    ends: list[float] = []
    short = 0

    def call(c: int) -> None:
        nonlocal short
        answers = index.search_vectors(blocks[c % len(blocks)], top_k=k, exact=True)
        ends.append(time.perf_counter())
        short += sum(len(hits) < k for hits in answers)
        pick = _kept_rows(ctx.seed, c, per_call, keep)
        kept[c] = (pick, [answers[r] for r in pick])

    start, length = ctx.slice_bounds()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and not ctx.tracer.taken and time.perf_counter() - t0 >= start:
            with ctx.tracer.slice():
                s0 = time.perf_counter()
                while time.perf_counter() - s0 < length:
                    call(len(ends))
            continue
        call(len(ends))
    window_s = ends[-1] - t0
    unwrap()
    memory = common.peak_bytes(dev)
    del index
    common.free_device()

    # the reference over a sample of the kept answers
    kept_at = [(c, int(r), hits) for c in sorted(kept) for r, hits in zip(*kept[c])]
    pick = common.sample(len(kept_at), int(tr["check_sample"]), ctx.seed)
    got = [kept_at[i][2] for i in pick]
    counts = np.array([len(h) for h in got])
    ids = np.array([[h.metadata.row_id for h in hits] + [0] * (k - len(hits)) for hits in got])
    scores = np.array([[h.similarity_score for h in hits] + [0.0] * (k - len(hits))
                       for hits in got])
    q = np.stack([blocks[kept_at[i][0] % len(blocks), kept_at[i][1]] for i in pick])
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    qd = torch.from_numpy(q).to(dev)
    ref_s, _ = search.int8_topk(rows, scales, n, qd, k)
    ref_of = search.int8_scores(rows, scales, qd, torch.from_numpy(ids).to(dev))
    numbers = compare.search_numbers(ids, scores, counts, ref_s[:, k - 1], ref_of)
    calls = len(ends)
    done = calls * per_call
    return common.Outcome(
        attempted=done, failed=short,
        end_to_end={"queries_per_s": done / window_s},
        numbers=numbers,
        records={"calls": calls, "queries_per_call": per_call, "window_s": window_s,
                 "t0": t0, "call_ends": ends},
        notes=[f"window {window_s:.3f} s, {calls} calls of {per_call} vectors, "
               f"{len(pick)} compared"],
        memory_peak_bytes=memory)


def control(ctx: common.Context) -> dict:
    """The program's numbers and the control's over ``check_sample``
    vectors: the program has no path below int8, so the reference in int4
    (rows and queries requantized to +-7) takes its place."""
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    k, n, dim = int(tr["top_k"]), int(cfg["index"]["rows"]), int(cfg["index"]["dim"])
    rows, scales = data.rows_int8(common.padded(n), dim, ctx.seed + 1, dev)
    qh, _ = data.noisy_queries(rows, scales, n, int(tr["check_sample"]), float(tr["noise"]),
                               ctx.seed)
    q = torch.from_numpy(qh / np.maximum(np.linalg.norm(qh, axis=-1, keepdims=True), 1e-12)).to(dev)
    ref_s, _ = search.int8_topk(rows, scales, n, q, k)
    index = common.index_over(ctx, rows, n, scales)
    ids, sc, counts = common.hits(index.search_vectors(qh, top_k=k, exact=True))
    del index
    ref_of = search.int8_scores(rows, scales, q, torch.from_numpy(ids).to(dev))
    out = {"program": compare.search_numbers(ids, sc, counts, ref_s[:, k - 1], ref_of)}
    c_s, c_i = search.int8_topk(rows, scales, n, q, k, row_levels=7, q_levels=7)
    ref_of = search.int8_scores(rows, scales, q, c_i)
    out["control"] = compare.search_numbers(c_i.cpu().numpy(), c_s.cpu().numpy(),
                                            np.full(len(q), k), ref_s[:, k - 1], ref_of)
    return out
