"""Served text queries: ``POST /api/search`` on the program's
``RetrievalServer`` under an open-loop Poisson schedule.

The end-to-end quantity is ``query_p95_ms``, the 95th percentile of all
requests, at a rate below the knee. No cell of ``BENCHMARK.json`` runs this
driver yet: it, the generator and the sweep are the starting point of the
served cell that waits under Open questions in ``PERF.md``.

Set-up: the towers from the seed, the configuration's index rows on the
device behind a ``UnifiedIndex`` and the facade, the server on a free
local port with the micro-batcher as the traffic file sets it, the
shapes of every batch bucket warmed directly and through HTTP, and the
load generator (``perfbench/loadgen.py``) started in its own process with
the schedule and its connections open. The window opens when the generator
is told to start; each request is timed from its due time to the last byte
of its answer. After the window the program is freed and a sample of the
answers, drawn from the seed and holding the longest query, is compared
with the reference: the frozen tokenizer, the float32 text tower, and an
exact float32 search of the same rows.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import data, weights
from ..reference import clip as ref_clip
from ..reference import compare, search, tokenizer
from . import common


def _post(port: int, texts: list[str], limit: int, threads: int = 8) -> None:
    """Warm the HTTP path: every text answered with 200."""
    todo = iter(texts)
    lock = threading.Lock()
    errors: list[str] = []

    def client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while True:
                with lock:
                    text = next(todo, None)
                if text is None:
                    return
                conn.request("POST", "/api/search", json.dumps({"query": text, "limit": limit}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                if resp.status != 200:
                    errors.append(f"warm-up answered {resp.status}")
        finally:
            conn.close()

    pool = [threading.Thread(target=client) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in pool):
        raise RuntimeError(f"warm-up failed: {errors[:3]}")


def _answer(rec: dict | None) -> dict | None:
    """The parsed answer of a record, or None where it failed."""
    if rec is None or rec["status"] != 200:
        return None
    try:
        body = json.loads(rec["body"])
    except ValueError:
        return None
    return body if body.get("success") else None


class Served:
    """The served system of one run: built and warmed by the constructor,
    then one or more open-loop windows (:meth:`window`), :meth:`close`,
    and the comparison of a window's answers (:meth:`check`)."""

    def __init__(self, ctx: common.Context) -> None:
        from intelligent_video_analysis_retrieval_system_tpu_torch.serve.rest import (
            RetrievalServer)
        from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
            EnhancedRetrievalSystem)
        from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

        tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
        self.ctx = ctx
        self.k = int(tr["limit"])
        self.n = int(cfg["index"]["rows"])
        self.work = tempfile.TemporaryDirectory(prefix="perfbench_serve_")
        self.emb = common.embedder(ctx)
        ctx.log("towers loaded")
        self.rows = data.rows_bf16(common.padded(self.n), cfg["index"]["dim"], ctx.seed + 1, dev)
        ctx.log("index rows made")
        self.index = common.index_over(ctx, self.rows, self.n)
        conf = Config(config_file=None, base_dir=self.work.name, create_dirs=True, overrides={
            "api": {"batching": True, "batching_max_batch": int(tr["max_batch"]),
                    "batching_window_ms": float(tr["window_ms"]),
                    "rate_limit_per_minute": 10 ** 9},
            "logging": {"file": False}})
        self.system = EnhancedRetrievalSystem(conf, embedder=self.emb, device=dev)
        self.system.index = self.index
        self.system.is_built = True
        self.sizes: list[tuple[float, int]] = []
        search_vectors = self.index.search_vectors
        sizes = self.sizes

        def counted(q, *args, **kwargs):
            sizes.append((time.perf_counter(), len(q)))
            return search_vectors(q, *args, **kwargs)

        self.index.search_vectors = counted
        ctx.tracer.wrap(self.emb, "encode_text", "encode_text")
        ctx.tracer.wrap(self.index, "search_vectors", "search_vectors")
        # every bucket a batch of at most max_batch reaches: the text tower
        # pads to 8/32/128 rows, the sweep to 8/16/32/64 queries
        for b in tr["warm_batches"]:
            vec = self.emb.encode_text([f"a photo of warm scene {b} {i}" for i in range(b)])
            self.index.search_vectors(vec, top_k=self.k)
        self.server = RetrievalServer(self.system, host="127.0.0.1", port=0)
        self.server.run(block=False)
        ctx.tracer.wrap(self.server.batcher, "_collect", "batch_window")
        ctx.tracer.wrap(self.server.batcher, "_run_batch", "batch")
        ctx.tracer.wrap(self.system.translator, "translate_query", "translate")
        ctx.log("shapes warmed")
        _post(self.server.port, [f"a photo of a warm street number {i}"
                                 for i in range(tr["warm_requests"])], self.k)
        ctx.log("HTTP path warmed")

    def window(self, rate: float, seconds: float, seed: int, trace: bool = False) -> dict:
        """One open-loop window of Poisson arrivals at ``rate``: the
        generator started (set-up ends once it is ready), its schedule run,
        every answer awaited up to ``drain_s`` past the window."""
        ctx, tr = self.ctx, self.ctx.traffic
        offsets = data.poisson_offsets(rate, seconds, seed)
        texts = data.text_queries(len(offsets), seed)
        plan = {"port": self.server.port, "path": "/api/search",
                "connections": int(tr["connections"]),
                "deadline": seconds + float(tr["drain_s"]), "offsets": offsets.tolist(),
                "bodies": [json.dumps({"query": t, "limit": self.k}) for t in texts]}
        plan_path = Path(self.work.name) / "plan.json"
        rec_path = Path(self.work.name) / "records.json"
        plan_path.write_text(json.dumps(plan))
        gen = subprocess.Popen([sys.executable, str(Path(__file__).resolve().parent.parent
                                                    / "loadgen.py"), str(plan_path), str(rec_path)],
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            if gen.stdout.readline().strip() != "ready":
                raise RuntimeError("the load generator did not start")
            stats = self.server.batcher.stats
            req0, bat0 = stats.requests, stats.batches
            self.sizes.clear()
            ctx.setup_done()
            t_go = time.perf_counter()
            gen.stdin.write("go\n")
            gen.stdin.flush()
            if trace:
                start, length = ctx.slice_bounds()
                time.sleep(max(0.0, t_go + start - time.perf_counter()))
                with ctx.tracer.slice():
                    time.sleep(length)
            summary, _ = gen.communicate(timeout=seconds + float(tr["drain_s"]) + 60)
        finally:
            if gen.returncode is None:
                gen.kill()
                gen.wait()
        recs = json.loads(rec_path.read_text())["records"]
        answers = [_answer(r) for r in recs]
        good = [a is not None and a["count"] == self.k for a in answers]
        lat = [(r["done"] - r["due"]) * 1e3 if ok else float("inf") for r, ok in zip(recs, good)]
        t_end = max((r["done"] for r in recs if r is not None), default=t_go)
        return {"texts": texts, "answers": answers, "good": good, "latencies_ms": lat,
                "batch_requests": stats.requests - req0, "batches": stats.batches - bat0,
                "batch_sizes": [b for _, b in self.sizes], "window_s": t_end - t_go,
                "summary": summary.strip()}

    def close(self) -> None:
        """Stop the server and free the program's state (the rows stay:
        they are the harness's data)."""
        self.server.stop()
        del self.system, self.index, self.emb, self.server
        common.free_device()

    def check(self, w: dict, seed: int) -> dict[str, float]:
        """The comparison numbers of a sample of window ``w``'s answers,
        drawn from ``seed`` and holding the longest query."""
        ctx, k = self.ctx, self.k
        texts, answers, good = w["texts"], w["answers"], w["good"]
        longest = int(np.argmax([len(t.split()) for t in texts]))
        answered = [i for i, ok in enumerate(good) if ok]
        if not answered:
            return {"hit_shortfall": float("inf"), "score_gap": float("inf")}
        must = answered.index(longest) if good[longest] else None
        pick = [answered[j] for j in common.sample(len(answered), int(ctx.traffic["check_sample"]),
                                                   seed, must)]
        q = reference_queries(ctx, [texts[i] for i in pick])
        ref_s, _ = search.float_topk(self.rows, self.n, q, k)
        ids = np.array([[h["frame_id"] for h in answers[i]["results"]] for i in pick])
        got = np.array([[h["similarity_score"] for h in answers[i]["results"]] for i in pick])
        ref_of = search.float_scores(self.rows, q, torch.from_numpy(ids).to(ctx.device))
        return compare.search_numbers(ids, got, np.full(len(pick), k), ref_s[:, k - 1], ref_of)


def reference_queries(ctx: common.Context, texts: list[str]) -> torch.Tensor:
    """The reference's normalized float32 embeddings of ``texts``."""
    cfg, dev = ctx.config, ctx.device
    tc = cfg["text_config"]
    tok, eot = tokenizer.tokenize(texts, tc["vocab_size"], tc["max_position_embeddings"])
    sd = weights.make(cfg, ctx.seed, dev)
    return ref_clip.normalize(ref_clip.text_embed(sd, cfg, torch.from_numpy(tok).to(dev),
                                                  torch.from_numpy(eot).to(dev)))


def run(ctx: common.Context) -> common.Outcome:
    served = Served(ctx)
    try:
        w = served.window(float(ctx.traffic["rate"]), ctx.seconds, ctx.seed, ctx.trace)
    finally:
        memory = common.peak_bytes(ctx.device)
        served.close()
    numbers = served.check(w, ctx.seed)
    served.work.cleanup()
    good = w["good"]
    return common.Outcome(
        attempted=len(good), failed=len(good) - sum(good),
        end_to_end={"query_p95_ms": common.nearest_rank(w["latencies_ms"], 95)},
        numbers=numbers,
        records=w,
        notes=[w["summary"], f"window {w['window_s']:.3f} s, {len(good)} requests due, "
               f"{sum(good)} answered with {served.k} hits"],
        memory_peak_bytes=memory)


def control(ctx: common.Context) -> dict:
    """The program's numbers and the control's over ``check_sample`` queries
    through ``encode_text`` + ``search_vectors``: the control is the
    program's own W8A8 path (``compute_dtype="int8"``). Each is read in
    batches of 8 and of the batcher's most (the tower's smallest and largest
    buckets): the program at its worse, the control at its better."""
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    k, n = int(tr["limit"]), int(cfg["index"]["rows"])
    rows = data.rows_bf16(common.padded(n), cfg["index"]["dim"], ctx.seed + 1, dev)
    texts = data.text_queries(int(tr["check_sample"]), ctx.seed)
    q = reference_queries(ctx, texts)
    ref_s, _ = search.float_topk(rows, n, q, k)
    out = {}
    for label, dtype in (("program", ctx.config["dtype"]), ("control", "int8")):
        emb = common.embedder(ctx, dtype)
        index = common.index_over(ctx, rows, n)
        readings = []
        for mb in (8, int(tr["max_batch"])):
            answers = []
            for s in range(0, len(texts), mb):
                answers += index.search_vectors(emb.encode_text(texts[s:s + mb]), top_k=k)
            ids, sc, counts = common.hits(answers)
            ref_of = search.float_scores(rows, q, torch.from_numpy(ids).to(dev))
            readings.append(compare.search_numbers(ids, sc, counts, ref_s[:, k - 1], ref_of))
        pick = max if label == "program" else min
        out[label] = {key: pick(r[key] for r in readings) for key in readings[0]}
        del emb, index
        common.free_device()
    return out
