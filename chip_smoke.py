#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: the text-query serving paths on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile     # PERF.md section 5's breakdown instead

Needs one CUDA card; without one it exits 1 and prints no result. Phases,
each printing one line (any failed check raises, and the script exits
non-zero):

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds the kernels of ``csrc/`` for sm_90a.
3. kernels  B1 (chunk-max sweep) over 1,000,000 x 768 bf16 rows, B in
            {1, 8, 32}, n_valid = N - 1000, 0.1% tombstones, against its
            plain torch version (atol 1e-3) and the full top-k against the
            exact reference (tie-aware, atol 5e-4); B3 (fused attention) at
            ViT-L/14 shapes, B in {1, 8}, against its plain version
            (atol = rtol = 2e-2); B2 (int8 chunk-max sweep) over 10,000,000 x
            768 int8 rows made on the card in blocks from a seeded
            ``torch.Generator`` and quantized by ``symmetric_int8`` (7.68 GB),
            B in {1, 8, 32}, n_valid = N - 1000, 0.1% tombstones, a group of
            exactly tied rows: chunk maxima ``torch.equal`` to the plain
            version, ``topk_search_int8`` at k = 20 and 100 equal to the
            blockwise ``int8_reference`` (tie-aware with atol 0).
4. slice    ``create_system`` on cuda with seeded random ViT-L/14 towers in
            bf16 (loading runs the self-test, which runs B3), an index of
            1,000,000 x 768 rows from ``numpy.random.default_rng(0)``;
            8 text requests through RequestHandler -> search ->
            format_results, one image query through search_by_image (B3),
            one ``search_batch`` of 8 and 8 concurrent requests through
            QueryBatcher, every answer checked against the exact reference
            over the same device rows.
5. int8     the int8 capacity mode: the same 1,000,000 rows quantized by
            ``quantize_rows_int8`` behind an int8 index (``load_system`` on a
            real int8 ``.rvdb`` with the bf16 copy where h5py imports, else
            ``attach_container`` over an in-memory stand-in; the container's
            dtype selects the int8 mode), served by a second system: 8
            requests through RequestHandler -> search -> format_results, one
            ``search_batch`` of 8 (exactly one B2 launch) and 8 concurrent
            QueryBatcher requests, every answer equal to ``int8_reference``
            over the same device rows and scales (atol 0); then the 8
            requests again with ``int8_rescore``, equal to a host f32 rescore
            of the top (k x factor) candidates of ``int8_reference``.
6. numbers  p50/p95 text-query latency (encode + search, 24 warm queries)
            of both slices, kernel vs plain times (CUDA events).

Each slice sets every launch count to 0 just before it runs and reads the
counts just after; the kernels' JSON line reports B1 and B3 from the bf16
slice and B2 from the int8 slice.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

``--profile`` runs phases 1-2, then serves the same 1M rows in bf16 and in
int8 and prints one JSON line per query phase (search, encode, search_vectors
at B=1 and 32, search_batch at B=32): wall p50/p95 of 20 warm calls, each
ended by a synchronize, then a ``torch.profiler`` trace of 20 more calls
giving the device busy time (the union of kernel, copy and memset
intervals), device ops per call and the milliseconds of each kernel; the
idle share is 1 - busy / mean untraced wall. It checks no answers and
prints no ``ok`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (  # noqa: E402
    native,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (  # noqa: E402
    tie_aware_equal,
)

N_ROWS = 1_000_000
N_INT8 = 10_000_000   # the int8 kernel phase: capacity scale
DIM = 768
N_REQUESTS = 8
N_LATENCY = 24
ATOL_CHUNK = 1e-3  # chunk maxima: summation order differs
TOL_MHA = 2e-2     # bf16 attention output


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class Timer:
    """Mean milliseconds per call: CUDA events on a card, host clock else."""

    def __init__(self, device) -> None:
        self.device = device

    def __call__(self, fn, iters: int = 10) -> float:
        import torch

        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(device, n_rows: int, dim: int, timer: Timer, require_kernels: bool):
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention, topk

    gen = torch.Generator(device=device).manual_seed(0)
    n_pad = -(-n_rows // topk.TILE_N) * topk.TILE_N
    x = torch.randn(n_pad, dim, generator=gen, device=device)
    x = (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    n_valid = n_rows - 1000
    dead = (torch.rand(n_pad, generator=gen, device=device) < 1e-3).to(torch.int8)
    record = {}
    for b in (1, 8, 32):
        q = torch.randn(b, dim, generator=gen, device=device)
        q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
        got = topk.chunk_max_sweep(x, q, n_valid, dead)
        ref = topk.chunk_max_plain(x, q, n_valid, dead)
        if device.type == "cuda":
            torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        if not torch.equal(fin, torch.isfinite(got)):
            raise AssertionError(f"B1 B={b}: masked chunks differ from the plain version")
        err = float((got[fin] - ref[fin]).abs().max())
        if err > ATOL_CHUNK:
            raise AssertionError(f"B1 B={b}: chunk maxima differ by {err} > {ATOL_CHUNK}")
        for k in (20, 100):
            res = topk.topk_search(x, q, k, n_valid=n_valid, deleted=dead)
            oracle = topk.topk_masked_reference(x, q, k, n_valid, deleted=dead)
            for i in range(b):
                tie_aware_equal(res.indices[i].cpu().numpy(), res.scores[i].cpu().numpy(),
                                oracle.indices[i].cpu().numpy(),
                                oracle.scores[i].cpu().numpy())
        record[b] = err
        log("kernels", f"B1 chunk_max_sweep N={n_rows} (pad {n_pad}) D={dim} bf16 B={b}: "
            f"max_abs_err={err:.3e} vs plain; topk k=20,100 tie-aware equal to the exact reference")
    b1 = {"max_abs_err": max(record.values())}
    for b in (1, 8, 32):
        q = torch.randn(b, dim, generator=gen, device=device).to(torch.bfloat16)
        ms = timer(lambda: topk.chunk_max_sweep(x, q, n_valid, dead), iters=20)
        plain = timer(lambda: topk.chunk_max_plain(x, q, n_valid, dead), iters=5)
        gbs = n_pad * dim * 2 / (ms * 1e-3) / 1e9
        log("numbers", f"B1 B={b}: kernel {ms:.4f} ms ({gbs:.0f} GB/s of rows), "
            f"plain {plain:.4f} ms")
        if b == 8:
            b1.update(ms=ms, plain_ms=plain)
    del x, dead

    # B3 at ViT-L/14 attention shapes
    t, d, h = 257, 1024, 16
    mha = {"max_abs_err": 0.0}
    for b in (1, 8):
        q, k, v = (torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(3))
        got = attention.fused_mha(q, k, v, h)
        ref = attention._einsum_attention(q, k, v, h)
        err = float((got.float() - ref.float()).abs().max())
        if not torch.allclose(got.float(), ref.float(), atol=TOL_MHA, rtol=TOL_MHA):
            raise AssertionError(f"B3 B={b}: max abs err {err} beyond atol=rtol={TOL_MHA}")
        mha["max_abs_err"] = max(mha["max_abs_err"], err)
        log("kernels", f"B3 fused_mha B={b} T={t} D={d} H={h} bf16: max_abs_err={err:.3e} "
            f"vs plain (atol=rtol={TOL_MHA})")
        if b == 8:
            mha["ms"] = timer(lambda: attention.fused_mha(q, k, v, h), iters=20)
            mha["plain_ms"] = timer(lambda: attention._einsum_attention(q, k, v, h), iters=20)
            log("numbers", f"B3 B=8: kernel {mha['ms']:.4f} ms, plain {mha['plain_ms']:.4f} ms")
    if require_kernels and (topk.chunk_max_sweep.launches == 0
                            or attention.fused_mha.launches == 0):
        raise AssertionError("a kernel comparison ran without launching its kernel")
    return b1, mha


def check_int8_kernels(device, n_rows: int, dim: int, timer: Timer, require_kernels: bool):
    """B2 against its plain version, and the two-phase int8 search against
    the full-matrix reference, at capacity scale."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk

    gen = torch.Generator(device=device).manual_seed(0)
    n_pad = -(-n_rows // topk.TILE_N) * topk.TILE_N
    x_i8 = torch.zeros((n_pad, dim), dtype=torch.int8, device=device)
    xs = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    for s in range(0, n_rows, 262_144):
        e = min(s + 262_144, n_rows)
        blk = torch.randn(e - s, dim, generator=gen, device=device)
        q8, sc = quant.symmetric_int8(blk / blk.norm(dim=-1, keepdim=True), dim=-1)
        x_i8[s:e] = q8
        xs[s:e] = sc[:, 0]
    # a group of exactly tied rows spread over the corpus
    src = n_rows // 2 + 17
    ties = [5, n_rows // 10 + 3, n_rows - 2000]
    x_i8[ties] = x_i8[src].clone()
    xs[ties] = xs[src].clone()
    n_valid = n_rows - 1000
    dead = (torch.rand(n_pad, generator=gen, device=device) < 1e-3).to(torch.int8)
    dead[ties + [src]] = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    log("kernels", f"B2 rows: {n_rows} x {dim} int8 (pad {n_pad}, "
        f"{n_pad * dim / 1e9:.2f} GB) made on {device} in {time.perf_counter() - t0:.1f} s")
    queries, errs = {}, {}
    for b in (1, 8, 32):
        q = torch.randn(b, dim, generator=gen, device=device)
        q[0] = x_i8[src].float()        # lands on the tie group
        queries[b] = q
        q_i8 = quant.symmetric_int8(q, dim=-1)[0]
        got = quant.int8_chunk_max_sweep(x_i8, xs, q_i8, n_valid, dead)
        ref = quant.int8_chunk_max_plain(x_i8, xs, q_i8, n_valid, dead)
        if device.type == "cuda":
            torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        if not torch.equal(fin, torch.isfinite(got)):
            raise AssertionError(f"B2 B={b}: masked chunks differ from the plain version")
        errs[b] = float((got[fin] - ref[fin]).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"B2 B={b}: chunk maxima differ from the plain version by "
                                 f"{errs[b]}")
        for k in (20, 100):
            res = quant.topk_search_int8(x_i8, xs, q, k, n_valid=n_valid, deleted=dead)
            oracle = quant.int8_reference(x_i8[:n_valid], xs[:n_valid], q, k, deleted=dead)
            for i in range(b):
                tie_aware_equal(res.indices[i].cpu().numpy(), res.scores[i].cpu().numpy(),
                                oracle.indices[i].cpu().numpy(),
                                oracle.scores[i].cpu().numpy(), atol=0.0)
            if sorted(res.indices[0, :4].tolist()) != sorted(ties + [src]):
                raise AssertionError(f"B2 B={b} k={k}: the tie group is not the top 4")
        log("kernels", f"B2 int8_chunk_max_sweep N={n_rows} (pad {n_pad}) D={dim} int8 B={b}: "
            f"max_abs_err={errs[b]:.3e}, chunk maxima equal to plain (torch.equal); "
            "topk_search_int8 k=20,100 equal to int8_reference (tie-aware, atol 0), tie "
            "group on top")
    b2 = {"max_abs_err": max(errs.values())}
    for b in (1, 8, 32):
        q_i8 = quant.symmetric_int8(queries[b], dim=-1)[0]
        ms = timer(lambda: quant.int8_chunk_max_sweep(x_i8, xs, q_i8, n_valid, dead), iters=20)
        plain = timer(lambda: quant.int8_chunk_max_plain(x_i8, xs, q_i8, n_valid, dead),
                      iters=3)
        search = timer(lambda: quant.topk_search_int8(x_i8, xs, queries[b], 20,
                                                      n_valid=n_valid, deleted=dead), iters=10)
        gbs = n_pad * dim / (ms * 1e-3) / 1e9
        log("numbers", f"B2 B={b}: kernel {ms:.4f} ms ({gbs:.0f} GB/s of rows; read floor "
            f"{n_pad * dim / 3.35e12 * 1e3:.2f} ms at 3.35 TB/s), plain {plain:.4f} ms; "
            f"topk_search_int8 k=20 {search:.4f} ms")
        if b == 8:
            b2.update(ms=ms, plain_ms=plain)
    if require_kernels and quant.int8_chunk_max_sweep.launches == 0:
        raise AssertionError("the B2 comparison ran without launching its kernel")
    return b2


# ---------------------------------------------------------------------------
# phase 4: the slice end to end
# ---------------------------------------------------------------------------


def synthetic_rows_bf16_bits(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """(n, dim) rows from numpy.random.default_rng(seed), as bf16 bits
    (round to nearest even), made in blocks to bound host memory."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, dim), np.uint16)
    for s in range(0, n, 131_072):
        e = min(s + 131_072, n)
        bits = rng.standard_normal((e - s, dim), dtype=np.float32).view(np.uint32)
        out[s:e] = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    return out


def synthetic_record(i: int) -> dict:
    """Keyframe metadata of row i: 1000 keyframes per video, one per second."""
    return {"folder": f"video_{i // 1000:04d}", "image": f"{i % 1000:06d}.jpg",
            "frame_id": (i % 1000) * 25, "row_id": i, "pts_time": float(i % 1000),
            "fps": 25.0}


class MemoryContainer:
    """The read interface of the port's ``index.container.IndexContainer``
    over rows held in memory (for machines without h5py)."""

    mode = "r"
    path = None
    dtype = "bfloat16"
    num_thumbnails = 0
    num_images = 0

    def __init__(self, bits: np.ndarray) -> None:
        self._bits = bits
        self.dim = bits.shape[1]

    @property
    def num_rows(self) -> int:
        return len(self._bits)

    num_metadata = num_rows

    def read_embeddings(self, start: int = 0, end: int | None = None,
                        as_float32: bool = False) -> np.ndarray:
        block = self._bits[start:end]
        return native.bf16_to_f32(block) if as_float32 else block

    def iter_metadata(self):
        return (synthetic_record(i) for i in range(self.num_rows))

    def deleted_rows(self) -> set:
        return set()

    def get_ann(self):
        return None

    def stats(self):
        from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import (
            ContainerStats,
        )

        return ContainerStats(path="<memory>", num_rows=self.num_rows, dim=self.dim,
                              dtype=self.dtype, num_thumbnails=0, num_images=0,
                              num_metadata=self.num_rows, file_bytes=0, journal_files=0)

    def close(self) -> None:
        pass


def open_index(system, bits: np.ndarray, workdir: Path) -> str:
    """Serve the rows through the facade: a real .rvdb via load_system
    where h5py imports, else attach_container over MemoryContainer."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex

    try:
        import h5py  # noqa: F401
    except ImportError:
        index = UnifiedIndex(system._index_config(), device=system.device)
        index.attach_container(MemoryContainer(bits))
        system.attach_index(index)
        return "attach_container (in-memory stand-in; h5py is not installed)"
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import (
        IndexContainer,
    )

    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "smoke.rvdb"
    with IndexContainer(path, "w", dim=bits.shape[1], dtype="bfloat16") as c:
        for s in range(0, len(bits), 131_072):
            e = min(s + 131_072, len(bits))
            c.append_embeddings(native.bf16_to_f32(bits[s:e]))
            c.append_metadata([synthetic_record(i) for i in range(s, e)])
        c.flush_checkpoint()
    system.load_system(path)
    return f"load_system on a real .rvdb ({path.name})"


def check_hits(system, hits: list[dict], qvec: np.ndarray, limit: int) -> None:
    """Hits must equal the exact reference over the same device rows."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_exact_reference,
    )

    if len(hits) != limit:
        raise AssertionError(f"{len(hits)} hits, expected {limit}")
    index = system.index
    rows = [index.row_for(h["folder"], h["image"]) for h in hits]
    if None in rows:
        raise AssertionError("a hit names no indexed keyframe")
    scores = np.array([h["similarity_score"] for h in hits], np.float32)
    if not np.all(np.isfinite(scores)) or np.any(np.diff(scores) > 0):
        raise AssertionError("hit scores are not finite and descending")
    q = qvec / max(float(np.linalg.norm(qvec)), 1e-12)
    q = torch.from_numpy(q[None].astype(np.float32)).to(index.device, index._dev_x.dtype)
    ref = topk_exact_reference(index._dev_x[:index.ntotal], q, limit)
    tie_aware_equal(np.array(rows), scores, ref.indices[0].cpu().numpy(),
                    ref.scores[0].cpu().numpy())


def make_rows(n_rows: int, config=None) -> np.ndarray:
    t0 = time.perf_counter()
    bits = synthetic_rows_bf16_bits(n_rows, DIM if config is None
                                    else config.vision.projection_dim)
    log("slice", f"made {bits.shape[0]} x {bits.shape[1]} rows from "
        f"numpy.random.default_rng(0) in {time.perf_counter() - t0:.1f} s")
    return bits


def run_slice(device, n_rows: int, require_kernels: bool, config=None,
              bits: np.ndarray | None = None) -> dict:
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention, quant, topk
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve import (
        QueryBatcher,
        RequestHandler,
        format_results,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    if bits is None:
        bits = make_rows(n_rows, config)

    # the main path starts here: every launch count from zero
    topk.chunk_max_sweep.launches = 0
    attention.fused_mha.launches = 0
    quant.int8_chunk_max_sweep.launches = 0
    system = create_system(torch_device=device)
    if config is not None:
        system.embedder._config_override = config
    t0 = time.perf_counter()
    system.embedder.ensure_loaded()
    cfg = system.embedder.config
    log("slice", f"towers loaded in {time.perf_counter() - t0:.1f} s: text "
        f"{cfg.text.num_layers}x{cfg.text.hidden_size}, vision "
        f"{cfg.vision.num_layers}x{cfg.vision.hidden_size}, "
        f"{system.embedder.compute_dtype}; self-test ran B3 "
        f"{attention.fused_mha.launches} times")
    if require_kernels and attention.fused_mha.launches == 0:
        raise AssertionError("loading the towers launched no B3 kernel")
    t0 = time.perf_counter()
    route = open_index(system, bits, ROOT / "build" / "chip_smoke")
    del bits
    log("slice", f"index of {system.index.ntotal} rows on {system.index.device} via "
        f"{route} in {time.perf_counter() - t0:.1f} s")

    handler = RequestHandler()
    queries = [f"scene {i}: a red car driving at night past neon signs" for i in range(N_REQUESTS)]
    for i, query in enumerate(queries):
        payload = {"query": query, "limit": 10 + i, "detail_level": "standard"}
        ok, err = handler.validate_request("search", payload, client_id="smoke")
        if not ok:
            raise AssertionError(f"request rejected: {err}")
        opts = SearchOptions(limit=payload["limit"])
        before = topk.chunk_max_sweep.launches
        hits = system.search(payload["query"], opts)
        if require_kernels and topk.chunk_max_sweep.launches <= before:
            raise AssertionError("a served request launched no B1 kernel")
        prompt, _ = system._clip_prompt(payload["query"], opts)
        check_hits(system, hits, system.embedder.encode_text([prompt])[0], opts.limit)
        formatted = format_results(hits, payload["detail_level"])
        if len(formatted) != opts.limit or "frame_id" not in formatted[0]:
            raise AssertionError("format_results dropped hits or fields")
    log("slice", f"{N_REQUESTS} requests through RequestHandler -> search -> "
        "format_results: every answer has `limit` hits, tie-aware equal to the exact "
        "reference")

    size = system.embedder.input_size
    image = np.random.default_rng(1).integers(0, 256, (size, size, 3), dtype=np.uint8)
    before = attention.fused_mha.launches
    hits = system.search_by_image(image, SearchOptions(limit=10))
    if require_kernels and attention.fused_mha.launches <= before:
        raise AssertionError("an image query launched no B3 kernel")
    served = attention.fused_mha.launches
    qvec = system.embedder.encode_images(image[None])[0]
    attention.fused_mha.launches = served  # the check's own encode is not the served path
    check_hits(system, hits, qvec, 10)
    log("slice", "image query through search_by_image: 10 hits, tie-aware equal to "
        "the exact reference")

    batch_q = [f"batch query {i}: people walking on a beach at sunset" for i in range(8)]
    opts = SearchOptions(limit=20)
    before = topk.chunk_max_sweep.launches
    batch_hits = system.search_batch(batch_q, opts)
    if require_kernels and topk.chunk_max_sweep.launches != before + 1:
        raise AssertionError("search_batch did not run exactly one B1 sweep")
    prompts = [system._clip_prompt(q, opts)[0] for q in batch_q]
    qvecs = system.embedder.encode_text(prompts)
    for hits, qvec in zip(batch_hits, qvecs):
        check_hits(system, hits, qvec, opts.limit)

    batcher = QueryBatcher(system, window_ms=100.0, max_batch=8)
    batcher.start()
    answers: dict[int, list] = {}
    conc_q = [f"concurrent {i}: a dog catching a frisbee" for i in range(8)]

    def ask(i: int) -> None:
        answers[i] = batcher.search(conc_q[i], top_k=20, timeout_s=120.0)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180.0)
    finally:
        batcher.stop()
    if len(answers) != 8:
        raise AssertionError(f"QueryBatcher answered {len(answers)} of 8 requests")
    for i in range(8):
        prompt = system._clip_prompt(conc_q[i], opts)[0]
        check_hits(system, answers[i], system.embedder.encode_text([prompt])[0], 20)
    log("slice", f"search_batch of 8 and 8 concurrent QueryBatcher requests "
        f"({batcher.stats.batches} batch(es), largest {batcher.stats.max_batch_seen}) "
        "tie-aware equal to the exact reference")

    # numbers: warm single-query latency, encode + search (+ host assembly)
    lat, enc, sweep = [], [], []
    nosave = SearchOptions(limit=20, use_cache=False)
    for i in range(N_LATENCY + 4):
        text = f"latency {i}: a crowded market street in the rain"
        t0 = time.perf_counter()
        hits = system.search(text, nosave)
        t1 = time.perf_counter()
        qv = system.embedder.encode_text([text])
        t2 = time.perf_counter()
        system.index.search_vectors(qv, top_k=20)
        t3 = time.perf_counter()
        if len(hits) != 20:
            raise AssertionError("latency query returned a short answer")
        if i >= 4:
            lat.append((t1 - t0) * 1e3)
            enc.append((t2 - t1) * 1e3)
            sweep.append((t3 - t2) * 1e3)
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    log("numbers", f"text query e2e over {system.index.ntotal} rows, {len(lat)} warm "
        f"queries: p50 {p50:.3f} ms, p95 {p95:.3f} ms; encode p50 "
        f"{np.percentile(enc, 50):.3f} ms; search_vectors p50 {np.percentile(sweep, 50):.3f} ms")
    b32 = [f"throughput {i}: a goal celebration in a stadium" for i in range(32)]
    bt = []
    for r in range(4):
        t0 = time.perf_counter()
        system.search_batch([f"{q} #{r}" for q in b32], nosave)
        bt.append((time.perf_counter() - t0) * 1e3)
    log("numbers", f"search_batch B=32: {np.median(bt[1:]):.3f} ms per batch "
        f"({32e3 / np.median(bt[1:]):.0f} queries/s)")
    launches = {"b1": topk.chunk_max_sweep.launches, "b3": attention.fused_mha.launches}
    if require_kernels and (launches["b1"] == 0 or launches["b3"] == 0):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    stats = system.get_system_stats()
    system.cleanup()
    return {"launches": launches, "p50_ms": p50, "p95_ms": p95,
            "ntotal": stats["index"]["ntotal"]}


# ---------------------------------------------------------------------------
# phase 5: the int8 capacity mode end to end
# ---------------------------------------------------------------------------


class Int8MemoryContainer(MemoryContainer):
    """The read interface of an int8 container written with the bf16 copy
    (``keep_fp``), over rows held in memory: the int8 rows and scales are
    what the container's write makes of the bf16 rows (``quantize_rows_int8``),
    the bf16 copy is the bits themselves."""

    dtype = "int8"
    has_fp_rows = True

    def __init__(self, bits: np.ndarray) -> None:
        from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import (
            quantize_rows_int8,
        )

        super().__init__(bits)
        self._q = np.empty(bits.shape, np.int8)
        self._s = np.empty((len(bits),), np.float32)
        for s in range(0, len(bits), 131_072):
            e = min(s + 131_072, len(bits))
            self._q[s:e], self._s[s:e] = quantize_rows_int8(native.bf16_to_f32(bits[s:e]))

    def read_quantized(self, start: int = 0, end: int | None = None):
        return self._q[start:end], self._s[start:end]

    def read_fp_bits(self, start: int = 0, end: int | None = None) -> np.ndarray:
        return self._bits[start:end]

    def read_fp_rows(self, row_ids: np.ndarray) -> np.ndarray:
        return native.bf16_to_f32(self._bits[np.asarray(row_ids, np.int64).reshape(-1)])


def open_int8_index(system, bits: np.ndarray, workdir: Path) -> str:
    """Serve the rows as an int8 index: a real int8 .rvdb (with the bf16
    copy) via load_system where h5py imports, else attach_container over
    Int8MemoryContainer."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex

    try:
        import h5py  # noqa: F401
    except ImportError:
        index = UnifiedIndex(system._index_config(), device=system.device)
        index.attach_container(Int8MemoryContainer(bits))
        system.attach_index(index)
        return "attach_container (int8 in-memory stand-in; h5py is not installed)"
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import (
        IndexContainer,
    )

    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "smoke_int8.rvdb"
    for side in (path.with_name(path.name + ".flat8"), path):
        side.unlink(missing_ok=True)
    with IndexContainer(path, "w", dim=bits.shape[1], dtype="int8", keep_fp=True) as c:
        for s in range(0, len(bits), 131_072):
            e = min(s + 131_072, len(bits))
            c.append_embeddings(native.bf16_to_f32(bits[s:e]))
            c.append_metadata([synthetic_record(i) for i in range(s, e)])
        c.flush_checkpoint()
    system.load_system(path)
    return f"load_system on a real int8 .rvdb with the bf16 copy ({path.name})"


def check_int8_answer(index, qvecs: np.ndarray, top_k: int, answers) -> None:
    """Every answer equals int8_reference over the same device rows, scales
    and tombstones: the same scores bit for bit, ids equal except inside
    groups of exactly tied scores."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import int8_reference

    q = np.atleast_2d(np.asarray(qvecs, np.float32))
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    n = index.ntotal
    ref = int8_reference(index._dev_x[:n], index._dev_scales[:n],
                         torch.from_numpy(q).to(index.device), top_k,
                         deleted=index._dev_deleted)
    for i, hits in enumerate(answers):
        if len(hits) != min(top_k, n):
            raise AssertionError(f"{len(hits)} hits, expected {min(top_k, n)}")
        tie_aware_equal(np.array([h.metadata.row_id for h in hits]),
                        np.array([h.similarity_score for h in hits], np.float32),
                        ref.indices[i].cpu().numpy(), ref.scores[i].cpu().numpy(), atol=0.0)


def check_rescore_answer(index, qvecs: np.ndarray, top_k: int, answers) -> None:
    """``int8_rescore`` answers equal a host f32 rescore, against the
    container's bf16 rows, of the int8 candidate set widened to top_k x
    factor and taken from int8_reference (which launches no B2)."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import int8_reference

    q = np.atleast_2d(np.asarray(qvecs, np.float32))
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    n = index.ntotal
    fetch = min(n, top_k * index.config.int8_rescore_factor)
    wide = int8_reference(index._dev_x[:n], index._dev_scales[:n],
                          torch.from_numpy(q).to(index.device), fetch,
                          deleted=index._dev_deleted)
    ids, scores = wide.indices.cpu().numpy(), wide.scores.cpu().numpy()
    rows = index._container.read_fp_rows(ids.reshape(-1)).reshape(len(q), fetch, -1)
    exact = np.einsum("bd,bkd->bk", q, rows, optimize=True).astype(np.float32)
    exact = np.where(np.isfinite(scores), exact, -np.inf)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :top_k]
    want_ids = np.take_along_axis(ids, order, axis=1)
    want_scores = np.take_along_axis(exact, order, axis=1)
    for i, hits in enumerate(answers):
        got_ids = np.array([h.metadata.row_id for h in hits])
        got_scores = np.array([h.similarity_score for h in hits], np.float32)
        if not (np.array_equal(got_ids, want_ids[i])
                and np.array_equal(got_scores, want_scores[i])):
            raise AssertionError("an int8_rescore answer differs from the host f32 rescore "
                                 "of the widened candidate set")


def run_int8_slice(device, bits: np.ndarray, require_kernels: bool, config=None) -> dict:
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention, quant, topk
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve import (
        QueryBatcher,
        RequestHandler,
        format_results,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    # the int8 path starts here: every launch count from zero
    topk.chunk_max_sweep.launches = 0
    attention.fused_mha.launches = 0
    quant.int8_chunk_max_sweep.launches = 0
    system = create_system(torch_device=device)
    if config is not None:
        system.embedder._config_override = config
    t0 = time.perf_counter()
    system.embedder.ensure_loaded()
    route = open_int8_index(system, bits, ROOT / "build" / "chip_smoke")
    index = system.index
    if str(index._dev_x.dtype) != "torch.int8" or index._dev_scales is None:
        raise AssertionError(f"the int8 index holds {index._dev_x.dtype} rows")
    log("int8", f"towers loaded and index of {index.ntotal} x {index.dim} int8 rows on "
        f"{index.device} via {route} in {time.perf_counter() - t0:.1f} s")

    # record what the served path searched: the exact query vectors and the
    # index's answers, to hold them against the reference
    calls: list = []
    served = index.search_vectors

    def recording(query_vectors, top_k=20, *args, **kwargs):
        answers = served(query_vectors, top_k, *args, **kwargs)
        calls.append((np.atleast_2d(np.asarray(query_vectors, np.float32)).copy(), top_k,
                      answers))
        return answers

    index.search_vectors = recording

    def hits_match(hits: list[dict], answers) -> None:
        raw = [(h.metadata.folder, h.metadata.image, round(float(h.similarity_score), 6))
               for h in answers]
        got = [(h["folder"], h["image"], h["similarity_score"]) for h in hits]
        if got != raw:
            raise AssertionError("the facade's hits differ from the index's answer")

    handler = RequestHandler()
    queries = [f"int8 scene {i}: a red car driving at night past neon signs"
               for i in range(N_REQUESTS)]

    def serve_requests(rescore: bool) -> None:
        for i, query in enumerate(queries):
            payload = {"query": query, "limit": 10 + i, "detail_level": "standard"}
            ok, err = handler.validate_request("search", payload, client_id="smoke")
            if not ok:
                raise AssertionError(f"request rejected: {err}")
            # no result cache: every request reaches the index
            opts = SearchOptions(limit=payload["limit"], use_cache=False)
            before, n_calls = quant.int8_chunk_max_sweep.launches, len(calls)
            hits = system.search(payload["query"], opts)
            if require_kernels and quant.int8_chunk_max_sweep.launches <= before:
                raise AssertionError("a served int8 request launched no B2 kernel")
            if len(calls) != n_calls + 1 or len(hits) != opts.limit:
                raise AssertionError(f"request {i}: {len(hits)} hits, expected {opts.limit}")
            qv, top_k, answers = calls[-1]
            (check_rescore_answer if rescore else check_int8_answer)(index, qv, top_k, answers)
            hits_match(hits, answers[0])
            formatted = format_results(hits, payload["detail_level"])
            if len(formatted) != opts.limit or "frame_id" not in formatted[0]:
                raise AssertionError("format_results dropped hits or fields")

    serve_requests(rescore=False)
    log("int8", f"{N_REQUESTS} requests through RequestHandler -> search -> format_results: "
        "every answer has `limit` hits, equal to int8_reference (atol 0), each launched B2")

    batch_q = [f"int8 batch {i}: people walking on a beach at sunset" for i in range(8)]
    opts = SearchOptions(limit=20, use_cache=False)
    before, n_calls = quant.int8_chunk_max_sweep.launches, len(calls)
    batch_hits = system.search_batch(batch_q, opts)
    if require_kernels and quant.int8_chunk_max_sweep.launches != before + 1:
        raise AssertionError("search_batch did not run exactly one B2 sweep")
    if len(calls) != n_calls + 1:
        raise AssertionError("search_batch did not make one index search")
    qv, top_k, answers = calls[-1]
    check_int8_answer(index, qv, top_k, answers)
    for hits, ans in zip(batch_hits, answers):
        if len(hits) != 20:
            raise AssertionError(f"search_batch answer of {len(hits)} hits")
        hits_match(hits, ans)

    batcher = QueryBatcher(system, window_ms=100.0, max_batch=8)
    batcher.start()
    conc: dict[int, list] = {}
    conc_q = [f"int8 concurrent {i}: a dog catching a frisbee" for i in range(8)]
    n_calls = len(calls)

    def ask(i: int) -> None:
        conc[i] = batcher.search(conc_q[i], top_k=20, timeout_s=120.0)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180.0)
    finally:
        batcher.stop()
    if len(conc) != 8 or any(len(conc[i]) != 20 for i in conc):
        raise AssertionError(f"QueryBatcher answered {len(conc)} of 8 requests in full")
    for qv, top_k, answers in calls[n_calls:]:
        check_int8_answer(index, qv, top_k, answers)
    log("int8", f"search_batch of 8 (one B2 launch) and 8 concurrent QueryBatcher requests "
        f"({batcher.stats.batches} batch(es), largest {batcher.stats.max_batch_seen}) "
        "equal to int8_reference (atol 0)")

    index.config.int8_rescore = True
    serve_requests(rescore=True)
    log("int8", f"the {N_REQUESTS} requests again with int8_rescore: equal to a host f32 "
        f"rescore of int8_reference's top k x {index.config.int8_rescore_factor} candidates")
    index.config.int8_rescore = False
    del index.search_vectors   # the numbers below time the index's own method

    lat, sweep, rescored = [], [], []
    nosave = SearchOptions(limit=20, use_cache=False)
    for i in range(N_LATENCY + 4):
        text = f"int8 latency {i}: a crowded market street in the rain"
        t0 = time.perf_counter()
        hits = system.search(text, nosave)
        t1 = time.perf_counter()
        qv = system.embedder.encode_text([text])
        t2 = time.perf_counter()
        index.search_vectors(qv, top_k=20)
        t3 = time.perf_counter()
        index.config.int8_rescore = True
        index.search_vectors(qv, top_k=20)
        t4 = time.perf_counter()
        index.config.int8_rescore = False
        if len(hits) != 20:
            raise AssertionError("latency query returned a short answer")
        if i >= 4:
            lat.append((t1 - t0) * 1e3)
            sweep.append((t3 - t2) * 1e3)
            rescored.append((t4 - t3) * 1e3)
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    log("numbers", f"int8 text query e2e over {index.ntotal} rows, {len(lat)} warm queries: "
        f"p50 {p50:.3f} ms, p95 {p95:.3f} ms; search_vectors p50 "
        f"{np.percentile(sweep, 50):.3f} ms, with int8_rescore "
        f"{np.percentile(rescored, 50):.3f} ms")
    launches = {"b1": topk.chunk_max_sweep.launches, "b2": quant.int8_chunk_max_sweep.launches,
                "b3": attention.fused_mha.launches}
    if require_kernels and launches["b2"] == 0:
        raise AssertionError(f"B2 never launched on the int8 path: {launches}")
    log("int8", f"launches on the int8 path: {launches}")
    ntotal = index.ntotal
    system.cleanup()
    return {"launches": launches, "p50_ms": p50, "p95_ms": p95, "ntotal": ntotal}


# ---------------------------------------------------------------------------
# --profile: where the time of a query goes
# ---------------------------------------------------------------------------

# kernel name (as the trace shows it) of each hand-written kernel
TRACE_KERNELS = {"b1": "chunk_max_bf16_kernel", "b2": "int8_chunk_max_kernel",
                 "b3": "mha_fwd_bf16_kernel"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_time(trace: dict) -> tuple[float, int, dict]:
    """(busy ms, op count, ms per TRACE_KERNELS entry) of a chrome trace:
    busy is the union of its kernel, copy and memset intervals."""
    spans, per_kernel = [], dict.fromkeys(TRACE_KERNELS, 0.0)
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        for key, name in TRACE_KERNELS.items():
            if name in ev.get("name", ""):
                per_kernel[key] += float(ev["dur"]) / 1e3
    busy, covered = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > covered:
            busy += end - max(start, covered)
            covered = end
    return busy / 1e3, len(spans), per_kernel


def profile_phase(name: str, fn, device, workdir: Path, iters: int = 20) -> dict:
    """Wall p50/p95 of ``iters`` warm calls, each ended by a synchronize,
    then device busy time and ops per call from a trace of ``iters`` more
    (device activity only); the idle share is 1 - busy / mean wall of the
    untraced calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"

    def call() -> None:
        fn()
        if on_card:
            torch.cuda.synchronize(device)

    for _ in range(4):
        call()
    wall = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
                 ) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        traced = (time.perf_counter() - t0) * 1e3
    path = workdir / f"trace_{name}.json"
    prof.export_chrome_trace(str(path))
    busy, ops, per_kernel = device_time(json.loads(path.read_text()))
    path.unlink()
    return {"phase": name, "wall_p50_ms": float(np.percentile(wall, 50)),
            "wall_p95_ms": float(np.percentile(wall, 95)), "traced_wall_ms": traced / iters,
            "device_busy_ms": busy / iters, "idle_share": 1.0 - busy / sum(wall),
            "device_ops": ops / iters,
            **{f"{key}_ms": ms / iters for key, ms in per_kernel.items()}}


def run_profile(device, bits: np.ndarray, config=None, iters: int = 20) -> list[dict]:
    """PERF.md section 5's breakdown: the query phases over the same rows
    served in bf16, then in int8."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    workdir = ROOT / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    rows = []
    for dtype, opener in (("bf16", open_index), ("int8", open_int8_index)):
        system = create_system(torch_device=device)
        if config is not None:
            system.embedder._config_override = config
        system.embedder.ensure_loaded()
        route = opener(system, bits, workdir)
        index, emb = system.index, system.embedder
        log("profile", f"{dtype}: {index.ntotal} x {index.dim} rows via {route}")
        nosave = SearchOptions(limit=20, use_cache=False)
        fresh = iter(range(10**9))   # new text per call: no translation cache hit

        def text() -> str:
            return f"profile {next(fresh)}: a crowded market street in the rain"

        qv1, qv32 = emb.encode_text([text()]), emb.encode_text([text() for _ in range(32)])

        def rescored(qv):
            def fn():
                index.config.int8_rescore = True
                try:
                    index.search_vectors(qv, top_k=20)
                finally:
                    index.config.int8_rescore = False
            return fn

        phases = [
            ("search_e2e_B1", lambda: system.search(text(), nosave)),
            ("encode_text_B1", lambda: emb.encode_text([text()])),
            ("search_vectors_B1", lambda: index.search_vectors(qv1, top_k=20)),
            ("search_vectors_B32", lambda: index.search_vectors(qv32, top_k=20)),
            ("search_batch_B32", lambda: system.search_batch([text() for _ in range(32)],
                                                              nosave)),
        ]
        if dtype == "int8":
            phases[4:4] = [("search_vectors_B1_rescore", rescored(qv1)),
                           ("search_vectors_B32_rescore", rescored(qv32))]
        else:
            size = emb.input_size
            images = np.random.default_rng(1).integers(0, 256, (8, size, size, 3), np.uint8)
            phases.append(("encode_images_B8", lambda: emb.encode_images(images)))
        for name, fn in phases:
            row = {"dtype": dtype, **profile_phase(name, fn, device, workdir, iters)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        system.cleanup()
    return rows


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="print the per-phase time breakdown instead of the smoke")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernels

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; TF32 off")

    t0 = time.perf_counter()
    kernels.load()
    log("build", f"nvcc {' '.join(kernels.NVCC_FLAGS)} -> {kernels.build_dir()} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {kernels.last_build_seconds()} s)")
    if args.profile:
        run_profile(device, make_rows(N_ROWS))
        print(smi, flush=True)
        return 0

    timer = Timer(device)
    b1, b3 = check_kernels(device, N_ROWS, DIM, timer, require_kernels=True)
    torch.cuda.empty_cache()
    b2 = check_int8_kernels(device, N_INT8, DIM, timer, require_kernels=True)
    torch.cuda.empty_cache()
    bits = make_rows(N_ROWS)
    result = run_slice(device, N_ROWS, require_kernels=True, bits=bits)
    torch.cuda.empty_cache()
    result8 = run_int8_slice(device, bits, require_kernels=True)

    record = {"kernels": [
        {"name": "chunk_max_sweep (B1)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/chunk_max.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/topk.py:134",
         "launches": result["launches"]["b1"], **b1},
        {"name": "int8_chunk_max_sweep (B2)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/int8_sweep.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/quant.py:167",
         "launches": result8["launches"]["b2"], **b2},
        {"name": "fused_mha (B3)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/mha.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/attention.py:32",
         "launches": result["launches"]["b3"], **b3},
    ]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
