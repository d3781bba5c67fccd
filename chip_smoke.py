#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: the text-query serving path on one GPU.

    python3 chip_smoke.py

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
            (atol = rtol = 2e-2).
4. slice    ``create_system`` on cuda with seeded random ViT-L/14 towers in
            bf16 (loading runs the self-test, which runs B3), an index of
            1,000,000 x 768 rows from ``numpy.random.default_rng(0)``;
            8 text requests through RequestHandler -> search ->
            format_results, one image query through search_by_image (B3),
            one ``search_batch`` of 8 and 8 concurrent requests through
            QueryBatcher, every answer checked against the exact reference
            over the same device rows.
5. numbers  p50/p95 text-query latency (encode + search, 24 warm queries),
            kernel vs plain times (CUDA events).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
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

from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (  # noqa: E402
    tie_aware_equal,
)

N_ROWS = 1_000_000
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
        if as_float32:
            return (block.astype(np.uint32) << 16).view(np.float32)
        return block

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
            c.append_embeddings((bits[s:e].astype(np.uint32) << 16).view(np.float32))
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


def run_slice(device, n_rows: int, require_kernels: bool, config=None) -> dict:
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention, topk
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve import (
        QueryBatcher,
        RequestHandler,
        format_results,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    t0 = time.perf_counter()
    bits = synthetic_rows_bf16_bits(n_rows, DIM if config is None
                                    else config.vision.projection_dim)
    log("slice", f"made {bits.shape[0]} x {bits.shape[1]} rows from "
        f"numpy.random.default_rng(0) in {time.perf_counter() - t0:.1f} s")

    # the main path starts here: every launch count from zero
    topk.chunk_max_sweep.launches = 0
    attention.fused_mha.launches = 0
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


def main() -> int:
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

    timer = Timer(device)
    b1, b3 = check_kernels(device, N_ROWS, DIM, timer, require_kernels=True)
    torch.cuda.empty_cache()
    result = run_slice(device, N_ROWS, require_kernels=True)

    record = {"kernels": [
        {"name": "chunk_max_sweep (B1)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/chunk_max.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/topk.py:134",
         "launches": result["launches"]["b1"], **b1},
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
