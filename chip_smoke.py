#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: the serving and index-build paths on one GPU.

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
6. build    the build path's kernels first: B5 (normalize) at (256, 224,
            224, 3) uint8 -> bf16 and (8, 224, 224, 3) f32 -> f32,
            ``torch.equal`` to its plain version; B4 (fused LN+MLP) at the
            ViT-L/14 vision shape (B = 8 and 256, T = 257, D = 1024, H =
            4096, bf16), the text shape (8, 77, 768; H = 3072) and one f32
            case, against its plain version (bf16: max abs difference <=
            0.01 x the output's max abs; f32: atol 5e-5). Then a system with
            seeded random ViT-L/14 towers in bf16 and ``fused_mlp=True``
            builds 8,192 keyframes of 224 x 224 x 3 in 8 video folders
            through ``build_system`` -> ``RAGBuilder.build_index`` (chunks of
            1,024, encode batches of 256): real JPEGs where PIL imports and a
            real ``.rvdb`` where h5py imports, else a ``RAGBuilder`` subclass
            that replaces only the missing piece (the route is printed).
            Checked: the report (8,192 processed, 0 failed, 8 chunks), B5
            once and B3 and B4 24 times per encode batch, the progress
            events, 256 built rows against an embedder without ``fused_mlp``
            (cosine >= 0.999), a second build that resumes and skips every
            file, 8 image queries that return their own frame first (score
            >= 0.99), 8 text requests equal to the exact reference; then
            1,024 frames built with ``index.dtype="int8"`` and served equal
            to ``int8_reference`` (atol 0).
7. numbers  p50/p95 text-query latency (encode + search, 24 warm queries)
            of both serving slices, images/s of the build, kernel vs plain
            vs library-call times (CUDA events) beside each kernel's bound.

Each slice sets every launch count to 0 just before it runs and reads the
counts just after; the kernels' JSON line reports B1 and B3 from the bf16
slice, B2 from the int8 slice and B4 and B5 from the build.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

``--profile`` runs phases 1-2, then a build of 2,048 keyframes (one JSON
line: where its wall time goes on the host and which kernels fill its
device time), then serves the same 1M rows in bf16 and in
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
TOL_LN_MLP = 1e-2  # bf16 LN+MLP: max abs difference over the output's max abs
ATOL_LN_MLP_F32 = 5e-5  # f32 LN+MLP: sums in another order, rsqrtf
N_FRAMES = 8192    # the build phase: keyframes, in N_FOLDERS video folders
N_FOLDERS = 8
N_FRAMES_INT8 = 1024

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate for their type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
            # yardstick (timed only, the port never calls it): one matmul over the
            # same rows and the max per 128-row chunk, without the masks
            lib = timer(lambda: (x @ q.T).view(n_pad // topk.CHUNK, topk.CHUNK, b).amax(dim=1),
                        iters=10)
            b1.update(ms=ms, plain_ms=plain, library_ms=lib,
                      **bound(n_pad * dim * 2 + b * dim * 2 + n_pad + n_pad // topk.CHUNK * b * 4,
                              2.0 * n_pad * dim * b, "bf16"))
            log("numbers", f"B1 B=8: bound {b1['bound_ms']:.4f} ms ({b1['bound_by']}), "
                f"library matmul + amax {lib:.4f} ms")
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
            dh = d // h

            def heads(y):
                return y.view(b, t, h, dh).transpose(1, 2)

            mha["library_ms"] = timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v)), iters=20)
            mha.update(bound(4 * b * t * d * 2, 4.0 * b * h * t * t * dh, "bf16"))
            log("numbers", f"B3 B=8: kernel {mha['ms']:.4f} ms, plain {mha['plain_ms']:.4f} ms, "
                f"library scaled_dot_product_attention {mha['library_ms']:.4f} ms, bound "
                f"{mha['bound_ms']:.4f} ms ({mha['bound_by']})")
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
            # yardstick (timed only): one int8 matmul over the same rows, the row
            # scales and the max per chunk, without the masks
            lib = None
            if device.type == "cuda":
                def int_mm():
                    dots = torch._int_mm(x_i8, q_i8.T.contiguous()).float()
                    return (dots * xs[:, None]).view(n_pad // topk.CHUNK, topk.CHUNK,
                                                     b).amax(dim=1)
                lib = timer(int_mm, iters=5)
            b2.update(ms=ms, plain_ms=plain, library_ms=lib,
                      **bound(n_pad * dim + n_pad * 4 + b * dim + n_pad
                              + n_pad // topk.CHUNK * b * 4, 2.0 * n_pad * dim * b, "int8"))
            log("numbers", f"B2 B=8: bound {b2['bound_ms']:.4f} ms ({b2['bound_by']}), "
                f"library _int_mm + scale + amax {lib} ms")
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
# phase 3b: the build path's kernels (B4, B5) against their plain versions
# ---------------------------------------------------------------------------


def check_build_kernels(device, timer: Timer, require_kernels: bool, config=None):
    """B5 (normalize) and B4 (LN+MLP half-block) at the shapes the build
    path gives them, each against its plain version; times, bounds and the
    library yardsticks (which the port never calls)."""
    import torch
    import torch.nn.functional as F

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import block, preprocess

    gen = torch.Generator(device=device).manual_seed(0)
    on_card = device.type == "cuda"
    size = 224 if config is None else config.vision.image_size
    big = 256 if config is None else 16

    # B5: uint8 -> bf16 at the build's batch, f32 -> f32 at the resize path's
    b5 = {"max_abs_err": 0.0}
    for batch, in_dtype, out_dtype in ((big, torch.uint8, torch.bfloat16),
                                       (8, torch.float32, torch.float32)):
        img = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        if in_dtype == torch.float32:
            img = img.float() + torch.rand(img.shape, generator=gen, device=device) - 0.5
        got = preprocess.normalize_images(img, dtype=out_dtype)
        ref = preprocess.normalize_images_reference(
            img, preprocess.CLIP_IMAGE_MEAN, preprocess.CLIP_IMAGE_STD, out_dtype)
        if on_card:
            torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"B5 {tuple(img.shape)} {in_dtype}->{out_dtype}: differs from "
                                 f"the plain version by {err} (must be torch.equal)")
        ms = timer(lambda: preprocess.normalize_images(img, dtype=out_dtype), iters=20)
        plain = timer(lambda: preprocess.normalize_images_reference(
            img, preprocess.CLIP_IMAGE_MEAN, preprocess.CLIP_IMAGE_STD, out_dtype), iters=10)
        bd = bound(img.numel() * (img.element_size() + got.element_size()),
                   3.0 * img.numel(), "f32")
        log("kernels", f"B5 normalize_images {tuple(img.shape)} {in_dtype} -> {out_dtype}: "
            "torch.equal to the plain version")
        log("numbers", f"B5 {tuple(img.shape)} {in_dtype}->{out_dtype}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); no single "
            "library call computes it")
        if in_dtype == torch.uint8:
            b5.update(ms=ms, plain_ms=plain, library_ms=None, **bd)
        del img, got, ref

    # B4: both towers' shapes in bf16, one f32 case
    if config is None:
        cases = [("vision B=8", (8, 257), 1024, 4096, torch.bfloat16),
                 ("vision B=256", (256, 257), 1024, 4096, torch.bfloat16),
                 ("text B=8", (8, 77), 768, 3072, torch.bfloat16),
                 ("text f32 B=8", (8, 77), 768, 3072, torch.float32)]
    else:  # CPU rehearsal: small shapes that pass the gate
        cases = [("vision B=8", (8, 17), 128, 512, torch.bfloat16),
                 ("vision B=256", (16, 17), 128, 512, torch.bfloat16),
                 ("text f32 B=8", (8, 16), 128, 256, torch.float32)]
    b4 = {"max_abs_err": 0.0}
    for name, tokens, d, h, dtype in cases:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=device)

        x = randn(*tokens, d).to(dtype)
        g, beta = 1.0 + 0.1 * randn(d), 0.1 * randn(d)
        w1, b1 = (randn(h, d) / d ** 0.5).to(dtype), 0.1 * randn(h)
        w2, b2 = (randn(d, h) / h ** 0.5).to(dtype), 0.1 * randn(d)
        args = (x, g, beta, w1, b1, w2, b2)
        got = block.fused_ln_mlp(*args)
        ref = block.fused_ln_mlp_reference(*args)
        if on_card:
            torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"B4 {name}: non-finite output")
        if dtype == torch.float32:
            if err > ATOL_LN_MLP_F32:
                raise AssertionError(f"B4 {name}: max abs err {err} > {ATOL_LN_MLP_F32}")
            tol = f"atol={ATOL_LN_MLP_F32}"
        else:
            if err > TOL_LN_MLP * top:
                raise AssertionError(f"B4 {name}: max abs err {err} > {TOL_LN_MLP} x max abs "
                                     f"{top}")
            tol = f"<= {TOL_LN_MLP} x max abs {top:.3f}"
            b4["max_abs_err"] = max(b4["max_abs_err"], err)
        log("kernels", f"B4 fused_ln_mlp {name} tokens={tokens} D={d} H={h} {dtype} "
            f"quick_gelu: max_abs_err={err:.3e} vs plain ({tol})")

        def library():
            # the unfused chain, on PyTorch's and cuBLAS's kernels
            ln = F.layer_norm(x.float(), (d,), g, beta, 1e-5).to(dtype)
            hid = F.linear(ln, w1, b1.to(dtype))
            hid = hid * torch.sigmoid(1.702 * hid)
            return x + F.linear(hid, w2, b2.to(dtype))

        n_tok = x.numel() // d
        iters = 5 if n_tok > 10_000 else 20
        ms = timer(lambda: block.fused_ln_mlp(*args), iters=iters)
        plain = timer(lambda: block.fused_ln_mlp_reference(*args), iters=3)
        lib = timer(library, iters=iters)
        esize = x.element_size()
        bd = bound(2 * x.numel() * esize + (w1.numel() + w2.numel()) * esize
                   + (3 * d + h) * 4, 4.0 * n_tok * d * h,
                   "bf16" if dtype == torch.bfloat16 else "f32")
        log("numbers", f"B4 {name}: kernel {ms:.4f} ms ({4.0 * n_tok * d * h / ms / 1e9:.1f} "
            f"TFLOP/s), plain {plain:.4f} ms, library unfused chain {lib:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if name == "vision B=256":   # the build path's shape
            b4.update(ms=ms, plain_ms=plain, library_ms=lib, **bd)
        del args, x, w1, w2, got, ref
    if require_kernels and (block.fused_ln_mlp.launches == 0
                            or preprocess.normalize_images.launches == 0):
        raise AssertionError("a kernel comparison ran without launching its kernel")
    return b4, b5


# ---------------------------------------------------------------------------
# phase 6: the build path end to end
# ---------------------------------------------------------------------------


def frame_pixels(folder: int, n: int, size: int) -> np.ndarray:
    """Keyframe ``n`` of video ``folder``: an 8 x 8 board of seeded colours."""
    cells = np.random.default_rng([folder, n]).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    return np.kron(cells, np.ones((size // 8, size // 8, 1), np.uint8))


def write_keyframes(root: Path, n_folders: int, per_folder: int, size: int,
                    have_pil: bool) -> None:
    """``root/video_XX/NNNNNN.jpg`` and ``root/../map/video_XX.csv``: real
    JPEGs where PIL imports, else files that hold the frame's seed (the
    smoke's ``_decode_one`` makes the pixels from it)."""
    import concurrent.futures as cf

    def write(job) -> None:
        folder, n = job
        path = root / f"video_{folder:02d}" / f"{n:06d}.jpg"
        if have_pil:
            from PIL import Image

            Image.fromarray(frame_pixels(folder, n, size)).save(path, format="JPEG", quality=90)
        else:
            path.write_bytes(f"{folder} {n}".encode())

    map_dir = root.parent / "map"
    map_dir.mkdir(parents=True, exist_ok=True)
    for folder in range(n_folders):
        (root / f"video_{folder:02d}").mkdir(parents=True, exist_ok=True)
        lines = ["n,pts_time,fps,frame_idx"]
        lines += [f"{n},{n / 2.0},25.0,{n * 12}" for n in range(per_folder)]
        (map_dir / f"video_{folder:02d}.csv").write_text("\n".join(lines) + "\n")
    jobs = [(f, n) for f in range(n_folders) for n in range(per_folder)]
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, jobs, chunksize=64))


class WritableMemoryContainer(MemoryContainer):
    """The write and read interface the builder and the index call, over
    rows held in memory (for machines without h5py): bf16 bits, or int8 rows
    with per-row scales as ``quantize_rows_int8`` makes them (and the bf16
    copy when ``keep_fp``), as the real container stores them."""

    mode = "a"

    def __init__(self, path: Path, dim: int, dtype: str, keep_fp: bool = False) -> None:
        if dtype not in ("bfloat16", "int8"):
            raise ValueError(f"the in-memory stand-in stores bfloat16 or int8, not {dtype}")
        self.path, self.dim, self.dtype = path, dim, dtype
        self._bits = np.zeros((0, dim), np.uint16)     # bf16 rows, or the bf16 copy
        self._q = np.zeros((0, dim), np.int8)
        self._s = np.zeros((0,), np.float32)
        self.has_fp_rows = dtype == "int8" and keep_fp
        self._meta: list[dict] = []
        self._thumbs: list[bytes] = []
        self._journal: list[str] = []
        self.maps: dict[str, str] = {}
        self.system: dict = {}
        self.checkpoints = 0

    @property
    def num_rows(self) -> int:
        return len(self._q) if self.dtype == "int8" else len(self._bits)

    @property
    def num_metadata(self) -> int:
        return len(self._meta)

    @property
    def num_thumbnails(self) -> int:
        return len(self._thumbs)

    def append_embeddings(self, rows: np.ndarray) -> tuple[int, int]:
        from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import (
            quantize_rows_int8,
        )

        rows = np.ascontiguousarray(rows, np.float32)
        start = self.num_rows
        if self.dtype == "int8":
            q, s = quantize_rows_int8(rows)
            self._q, self._s = np.concatenate([self._q, q]), np.concatenate([self._s, s])
        if self.dtype == "bfloat16" or self.has_fp_rows:
            self._bits = np.concatenate([self._bits, native.f32_to_bf16(rows)])
        return start, self.num_rows

    def append_metadata(self, records: list[dict]) -> None:
        self._meta.extend(dict(r) for r in records)

    def append_thumbnails(self, jpegs: list[bytes]) -> None:
        self._thumbs.extend(jpegs)

    def append_journal(self, hashes: list[str]) -> None:
        self._journal.extend(hashes)

    def journal_hashes(self) -> set[str]:
        return set(self._journal)

    def put_map(self, folder: str, csv_text: str) -> None:
        self.maps[folder] = csv_text

    def put_system(self, key: str, value) -> None:
        self.system[key] = value

    def flush_checkpoint(self, extra: dict | None = None) -> None:
        self.checkpoints += 1

    def repair_to_consistent(self) -> int:
        return 0

    def read_embeddings(self, start: int = 0, end: int | None = None,
                        as_float32: bool = False) -> np.ndarray:
        if self.dtype == "int8":
            q, s = self.read_quantized(start, end)
            return q.astype(np.float32) * s[:, None] if as_float32 else q
        return super().read_embeddings(start, end, as_float32)

    def read_embeddings_f32_any(self, start: int = 0, end: int | None = None) -> np.ndarray:
        return self.read_embeddings(start, end, as_float32=True)

    def read_quantized(self, start: int = 0, end: int | None = None):
        return self._q[start:end], self._s[start:end]

    def read_fp_bits(self, start: int = 0, end: int | None = None) -> np.ndarray:
        return self._bits[start:end]

    def read_fp_rows(self, row_ids: np.ndarray) -> np.ndarray:
        return native.bf16_to_f32(self._bits[np.asarray(row_ids, np.int64).reshape(-1)])

    def iter_metadata(self):
        return (dict(r) for r in self._meta)


def smoke_builder_class(have_pil: bool, have_h5py: bool):
    """``RAGBuilder`` as it is where PIL and h5py import; else a subclass
    that replaces only the missing piece: ``_decode_one`` (the frame made
    with numpy from the file's bytes) and/or ``_open_container`` (the
    in-memory stand-in, kept per output path so that a resume finds it)."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.builder import RAGBuilder

    class SmokeBuilder(RAGBuilder):
        containers: dict[str, WritableMemoryContainer] = {}

    if not have_pil:
        def _decode_one(self, path: Path):
            folder, n = (int(v) for v in Path(path).read_bytes().split())
            return frame_pixels(folder, n, self.input_size), b""

        SmokeBuilder._decode_one = _decode_one
    if not have_h5py:
        def _open_container(self, output_path: Path, resume: bool):
            key = str(output_path)
            if resume and key in self.containers:
                container = self.containers[key]
                container.repair_to_consistent()
                return container, container.journal_hashes()
            container = WritableMemoryContainer(
                output_path, self.embed_dim, self.config.dtype,
                keep_fp=getattr(self.config, "int8_rescore", False))
            self.containers[key] = container
            return container, set()

        SmokeBuilder._open_container = _open_container
    return SmokeBuilder


def run_build_slice(device, require_kernels: bool, config=None, n_frames: int = N_FRAMES,
                    n_folders: int = N_FOLDERS, n_int8: int = N_FRAMES_INT8,
                    chunk_size: int = 1024, batch_size: int = 256,
                    workdir: Path | None = None) -> dict:
    """``build_system`` -> ``RAGBuilder.build_index`` over a keyframes tree at
    the full width of CLIP ViT-L/14 with ``fused_mlp``, then the built index
    served; every check is fatal."""
    import importlib.util
    import shutil

    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import (
        attention, block, preprocess, quant, topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve import (
        RequestHandler,
        format_results,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
        SearchOptions,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    have_pil = importlib.util.find_spec("PIL") is not None
    have_h5py = importlib.util.find_spec("h5py") is not None
    workdir = workdir or ROOT / "build" / "chip_smoke" / "build_phase"
    shutil.rmtree(workdir, ignore_errors=True)
    keyframes = workdir / "keyframes"
    per_folder = n_frames // n_folders
    on_card = device.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def embedder(fused_mlp: bool) -> CLIPEmbedder:
        return CLIPEmbedder(config=config, device=device, fused_mlp=fused_mlp,
                            image_batch_size=batch_size)

    # the build path starts here: every launch count from zero
    counters = {"b1": topk.chunk_max_sweep, "b2": quant.int8_chunk_max_sweep,
                "b3": attention.fused_mha, "b4": block.fused_ln_mlp,
                "b5": preprocess.normalize_images}
    for fn in counters.values():
        fn.launches = 0
    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=workdir,
               overrides={"index": {"chunk_size": chunk_size},
                          "model": {"image_batch_size": batch_size}}),
        embedder=embedder(fused_mlp=True), device=device)
    system.builder_class = smoke_builder_class(have_pil, have_h5py)
    t0 = time.perf_counter()
    system.embedder.ensure_loaded()
    cfg = system.embedder.config
    size = cfg.vision.image_size
    n_layers = cfg.vision.num_layers
    fused = sum(blk.fused_mlp for blk in system.embedder.model.vision_model.encoder.layers)
    log("build", f"towers loaded in {time.perf_counter() - t0:.1f} s: vision "
        f"{n_layers}x{cfg.vision.hidden_size}, text {cfg.text.num_layers}x"
        f"{cfg.text.hidden_size}, {system.embedder.compute_dtype}, fused_mlp on {fused} of "
        f"{n_layers} vision blocks; the self-test launched B5 "
        f"{preprocess.normalize_images.launches}, B3 {attention.fused_mha.launches}, B4 "
        f"{block.fused_ln_mlp.launches} times")
    if require_kernels and fused != n_layers:
        raise AssertionError("fused_mlp=True did not reach every vision block")
    t0 = time.perf_counter()
    write_keyframes(keyframes, n_folders, per_folder, size, have_pil)
    log("build", f"{n_frames} keyframes of {size}x{size}x3 in {n_folders} folders written in "
        f"{time.perf_counter() - t0:.1f} s ({'real JPEGs, decoded by PIL' if have_pil else 'seed files: PIL is not installed, frames made with numpy'}); container: "
        f"{'a real .rvdb (h5py)' if have_h5py else 'in-memory stand-in (h5py is not installed)'}")

    events: list[tuple] = []
    system.on("build_progress", lambda stage, done, total: events.append((stage, done, total)))
    out_path = workdir / "index" / "built.rvdb"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    before = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    out = system.build_system(keyframes, map_dir=workdir / "map", output_path=out_path,
                              resume=True)
    sync()
    build_s = time.perf_counter() - t0
    report = out["report"]
    n_chunks = -(-n_frames // chunk_size)
    batches = sum(-(-min(chunk_size, n_frames - s) // batch_size)
                  for s in range(0, n_frames, chunk_size))
    if (report["processed"], report["failed"], report["chunks"]) != (n_frames, 0, n_chunks):
        raise AssertionError(f"build report {report}")
    launched = {k: fn.launches - before[k] for k, fn in counters.items()}
    log("build", f"build_system: {report['processed']} keyframes in {report['chunks']} chunks, "
        f"{report['failed']} failed, {build_s:.1f} s, {n_frames / build_s:.1f} images/s "
        f"(report: {report['images_per_s']:.1f}); launches {launched}")
    if require_kernels:
        want = {"b5": batches, "b3": batches * n_layers, "b4": batches * n_layers}
        got = {k: launched[k] for k in want}
        if got != want:
            raise AssertionError(f"launches on the build {got}, expected {want} "
                                 f"({batches} encode batches x {n_layers} layers)")
    stages = [e[0] for e in events]
    if (stages[0], stages[-2:]) != ("validate", ["index", "done"]) or \
            stages.count("build") != n_chunks:
        raise AssertionError(f"build_progress events out of order: {stages}")
    index = system.index
    if index.ntotal != n_frames or index.device.type != device.type:
        raise AssertionError(f"built index holds {index.ntotal} rows on {index.device}")
    meta = index.get_metadata(per_folder + 3)
    if (meta.folder, meta.image, meta.frame_id, meta.pts_time) != \
            ("video_01", "000003.jpg", 36, 1.5):
        raise AssertionError(f"metadata of row {per_folder + 3}: {meta}")

    # the built rows against an embedder without fused_mlp, on the same pixels
    # (these comparisons are not the build path: the counts are put back after)
    on_path = {k: fn.launches for k, fn in counters.items()}
    builder = system._make_builder()
    files = [keyframes / f"video_{f:02d}" / f"{n:06d}.jpg"
             for f in (0, n_folders - 1) for n in range(min(128, per_folder))]
    pixels = np.stack([builder._decode_one(path)[0] for path in files])
    rows = [index.row_for(path.parent.name, path.name) for path in files]
    built = index.read_rows_f32()[rows]
    built /= np.linalg.norm(built, axis=-1, keepdims=True)
    plain_emb = embedder(fused_mlp=False)
    plain_emb.ensure_loaded()
    w_f = system.embedder.model.vision_model.encoder.layers[0].mlp.fc1.weight
    w_p = plain_emb.model.vision_model.encoder.layers[0].mlp.fc1.weight
    if not torch.equal(w_f, w_p):
        raise AssertionError("the two embedders' seeded weights differ")
    b4_before = block.fused_ln_mlp.launches
    unfused = plain_emb.encode_images(pixels)
    if block.fused_ln_mlp.launches != b4_before:
        raise AssertionError("the embedder without fused_mlp launched B4")
    cos = np.sum(built * unfused, axis=-1)
    if cos.min() < 0.999:
        raise AssertionError(f"built rows vs the unfused embedder: min cosine {cos.min()}")
    log("build", f"{len(files)} built rows vs the same frames through an embedder with "
        f"fused_mlp=False: min cosine {cos.min():.6f} (>= 0.999)")

    # encode_images per batch, fused_mlp on and off
    batch = pixels[:batch_size] if len(pixels) >= batch_size else np.resize(
        pixels, (batch_size, *pixels.shape[1:]))
    enc = {}
    for name, emb in (("on", system.embedder), ("off", plain_emb)):
        emb.encode_images(batch)
        sync()
        t0 = time.perf_counter()
        for _ in range(2):
            emb.encode_images(batch)
        sync()
        enc[name] = (time.perf_counter() - t0) * 1e3 / 2
    log("numbers", f"encode_images B={batch_size}: {enc['on']:.1f} ms per batch with fused_mlp "
        f"({batch_size / enc['on'] * 1e3:.0f} images/s), {enc['off']:.1f} ms without "
        f"({batch_size / enc['off'] * 1e3:.0f} images/s)")
    del plain_emb
    for k, fn in counters.items():
        fn.launches = on_path[k]

    # resume: every file is journaled
    events.clear()
    out2 = system.build_system(keyframes, map_dir=workdir / "map", output_path=out_path,
                               resume=True)
    rep2 = out2["report"]
    if (rep2["skipped_resume"], rep2["processed"], rep2["resumed"]) != (n_frames, 0, True):
        raise AssertionError(f"resumed build report {rep2}")
    if system.index.ntotal != n_frames:
        raise AssertionError("the resumed build changed the row count")
    log("build", f"second build_system with resume=True: skipped_resume "
        f"{rep2['skipped_resume']}, processed 0, {system.index.ntotal} rows served")
    index = system.index

    # the built index served: image queries find their own frame, text
    # requests equal the exact reference
    for i, path in enumerate(files[::len(files) // 8][:8]):
        b5_before = preprocess.normalize_images.launches
        hits = system.search_by_image(builder._decode_one(path)[0], SearchOptions(limit=5))
        if require_kernels and preprocess.normalize_images.launches != b5_before + 1:
            raise AssertionError("an image query did not launch B5 once")
        top = hits[0]
        if (top["folder"], top["image"]) != (path.parent.name, path.name) or \
                top["similarity_score"] < 0.99:
            raise AssertionError(f"search_by_image of {path.parent.name}/{path.name}: top hit "
                                 f"{top['folder']}/{top['image']} at {top['similarity_score']}")
        if i == 0:
            log("build", f"search_by_image of a built frame: own row first at "
                f"{top['similarity_score']:.6f}, runner-up {hits[1]['similarity_score']:.6f}")
    handler = RequestHandler()
    for i in range(N_REQUESTS):
        payload = {"query": f"built scene {i}: a red car driving at night past neon signs",
                   "limit": 10 + i, "detail_level": "standard"}
        ok, err = handler.validate_request("search", payload, client_id="smoke")
        if not ok:
            raise AssertionError(f"request rejected: {err}")
        opts = SearchOptions(limit=payload["limit"], use_cache=False)
        b1_before = topk.chunk_max_sweep.launches
        hits = system.search(payload["query"], opts)
        if require_kernels and topk.chunk_max_sweep.launches <= b1_before:
            raise AssertionError("a request over the built index launched no B1 kernel")
        prompt, _ = system._clip_prompt(payload["query"], opts)
        check_hits(system, hits, system.embedder.encode_text([prompt])[0], opts.limit)
        if len(format_results(hits, payload["detail_level"])) != opts.limit:
            raise AssertionError("format_results dropped hits")
    log("build", f"the built index served: 8 image queries return their own frame first "
        f"(score >= 0.99), {N_REQUESTS} text requests through RequestHandler tie-aware equal "
        "to the exact reference")
    launches = {k: fn.launches for k, fn in counters.items()}

    # the same path with index.dtype = int8: one folder's frames
    n_int8 = min(n_int8, per_folder)
    small = workdir / "keyframes_int8"
    (small / "video_00").mkdir(parents=True)
    for n in range(n_int8):
        shutil.copy(keyframes / "video_00" / f"{n:06d}.jpg", small / "video_00" / f"{n:06d}.jpg")
    system.config.set("index.dtype", "int8")
    b2_before = quant.int8_chunk_max_sweep.launches
    out8 = system.build_system(small, map_dir=workdir / "map",
                               output_path=workdir / "index" / "built_int8.rvdb", resume=False)
    index = system.index
    if out8["report"]["processed"] != n_int8 or index._container.dtype != "int8" or \
            index._dev_x.dtype != torch.int8 or index._dev_scales is None:
        raise AssertionError(f"int8 build: report {out8['report']}, container "
                             f"{index._container.dtype}, rows {index._dev_x.dtype}")
    qvecs = system.embedder.encode_text(
        [f"int8 built {i}: people walking on a beach at sunset" for i in range(8)])
    check_int8_answer(index, qvecs, 10, index.search_vectors(qvecs, top_k=10))
    hits = system.search("a dog catching a frisbee", SearchOptions(limit=10, use_cache=False))
    if len(hits) != 10:
        raise AssertionError("the int8 built index answered short")
    b2 = quant.int8_chunk_max_sweep.launches - b2_before
    if require_kernels and b2 < 2:
        raise AssertionError("serving the int8 built index launched no B2 kernel")
    log("build", f"{n_int8} frames built again with index.dtype=int8: an int8 container, "
        f"answers equal to int8_reference (atol 0), B2 launched {b2} times")
    launches["b2"] = b2
    system.cleanup()
    return {"launches": launches, "images_per_s": n_frames / build_s, "build_s": build_s,
            "encode_ms": enc, "ntotal": n_frames}


# ---------------------------------------------------------------------------
# --profile: where the time of a query goes
# ---------------------------------------------------------------------------

# kernel name (as the trace shows it) of each hand-written kernel
TRACE_KERNELS = {"b1": "chunk_max_bf16_kernel", "b2": "int8_chunk_max_kernel",
                 "b3": "mha_fwd_bf16_kernel", "b4": "ln_mlp_bf16_kernel",
                 "b5": "normalize_kernel"}
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


def profile_build(device, config=None, n_frames: int = 2048, n_folders: int = 2,
                  chunk_size: int = 1024, batch_size: int = 256) -> dict:
    """Where a build's time goes: host wall of hashing, decode, the embed
    calls and the container writes, and the device time of the embed calls
    by kernel (a ``torch.profiler`` trace of the whole build)."""
    import importlib.util
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from intelligent_video_analysis_retrieval_system_tpu_torch.index import builder as bmod
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    have_pil = importlib.util.find_spec("PIL") is not None
    have_h5py = importlib.util.find_spec("h5py") is not None
    on_card = device.type == "cuda"
    workdir = ROOT / "build" / "chip_smoke" / "profile_build"
    shutil.rmtree(workdir, ignore_errors=True)
    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=workdir,
               overrides={"index": {"chunk_size": chunk_size},
                          "model": {"image_batch_size": batch_size}}),
        embedder=CLIPEmbedder(config=config, device=device, fused_mlp=True,
                              image_batch_size=batch_size), device=device)
    system.embedder.ensure_loaded()
    write_keyframes(workdir / "keyframes", n_folders, n_frames // n_folders,
                    system.embedder.input_size, have_pil)
    (workdir / "index").mkdir(parents=True, exist_ok=True)
    spent = {"hash": 0.0, "embed": 0.0, "chunk": 0.0, "append": 0.0}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    base = smoke_builder_class(have_pil, have_h5py)

    class TimedBuilder(base):
        def __init__(self, embed_fn, *args, **kwargs):
            def embed(batch):
                out = embed_fn(batch)
                if on_card:
                    torch.cuda.synchronize()
                return out
            super().__init__(timed("embed", embed), *args, **kwargs)

        _process_chunk = timed("chunk", base._process_chunk)

        def _open_container(self, output_path, resume):
            container, done = super()._open_container(output_path, resume)
            for name in ("append_embeddings", "append_metadata", "append_thumbnails",
                         "append_journal", "flush_checkpoint"):
                setattr(container, name, timed("append", getattr(container, name)))
            return container, done

    system.builder_class = TimedBuilder
    hash_all = bmod._hash_all
    bmod._hash_all = timed("hash", hash_all)
    try:
        with profile(activities=[ProfilerActivity.CUDA if on_card
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            out = system.build_system(workdir / "keyframes", map_dir=workdir / "map",
                                      output_path=workdir / "index" / "p.rvdb", resume=False)
            wall = time.perf_counter() - t0
    finally:
        bmod._hash_all = hash_all
    path = workdir / "trace_build.json"
    prof.export_chrome_trace(str(path))
    busy, ops, per_kernel = device_time(json.loads(path.read_text()))
    path.unlink()
    system.cleanup()
    decode = spent["chunk"] - spent["embed"] - spent["append"]
    row = {"phase": "build", "frames": out["report"]["processed"], "wall_s": wall,
           "images_per_s": out["report"]["processed"] / wall,
           "host_hash_s": spent["hash"], "host_decode_s": decode,
           "embed_calls_s": spent["embed"], "container_writes_s": spent["append"],
           "other_host_s": wall - spent["hash"] - spent["chunk"],
           "device_busy_s": busy / 1e3, "device_ops": ops,
           "idle_share": 1.0 - busy / 1e3 / wall,
           **{f"{key}_s": ms / 1e3 for key, ms in per_kernel.items()},
           "other_device_s": (busy - sum(per_kernel.values())) / 1e3}
    print(json.dumps(row), flush=True)
    return row


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
        profile_build(device)
        torch.cuda.empty_cache()
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
    del bits
    torch.cuda.empty_cache()
    b4, b5 = check_build_kernels(device, timer, require_kernels=True)
    torch.cuda.empty_cache()
    built = run_build_slice(device, require_kernels=True)

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
        {"name": "fused_ln_mlp (B4)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/ln_mlp.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/block.py:78",
         "launches": built["launches"]["b4"], **b4},
        {"name": "normalize_images (B5)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/normalize.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/preprocess.py:127",
         "launches": built["launches"]["b5"], **b5},
    ]}
    log("build", f"launches on the build path: {built['launches']}")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
