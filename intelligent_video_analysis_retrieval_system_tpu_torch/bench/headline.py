"""The bench's sections: the headline text query over a 1M-row bf16 index
(and the same query through the sharded search on a one-device mesh), the
multi-device anchor (one card's 1,250,000-row shard of a 10M corpus over 8
cards, bf16 then int8), the image tower's throughput, the int8 capacity
mode at 10M rows, and the IVF approximate mode over the same 10M int8 rows
(and through the sharded IVF on a one-device mesh).

Counterpart of the JAX package's root ``bench.py``. Each section takes the
device and returns its keys; a section that fails raises. The sections
compose tower + search directly, as the JAX bench does: the query text is
tokenized once and token 1 is replaced by the call's number, so every call
encodes a different query without paying the tokenizer. The towers are
random from a seed (no checkpoint ships with the repository), the rows are
synthetic (``bench/data.py``).

``verify``, when given, is called after a section's timing with the rows
the section searched and every answer it got (``verify(section, x, scales,
n_valid, queries, result)``: ``scales`` None for bf16 rows, ``queries`` as
they went into the search, ``result`` a ``TopKResult`` of all of them; the
IVF sections add ``ivf=(state, nprobe)``, the structure and probe count the
answers came from): the chip smoke holds them against the references. The
served sections (``bench/served.py``) hand it their answers the same way,
with ``decimals=6``: the scores as the server rounds them.
``verify_tower``, when given to :func:`image_tower`, gets the model, the
normalized pixels of the timed batch and the embeddings the timed route gave
for them; ``verify_static`` gets the timed W8A8-static model, its scale tree
(``models.calibrate``), the first 8 of those pixels and what the timed model
gave for them.
"""

from __future__ import annotations

import gc
import sys
import tempfile
import time
from typing import Callable

import torch

from ..index.unified import UnifiedIndex
from ..models.calibrate import calibrate_act_scales, set_act_scales
from ..models.clip import CLIPConfig
from ..models.convert import empty_model
from ..ops.ann import build_ivf, default_nlist, ivf_topk
from ..ops.preprocess import normalize_images
from ..ops.quant import topk_search_int8
from ..ops.topk import TILE_N, TopKResult, _ceil_to, topk_search
from ..parallel.mesh import MeshSpec, create_mesh
from ..parallel.sharded_ann import make_sharded_ivf, sharded_ivf_topk
from ..parallel.sharded_search import place_rows, sharded_topk, sharded_topk_int8
from ..system.embedder import CLIPEmbedder
from ..system.facade import EnhancedRetrievalSystem, SearchOptions
from ..utils.config import Config
from .data import MemoryContainer, gen_db_bf16, gen_db_int8
from .timing import MIN_CALLS as CALLS
from .timing import _sync, percentile_wall

__all__ = ["K", "BASELINE_MS", "NOT_PORTED", "TextQuery", "headline_1M", "anchor_1M25",
           "image_tower", "int8_10M", "ivf_10M"]

K = 10
# the reference system's own figure for one text query over its index (ms)
BASELINE_MS = 39.0
PROMPT = "a photo of a scene"
# sections of the JAX bench whose modules the port does not have yet (every
# one is ported)
NOT_PORTED: list[str] = []

Verify = Callable[..., None]
VerifyTower = Callable[[torch.nn.Module, torch.Tensor, torch.Tensor], None]
VerifyStatic = Callable[[torch.nn.Module, dict, torch.Tensor, torch.Tensor], None]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _size_name(n: int) -> str:
    return f"{n // 1_000_000}M" if n >= 1_000_000 else f"{n // 1000}k"


class TextQuery:
    """The bench prompt through the text tower, token 1 salted per query."""

    def __init__(self, embedder: CLIPEmbedder) -> None:
        embedder.ensure_loaded()
        cfg = embedder.config.text
        tokens = embedder.tokenizer([PROMPT], cfg.max_length)
        self.model = embedder.model
        self.device = embedder.device
        self.tokens = torch.from_numpy(tokens).to(self.device)
        self.eot = torch.from_numpy(embedder.tokenizer.eot_positions(tokens)).to(self.device)
        # below the start and end tokens, the two largest ids
        self.salt_mod = min(49_000, cfg.vocab_size - 2)
        self.dim = cfg.projection_dim

    def encode(self, salt: int, batch: int = 1) -> torch.Tensor:
        """(batch, D) f32 L2-normalized embeddings on the device; query
        ``j`` of the batch carries ``salt + j`` as its token 1."""
        with torch.inference_mode():
            toks = self.tokens.repeat(batch, 1)
            toks[:, 1] = (salt + torch.arange(batch, device=self.device)) % self.salt_mod
            emb = self.model.encode_text(toks, self.eot.repeat(batch)).float()
            return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)


def one_device_mesh(device: torch.device):
    """The mesh of one ``"index"`` shard on ``device`` that the sharded
    sections time: the per-card program of the multi-device search."""
    return create_mesh(MeshSpec(axis_names=("index",), shape=(1,)), devices=[device])


def _stack(results: list[TopKResult]) -> TopKResult:
    return TopKResult(torch.cat([r.scores for r in results]),
                      torch.cat([r.indices for r in results]))


# ---------------------------------------------------------------------------
# headline: one text query over the bf16 index
# ---------------------------------------------------------------------------


def headline_1M(device: torch.device, embedder: CLIPEmbedder, rows: int,
                verify: Verify | None = None) -> dict:
    """p50/p95 of text tower + L2 normalize + ``topk_search`` (kernel B1 on a
    card) over ``rows`` x D bf16 rows, ``K = 10``; then the same query
    through ``sharded_topk`` on a one-device mesh (the JAX bench's
    ``sharded_1M``: ``latency_1M_sharded_1dev_p50_ms``), through
    ``EnhancedRetrievalSystem.search`` over an index of the same rows, and
    ``search_batch`` at 32 queries."""
    tq = TextQuery(embedder)
    n_pad = _ceil_to(rows, TILE_N)
    log(f"generating {rows} x {tq.dim} bf16 rows on {device}...")
    xd = gen_db_bf16(n_pad, tq.dim, 7, device)
    asked: list[torch.Tensor] = []
    answers: list[TopKResult] = []

    def query(i: int) -> None:
        q = tq.encode(i + 1).to(xd.dtype)
        res = topk_search(xd, q, K, n_valid=rows)
        if i >= 0:  # warm-up calls carry negative numbers
            asked.append(q)
            answers.append(res)

    t = percentile_wall(query, CALLS, device)
    log(f"{_size_name(rows)} bf16 e2e: p50={t['p50_ms']:.3f} ms p95={t['p95_ms']:.3f} ms over "
        f"{CALLS} queries (device p50 {t['device_p50_ms']})")
    if verify is not None:
        verify("headline_1M", xd, None, rows, torch.cat(asked), _stack(answers))
    out = {
        "metric": f"e2e_text_query_latency_{_size_name(rows)}_index",
        "value": round(t["p50_ms"], 3),
        "vs_baseline": round(BASELINE_MS / t["p50_ms"], 2),
        "p95": round(t["p95_ms"], 3),
        "queries": CALLS,
        "extra": {"tokenizer_kind": embedder.tokenizer.kind,
                  "headline_device_p50_ms": t["device_p50_ms"]},
    }

    out["extra"].update(_sharded_1M(device, tq, xd, rows, verify))

    # the same rows behind the facade: what a served request pays
    bits = xd[:rows].cpu().view(torch.int16).numpy().view("uint16")
    del xd
    with tempfile.TemporaryDirectory(prefix="ivars_bench_") as workdir:
        system = EnhancedRetrievalSystem(Config(config_file=None, base_dir=workdir),
                                         embedder=embedder, device=device)
        index = UnifiedIndex(system._index_config(), device=device)
        index.attach_container(MemoryContainer(bits))
        system.attach_index(index)
        try:
            nosave = SearchOptions(limit=K, use_cache=False)

            def served(i: int) -> None:
                hits = system.search(f"{PROMPT} number {i}", nosave)
                if len(hits) != min(K, rows):
                    raise RuntimeError(f"the facade answered {len(hits)} hits, not {K}")

            f = percentile_wall(served, CALLS, device)

            def served_batch(i: int) -> None:
                got = system.search_batch([f"{PROMPT} batch {i} query {j}" for j in range(32)],
                                          nosave)
                if len(got) != 32 or any(len(h) != min(K, rows) for h in got):
                    raise RuntimeError("search_batch answered short")

            b = percentile_wall(served_batch, CALLS, device)
        finally:
            system.cleanup()
    log(f"facade search: p50={f['p50_ms']:.3f} ms p95={f['p95_ms']:.3f} ms; search_batch "
        f"B=32: p50={b['p50_ms']:.3f} ms")
    out["extra"].update(facade_search_p50_ms=round(f["p50_ms"], 3),
                        facade_search_p95_ms=round(f["p95_ms"], 3),
                        search_batch_b32_ms=round(b["p50_ms"], 3))
    return out


def _sharded_1M(device: torch.device, tq: TextQuery, xd: torch.Tensor, rows: int,
                verify: Verify | None) -> dict:
    """The headline query through the sharded search on a one-device mesh,
    over the headline's rows (its one shard is a view of them)."""
    mesh = one_device_mesh(device)
    xs = place_rows(mesh, xd, xd.shape[0])
    asked: list[torch.Tensor] = []
    answers: list[TopKResult] = []

    def query(i: int) -> None:
        q = tq.encode(i + 1).to(xd.dtype)
        res = sharded_topk(mesh, xs, q, K, rows)
        if i >= 0:
            asked.append(q)
            answers.append(res)

    t = percentile_wall(query, CALLS, device)
    log(f"{_size_name(rows)} sharded (1-device mesh): p50={t['p50_ms']:.3f} ms "
        f"p95={t['p95_ms']:.3f} ms (device p50 {t['device_p50_ms']})")
    if verify is not None:
        verify("sharded_1M", xd, None, rows, torch.cat(asked), _stack(answers))
    return {"latency_1M_sharded_1dev_p50_ms": round(t["p50_ms"], 3)}


# ---------------------------------------------------------------------------
# the multi-device anchor: one card's shard of 10M rows over 8 cards
# ---------------------------------------------------------------------------


def anchor_1M25(device: torch.device, embedder: CLIPEmbedder, rows: int,
                verify: Verify | None = None) -> dict:
    """One card's shard of a corpus of ten times ``rows`` over 8 cards
    (1,250,000 rows at the default 1M), on a one-device mesh: text query +
    ``sharded_topk`` over bf16 rows (kernel B1), then + ``sharded_topk_int8``
    over int8 rows (kernel B2). The key names are the JAX bench's
    (``latency_10M_8chip_anchor_ms``, ``..._p95_ms``, ``..._int8_ms``)."""
    tq = TextQuery(embedder)
    n_a = 10 * rows // 8
    n_pad = _ceil_to(n_a, TILE_N)
    mesh = one_device_mesh(device)
    log(f"anchor: generating {n_a} x {tq.dim} bf16 rows on {device}...")
    xa = gen_db_bf16(n_pad, tq.dim, 21, device)
    xs = place_rows(mesh, xa, n_pad)

    def timed(search, cast, section: str, x, scales) -> dict:
        asked: list[torch.Tensor] = []
        answers: list[TopKResult] = []

        def query(i: int) -> None:
            q = cast(tq.encode(i + 1))
            res = search(q)
            if i >= 0:
                asked.append(q)
                answers.append(res)

        t = percentile_wall(query, CALLS, device)
        if verify is not None:
            verify(section, x, scales, n_a, torch.cat(asked), _stack(answers))
        return t

    t = timed(lambda q: sharded_topk(mesh, xs, q, K, n_a), lambda q: q.to(xa.dtype),
              "anchor_1M25", xa, None)
    log(f"anchor bf16 {n_a} sharded: p50={t['p50_ms']:.3f} ms p95={t['p95_ms']:.3f} ms")
    out = {"anchor_rows": n_a, "latency_10M_8chip_anchor_ms": round(t["p50_ms"], 3),
           "latency_10M_8chip_anchor_p95_ms": round(t["p95_ms"], 3)}
    del xa, xs
    gc.collect()
    xq, sq = gen_db_int8(n_pad, tq.dim, 22, device)
    xqs, sqs = place_rows(mesh, xq, n_pad), place_rows(mesh, sq, n_pad)
    t = timed(lambda q: sharded_topk_int8(mesh, xqs, sqs, q, K, n_a), lambda q: q,
              "anchor_1M25_int8", xq, sq)
    log(f"anchor int8 {n_a} sharded: p50={t['p50_ms']:.3f} ms p95={t['p95_ms']:.3f} ms")
    out["latency_10M_8chip_anchor_int8_ms"] = round(t["p50_ms"], 3)
    del xq, sq, xqs, sqs
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# image tower throughput
# ---------------------------------------------------------------------------


def image_tower(device: torch.device, full: bool,
                verify_tower: VerifyTower | None = None,
                verify_static: VerifyStatic | None = None) -> dict:
    """Frames per second of uint8 pixels -> ``normalize_images`` (kernel B5)
    -> vision tower (kernel B3) -> projection, in bf16: ViT-B/32 at B=256,
    or with ``full`` ViT-L/14 at B=128 (8 on the CPU). Then the same with
    the tower in W8A8 with static scales, calibrated on the timed batch
    through the dynamic twin (the JAX bench's
    ``image_tower_fps_int8_static``); both twins share the bf16 tower's
    parameters."""
    name, cfg = ("ViT-L/14", CLIPConfig.vit_l_14()) if full else \
        ("ViT-B/32", CLIPConfig.vit_b_32())
    batch = 8 if device.type == "cpu" else (128 if full else 256)
    embedder = CLIPEmbedder(config=cfg, device=device)
    embedder.ensure_loaded()
    size = cfg.vision.image_size
    gen = torch.Generator(device=device).manual_seed(0)
    px = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=device,
                       dtype=torch.uint8)

    def embed(i: int) -> None:
        with torch.inference_mode():
            embedder.model.encode_image(normalize_images(px, dtype=embedder.model.dtype))

    t = percentile_wall(embed, CALLS, device)
    fps = batch / (t["p50_ms"] / 1e3)
    log(f"image embed: {fps:.0f} frames/s ({name} bf16 B={batch}, {t['p50_ms']:.3f} ms per "
        "batch)")
    if verify_tower is not None:
        with torch.inference_mode():
            pixels = normalize_images(px, dtype=embedder.model.dtype)
            verify_tower(embedder.model, pixels, embedder.model.encode_image(pixels))
    out = {"image_tower_fps": round(fps), "image_tower": name, "image_tower_batch": batch,
           "image_tower_ms_per_batch": round(t["p50_ms"], 3)}

    dtype = embedder.model.dtype
    sd = embedder.model.state_dict()

    def twin(static: bool) -> torch.nn.Module:
        m = empty_model(cfg, "meta", dtype=dtype, w8a8=True, w8a8_static=static)
        m.load_state_dict(sd, strict=True, assign=True)
        return m.eval()

    with torch.inference_mode():
        pixels = normalize_images(px, dtype=dtype)
    scales = calibrate_act_scales(twin(False), [(pixels,)], method="encode_image")["act_scales"]
    static = twin(True)
    set_act_scales(static, scales)

    def embed_static(i: int) -> None:
        with torch.inference_mode():
            static.encode_image(normalize_images(px, dtype=dtype))

    ts = percentile_wall(embed_static, CALLS, device)
    sfps = batch / (ts["p50_ms"] / 1e3)
    log(f"image embed: {sfps:.0f} frames/s ({name} W8A8-static B={batch}, "
        f"{ts['p50_ms']:.3f} ms per batch)")
    if verify_static is not None:
        with torch.inference_mode():
            first = static.encode_image(pixels)[:8]
        verify_static(static, scales, pixels[:8], first)
    out.update(image_tower_fps_int8_static=round(sfps),
               image_tower_int8_static_ms_per_batch=round(ts["p50_ms"], 3))
    return out


# ---------------------------------------------------------------------------
# the int8 capacity mode at 10M rows
# ---------------------------------------------------------------------------


def int8_10M(device: torch.device, embedder: CLIPEmbedder, rows: int,
             verify: Verify | None = None) -> dict:
    """One text query over ``rows`` x D int8 rows (10,000,000 in a full run:
    7.7 GB on the card) through ``topk_search_int8`` (kernel B2), the query
    padded to 8 as the served path pads it; then batches of 128 and 32
    queries, and the first quarter and half of the same rows. The key names
    are the JAX bench's and say 10M, 2M5 and 5M whatever ``rows`` is;
    ``int8_rows`` says what was swept."""
    tq = TextQuery(embedder)
    n_pad = _ceil_to(rows, TILE_N)
    log(f"generating {rows} x {tq.dim} int8 rows on {device} ({n_pad * tq.dim / 1e9:.2f} GB)...")
    x10, s10 = gen_db_int8(n_pad, tq.dim, 0, device)
    pad7 = torch.zeros((7, tq.dim), dtype=torch.float32, device=device)

    def timed(n_valid: int, x: torch.Tensor, s: torch.Tensor, batch: int | None) -> dict:
        """One query padded to 8 (``batch`` None), or ``batch`` queries."""
        asked: list[torch.Tensor] = []
        answers: list[TopKResult] = []

        def query(i: int) -> None:
            if batch is None:
                q = torch.cat([tq.encode(i + 1), pad7])
            else:
                q = tq.encode(i * batch + 1, batch)
            res = topk_search_int8(x, s, q, K, n_valid=n_valid)
            # every single query is kept for verify, and the first batch
            if i >= 0 and (batch is None or i == 0):
                keep = 1 if batch is None else batch
                asked.append(q[:keep])
                answers.append(TopKResult(res.scores[:keep], res.indices[:keep]))

        t = percentile_wall(query, CALLS, device)
        if verify is not None:
            verify("int8_10M", x, s, n_valid, torch.cat(asked), _stack(answers))
        return t

    t = timed(rows, x10, s10, None)
    log(f"int8 e2e over {rows} rows: p50={t['p50_ms']:.3f} ms p95={t['p95_ms']:.3f} ms over "
        f"{CALLS} queries (device p50 {t['device_p50_ms']})")
    out = {"int8_rows": rows,
           "latency_10M_int8_1chip_p50_ms": round(t["p50_ms"], 3),
           "latency_10M_int8_1chip_p95_ms": round(t["p95_ms"], 3),
           "latency_10M_int8_device_p50_ms": t["device_p50_ms"],
           "queries_10M": CALLS}
    # B2 sweeps the rows once per query group (ops.quant.int8_sweep_plan): a
    # batch of 128 at the index's 768 is one sweep
    for b in (128, 32):
        tb = timed(rows, x10, s10, b)
        qps = b / (tb["p50_ms"] / 1e3)
        log(f"int8 batched B={b}: {tb['p50_ms']:.3f} ms per batch = {qps:.0f} queries/s")
        out[f"qps_10M_int8_1chip_b{b}"] = round(qps)
    # the first quarter and half of the same rows
    for n_small, key in ((rows // 4, "latency_2M5_int8_1chip_p50_ms"),
                         (rows // 2, "latency_5M_int8_1chip_p50_ms")):
        n_pad_s = _ceil_to(n_small, TILE_N)
        ts = timed(n_small, x10[:n_pad_s], s10[:n_pad_s], None)
        log(f"int8 e2e over {n_small} rows: p50={ts['p50_ms']:.3f} ms")
        out[key] = round(ts["p50_ms"], 3)
    del x10, s10
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# the IVF approximate mode over the 10M int8 rows
# ---------------------------------------------------------------------------


def _sharded_ivf(device: torch.device, tq: TextQuery, x10: torch.Tensor, s10: torch.Tensor,
                 state, rows: int, verify: Verify | None, nprobe: int = 32) -> dict:
    """The IVF section's state partitioned over a one-device mesh (the shard
    views the section's rows), one text query + ``sharded_ivf_topk``."""
    mesh = one_device_mesh(device)
    n_pad = x10.shape[0]
    xs, ss = place_rows(mesh, x10, n_pad), place_rows(mesh, s10, n_pad)
    sivf = make_sharded_ivf(mesh, "index", state, n_pad)
    asked: list[torch.Tensor] = []
    answers: list[TopKResult] = []

    def query(i: int) -> None:
        q = tq.encode(i + 1)
        res = sharded_ivf_topk(mesh, xs, sivf, q, K, nprobe=nprobe, n_valid=rows,
                               scales_sharded=ss)
        if i >= 0:
            asked.append(q)
            answers.append(res)

    t = percentile_wall(query, CALLS, device)
    log(f"{rows} int8 sharded IVF (1-device mesh) e2e nprobe={nprobe}: "
        f"p50={t['p50_ms']:.3f} ms p95={t['p95_ms']:.3f} ms (device p50 {t['device_p50_ms']})")
    if verify is not None:
        verify("sharded_ivf_10M", x10, s10, rows, torch.cat(asked), _stack(answers),
               ivf=(state, nprobe))
    return {f"latency_10M_int8_sharded_ivf_np{nprobe}_p50_ms": round(t["p50_ms"], 3)}


def ivf_10M(device: torch.device, embedder: CLIPEmbedder, rows: int,
            verify: Verify | None = None, keep: dict | None = None) -> dict:
    """``build_ivf`` over ``rows`` x D int8 rows (the int8 section's, made
    again from its seed) with the JAX bench's parameters (nlist 8192, or
    ``default_nlist`` where that is smaller; 48 sample rows per list; 6
    k-means iterations), timed; then one text query + ``ivf_topk`` at B=1,
    nprobe 16 and 64, and + ``sharded_ivf_topk`` over the same state
    partitioned on a one-device mesh at nprobe 32 (the per-card program of
    the multi-device IVF). The key names are the JAX bench's and say 10M
    whatever ``rows`` is. ``keep``, when given, receives the rows, their
    scales and the structure (``x``, ``scales``, ``state``) for the served
    section that follows."""
    tq = TextQuery(embedder)
    n_pad = _ceil_to(rows, TILE_N)
    log(f"IVF section: generating {rows} x {tq.dim} int8 rows on {device}...")
    x10, s10 = gen_db_int8(n_pad, tq.dim, 0, device)
    _sync(device)
    t0 = time.perf_counter()
    state, report = build_ivf(x10, n_rows=rows, x_scales=s10,
                              nlist=min(8192, default_nlist(rows)), sample_per_list=48,
                              kmeans_iters=6)
    _sync(device)
    build_s = time.perf_counter() - t0
    log(f"IVF build over {rows} rows: {build_s:.2f} s (nlist={report.nlist} "
        f"cap={report.bucket_cap} leftover={report.leftover})")
    out = {"ivf_build_10M_s": round(build_s, 2), "ivf_nlist": report.nlist,
           "ivf_bucket_cap": report.bucket_cap}
    for nprobe in (16, 64):
        asked: list[torch.Tensor] = []
        answers: list[TopKResult] = []

        def query(i: int) -> None:
            q = tq.encode(i + 1)
            res = ivf_topk(x10, state, q, K, nprobe=nprobe, n_valid=rows, x_scales=s10)
            if i >= 0:  # warm-up calls carry negative numbers
                asked.append(q)
                answers.append(res)

        t = percentile_wall(query, CALLS, device)
        log(f"{rows} int8 IVF e2e nprobe={nprobe}: p50={t['p50_ms']:.3f} ms "
            f"p95={t['p95_ms']:.3f} ms (device p50 {t['device_p50_ms']})")
        if verify is not None:
            verify("ivf_10M", x10, s10, rows, torch.cat(asked), _stack(answers),
                   ivf=(state, nprobe))
        out[f"latency_10M_int8_ivf_np{nprobe}_p50_ms"] = round(t["p50_ms"], 3)
    out.update(_sharded_ivf(device, tq, x10, s10, state, rows, verify))
    if keep is not None:
        keep.update(x=x10, scales=s10, state=state)
    del x10, s10, state
    gc.collect()
    return out
