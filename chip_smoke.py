#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: the serving, REST, P2P, agent, Socket.IO, IVF, index-build, W8A8, ingest, multi-device search and training paths (in one process and across four) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile     # PERF.md section 5's breakdown instead

Needs one CUDA card; without one it exits 1 and prints no result. Phases,
each printing one line (any failed check raises, and the script exits
non-zero):

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds the kernels of ``csrc/`` for sm_90a.
3. kernels  B1 (chunk-max sweep) over 1,000,000 x 768 bf16 rows, B in
            {1, 8, 32, 64}, n_valid = N - 1000, 0.1% tombstones, against its
            plain torch version (atol 1e-3) and the full top-k against the
            exact reference (tie-aware, atol 5e-4), timed with matmul + amax
            by CUDA-graph replay at each B; B3 (fused attention) at
            ViT-L/14 shapes, B in {1, 8}, at the bench's ViT-B/32 shape
            (B = 256, T = 50, D = 768, 12 heads) and at SigLIP so400m/14's
            two (B = 256, D = 1152, 16 heads of 72: T = 729, the two-pass
            wgmma variant, and T = 64, the text tower) and at T = 273 there,
            and on inputs the wrapper copies or pads for it (an unaligned
            view at T = 300, head dim 36 at T = 729), against its plain
            version (atol = rtol = 2e-2), each launch's variant read from
            its span, where the library names it; then SigLIP's text tower at its
            published widths in bf16 on 8 texts against the f32 reference
            of the benchmark (``perfbench/reference/siglip.py``, cosine >=
            0.995); B2 (int8 chunk-max sweep) over 10,000,000 x
            768 int8 rows made on the card in blocks from a seeded
            ``torch.Generator`` and quantized by ``symmetric_int8`` (7.68 GB),
            B in {1, 8, 32, 512}, n_valid = N - 1000, 0.1% tombstones, a group
            of exactly tied rows: chunk maxima ``torch.equal`` to the plain
            version, ``topk_search_int8`` at k = 20 and 100 equal to the
            blockwise ``int8_reference`` (tie-aware with atol 0); B=8 and
            B=512 timed over those rows and over 10,000,000 x 512 (B2's
            sweeps ``int8_sweep_plan`` gives, each beside its bound: the
            larger of the products at the int8 peak and one read of the rows
            per sweep). Then the IVF
            mode below the facade over the same rows: ``build_ivf`` with the
            bench's parameters (nlist 8192, 48 sample rows per list, 6
            k-means iterations), answers at nprobe 16 and 64, B = 1 and 8,
            bit for bit ``testing.ivf_candidate_reference`` (tombstones and
            n_valid included), and ``ivf_topk`` at nprobe 64 against
            ``topk_search_int8`` (B2) at B in {1, 2, 4, 8, 16}, wall and
            CUDA-event time: the card's crossover at 10M rows.
4. slice    ``create_system`` on cuda with seeded random ViT-L/14 towers in
            bf16 (loading runs the self-test, which runs B3), an index of
            1,000,000 x 768 rows from ``numpy.random.default_rng(0)``;
            8 text requests through RequestHandler -> search ->
            format_results, one image query through search_by_image (B3),
            one ``search_batch`` of 8 and 8 concurrent requests through
            QueryBatcher, every answer checked against the exact reference
            over the same device rows.
4b. serve   the same system behind ``start_server`` (the port's
            ``RetrievalServer`` on the standard library, batcher on: window
            8 ms, at most 64 a batch), driven over HTTP with
            ``http.client`` and over ``/ws`` with the port's own
            WebSocket client: ``/api/health``; 32 searches at concurrency 1
            (exactly one B1 launch each), 256 at 16 and 256 at 64, then 256
            at 16 under ``torch.profiler`` (the card's idle share against the
            untraced round), every answer tie-aware equal to the exact f32
            reference for the vector the server searched; ``search_batch``
            of the 32 (one B1 launch, each list equal to its single answer);
            ``image_search`` with a 224 x 224 JPEG (B5 once, B3 once per
            vision layer, B1 once; checked); ``similar``, ``metadata``,
            ``stats``; the admin gate (401 without the token, 200 with it);
            a ``/ws`` ping and a ``/ws`` search equal to the REST answer;
            ``/api/build`` over 256 seeded JPEG keyframes (401 without the
            token) with every ``build_progress`` event and ``build_done``
            received on the socket, then a search over the built rows.
            Prints served p50/p95, QPS at concurrency 1, 16 and 64,
            ``served_avg_batch`` and the idle share.
4c. p2p     before 4b, on the same system: a port ``NetworkServer`` on a
            free loopback port (no discovery) shares a second bf16 index of
            1,000,000 x 768 rows from ``numpy.random.default_rng(1)`` on the
            card, its records named apart (``peer_video_*``: the fan-in
            dedups on folder and image); ``NetworkClient().load_remote_index``
            joins ``system.remote_indexes``. 8 text queries through
            ``search`` (limit 20, no cache; B1 once locally and once on the
            peer each) tie-aware equal to the exact f32 reference over both
            row sets, with hits of both; ``search_batch`` of the 8 equal to
            ``search`` per query; ``RemoteUnifiedIndex.search_vector`` equal
            to the peer's exact reference; a vector of the wrong length
            answers 400. ``enable_llm`` with a scripted provider: one
            ``search_keyframes`` call (``clip_only``, limit 5), then a text;
            ``chat``'s ``search_results`` equal ``system.search`` with those
            options and the exact reference; ``llm_enhanced`` with 4
            scripted variants equal to the max-merge of their exact
            references. A ``RetrievalServer`` over the system: a Socket.IO
            polling handshake and ``40``, ``search`` equal to the same
            query's ``/api/search``, the upgrade to WebSocket, then
            ``image_search`` of a 224 x 224 JPEG (B5 and B3) equal to
            ``/api/image_search``, ``system_stats`` with an ack id. Prints
            the peer's remote search p50/p95 (20 warm calls) beside local
            ``search_vectors`` at B=1, the fan-in p50 beside phase 4's, and
            the Socket.IO search round trip beside ``/ws``'s. Then the
            remote indexes and the LLM processor are cleared, the server
            and the peer stopped (the peer no longer answers a health
            check).
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
            builds 4,096 keyframes of 224 x 224 x 3 in 8 video folders
            through ``build_system`` -> ``RAGBuilder.build_index`` (chunks of
            1,024, encode batches of 256): real JPEGs where PIL imports and a
            real ``.rvdb`` where h5py imports, else a ``RAGBuilder`` subclass
            that replaces only the missing piece (the route is printed).
            Checked: the report (4,096 processed, 0 failed, 4 chunks), B5
            once and B3 and B4 24 times per encode batch, the progress
            events, 256 built rows against an embedder without ``fused_mlp``
            (cosine >= 0.999), a second build that resumes and skips every
            file, 8 image queries that return their own frame first (score
            >= 0.99), 8 text requests equal to the exact reference; then
            1,024 frames built with ``index.dtype="int8"`` and served equal
            to ``int8_reference`` (atol 0).
6b. w8a8   the W8A8 tower modes (``torch._int_mm`` products; the quant and
            dequant passes are torch operations). ``w8a8_dense`` on the card
            ``torch.equal`` to the same op on the CPU, dynamic and static
            scales, at the vision shapes (8 x 257 and 256 x 257 tokens; for
            the latter the first and last 1,024 rows; 1024->1024, 1024->4096,
            4096->1024) and the text shapes (8 x 77 tokens; 768->768,
            768->3072, 3072->768), timed beside ``_int_mm`` alone and
            ``F.linear`` in bf16; int8 attention at (8, 257, 1024, 16 heads)
            against the CPU (cosine >= 0.9999 on the same q, k, v; >= 0.999
            for the layer with its bf16 projections), timed beside B3. The
            embedder at ViT-L/14 width in bf16, ``int8`` and ``int8_static``:
            4 image batches of 256 and 4 text batches calibrate the static
            one (``self_test`` not counted), its static text tower against
            the same weights and scales on the CPU (cosine >= 0.999), cosines
            against bf16 printed, ``encode_images`` ms per batch of 256 and
            ``encode_text`` B=1 p50 in each mode. Then a facade with
            ``device.compute_dtype = "int8_static"`` builds 1,024 JPEG
            keyframes (the vision tower calibrates on the build's 4 batches)
            and keeps ``<index>.act_scales.json``, which 4 text requests
            complete; a second facade loads the index (``load_system`` where
            h5py imports, else ``attach_index`` over the stand-in) and is
            static at once, health without the calibrating warning, 8 text
            requests and 2 image queries equal to the exact reference over
            the built rows (tie-aware). Counted: B5 once per image batch, B3
            once per vision layer and forward, B1 once per query, six
            ``_int_mm`` a layer and forward.
7. ingest   keyframe ingest. First whether cv2 imports (the route is
            printed: video decode and stage 1's JPEG writes need it). B3 at
            DINO ViT-S/16's shape (B = 128, T = 197, D = 384, 6 heads) and B5
            at (128, 224, 224, 3) f32 -> bf16 with DINO's mean/std, each
            against its plain version and timed; ``dino_embedder()`` (seeded,
            bf16) on a batch of 128 frames: 12 B3 launches and one B5, cosine
            >= 0.999 against the same tower with every attention on its plain
            route and against the f32 tower, ms per batch. Stage 1 (the
            launch counts start here): where cv2 imports, two seeded MJPG
            videos of 1280 x 720, 750 frames at 25 fps in 6 static scenes
            through ``extract_frames_batch`` with the pixel embedder and with
            DINO (``dedup_resize=224``), each sequentially and with
            ``workers=2`` (the same files byte for byte), one keyframe per
            scene for the pixel embedder, every keep mask equal to
            ``sequential_dedup_carry`` on the CPU over the card's own
            embeddings, the map CSV schema; without cv2, the same scenes made
            at 224 x 224 with numpy through the same fused device step. Stage
            2: ``apply_filters`` over 8 folders x 256 JPEG keyframes of 256 x
            256 written with PIL, in copy mode and in clustering mode, whose
            per-folder reports equal a run on the CPU but where a score or a
            similarity lies within 1e-5 of its threshold (printed). Then
            ``index_videos`` over the two videos with the seeded ViT-L/14
            towers: every keyframe found first by its own image. Frames/s of
            each run.
8. mesh     multi-device search (``parallel/``) on ``create_mesh()`` (one
            device) and on 4 logical shards of the card (``["cuda:0"] * 4``),
            every shard a view of the phase's rows. Right after the int8 IVF
            phase, over its 10,000,000 int8 rows (padded to split in 4):
            ``sharded_topk_int8`` at B = 1 and 8 ``torch.equal`` to the
            single-device ``topk_search_int8`` (tombstones, n_valid), B2
            launches a call (shards x the sweeps of ``int8_sweep_plan``), B=1 p50/p95 beside
            the single-device search's; ``sharded_ivf_topk`` on that phase's
            structure partitioned over the 4 shards, nprobe 16 and 64, B = 1
            and 8, ``torch.equal`` to ``ivf_topk``, p50 beside it. After the
            open phase, ``create_system(mesh=create_mesh())`` over the
            slice's 1,000,000 bf16 rows in a writable in-memory stand-in:
            8 text requests (one B1 launch each) tie-aware equal to the exact
            reference over the shard's rows, p50/p95 of 24 warm B=1 queries
            beside phase 4's single-device facade; ``sharded_topk`` over the
            same rows on both meshes (4 shards view a copy padded to split in
            4), B = 1 and 8, against ``topk_search`` (one shard: the same
            ids), B1 launches a call (= shards); a delete (the row gone, the
            answer equal to the masked reference) and 8 rows appended in
            place (each its own nearest neighbour). Each half sets B1's and
            B2's counts to 0 first; the single-device references are not
            counted.
9. bench    the port's bench (``bench.main(["--probes"])``) in this process
            at full size, with its three hooks: the headline text query over
            1,000,000 bf16 rows (every answer tie-aware equal to the exact
            f32 reference over the same rows), the ViT-B/32 image tower at
            B=256 (the timed batch again with every attention layer on its
            plain route: cosine >= 0.999), the int8 capacity mode over
            10,000,000 rows (every single-query answer and the first batch of
            128 and of 32 equal to ``int8_reference``, atol 0), the served
            sections through the REST server (``served_qps`` over 1,000,000
            fresh bf16 rows, ``served_10M`` over the IVF section's int8 rows
            with its structure attached and dense: every timed answer against
            the reference of the route its batch took, the scores rounded as
            the server rounds them), the W8A8-static image tower (the timed
            model's first 8 embeddings against the same weights and scales on
            the CPU: cosine >= 0.999), the sharded sections on a one-device
            mesh (``sharded_1M`` over the headline's rows, the anchor's
            1,250,000-row shard in bf16 and int8, the sharded IVF at nprobe
            32 over the IVF section's structure: every timed answer against
            the same references), ``not_ported`` empty; its JSON line is
            printed as it is.
10. probes  inside the same bench run, what its probes (``bench/probes.py``)
            returned, held against their plain versions on the same inputs:
            P1 (int8 tensor-core sweep) and P2 (rows widened to bf16) over
            2,097,152 x 768 int8 rows with 2,000,000 live, at 128, 256 and
            512 rows per block (P1 ``torch.equal`` to its plain version and
            to B2 under an all-zero tombstone mask; P2 within 1e-5 x max
            |score|); P3 (memory stream) over 1.5 GiB as bf16, int8 and int32
            at 1, 2 and 4 blocks per multiprocessor (``torch.equal``). The
            probes' times are the bench's own; the hook adds the plain
            versions' and the library calls', and the stream rate is set
            beside the published 3.35 TB/s. The hook's launches are taken off
            the counts.
11. open    the int8 facade over the 1,000,000 rows opened twice from a
            stand-in container that has a path: record by record (which
            writes the ``.meta.npz`` and ``.flat8`` sidecars), then through
            the sidecars (columnar metadata); seconds of each, the same hits
            from both.
12. ann     the IVF mode through the facade: ``index_type="IndexIVFFlat"``
            over 1,000,000 x 768 bf16 rows around 4,096 seeded centres (the
            slice's rows as noise) in a writable in-memory stand-in; nlist
            4,096, bucket_cap 384; asserts ``ann_active``, builds again
            (bit for bit the first), prints the recall guard's ladder; 8
            facade queries at B=1 (each one ``ivf_topk`` call) tie-aware
            equal to the candidate-set reference; nprobe = nlist at B=1 and
            B=8 equal to ``exact=True`` (within the query's bf16 rounding,
            which the dense path applies); B=8 equal to eight B=1 calls; a
            batch above ``ann_max_batch`` through B1, equal to ``exact=True``;
            p50/p95 of IVF, exact and facade queries at B=1; 1,000 appended
            rows in the tail, each found by its own vector; deleted rows
            never returned; ``measure_ann_crossover`` over B in {1, ..., 64};
            a reopen with a default config restores ``ann_active``, nprobe
            and ``ann_max_batch``. TF32 must be off.
13. train   CLIP contrastive training (``parallel.CLIPTrainer``). B3 at the
            training shapes (B = 64, T = 257, D = 1024, 16 heads; one
            ``(2, 2)`` shard's 32 x 257 x 512, 8 heads; a 4-way shard's 32 x
            257 x 256, 4 heads; bf16): the forward against its plain version
            and timed beside SDPA, the gradients through ``fused_mha``
            ``torch.equal`` to ``_einsum_attention``'s, the einsum-recompute
            backward timed beside SDPA's backward and forward + backward.
            Then seeded ViT-L/14 towers in bf16 with remat and B3 on
            ``create_mesh(MeshSpec(("data", "model"), (1, 1)))``: ``init(0)``
            and 6 steps on one seeded batch of 64 (raw pixels, tokens ending
            in the EOT id), every loss finite and the last below the first,
            step ms p50 over steps 2-6, image-text pairs/s, peak memory, B3
            launches = 48 a step (24 layers, twice with the recompute). The
            first step again with every B3 call on its plain version: loss
            within 2e-3 relative, the gradients' cosine per tower >= 0.999;
            with ``fused_attn=False`` (bf16 logits) and on a ``(2, 2)`` mesh
            of logical shards (``["cuda:0"] * 4``: B3 launches 192, every
            split tensor in 2 shards, one update): loss within 2e-3, cosine
            >= 0.998 (two bf16 roundings of a near-uniform softmax's
            gradients sit at 0.9989-0.9993); the ``(1, 1)`` and ``(2, 2)``
            layouts in f32: loss within 1e-5, cosine >= 0.99999. A
            checkpoint of step 6 under
            ``build/chip_smoke/train_phase/`` (deleted at the end) restored
            ``torch.equal`` on its devices, step 7's loss ``==`` from both
            states. Train -> deploy: ``trainer.state_dict`` into
            ``CLIPEmbedder.load_params``, ``encode_images`` of 8 of the
            batch's images against the trainer's ``encode_image`` of the
            same normalized pixels (cosine >= 0.999).
13b. train-mp  the same training across processes: this script again as
            four ranks (``--train-rank``; the kernels are built before they
            start, so none runs nvcc), each joining one gloo group (NCCL
            refuses two ranks on one card) and owning one logical shard of
            ``cuda:0`` of a ``(2, 2)`` mesh, so data and model parallelism
            both cross the processes. ``init(0)`` and 2 steps on phase
            13's batch: the first step's loss within 2e-3 and its gradients
            at cosine >= 0.998 per tower of phase 13's one-process ``(2,
            2)`` step; the metrics of both steps and every shard after them
            equal on every rank that holds it; the ranks' checkpoint
            restored here by a one-process ``(2, 2)`` trainer equal to their
            shards; B3 launches per rank 48 a step (24 layers, twice with
            the recompute, each launch over half the heads). Prints the
            step ms, the peak memory per rank and the launches per rank.
13c. entry  ``graft_entry.entry()``: the seeded ViT-L/14 image tower in
            bf16 over (4, 224, 224, 3) zeros and the f32 normalize: shape
            (4, 768), finite, unit norms, cosine >= 0.999 to the same call
            with B3 on its plain version, B3 launched 24 times; timed.
14. numbers p50/p95 text-query latency (encode + search, 24 warm queries)
            of both serving slices, images/s of the build, kernel vs plain
            vs library-call times (CUDA events) beside each kernel's bound.

Each slice sets every launch count to 0 just before it runs and reads the
counts just after; the kernels' JSON line reports B1 and B3 from the bf16
slice, B2 from the int8 slice, B4 and B5 from the build and P1-P3 from the
bench (whose own B1, B2, B3 and B5 launches are printed beside them); B3 and
B5 carry the ingest path's launches and their DINO shapes beside, and B1,
B3 and B5 the serve phase's (``serve_launches``) and the P2P phase's
(``p2p_launches``) and the int8_static
facade's (``w8a8_launches``), B1 and B2 the mesh phase's
(``mesh_launches``), B3 the training steps' (``train_launches``), its
training shapes (``train``), each rank's launches across processes
(``train_multiproc_launches``) and ``entry()``'s (``entry_launches``). The
IVF phase counts ``ops.ann.ivf_topk.calls`` beside B1's and B3's launches.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

``--profile`` runs phases 1-2, then a build of 2,048 keyframes (one JSON
line: where its wall time goes on the host and which kernels fill its
device time), then DINO extraction of one 750-frame video (one JSON line:
wall, device busy, idle share, device ops per batch, B3 and B5 seconds),
then serves the same 1M rows in bf16 and in
int8 and prints one JSON line per query phase (search, encode, search_vectors
at B=1 and 32, search_batch at B=32): wall p50/p95 of 20 warm calls, each
ended by a synchronize, then a ``torch.profiler`` trace of 20 more calls
giving the device busy time (the union of kernel, copy and memset
intervals), device ops per call and the milliseconds of each kernel; the
idle share is 1 - busy / mean untraced wall; then the IVF path at B=1:
``search_vectors`` (IVF and ``exact=True``) and the facade's ``search``
over the 1M clustered bf16 rows, ``ivf_topk`` at nprobe 16 and 64 and
``topk_search_int8`` over 10M int8 rows; last, one training row (phase 13's
trainer: step, ``value_and_grad`` and ``apply_gradients`` wall p50, then a
traced step's device busy, idle share, ops and costliest kernels). It checks
no answers and prints no ``ok`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from intelligent_video_analysis_retrieval_system_tpu_torch.bench.data import (  # noqa: E402
    MemoryContainer,
    synthetic_record,
)
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
COS_SIGLIP_TEXT = 0.995   # SigLIP's text tower in bf16 over 27 layers against f32
TOL_LN_MLP = 1e-2  # bf16 LN+MLP: max abs difference over the output's max abs
ATOL_LN_MLP_F32 = 5e-5  # f32 LN+MLP: sums in another order, rsqrtf
N_FRAMES = 4096    # the build phase: keyframes, in N_FOLDERS video folders
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


_LOG_TO = None   # the real stdout, while the bench phase captures the bench's own


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", file=_LOG_TO or sys.stdout, flush=True)


class Timer:
    """Mean milliseconds per call: CUDA events on a card, host clock else."""

    def __init__(self, device) -> None:
        self.device = device

    def __call__(self, fn, iters: int = 10, graph: bool = False) -> float:
        """``graph``: capture the ``iters`` calls into one CUDA graph and time
        its replay, so that a kernel shorter than the host's launch gap (tens
        of microseconds from Python) is timed and not the gap. Only for
        functions that neither synchronize nor read a result on the host."""
        import torch

        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        call, calls, per = fn, iters, iters
        if graph:
            captured = torch.cuda.CUDAGraph()
            with torch.cuda.graph(captured):
                for _ in range(iters):
                    fn()
            captured.replay()   # warm
            call, calls, per = captured.replay, 3, 3 * iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()   # each result is dropped at once, so the allocator reuses its block
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / per


def sdpa(q, k, v, h):
    """The library yardstick of B3 (timed only; the port never calls it)."""
    import torch

    b_, t_, d_ = q.shape
    return torch.nn.functional.scaled_dot_product_attention(
        *(y.view(b_, t_, h, d_ // h).transpose(1, 2) for y in (q, k, v)))


def check_mha(device, gen, timer: Timer, b: int, t: int, d: int, h: int, timed: bool,
              unaligned: bool = False, want: str | None = None) -> dict:
    """B3 at one shape against its plain version (atol = rtol = TOL_MHA); with
    ``timed`` the kernel, the plain version and SDPA by CUDA-graph replay
    beside the byte bound. ``unaligned``: q, k, v are views 2 bytes past
    their allocations (the wrapper copies them to a 16-byte boundary);
    ``want``: the variant the shape must take."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch import trace
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention

    on_card = device.type == "cuda"
    if unaligned:
        raw = torch.randn(3, b * t * d + 1, generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (raw[i, 1:].view(b, t, d) for i in range(3))
        assert q.data_ptr() % 16 == 2
    else:
        q, k, v = (torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(3))
    trace.take()
    trace.enable()
    try:
        got = attention.fused_mha(q, k, v, h)
    finally:
        trace.disable()
    # the variant the launch took, as its span names it (none on the CPU)
    took = [s.attrs["variant"] for s in trace.take() if s.name == "attn.b3"]
    ref = attention._einsum_attention(q, k, v, h)
    err = float((got.float() - ref.float()).abs().max())
    if not torch.allclose(got.float(), ref.float(), atol=TOL_MHA, rtol=TOL_MHA):
        raise AssertionError(f"B3 B={b} T={t} D={d} H={h}: max abs err {err} beyond "
                             f"atol=rtol={TOL_MHA}")
    plan = attention.mha_plan(t, d // h)
    if want is not None and plan["variant"] != want:
        raise AssertionError(f"B3 B={b} T={t} D={d} H={h}: the plan names {plan['variant']}, "
                             f"not {want}")
    if on_card and took != [plan["variant"]]:
        raise AssertionError(f"B3 B={b} T={t} D={d} H={h}: the library launched {took}, the "
                             f"plan names {plan['variant']}")
    log("kernels", f"B3 fused_mha B={b} T={t} D={d} H={h} bf16 ({plan['variant']}, "
        f"{plan['frags']} fragments): max_abs_err={err:.3e} vs plain (atol=rtol={TOL_MHA})")
    out = {"shape": [b, t, d, h], "variant": plan["variant"], "max_abs_err": err}
    if timed:
        out.update(
            ms=timer(lambda: attention.fused_mha(q, k, v, h), iters=20, graph=on_card),
            plain_ms=timer(lambda: attention._einsum_attention(q, k, v, h), iters=10,
                           graph=on_card),
            library_ms=timer(lambda: sdpa(q, k, v, h), iters=20, graph=on_card),
            **bound(4 * b * t * d * 2, 4.0 * b * t * t * d, "bf16"))
        log("numbers", f"B3 B={b} T={t} D={d}: kernel {out['ms']:.4f} ms, plain "
            f"{out['plain_ms']:.4f} ms, library scaled_dot_product_attention "
            f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


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
    for b in (1, 8, 32, 64):
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
    # kernel and yardstick by CUDA-graph replay (a launch gap is not timed);
    # the plain version, milliseconds long, eagerly
    on_card = device.type == "cuda"
    per_b = {}
    for b in (1, 8, 32, 64):
        q = torch.randn(b, dim, generator=gen, device=device).to(torch.bfloat16)
        ms = timer(lambda: topk.chunk_max_sweep(x, q, n_valid, dead), iters=20, graph=on_card)
        plain = timer(lambda: topk.chunk_max_plain(x, q, n_valid, dead), iters=5)
        # yardstick (timed only, the port never calls it): one matmul over the
        # same rows and the max per 128-row chunk, without the masks
        lib = timer(lambda: (x @ q.T).view(n_pad // topk.CHUNK, topk.CHUNK, b).amax(dim=1),
                    iters=20, graph=on_card)
        b_pad = topk.bucket_b(b)   # the sweep's output and products run at the bucket
        cell = dict(ms=ms, plain_ms=plain, library_ms=lib,
                    **bound(n_pad * dim * 2 + b * dim * 2 + n_pad + n_pad // topk.CHUNK * b_pad * 4,
                            2.0 * n_pad * dim * b_pad, "bf16"))
        per_b[b] = cell
        gbs = n_pad * dim * 2 / (ms * 1e-3) / 1e9
        log("numbers", f"B1 B={b}: kernel {ms:.4f} ms ({gbs:.0f} GB/s of rows), bound "
            f"{cell['bound_ms']:.4f} ms ({cell['bound_by']}, {cell['bound_ms'] / ms:.0%}), "
            f"library matmul + amax {lib:.4f} ms, plain {plain:.4f} ms")
    b1.update(per_b[8])
    b1["per_batch"] = {str(b): {k_: v_ for k_, v_ in c.items() if k_ != "bound_by"}
                       for b, c in per_b.items()}
    del x, dead

    # B3: the towers' attention shapes, timed (CUDA-graph replay: the kernel is
    # shorter than a launch gap), then the ragged shapes of both variants
    def mha_case(b, t, d, h, timed, **kw):
        return check_mha(device, gen, timer, b, t, d, h, timed, **kw)

    narrow = dim < DIM   # CPU rehearsal: small widths, few images
    t_l, d_l, h_l = (257, 1024, 16) if not narrow else (17, 64, 4)
    mha_case(1, t_l, d_l, h_l, timed=False)
    main = mha_case(8, t_l, d_l, h_l, timed=True)           # image queries, self-test
    big = mha_case(256 if not narrow else 4, t_l, d_l, h_l, timed=True)   # the build's batch
    b32 = mha_case(256 if not narrow else 4, 50, 768 if not narrow else 48, 12, timed=True)
    # SigLIP so400m/14: head dim 72, 729 tokens (the wgmma variant at depth 80)
    # and 64 (registers); 273 tokens, the first length past the register tile
    d_s, h_s = (1152, 16) if not narrow else (144, 2)
    so400m = mha_case(256 if not narrow else 4, 729, d_s, h_s, timed=True)
    so400m_text = mha_case(256 if not narrow else 4, 64, d_s, h_s, timed=True)
    wg_273 = mha_case(256 if not narrow else 4, 273, d_s, h_s, timed=True)
    ragged = [mha_case(2, t, 256 if not narrow else 64, 4, timed=False)
              for t in (1, 16, 17, 197, 273, 320)]
    # inputs the bf16 kernels do not read as they come, past 272 keys: an
    # unaligned view (copied) and a head dim that is no multiple of 8 (padded)
    ragged += [mha_case(2, 300, 256 if not narrow else 64, 4, timed=False, unaligned=True,
                        want="wgmma"),
               mha_case(2, 729, 576 if not narrow else 72, 16 if not narrow else 2,
                        timed=False, want="wgmma")]
    mha = {k_: v_ for k_, v_ in main.items() if k_ != "shape"}
    mha["max_abs_err"] = max(c["max_abs_err"]
                             for c in (main, big, b32, so400m, so400m_text, wg_273, *ragged))
    mha["vit_l_14_b256"] = big
    mha["vit_b_32"] = b32
    mha["siglip_so400m_b256"] = so400m
    mha["siglip_text_b256"] = so400m_text
    mha["t273_b256"] = wg_273
    mha["siglip_text_tower"] = check_siglip_text(device, timer, narrow)
    if require_kernels and (topk.chunk_max_sweep.launches == 0
                            or attention.fused_mha.launches == 0):
        raise AssertionError("a kernel comparison ran without launching its kernel")
    return b1, mha


def check_siglip_text(device, timer: Timer, narrow: bool) -> dict:
    """SigLIP so400m/14's text tower (``models.siglip``, bf16, B3 at 64
    tokens) on 8 hash-tokenized texts against the benchmark's f32 reference
    over the same seeded weights (``narrow``: the tiny test widths)."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.models import siglip
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.tokenizer import (
        load_tokenizer)
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention
    from perfbench import weights_siglip
    from perfbench.drivers.encode_siglip import siglip_config
    from perfbench.reference import siglip as ref

    cfg = json.loads((ROOT / "perfbench" / "configs" / "siglip-so400m-patch14-384.json").read_text())
    if narrow:
        cfg["text_config"].update(vocab_size=512, max_position_embeddings=16, hidden_size=48,
                                  intermediate_size=136, num_hidden_layers=2,
                                  num_attention_heads=4)
    text = siglip_config(cfg).text
    sd = {k: v for k, v in weights_siglip.make(cfg, 20_260_314, device).items()
          if k.startswith("text_model.")}
    with torch.device("meta"):
        model = siglip.SiglipTextTower(text)
    model = model.to_empty(device=device)
    model.load_state_dict({k[len("text_model."):]: v for k, v in sd.items()}, strict=True)
    tok = load_tokenizer(None, vocab_size=text.vocab_size)
    ids = torch.from_numpy(tok([f"a keyframe of scene {i}" for i in range(8)],
                               text.max_length)).to(device)
    launches = attention.fused_mha.launches
    with torch.no_grad():
        got = model(ids, torch.bfloat16).float()
    moved = attention.fused_mha.launches - launches
    want = ref.text_embed(sd, cfg, ids.long())
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min())
    if cos < COS_SIGLIP_TEXT or (device.type == "cuda" and moved != text.num_layers):
        raise AssertionError(f"SigLIP text tower: cosine {cos} (at least {COS_SIGLIP_TEXT}), "
                             f"B3 launches {moved}")
    out = {"cosine_min": cos, "b3_launches": moved,
           "ms": timer(lambda: model(ids, torch.bfloat16), iters=10)}
    log("kernels", f"SigLIP text tower bf16, 8 texts of {text.max_length} tokens: cosine "
        f"with the f32 reference {cos:.6f} (at least {COS_SIGLIP_TEXT}), B3 {moved} launches, "
        f"{out['ms']:.3f} ms a call")
    del model, sd
    return out


def int8_rows(device, n_rows: int, dim: int, gen):
    """``n_rows`` unit rows of ``dim`` from ``gen``, quantized per row by
    ``symmetric_int8`` in blocks on the device, and their f32 scales; padded
    (with zero rows and scales) so that they also split into MESH_SHARDS
    shards of TILE_N multiples: the mesh phase's shards are views of them."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk

    n_pad = -(-n_rows // (topk.TILE_N * MESH_SHARDS)) * topk.TILE_N * MESH_SHARDS
    x_i8 = torch.zeros((n_pad, dim), dtype=torch.int8, device=device)
    xs = torch.zeros((n_pad,), dtype=torch.float32, device=device)
    for s in range(0, n_rows, 262_144):
        e = min(s + 262_144, n_rows)
        blk = torch.randn(e - s, dim, generator=gen, device=device)
        q8, sc = quant.symmetric_int8(blk / blk.norm(dim=-1, keepdim=True), dim=-1)
        x_i8[s:e] = q8
        xs[s:e] = sc[:, 0]
    return x_i8, xs


def b2_bound(n_pad: int, dim: int, b: int, sweeps: int) -> dict:
    """B2's least time for ``b`` queries over ``n_pad`` int8 rows in
    ``sweeps`` launches: the larger of the products at the int8 peak and,
    for every sweep, one read of the rows, their scales and tombstones (with
    the queries and the chunk maxima written)."""
    one = n_pad * dim + n_pad * 4 + n_pad + b * dim + n_pad // 128 * b * 4
    return bound(sweeps * one, 2.0 * n_pad * dim * b, "int8")


def b2_sweep_row(timer, x_i8, xs, n_valid, dead, q) -> dict:
    """B2 timed over the rows for the queries ``q`` (quantized here), with
    its sweeps, their query group and its bound."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk

    q_i8 = quant.symmetric_int8(q, dim=-1)[0]
    n_pad, dim = x_i8.shape
    b = q_i8.shape[0]
    plan = quant.int8_sweep_plan(topk.bucket_b(b), dim)
    before = quant.int8_chunk_max_sweep.launches
    ms = timer(lambda: quant.int8_chunk_max_sweep(x_i8, xs, q_i8, n_valid, dead),
               iters=20 if b <= 64 else 5)
    launches = quant.int8_chunk_max_sweep.launches - before
    row = {"rows": n_pad, "dim": dim, "b": b, "sweeps": len(plan),
           "group": plan[0]["group"], "ms": ms, **b2_bound(n_pad, dim, b, len(plan))}
    if launches % len(plan):
        raise AssertionError(f"B2 B={b} D={dim}: {launches} launches, not whole calls of "
                             f"{len(plan)} sweeps")
    log("numbers", f"B2 sweeps {n_pad} x {dim} int8, B={b}: {len(plan)} sweep(s) of up to "
        f"{plan[0]['group']} queries, {ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), {100 * row['bound_ms'] / ms:.1f}% of it")
    return row


def check_int8_kernels(device, n_rows: int, dim: int, timer: Timer, require_kernels: bool,
                       keep: dict | None = None):
    """B2 against its plain version, and the two-phase int8 search against
    the full-matrix reference, at capacity scale. ``keep`` (a dict) gets the
    rows, scales, live count and tombstones for the int8 IVF phase."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk

    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    x_i8, xs = int8_rows(device, n_rows, dim, gen)
    n_pad = x_i8.shape[0]
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
    for b in (1, 8, 32, 512):
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
        del got, ref, fin
        # the blockwise reference at 512 queries would take minutes
        for k in () if b == 512 else (20, 100):
            res = quant.topk_search_int8(x_i8, xs, q, k, n_valid=n_valid, deleted=dead)
            oracle = quant.int8_reference(x_i8[:n_valid], xs[:n_valid], q, k, deleted=dead)
            for i in range(b):
                tie_aware_equal(res.indices[i].cpu().numpy(), res.scores[i].cpu().numpy(),
                                oracle.indices[i].cpu().numpy(),
                                oracle.scores[i].cpu().numpy(), atol=0.0)
            if sorted(res.indices[0, :4].tolist()) != sorted(ties + [src]):
                raise AssertionError(f"B2 B={b} k={k}: the tie group is not the top 4")
        log("kernels", f"B2 int8_chunk_max_sweep N={n_rows} (pad {n_pad}) D={dim} int8 B={b}: "
            f"max_abs_err={errs[b]:.3e}, chunk maxima equal to plain (torch.equal)"
            + ("" if b == 512 else "; topk_search_int8 k=20,100 equal to int8_reference "
               "(tie-aware, atol 0), tie group on top"))
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
                      **b2_bound(n_pad, dim, b, 1))
            log("numbers", f"B2 B=8: bound {b2['bound_ms']:.4f} ms ({b2['bound_by']}), "
                f"library _int_mm + scale + amax {lib} ms")
    # B2's sweeps at a served batch and at the k-NN call's 512, over rows of 768
    # and of 512
    b2["sweeps"] = [b2_sweep_row(timer, x_i8, xs, n_valid, dead, queries[b]) for b in (8, 512)]
    del queries
    x512, xs512 = int8_rows(device, n_rows, 512, gen)
    q512 = torch.randn(512, 512, generator=gen, device=device)
    got = quant.int8_chunk_max_sweep(x512, xs512, quant.symmetric_int8(q512, dim=-1)[0],
                                     n_valid, dead)
    if not torch.equal(got, quant.int8_chunk_max_plain(
            x512, xs512, quant.symmetric_int8(q512, dim=-1)[0], n_valid, dead)):
        raise AssertionError("B2 B=512 D=512: chunk maxima differ from the plain version")
    del got
    b2["sweeps"] += [b2_sweep_row(timer, x512, xs512, n_valid, dead, q512[:b]) for b in (8, 512)]
    del x512, xs512, q512
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if require_kernels and quant.int8_chunk_max_sweep.launches == 0:
        raise AssertionError("the B2 comparison ran without launching its kernel")
    if keep is not None:
        keep.update(x_i8=x_i8, xs=xs, n_valid=n_valid, dead=dead)
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
    # the serve phase takes the system on (and cleans it up)
    return {"launches": launches, "p50_ms": p50, "p95_ms": p95,
            "ntotal": stats["index"]["ntotal"], "system": system}


# ---------------------------------------------------------------------------
# phase 4b: the slice's system behind the REST server
# ---------------------------------------------------------------------------

SERVE_SERIAL = 32     # requests at concurrency 1 (and the search_batch of as many)
SERVE_TIMED = 256     # requests per round at concurrency 16 and 64
SERVE_FRAMES = 256    # keyframes the build wizard indexes
ADMIN_TOKEN = "smoke-admin-token"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(conn, method: str, path: str, payload=None, headers: dict | None = None):
    """(status, body): the body parsed where the answer is JSON, else bytes."""
    body = None if payload is None else json.dumps(payload).encode()
    conn.request(method, path, body, {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    if resp.getheader("Content-Type", "").startswith("application/json"):
        return resp.status, json.loads(data)
    return resp.status, data


def check_served(system, results: list[list[dict]], qvecs: list[np.ndarray],
                 limit: int) -> None:
    """Served hits (standard detail) against the exact f32 reference over the
    index's device rows: ``limit`` hits each, tie-aware equal; 64 queries
    per reference product."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_exact_reference,
    )

    index = system.index
    x = index._dev_x[:index.ntotal]
    for s in range(0, len(results), 64):
        q = np.stack([v / max(float(np.linalg.norm(v)), 1e-12) for v in qvecs[s:s + 64]])
        ref = topk_exact_reference(x, torch.from_numpy(q.astype(np.float32)).to(
            index.device, x.dtype), limit)
        ref_ids, ref_scores = ref.indices.cpu().numpy(), ref.scores.cpu().numpy()
        for j, hits in enumerate(results[s:s + 64]):
            if len(hits) != limit:
                raise AssertionError(f"{len(hits)} served hits, expected {limit}")
            rows = [index.row_for(h["folder"], h["image"]) for h in hits]
            if None in rows:
                raise AssertionError("a served hit names no indexed keyframe")
            tie_aware_equal(np.array(rows), np.array([h["similarity_score"] for h in hits]),
                            ref_ids[j], ref_scores[j])


def run_serve_phase(device, system, require_kernels: bool, workdir: Path | None = None,
                    timed: int = SERVE_TIMED, n_frames: int = SERVE_FRAMES) -> dict:
    """The slice's facade behind ``start_server`` (the port's
    ``RetrievalServer``, batching on), driven over HTTP and ``/ws`` by the
    standard library; every answer is checked. Cleans the system up."""
    import base64
    import http.client
    import importlib.util
    import io
    import shutil

    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench import served
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import (
        attention, preprocess, quant, topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_exact_reference,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve.websocket import (
        WebSocketClient,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.testing import ATOL_TOPK

    workdir = workdir or ROOT / "build" / "chip_smoke" / "serve_phase"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    on_card = device.type == "cuda"
    phase_t0 = time.perf_counter()
    for key, value in (("api.batching", True), ("api.batching_max_batch", 64),
                       ("api.batching_window_ms", 8.0), ("api.rate_limit_per_minute", 10**9),
                       ("api.admin_token", ADMIN_TOKEN),
                       ("paths.index_dir", str(workdir / "index")),
                       ("paths.map_dir", str(workdir / "map"))):
        system.config.set(key, value)
    recorder = served.Recorder(system.embedder)
    n_layers = system.embedder.config.vision.num_layers
    ntotal = system.index.ntotal

    def vector(text: str, which: int = -1) -> np.ndarray:
        return recorder.vectors[system._clip_prompt(text, SearchOptions())[0]][which]

    def checked_round(texts: list[str], concurrency: int) -> tuple[float, list[float]]:
        elapsed, lat, bodies = served.fire(port, texts, concurrency)
        check_served(system, [b["results"] for b in bodies], [vector(t) for t in texts], 10)
        return elapsed, lat

    # the serve path starts here: every launch count from zero
    counters = {"b1": topk.chunk_max_sweep, "b2": quant.int8_chunk_max_sweep,
                "b3": attention.fused_mha, "b5": preprocess.normalize_images}
    for fn in counters.values():
        fn.launches = 0
    port = free_port()
    server = system.start_server(host="127.0.0.1", port=port, block=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        status, health = http_call(conn, "GET", "/api/health")
        if status != 200 or not health["success"] or not health["index_loaded"]:
            raise AssertionError(f"/api/health answered {status}: {health}")

        # concurrency 1: one batch, one B1 launch per request (exact counts)
        serial = [f"serve serial {i}: a red car at night past neon signs"
                  for i in range(SERVE_SERIAL)]
        before = topk.chunk_max_sweep.launches
        elapsed1, lat1 = checked_round(serial, 1)
        if require_kernels and topk.chunk_max_sweep.launches - before != SERVE_SERIAL:
            raise AssertionError(f"{SERVE_SERIAL} serial searches launched B1 "
                                 f"{topk.chunk_max_sweep.launches - before} times")
        stats = server.batcher.stats
        requests0, batches0 = stats.requests, stats.batches
        elapsed16, lat16 = checked_round(
            [f"serve c16 {i}: people walking on a beach at sunset" for i in range(timed)], 16)
        avg_batch = (stats.requests - requests0) / max(stats.batches - batches0, 1)
        elapsed64, _ = checked_round(
            [f"serve c64 {i}: a dog catching a frisbee" for i in range(timed)], 64)
        trace_path = workdir / "trace_serve.json"
        with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
                     ) as prof:
            traced_s, _ = checked_round(
                [f"serve traced {i}: a crowded market street in the rain"
                 for i in range(timed)], 16)
        prof.export_chrome_trace(str(trace_path))
        busy_ms, ops, _ = device_time(json.loads(trace_path.read_text()))
        trace_path.unlink()
        idle = 1.0 - busy_ms / (elapsed16 * 1e3)
        p50, p95 = float(np.percentile(lat16, 50)) * 1e3, float(np.percentile(lat16, 95)) * 1e3
        qps = {1: SERVE_SERIAL / elapsed1, 16: timed / elapsed16, 64: timed / elapsed64}
        log("serve", f"{SERVE_SERIAL} + 3 x {timed} searches over {ntotal} rows through "
            f"RetrievalServer, every answer tie-aware equal to the exact f32 reference")
        log("numbers", f"served p50 {p50:.3f} ms, p95 {p95:.3f} ms at concurrency 16 "
            f"({timed} requests, limit 10); serial p50 {np.percentile(lat1, 50) * 1e3:.3f} ms")
        log("numbers", "served QPS at concurrency 1 / 16 / 64: "
            f"{qps[1]:.1f} / {qps[16]:.1f} / {qps[64]:.1f}; served_avg_batch "
            f"{avg_batch:.2f} at concurrency 16")
        log("numbers", f"served idle share of the card at concurrency 16: {idle:.4f} (device "
            f"busy {busy_ms:.1f} ms in a traced round of {traced_s * 1e3:.1f} ms against "
            f"{elapsed16 * 1e3:.1f} ms untraced; {ops / timed:.1f} device ops a request)")

        # search_batch of the serial queries: one B1 launch, the single answers
        before = topk.chunk_max_sweep.launches
        status, out = http_call(conn, "POST", "/api/search_batch",
                                {"queries": serial, "limit": 10})
        if status != 200 or len(out["results"]) != SERVE_SERIAL:
            raise AssertionError(f"/api/search_batch answered {status}")
        if require_kernels and topk.chunk_max_sweep.launches - before != 1:
            raise AssertionError("a search_batch of 32 did not launch B1 exactly once")
        check_served(system, out["results"], [vector(t) for t in serial], 10)
        _, _, singles = served.fire(port, serial, 1)
        for text, got, single in zip(serial, out["results"], singles):
            gap = float(np.linalg.norm(vector(text, 0) - vector(text)))
            rows = {(h["folder"], h["image"]): i for i, h in
                    enumerate(got + single["results"])}
            tie_aware_equal([rows[h["folder"], h["image"]] for h in got],
                            [h["similarity_score"] for h in got],
                            [rows[h["folder"], h["image"]] for h in single["results"]],
                            [h["similarity_score"] for h in single["results"]],
                            atol=ATOL_TOPK + gap)
        log("serve", f"search_batch of {SERVE_SERIAL}: one B1 launch, each list tie-aware "
            "equal to its single answer and to the exact reference")

        # image_search: one B5 launch and one B3 per vision layer (serial)
        size = system.embedder.input_size
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(3).integers(0, 256, (size, size, 3),
                                                          dtype=np.uint8)).save(buf, "JPEG")
        before = {k: fn.launches for k, fn in counters.items()}
        status, out = http_call(conn, "POST", "/api/image_search", {
            "image_base64": base64.b64encode(buf.getvalue()).decode(), "limit": 10})
        moved = {k: fn.launches - before[k] for k, fn in counters.items()}
        if status != 200:
            raise AssertionError(f"/api/image_search answered {status}: {out}")
        if require_kernels and (moved["b5"], moved["b3"], moved["b1"]) != (1, n_layers, 1):
            raise AssertionError(f"an image query launched {moved}, expected B5 once, B3 "
                                 f"{n_layers} times, B1 once")
        saved = {k: fn.launches for k, fn in counters.items()}
        pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        qvec = system.embedder.encode_images(pixels[None])[0]
        for k, fn in counters.items():   # the check's own encode is not the served path
            fn.launches = saved[k]
        check_served(system, [out["results"]], [qvec], 10)

        # similar, metadata, stats
        row = 12_345 % ntotal
        meta = system.index.get_metadata(row)
        status, out = http_call(conn, "GET", f"/api/similar/{meta.folder}/{meta.image}?limit=10")
        if status != 200 or out["count"] != 10:
            raise AssertionError(f"/api/similar answered {status}: {out}")
        index = system.index
        qrow = index._container.read_embeddings(row, row + 1, as_float32=True)[0]
        q = torch.from_numpy(qrow / max(float(np.linalg.norm(qrow)), 1e-12)).to(
            index.device, index._dev_x.dtype)[None]
        ref = topk_exact_reference(index._dev_x[:ntotal], q, 11)
        keep = ref.indices[0].cpu().numpy() != row
        ref_ids = ref.indices[0].cpu().numpy()[keep][:10]
        ref_scores = ref.scores[0].cpu().numpy()[keep][:10]
        tie_aware_equal(np.array([index.row_for(h["folder"], h["image"]) for h in out["results"]]),
                        np.array([h["similarity_score"] for h in out["results"]]),
                        ref_ids, ref_scores)
        status, out = http_call(conn, "GET", f"/api/metadata/{meta.folder}/{meta.image}")
        want = synthetic_record(row)
        if status != 200 or any(out["metadata"][k] != want[k] for k in
                                ("folder", "image", "frame_id", "row_id")):
            raise AssertionError(f"/api/metadata answered {status}: {out}")
        status, out = http_call(conn, "GET", "/api/stats")
        if status != 200 or out["stats"]["index"]["ntotal"] != ntotal:
            raise AssertionError(f"/api/stats answered {status}")

        # the admin gate
        status, _ = http_call(conn, "POST", "/api/maintenance", {"action": "clear_cache"})
        status_ok, out = http_call(conn, "POST", "/api/maintenance", {"action": "clear_cache"},
                                   headers={"X-Admin-Token": ADMIN_TOKEN})
        if (status, status_ok) != (401, 200) or not out["report"]["cleared"]:
            raise AssertionError(f"admin gate: {status} without the token, {status_ok} with it")
        log("serve", f"image_search (launches {moved}), similar, metadata and stats checked; "
            "/api/maintenance 401 without the admin token, 200 with it")

        with WebSocketClient("127.0.0.1", port, timeout=300) as ws:
            ws.send_json({"event": "ping", "request_id": "p1"})
            pong = ws.receive_json()
            if pong.get("event") != "pong" or pong.get("request_id") != "p1":
                raise AssertionError(f"/ws ping answered {pong}")
            text = "serve ws: a goal celebration in a stadium"
            ws.send_json({"event": "search", "data": {"query": text, "limit": 10},
                          "request_id": "s1"})
            got = ws.receive_json()
            status, rest = http_call(conn, "POST", "/api/search", {"query": text, "limit": 10})
            if got.get("event") != "result" or got.get("request_id") != "s1" or status != 200:
                raise AssertionError(f"/ws search answered {got.get('event')}")
            check_served(system, [got["results"], rest["results"]],
                         [vector(text, 0), vector(text)], 10)
            rows = {(h["folder"], h["image"]): i for i, h in
                    enumerate(got["results"] + rest["results"])}
            tie_aware_equal([rows[h["folder"], h["image"]] for h in got["results"]],
                            [h["similarity_score"] for h in got["results"]],
                            [rows[h["folder"], h["image"]] for h in rest["results"]],
                            [h["similarity_score"] for h in rest["results"]],
                            atol=ATOL_TOPK + float(np.linalg.norm(vector(text, 0)
                                                                  - vector(text))))

            # the build wizard over a seeded JPEG tree, its progress on this socket
            have_pil = importlib.util.find_spec("PIL") is not None
            have_h5py = importlib.util.find_spec("h5py") is not None
            keyframes = workdir / "keyframes"
            write_keyframes(keyframes, 4, n_frames // 4, size, have_pil)
            system.builder_class = smoke_builder_class(have_pil, have_h5py)
            denied, _ = http_call(conn, "POST", "/api/build",
                                  {"keyframes_dir": str(keyframes)})
            before = {k: fn.launches for k, fn in counters.items()}
            t0 = time.perf_counter()
            status, out = http_call(conn, "POST", "/api/build",
                                    {"keyframes_dir": str(keyframes)},
                                    headers={"X-Admin-Token": ADMIN_TOKEN})
            if (denied, status) != (401, 200):
                raise AssertionError(f"/api/build answered {denied} without the token and "
                                     f"{status} with it")
            events = []
            while not events or events[-1]["event"] == "build_progress":
                events.append(ws.receive_json())
            build_s = time.perf_counter() - t0
        status, state = http_call(conn, "GET", "/api/build/status")
        moved = {k: fn.launches - before[k] for k, fn in counters.items()}
        stages = [e.get("stage") for e in events[:-1]]
        if events[-1]["event"] != "build_done" or events[-1]["processed"] != n_frames or \
                state.get("status") != "done" or stages[0] != "validate" or \
                stages[-2:] != ["index", "done"]:
            raise AssertionError(f"build wizard: events {[e['event'] for e in events]}, "
                                 f"stages {stages}, status {state}")
        if require_kernels and (moved["b5"] < 1 or moved["b3"] != n_layers * moved["b5"]):
            raise AssertionError(f"the build wizard launched {moved}")
        text = "serve built: a red car at night"
        status, out = http_call(conn, "POST", "/api/search", {"query": text, "limit": 10})
        if status != 200 or system.index.ntotal != n_frames:
            raise AssertionError(f"search after the build answered {status}")
        check_served(system, [out["results"]], [vector(text)], 10)
        log("serve", f"/api/build of {n_frames} keyframes in {build_s:.1f} s: "
            f"{len(events) - 1} build_progress events on /ws ({' '.join(stages)}), then "
            f"build_done; launches {moved}; a search over the built rows checked")
    finally:
        conn.close()
        recorder.close()
        system.cleanup()
    launches = {k: fn.launches for k, fn in counters.items()}
    seconds = time.perf_counter() - phase_t0
    log("serve", f"phase in {seconds:.1f} s; launches on the serve path {launches}")
    if require_kernels and any(launches[k] == 0 for k in ("b1", "b3", "b5")):
        raise AssertionError(f"a kernel of the serve path never launched: {launches}")
    return {"launches": launches, "p50_ms": p50, "p95_ms": p95, "qps": qps,
            "avg_batch": avg_batch, "idle_share": idle, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 4c: P2P fan-in, the agents and the Socket.IO wire on the slice's system
# ---------------------------------------------------------------------------

P2P_QUERIES = 8
P2P_TIMED = 20


class PeerContainer(MemoryContainer):
    """The stand-in container of the peer's rows, its records named apart from
    the slice's (``peer_video_*``): the fan-in dedups on (folder, image), so
    rows named alike would merge into one hit without a failure."""

    @staticmethod
    def record(i: int) -> dict:
        rec = synthetic_record(i)
        rec["folder"] = "peer_" + rec["folder"]
        return rec

    def iter_metadata(self):
        return (self.record(i) for i in range(self.num_rows))

    def get_metadata(self, row_id: int) -> dict:
        return self.record(row_id)


def fan_in_reference(indexes: list, qvecs: np.ndarray, limit: int) -> list[tuple]:
    """Per query, the exact top ``limit`` over every index's device rows
    together: (keys, scores), a key being (folder, image)."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_exact_reference,
    )

    q = qvecs / np.maximum(np.linalg.norm(qvecs, axis=1, keepdims=True), 1e-12)
    parts = []
    for index in indexes:
        ref = topk_exact_reference(index._dev_x[:index.ntotal], torch.from_numpy(
            q.astype(np.float32)).to(index.device, index._dev_x.dtype), limit)
        parts.append((index, ref.indices.cpu().numpy(), ref.scores.cpu().numpy()))
    out = []
    for j in range(len(q)):
        cand = [(float(s), index.get_metadata(int(i)).key)
                for index, ids, scores in parts for i, s in zip(ids[j], scores[j])]
        cand.sort(key=lambda c: -c[0])
        out.append(([c[1] for c in cand[:limit]], np.array([c[0] for c in cand[:limit]])))
    return out


def same_keyed_hits(hits: list[dict], keys: list, scores, atol: float | None = None) -> None:
    """Hits (dicts with folder, image, similarity_score) tie-aware equal to
    the reference's keys and scores."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.testing import ATOL_TOPK

    got = [(h["folder"], h["image"]) for h in hits]
    if len(got) != len(keys):
        raise AssertionError(f"{len(got)} hits, expected {len(keys)}")
    ids = {k: i for i, k in enumerate(sorted(set(got) | set(keys)))}
    tie_aware_equal([ids[k] for k in got], [h["similarity_score"] for h in hits],
                    [ids[k] for k in keys], scores, atol=ATOL_TOPK if atol is None else atol)


def run_p2p_phase(device, system, require_kernels: bool, single_p50_ms: float,
                  n_peer: int = N_ROWS, timed: int = P2P_TIMED) -> dict:
    """Phase 4c on the slice's system (its bf16 rows from default_rng(0)): a
    port ``NetworkServer`` on the card shares a second index of ``n_peer``
    bf16 rows from default_rng(1), loaded into ``system.remote_indexes``;
    the fan-in, the remote search, the agents' chat and ``llm_enhanced``, and
    the Socket.IO wire of a ``RetrievalServer`` over the system, each checked
    against its reference. Leaves the system as it found it."""
    import base64
    import io
    import urllib.error
    import urllib.request

    import torch
    from PIL import Image

    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import (
        attention, preprocess, topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve.p2p import (
        NetworkClient,
        NetworkServer,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve.rest import RetrievalServer
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve.websocket import (
        WebSocketClient,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
    )

    phase_t0 = time.perf_counter()
    local = system.index
    dim = local.dim
    t0 = time.perf_counter()
    peer_bits = synthetic_rows_bf16_bits(n_peer, dim, seed=1)
    peer_index = UnifiedIndex(device=device)
    peer_index.attach_container(PeerContainer(peer_bits))
    del peer_bits
    peer = NetworkServer("127.0.0.1", free_port(), node_name="smoke-peer",
                         enable_discovery=False, device=device)
    peer.register_index("peer", peer_index)
    peer.start_server()
    log("p2p", f"peer NetworkServer on 127.0.0.1:{peer.port} shares {peer_index.ntotal} x "
        f"{dim} bf16 rows from numpy.random.default_rng(1) on {peer_index.device} "
        f"(set up in {time.perf_counter() - t0:.1f} s)")
    counters = {"b1": topk.chunk_max_sweep, "b3": attention.fused_mha,
                "b5": preprocess.normalize_images}

    def uncounted(fn, *args, **kwargs):
        """A reference's own work is not the phase's path."""
        saved = {k: c.launches for k, c in counters.items()}
        try:
            return fn(*args, **kwargs)
        finally:
            for k, c in counters.items():
                c.launches = saved[k]

    def prompt_vecs(texts: list[str]) -> np.ndarray:
        """The vectors the facade searches: each prompt encoded alone, as
        ``search`` encodes it."""
        return np.stack([uncounted(system.embedder.encode_text,
                                   [system._clip_prompt(t, SearchOptions())[0]])[0]
                         for t in texts])

    server = RetrievalServer(system, host="127.0.0.1", port=free_port())
    numbers: dict = {}
    try:
        # the P2P path starts here: every launch count from zero
        for c in counters.values():
            c.launches = 0
        client = NetworkClient(timeout_s=120)
        remote = client.load_remote_index("127.0.0.1", peer.port, "peer")
        if (remote.ntotal, remote.dim) != (n_peer, dim):
            raise AssertionError(f"the remote index reports {remote.ntotal} x {remote.dim}")
        system.remote_indexes.append(remote)

        # fan-in: local rows (B1 here) and the peer's (B1 there), merged
        queries = [f"p2p {i}: a red car driving at night past neon signs"
                   for i in range(P2P_QUERIES)]
        opts = SearchOptions(limit=20, use_cache=False)
        answers = []
        for q in queries:
            before = topk.chunk_max_sweep.launches
            answers.append(system.search(q, opts))
            if require_kernels and topk.chunk_max_sweep.launches - before != 2:
                raise AssertionError("a fan-in search did not launch B1 once locally and "
                                     "once on the peer")
        refs = uncounted(fan_in_reference, [local, peer_index], prompt_vecs(queries), 20)
        sources = set()
        for hits, (keys, scores) in zip(answers, refs):
            same_keyed_hits(hits, keys, scores)
            sources |= {h.get("source", "local").split(":")[0] for h in hits}
        if sources != {"local", "remote"}:
            raise AssertionError(f"the fan-in answers hold hits of {sources} only")
        batch = system.search_batch(queries, opts)
        for got, single in zip(batch, answers):
            if [(h["folder"], h["image"], h["similarity_score"]) for h in got] != \
                    [(h["folder"], h["image"], h["similarity_score"]) for h in single]:
                raise AssertionError("search_batch with a remote index differs from search")
        log("p2p", f"{P2P_QUERIES} fan-in searches (limit 20) tie-aware equal to the exact "
            f"f32 reference over both {local.ntotal}-row and {n_peer}-row sets, hits of both; "
            "search_batch equal to search per query")

        # the remote search alone, and a query vector of the wrong length
        qvecs = prompt_vecs(queries[:2])
        for qvec, hits in zip(qvecs, (remote.search_vector(v, top_k=20) for v in qvecs)):
            (keys, scores), = uncounted(fan_in_reference, [peer_index], qvec[None], 20)
            same_keyed_hits(hits, keys, scores)
            if any(h["row_id"] != peer_index.row_for(h["folder"], h["image"]) for h in hits):
                raise AssertionError("a remote hit's row_id is not its row")
        try:
            remote.search_vector(np.zeros(dim - 1, np.float32))
            raise AssertionError("a query vector of the wrong length was answered")
        except urllib.error.HTTPError as exc:
            if exc.code != 400:
                raise AssertionError(f"a wrong-length vector answered {exc.code}") from exc
        log("p2p", "RemoteUnifiedIndex.search_vector tie-aware equal to the peer's exact "
            f"reference; a vector of {dim - 1} values answered 400")

        # the agents: a scripted provider calls search_keyframes, then answers
        script = [{"content": None, "tool_calls": [
                      {"id": "c1", "name": "search_keyframes",
                       "arguments": json.dumps({"query": "a goal celebration in a stadium",
                                                "limit": 5, "mode": "clip_only"})}]},
                  {"content": "Five frames show a celebration.", "tool_calls": None}]
        calls: list = []

        def scripted(messages, tools=None):
            calls.append(len(messages))
            return script[min(len(calls) - 1, len(script) - 1)]

        proc = system.enable_llm(complete_fn=scripted)
        out = system.chat("show me a goal celebration")
        want = system.search("a goal celebration in a stadium",
                             SearchOptions(mode="clip_only", limit=5, use_cache=False))
        if out["method"] != "agent" or out["tool_calls"] != ["search_keyframes"] or \
                out["response"] != script[1]["content"]:
            raise AssertionError(f"chat answered {out['method']}: {out['response']!r}")
        if [(h["folder"], h["image"], h["similarity_score"]) for h in out["search_results"]] \
                != [(h["folder"], h["image"], round(h["similarity_score"], 4)) for h in want]:
            raise AssertionError("the agent's search_results differ from system.search")
        (keys, scores), = uncounted(fan_in_reference, [local, peer_index],
                                    prompt_vecs(["a goal celebration in a stadium"]), 5)
        same_keyed_hits(want, keys, scores)
        # llm_enhanced: the query and three scripted expansions, max-merged
        proc.complete_fn = lambda messages, tools=None: {
            "content": "a red sports car\ncars on a wet street at night\nneon lights",
            "tool_calls": None}
        text = "a red car at night"
        variants = proc.expand_query(text)
        if len(variants) != 4 or variants[0] != text:
            raise AssertionError(f"expand_query gave {variants}")
        got = system.search(text, SearchOptions(mode="llm_enhanced", limit=20, use_cache=False))
        vv = uncounted(system.embedder.encode_text, variants)
        merged: dict = {}
        for keys, scores in uncounted(fan_in_reference, [local, peer_index], vv, 20):
            for k, s in zip(keys, scores):
                merged[k] = max(merged.get(k, -np.inf), float(s))
        best = sorted(merged, key=lambda k: -merged[k])[:20]
        same_keyed_hits(got, best, np.array([merged[k] for k in best]))
        log("p2p", "agents: chat through a scripted search_keyframes call equals "
            "system.search (clip_only, limit 5) and the exact reference; llm_enhanced with 4 "
            "scripted variants equals the merge of their exact references")

        # the Socket.IO wire of the REST server over the same system
        server.run(block=False)
        base = f"http://127.0.0.1:{server.port}/socket.io/?EIO=4"

        def get(url: str) -> str:
            with urllib.request.urlopen(url, timeout=120) as resp:
                return resp.read().decode()

        def post(url: str, body: str) -> str:
            req = urllib.request.Request(url, data=body.encode(),
                                         headers={"Content-Type": "text/plain;charset=UTF-8"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.read().decode()

        def rest_call(path: str, payload: dict) -> dict:
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())

        def event(packet: str) -> tuple[str, dict]:
            if not packet.startswith("42"):
                raise AssertionError(f"expected an event, got {packet[:80]!r}")
            name, data = json.loads(packet[2:])
            return name, data

        def receive(ws) -> str:
            """The next packet that is not the server's ping (answered)."""
            while True:
                packet = ws.receive()[1].decode()
                if packet != "2":
                    return packet
                ws.send(1, b"3")

        def same_answers(a: list[dict], b: list[dict]) -> None:
            same_keyed_hits(a, [(h["folder"], h["image"]) for h in b],
                            [h["similarity_score"] for h in b], atol=0.0)

        hello = get(base + "&transport=polling")
        sid = json.loads(hello[1:])["sid"]
        poll = f"{base}&transport=polling&sid={sid}"
        post(poll, "40")
        packets = get(poll).split("\x1e")
        if not packets[0].startswith("40") or event(packets[1])[0] != "connected":
            raise AssertionError(f"namespace connect answered {packets}")
        text = "socket.io: people walking on a beach at sunset"
        post(poll, "42" + json.dumps(["search", {"query": text, "limit": 10}]))
        name, sio_out = event(get(poll).split("\x1e")[0])
        system.cache.clear()
        rest_out = rest_call("/api/search", {"query": text, "limit": 10})
        if name != "result" or sio_out["count"] != 10:
            raise AssertionError(f"socket.io search answered {name}")
        same_answers(sio_out["results"], rest_out["results"])
        size = system.embedder.input_size
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(5).integers(0, 256, (size, size, 3),
                                                          dtype=np.uint8)).save(buf, "JPEG")
        jpeg = base64.b64encode(buf.getvalue()).decode()
        with WebSocketClient("127.0.0.1", server.port, timeout=120,
                             path=f"/socket.io/?EIO=4&transport=websocket&sid={sid}") as ws:
            ws.send(1, b"2probe")
            if receive(ws) != "3probe":
                raise AssertionError("the upgrade probe was not answered")
            ws.send(1, b"5")
            before = {k: c.launches for k, c in counters.items()}
            ws.send(1, ('42["image_search", {"image_base64": "%s", "limit": 10}]'
                        % jpeg).encode())
            name, img_out = event(receive(ws))
            moved = {k: c.launches - before[k] for k, c in counters.items()}
            if name != "image_search_result" or img_out["count"] != 10:
                raise AssertionError(f"socket.io image_search answered {name}")
            if require_kernels and (moved["b5"] < 1 or moved["b3"] < 1):
                raise AssertionError(f"socket.io image_search launched {moved}")
            rest_img = rest_call("/api/image_search", {"image_base64": jpeg, "limit": 10})
            same_answers(img_out["results"], rest_img["results"])
            ws.send(1, b'4217["system_stats", {}]')
            ack, stats = receive(ws), receive(ws)
            if not ack.startswith("4317") or event(stats)[0] != "system_stats" or \
                    event(stats)[1]["stats"]["remote_indexes"] != 1:
                raise AssertionError(f"system_stats with an ack answered {ack[:40]!r}")
            # numbers: the Socket.IO search round trip beside /ws's
            sio_rt = []
            for i in range(timed + 2):
                t0 = time.perf_counter()
                ws.send(1, ("42" + json.dumps(["search", {
                    "query": f"socket.io timed {i}: a dog catching a frisbee",
                    "limit": 10}])).encode())
                if event(receive(ws))[0] != "result":
                    raise AssertionError("a socket.io search did not answer a result")
                sio_rt.append((time.perf_counter() - t0) * 1e3)
        with WebSocketClient("127.0.0.1", server.port, timeout=120) as plain:
            ws_rt = []
            for i in range(timed + 2):
                t0 = time.perf_counter()
                plain.send_json({"event": "search", "data": {
                    "query": f"ws timed {i}: a dog catching a frisbee", "limit": 10}})
                if plain.receive_json().get("event") != "result":
                    raise AssertionError("/ws search did not answer a result")
                ws_rt.append((time.perf_counter() - t0) * 1e3)
        log("p2p", "Socket.IO: polling handshake and 40, search equal to /api/search, "
            f"upgrade to WebSocket, image_search equal to /api/image_search (launches {moved}), "
            "system_stats with an ack")
        launches = {k: c.launches for k, c in counters.items()}

        # numbers (not the path): the remote search and the fan-in, warm
        def wall(fn) -> list[float]:
            out = []
            for i in range(timed + 2):
                t0 = time.perf_counter()
                fn(i)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return out[2:]

        tv = prompt_vecs([f"timed {i}: a crowded market street in the rain"
                          for i in range(timed + 2)])
        remote_ms = wall(lambda i: remote.search_vector(tv[i], top_k=20))
        local_ms = wall(lambda i: local.search_vectors(tv[i][None], top_k=20))
        fan_ms = wall(lambda i: system.search(f"fan-in timed {i}: a crowded market street",
                                              SearchOptions(limit=20, use_cache=False)))
        p = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
        numbers = {"remote_p50_ms": p(remote_ms, 50), "remote_p95_ms": p(remote_ms, 95),
                   "local_b1_p50_ms": p(local_ms, 50), "local_b1_p95_ms": p(local_ms, 95),
                   "fan_in_p50_ms": p(fan_ms, 50), "fan_in_p95_ms": p(fan_ms, 95),
                   "single_p50_ms": single_p50_ms,
                   "socketio_search_p50_ms": p(sio_rt[2:], 50),
                   "ws_search_p50_ms": p(ws_rt[2:], 50)}
        log("numbers", f"peer remote search over {n_peer} rows, {timed} warm calls: p50 "
            f"{numbers['remote_p50_ms']:.3f} ms, p95 {numbers['remote_p95_ms']:.3f} ms; local "
            f"search_vectors B=1 p50 {numbers['local_b1_p50_ms']:.3f} ms, p95 "
            f"{numbers['local_b1_p95_ms']:.3f} ms")
        log("numbers", f"fan-in search (local + 1 peer) p50 {numbers['fan_in_p50_ms']:.3f} ms, "
            f"p95 {numbers['fan_in_p95_ms']:.3f} ms; phase 4's single-system p50 "
            f"{single_p50_ms:.3f} ms")
        log("numbers", f"Socket.IO search round trip p50 {numbers['socketio_search_p50_ms']:.3f} "
            f"ms; /ws {numbers['ws_search_p50_ms']:.3f} ms ({timed} warm searches each)")
    finally:
        system.remote_indexes.clear()
        system.llm_processor = None
        system.cache.clear()
        server.stop()
        peer.stop_server()
    if NetworkClient(timeout_s=2).health_check("127.0.0.1", peer.port):
        raise AssertionError("the peer still answers after stop_server")
    seconds = time.perf_counter() - phase_t0
    log("p2p", f"phase in {seconds:.1f} s; launches on the P2P path {launches}; peer stopped, "
        "remote_indexes and llm_processor cleared")
    if require_kernels and any(launches[k] == 0 for k in ("b1", "b3", "b5")):
        raise AssertionError(f"a kernel of the P2P path never launched: {launches}")
    return {"launches": launches, "numbers": numbers, "seconds": seconds}


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

    def __init__(self, bits: np.ndarray, path: Path | None = None) -> None:
        from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import (
            quantize_rows_int8,
        )

        super().__init__(bits, path)
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


def pixels_for_b5(device, gen, batch: int, size: int, in_dtype):
    """(batch, size, size, 3) pixels in [0, 255]: uint8, or float32 off the
    integers (the resize path's values)."""
    import torch

    img = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=device,
                        dtype=torch.uint8)
    if in_dtype == torch.float32:
        img = img.float() + torch.rand(img.shape, generator=gen, device=device) - 0.5
    return img


def check_normalize(img, out_dtype, mean: tuple, std: tuple, timer: Timer) -> dict:
    """B5 on ``img`` against its plain version (``torch.equal``), then the
    kernel's and the plain version's times beside the byte bound."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import preprocess

    got = preprocess.normalize_images(img, mean=mean, std=std, dtype=out_dtype)
    ref = preprocess.normalize_images_reference(img, mean, std, out_dtype)
    if img.device.type == "cuda":
        torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    name = f"{tuple(img.shape)} {img.dtype}->{out_dtype}"
    if not torch.equal(got, ref):
        raise AssertionError(f"B5 {name}: differs from the plain version by {err} (must be "
                             "torch.equal)")
    ms = timer(lambda: preprocess.normalize_images(img, mean=mean, std=std, dtype=out_dtype),
               iters=20)
    plain = timer(lambda: preprocess.normalize_images_reference(img, mean, std, out_dtype),
                  iters=10)
    bd = bound(img.numel() * (img.element_size() + got.element_size()), 3.0 * img.numel(),
               "f32")
    log("kernels", f"B5 normalize_images {name}: torch.equal to the plain version")
    log("numbers", f"B5 {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); no single library call computes it")
    return {"shape": list(img.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": None, **bd}


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
        img = pixels_for_b5(device, gen, batch, size, in_dtype)
        case = check_normalize(img, out_dtype, preprocess.CLIP_IMAGE_MEAN,
                               preprocess.CLIP_IMAGE_STD, timer)
        if in_dtype == torch.uint8:
            b5.update({k: v for k, v in case.items() if k != "shape"})
        del img

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
        ms = timer(lambda: block.fused_ln_mlp(*args), iters=iters, graph=on_card)
        plain = timer(lambda: block.fused_ln_mlp_reference(*args), iters=3)
        lib = timer(library, iters=iters, graph=on_card)
        esize = x.element_size()
        bd = bound(2 * x.numel() * esize + (w1.numel() + w2.numel()) * esize
                   + (3 * d + h) * 4, 4.0 * n_tok * d * h,
                   "bf16" if dtype == torch.bfloat16 else "f32")
        log("numbers", f"B4 {name}: kernel {ms:.4f} ms ({4.0 * n_tok * d * h / ms / 1e9:.1f} "
            f"TFLOP/s), plain {plain:.4f} ms, library unfused chain {lib:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if name == "vision B=256":   # the build path's shape
            b4.update(ms=ms, plain_ms=plain, library_ms=lib, **bd)
        elif name == "vision B=8":   # an image query's
            b4["vit_l_14_b8"] = {"ms": ms, "plain_ms": plain, "library_ms": lib, **bd}
        del args, x, w1, w2, got, ref

    # B4 across the gate: every width class of the kernel's template, token
    # counts around its 64-token tile and beyond one round of clusters, the three
    # activations at one shape (checked, not timed)
    if config is None:
        widths, counts = (128, 512, 768, 1024), (1, 63, 64, 65, 2056, 65_792)
    else:
        widths, counts = (128, 256), (1, 63, 64, 65)
    swept = 0
    for d in widths:
        h = 4 * d if d > 128 else 256
        for n_tok in counts:
            for act in (block.ACTIVATIONS if n_tok == 65 else ("quick_gelu",)):
                x = torch.randn(n_tok, d, generator=gen, device=device).to(torch.bfloat16)
                args = (x, 1.0 + 0.1 * torch.randn(d, generator=gen, device=device),
                        0.1 * torch.randn(d, generator=gen, device=device),
                        (torch.randn(h, d, generator=gen, device=device) / d ** 0.5).to(x.dtype),
                        0.1 * torch.randn(h, generator=gen, device=device),
                        (torch.randn(d, h, generator=gen, device=device) / h ** 0.5).to(x.dtype),
                        0.1 * torch.randn(d, generator=gen, device=device))
                got = block.fused_ln_mlp(*args, act=act)
                ref = block.fused_ln_mlp_reference(*args, act=act)
                err = float((got.float() - ref.float()).abs().max())
                top = float(ref.float().abs().max())
                if not bool(torch.isfinite(got).all()) or err > TOL_LN_MLP * top:
                    plan = block.ln_mlp_plan(n_tok, d)
                    raise AssertionError(f"B4 D={d} H={h} tokens={n_tok} {act} (cluster "
                                         f"{plan['cluster']}): max abs err {err} > {TOL_LN_MLP} "
                                         f"x max abs {top}")
                b4["max_abs_err"] = max(b4["max_abs_err"], err)
                swept += 1
                del args, x, got, ref
    log("kernels", f"B4 fused_ln_mlp bf16 D in {widths} x tokens in {counts}, all activations at "
        f"65 tokens: {swept} cases within {TOL_LN_MLP} x max abs of the plain version")
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
        self._ann = None

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
# phase 6b: the W8A8 tower modes (torch._int_mm products around B1, B3, B5)
# ---------------------------------------------------------------------------

W8A8_FRAMES = 1024        # keyframes the int8_static facade builds
W8A8_ROWS = 1024          # rows from each end of a large product held against the CPU
COS_INT8_ATTN = 0.9999    # int8 attention, card vs CPU, same q, k, v: exact integer products
COS_W8A8 = 0.999          # a W8A8 layer or tower, card vs CPU: bf16 rounds apart


def w8a8_shapes(config) -> list[tuple[str, int, int, int]]:
    """(name, tokens, in, out) of the towers' dense layers: the vision
    tower at B = 8 and 256, the text tower at B = 8."""
    v, t = config.vision, config.text
    out = []
    for tower, b, tokens, d, ratio in (("vision", 8, v.num_patches + 1, v.hidden_size,
                                        v.mlp_ratio),
                                       ("vision", 256, v.num_patches + 1, v.hidden_size,
                                        v.mlp_ratio),
                                       ("text", 8, t.max_length, t.hidden_size, t.mlp_ratio)):
        for layer, k, n in (("qkvo", d, d), ("fc1", d, d * ratio), ("fc2", d * ratio, d)):
            out.append((f"{tower} B={b} {layer} {k}->{n}", b * tokens, k, n))
    return out


def check_w8a8_ops(device, timer: Timer, config=None) -> dict:
    """``w8a8_dense`` on the card against the same op on CPU copies of its
    inputs, ``torch.equal``, dynamic and static (a scale that saturates the
    largest activations), at the towers' shapes (for B = 256 the first and
    last ``W8A8_ROWS`` rows: every row is computed on its own), timed beside
    ``_int_mm`` alone and ``F.linear`` in bf16; int8 attention at (8, 257,
    1024, 16 heads) against the CPU, timed beside B3 on the same q, k, v."""
    import torch
    import torch.nn.functional as F

    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (
        CLIPConfig,
        MultiHeadAttention,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention, quant

    config = config or CLIPConfig.vit_l_14()
    gen = torch.Generator(device=device).manual_seed(10)
    times = {}
    for name, m, k, n in w8a8_shapes(config):
        x = (torch.randn(m, k, generator=gen, device=device) * 2).bfloat16()
        w = torch.randn(n, k, generator=gen, device=device) * k ** -0.5
        b = torch.randn(n, generator=gen, device=device) * 0.02
        a_scale = (x.float().abs().amax() * 0.7 / 127.0).reshape(())
        rows = torch.arange(m) if m <= 2 * W8A8_ROWS else \
            torch.cat([torch.arange(W8A8_ROWS), torch.arange(m - W8A8_ROWS, m)])
        xc, wc, bc = x[rows.to(device)].cpu(), w.cpu(), b.cpu()
        for a in (None, a_scale):
            got = quant.w8a8_dense(x, w, b, a_scale=a)[rows.to(device)].cpu()
            want = quant.w8a8_dense(xc, wc, bc, a_scale=None if a is None else a.cpu())
            if not torch.equal(got, want):
                raise AssertionError(f"w8a8_dense {name} {'static' if a is not None else 'dynamic'}:"
                                     f" the card differs from the CPU by "
                                     f"{(got.float() - want.float()).abs().max().item()}")
        qw = quant.quantize_weight_int8(w)
        x8 = quant.symmetric_int8(x.float(), dim=-1)[0]
        wb = w.bfloat16()
        bb = b.bfloat16()
        t = {"dynamic_ms": timer(lambda: quant.w8a8_dense(x, w, b, qweight=qw)),
             "static_ms": timer(lambda: quant.w8a8_dense(x, w, b, a_scale=a_scale, qweight=qw)),
             "int_mm_ms": timer(lambda: quant._int_mm(x8, qw[0])),
             "bf16_linear_ms": timer(lambda: F.linear(x, wb, bb))}
        times[name] = t
        log("w8a8", f"w8a8_dense {name} ({m} tokens): card torch.equal the CPU "
            f"({len(rows)} rows), dynamic and static; dynamic {t['dynamic_ms']:.3f} ms, static "
            f"{t['static_ms']:.3f} ms, _int_mm alone {t['int_mm_ms']:.3f} ms, F.linear bf16 "
            f"{t['bf16_linear_ms']:.3f} ms")
        del x, w, x8, qw, wb

    v = config.vision
    mha = MultiHeadAttention(v.hidden_size, v.num_heads, int8_attn=True)
    cpu_gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=cpu_gen) * v.hidden_size ** -0.5)
    x = torch.randn(8, v.num_patches + 1, v.hidden_size, generator=cpu_gen).bfloat16()

    def cosine(a, b) -> float:
        return float(F.cosine_similarity(a.float().cpu().reshape(-1, v.hidden_size),
                                         b.float().reshape(-1, v.hidden_size)).min())

    with torch.inference_mode():
        qkv = [proj(x) for proj in (mha.q_proj, mha.k_proj, mha.v_proj)]
        core_want = mha._int8_attention(*qkv)
        want = mha(x)
        mha = mha.to(device)
        xd = x.to(device)
        # the int8 attention itself on the same q, k, v
        cos_core = cosine(mha._int8_attention(*(t.to(device) for t in qkv)), core_want)
        # the whole layer: the bf16 projections round apart on the card and
        # the CPU, and near-uniform weights over 257 keys sit at 0.49 of
        # p8's 1/127 step, so a projection's last bit can move p8 by one
        cos = cosine(mha(xd), want)
        if cos_core < COS_INT8_ATTN or cos < COS_W8A8:
            raise AssertionError(f"int8 attention, card vs CPU: cosine {cos_core} on the same "
                                 f"q, k, v (>= {COS_INT8_ATTN}), {cos} for the layer (>= "
                                 f"{COS_W8A8})")
        q, k_, v_ = mha.q_proj(xd), mha.k_proj(xd), mha.v_proj(xd)
        attn = {"int8_attention_ms": timer(lambda: mha._int8_attention(q, k_, v_)),
                "b3_ms": timer(lambda: attention.fused_mha(q, k_, v_, v.num_heads))
                if device.type == "cuda" else None}
    log("w8a8", f"int8 attention at {tuple(x.shape)}, {v.num_heads} heads, card vs CPU: min "
        f"cosine {cos_core:.7f} on the same q, k, v (>= {COS_INT8_ATTN}), {cos:.7f} for the "
        f"layer with its bf16 projections (>= {COS_W8A8}); {attn['int8_attention_ms']:.3f} ms, "
        f"B3 on the same q, k, v {attn['b3_ms']} ms")
    return {"dense": times, "attention": {"cos_core": cos_core, "cos_layer": cos, **attn}}


def _text_batch(i: int) -> list[str]:
    return [f"w8a8 query {i}-{j}: a red car driving at night past neon signs" for j in range(8)]


def run_w8a8_embedders(device, timer: Timer, config=None, batch: int = 256,
                       n_latency: int = 20) -> dict:
    """The embedder's modes at ViT-L/14 width with seeded towers: ``int8``,
    then ``int8_static`` calibrated by 4 image batches of ``batch`` and 4
    text batches (``self_test`` not counted), its static text tower against
    the same model on the CPU, cosines against the bf16 embedder (printed),
    ``encode_images`` ms per batch and ``encode_text`` B=1 p50 in each mode."""
    import torch
    import torch.nn.functional as F

    from intelligent_video_analysis_retrieval_system_tpu_torch.models.calibrate import (
        set_act_scales,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
        empty_model,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        _CAL_BATCHES,
        CLIPEmbedder,
    )

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize()

    embs = {}
    for mode in ("bfloat16", "int8", "int8_static"):
        embs[mode] = CLIPEmbedder(config=config, compute_dtype=mode, device=device,
                                  image_batch_size=batch)
        embs[mode].ensure_loaded()
    cfg = embs["int8"].config
    w = [e.model.vision_model.encoder.layers[0].mlp.fc1.weight for e in embs.values()]
    if not all(torch.equal(w[0], x) for x in w[1:]):
        raise AssertionError("the three embedders' seeded weights differ")
    static = embs["int8_static"]
    if static.get_stats()["act_scales_calibrated"] or static._cal_seen != {"vision": 0,
                                                                            "text": 0}:
        raise AssertionError(f"self_test counted as calibration: {static._cal_seen}")
    size = cfg.vision.image_size
    images = [np.stack([frame_pixels(100 + i, n, size) for n in range(batch)])
              for i in range(_CAL_BATCHES)]
    t0 = time.perf_counter()
    for i in range(_CAL_BATCHES):
        static.encode_images(images[i])
        static.encode_text(_text_batch(i))
    sync()
    cal_s = time.perf_counter() - t0
    if static.get_stats()["act_scales_calibrated"] != ["text", "vision"]:
        raise AssertionError(f"int8_static after {_CAL_BATCHES} batches: "
                             f"{static.get_stats()['act_scales_calibrated']}")
    emb = {m: (e.encode_images(images[0]), e.encode_text(_text_batch(0))) for m, e in embs.items()}
    if static._cal_seen != {"vision": _CAL_BATCHES, "text": _CAL_BATCHES}:
        raise AssertionError(f"static encodes still calibrate: {static._cal_seen}")
    for m, (img, txt) in emb.items():
        if not (np.isfinite(img).all() and np.isfinite(txt).all()):
            raise AssertionError(f"{m} embeddings are not finite")

    # the static text tower on the card against the same weights and scales on the CPU
    cpu = empty_model(cfg, "cpu", dtype=torch.bfloat16, w8a8=True, w8a8_static=True)
    cpu.load_state_dict({k: v.cpu() for k, v in static.model.state_dict().items()})
    set_act_scales(cpu, static._act_scales)
    tokens = static.tokenizer(_text_batch(0), cfg.text.max_length)
    eot = static.tokenizer.eot_positions(tokens)
    with torch.inference_mode():
        ref = cpu.encode_text(torch.from_numpy(tokens), torch.from_numpy(eot)).float()
    ref = F.normalize(ref, dim=-1).numpy()
    cos_cpu = float(np.sum(emb["int8_static"][1] * ref, -1).min())
    if cos_cpu < COS_W8A8:
        raise AssertionError(f"static text tower: card vs CPU cosine {cos_cpu} < {COS_W8A8}")
    del cpu
    cos_bf16 = {m: (float(np.sum(emb[m][0] * emb["bfloat16"][0], -1).min()),
                    float(np.sum(emb[m][1] * emb["bfloat16"][1], -1).min()))
                for m in ("int8", "int8_static")}
    log("w8a8", f"int8_static: {_CAL_BATCHES} image batches of {batch} and {_CAL_BATCHES} text "
        f"batches calibrated both towers in {cal_s:.1f} s (self_test not counted); static "
        f"encodes finite; static text tower card vs CPU min cosine {cos_cpu:.6f} (>= "
        f"{COS_W8A8}); min cosine against the bf16 embedder (images, texts; random towers, "
        f"not gated): {cos_bf16}")

    numbers = {}
    for m, e in embs.items():
        e.encode_images(images[1])
        sync()
        t0 = time.perf_counter()
        for _ in range(2):
            e.encode_images(images[1])
        sync()
        per_batch = (time.perf_counter() - t0) * 1e3 / 2
        walls = []
        for i in range(n_latency + 2):
            t0 = time.perf_counter()
            e.encode_text([f"latency {m} {i}: people walking on a beach at sunset"])
            walls.append((time.perf_counter() - t0) * 1e3)
        numbers[m] = {"encode_images_ms": per_batch,
                      "encode_text_p50_ms": float(np.percentile(walls[2:], 50))}
    log("numbers", "W8A8 embedders, " + "; ".join(
        f"{m}: encode_images B={batch} {v['encode_images_ms']:.1f} ms per batch "
        f"({batch / v['encode_images_ms'] * 1e3:.0f} images/s), encode_text B=1 p50 "
        f"{v['encode_text_p50_ms']:.2f} ms" for m, v in numbers.items()))
    del embs, static
    return {"numbers": numbers, "cos_cpu": cos_cpu, "cos_bf16": cos_bf16, "cal_s": cal_s}


def run_w8a8_facade(device, require_kernels: bool, config=None, n_frames: int = W8A8_FRAMES,
                    batch_size: int = 256, n_queries: int = N_REQUESTS,
                    workdir: Path | None = None) -> dict:
    """A facade with ``device.compute_dtype = "int8_static"`` builds
    ``n_frames`` keyframes (the build phase's JPEG route), calibrates its
    text tower on 4 requests and keeps ``<index>.act_scales.json`` beside
    the index; a second facade loads the index and is static at once (health
    without the calibrating warning) and answers ``n_queries`` text requests
    and two image queries equal to the exact reference over the built rows
    (tie-aware). Launch counts: B5 once per image batch, B3 once per vision
    layer and forward, B1 once per query, six ``_int_mm`` a layer and
    forward."""
    import importlib.util
    import shutil

    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import (
        attention, preprocess, quant, topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        _CAL_BATCHES,
        CLIPEmbedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
        SearchOptions,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    have_pil = importlib.util.find_spec("PIL") is not None
    have_h5py = importlib.util.find_spec("h5py") is not None
    workdir = workdir or ROOT / "build" / "chip_smoke" / "w8a8_phase"
    shutil.rmtree(workdir, ignore_errors=True)
    keyframes = workdir / "keyframes"
    n_folders = 4
    counters = {"b1": topk.chunk_max_sweep, "b3": attention.fused_mha,
                "b5": preprocess.normalize_images}

    def counts() -> dict:
        return {**{k: fn.launches for k, fn in counters.items()},
                "int_mm": quant.w8a8_dense.calls}

    def facade(name: str) -> EnhancedRetrievalSystem:
        over = {"device": {"compute_dtype": "int8_static"},
                "model": {"image_batch_size": batch_size}, "index": {"chunk_size": 1024}}
        # no embedder given: the config's compute_dtype makes it (ViT-L/14,
        # seeded); a smaller config stands in on the CPU
        emb = None if config is None else CLIPEmbedder(
            config=config, compute_dtype="int8_static", device=device,
            image_batch_size=batch_size)
        system = EnhancedRetrievalSystem(
            Config(config_file=None, base_dir=workdir / name, overrides=over),
            embedder=emb, device=device)
        system.builder_class = smoke_builder_class(have_pil, have_h5py)
        return system

    system = facade("first")
    system.embedder.ensure_loaded()
    cfg = system.embedder.config
    size, vl, tl = cfg.vision.image_size, cfg.vision.num_layers, cfg.text.num_layers
    write_keyframes(keyframes, n_folders, n_frames // n_folders, size, have_pil)
    out_path = workdir / "index" / "w8a8.rvdb"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    sidecar = Path(f"{out_path}.act_scales.json")

    # the int8_static path starts here: every count from zero
    for fn in counters.values():
        fn.launches = 0
    quant.w8a8_dense.calls = 0
    t0 = time.perf_counter()
    out = system.build_system(keyframes, map_dir=workdir / "map", output_path=out_path)
    build_s = time.perf_counter() - t0
    batches = -(-n_frames // batch_size)
    got = counts()
    want = {"b5": batches, "b3": batches * vl, "int_mm": batches * vl * 6}
    if out["report"]["processed"] != n_frames or got["int_mm"] != want["int_mm"] or (
            require_kernels and {k: got[k] for k in ("b5", "b3")} != {"b5": want["b5"],
                                                                     "b3": want["b3"]}):
        raise AssertionError(f"int8_static build: report {out['report']}, counts {got}, "
                             f"expected {want}")
    frozen = json.loads(sidecar.read_text())["towers"] if sidecar.is_file() else {}
    if list(frozen) != (["vision"] if batches >= _CAL_BATCHES else []):
        raise AssertionError(f"after the build the sidecar holds {list(frozen)}")
    log("w8a8", f"int8_static facade built {n_frames} keyframes in {build_s:.1f} s "
        f"({n_frames / build_s:.1f} images/s, {batches} batches of {batch_size}, all calibrating"
        f" the vision tower); counts {got}; {sidecar.name} holds {list(frozen)}")
    for i in range(_CAL_BATCHES):
        system.search(f"calibration request {i}: a busy street market",
                      SearchOptions(limit=10, use_cache=False))
    frozen = json.loads(sidecar.read_text())["towers"]
    if sorted(frozen) != ["text", "vision"] or \
            system.embedder.get_stats()["act_scales_calibrated"] != ["text", "vision"]:
        raise AssertionError(f"after {_CAL_BATCHES} requests the sidecar holds {list(frozen)}")
    built = system.index._container
    system.cleanup()

    # a second facade over the same index: static at once
    second = facade("second")
    if have_h5py:
        second.load_system(out_path)
        route = "load_system"
    else:
        index = UnifiedIndex(second._index_config(), device=device)
        index.attach_container(built)
        second.attach_index(index)
        route = "attach_index over the in-memory stand-in"
    if second.embedder.get_stats()["act_scales_calibrated"] != ["text", "vision"]:
        raise AssertionError("the second facade did not import the scales")
    second.embedder.ensure_loaded()
    health = second.health.comprehensive_health_check()["components"]["embedder"]
    if "calibrating" in str(health["detail"]):
        raise AssertionError(f"health of the loaded int8_static facade: {health}")
    for i in range(n_queries):
        query = f"static request {i}: people walking on a beach at sunset"
        opts = SearchOptions(limit=10, use_cache=False)
        before = counts()
        hits = second.search(query, opts)
        after = counts()
        step = {k: after[k] - before[k] for k in after}
        want_step = {"b1": 1, "b3": 0, "b5": 0, "int_mm": tl * 6}
        if step["int_mm"] != want_step["int_mm"] or (require_kernels and step != want_step):
            raise AssertionError(f"one static request counted {step}, expected {want_step}")
        prompt, _ = second._clip_prompt(query, opts)
        check_hits(second, hits, second.embedder.encode_text([prompt])[0], opts.limit)
    own = []
    builder = second._make_builder()
    for folder in (0, n_folders - 1):
        path = keyframes / f"video_{folder:02d}" / f"{folder + 3:06d}.jpg"
        pixels = builder._decode_one(path)[0]
        before = counts()
        hits = second.search_by_image(pixels, SearchOptions(limit=10))
        after = counts()
        step = {k: after[k] - before[k] for k in after}
        want_step = {"b1": 1, "b3": vl, "b5": 1, "int_mm": vl * 6}
        if step["int_mm"] != want_step["int_mm"] or (require_kernels and step != want_step):
            raise AssertionError(f"one static image query counted {step}, expected {want_step}")
        check_hits(second, hits, second.embedder.encode_images(pixels[None])[0], 10)
        own.append(((hits[0]["folder"], hits[0]["image"]) == (path.parent.name, path.name),
                    round(hits[0]["similarity_score"], 6)))
    if second.embedder._cal_seen != {"vision": 0, "text": 0}:
        raise AssertionError(f"the loaded facade calibrated again: {second.embedder._cal_seen}")
    launches = counts()
    log("w8a8", f"second facade ({route}): static at once, health {health['status']} without "
        f"the calibrating warning; {n_queries} text requests and 2 image queries equal to the "
        f"exact reference (tie-aware), each request one B1 and {tl * 6} _int_mm, each image "
        f"query one B5, {vl} B3, {vl * 6} _int_mm; own frame first, top score: {own}; counts on "
        f"the path {launches}")
    second.cleanup()
    return {"launches": launches, "build_s": build_s, "images_per_s": n_frames / build_s}


# ---------------------------------------------------------------------------
# phase 7: keyframe ingest (the DINO tower, stage 1 and 2, index_videos)
# ---------------------------------------------------------------------------

INGEST_VIDEOS = 2
INGEST_FRAMES = 750      # per video: 30 s at 25 fps
INGEST_SCENES = 6
INGEST_SIZE = (720, 1280)
STAGE2_FOLDERS = 8
STAGE2_PER_FOLDER = 256
COS_DINO = 0.999         # DINO through B3 against the plain attention route / f32
NEAR = 1e-5              # stage 2: a score or similarity this close to its threshold


def probe_cv2():
    """(the cv2 module or None, the route line): video decode and the JPEG
    writes of stage 1 need OpenCV."""
    import importlib.util

    if importlib.util.find_spec("cv2") is None:
        return None, "cv2 is not installed"
    try:
        import cv2
    except ImportError as exc:
        return None, f"cv2 is installed but does not import ({exc})"
    return cv2, f"cv2 {cv2.__version__} imports"


def scene_frames(seed: int, n: int, scenes: int, height: int, width: int,
                 cell: int) -> np.ndarray:
    """``n`` frames of ``scenes`` static scenes (a board of seeded colours in
    ``cell``-pixel squares) with per-frame noise of 0-2 levels."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, height, width, 3), np.uint8)
    per = -(-n // scenes)
    noise = rng.integers(0, 3, (4, height, width, 3), dtype=np.uint8)
    for s in range(scenes):
        board = rng.integers(0, 200, (-(-height // cell), -(-width // cell), 3), dtype=np.uint8)
        base = np.kron(board, np.ones((cell, cell, 1), np.uint8))[:height, :width]
        for i in range(s * per, min(n, (s + 1) * per)):
            out[i] = base + noise[i % 4]
    return out


def write_scene_videos(cv2, root: Path, n_videos: int, n_frames: int, scenes: int,
                       size: tuple[int, int]) -> list[Path]:
    """Seeded MJPG ``.avi`` videos at 25 fps (OpenCV encodes MJPG itself,
    without ffmpeg)."""
    import concurrent.futures as cf

    root.mkdir(parents=True, exist_ok=True)
    h, w = size

    def write(v: int) -> Path:
        path = root / f"video_{v}.avi"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (w, h))
        if not writer.isOpened():
            raise AssertionError(f"cv2.VideoWriter cannot write MJPG to {path}")
        for frame in scene_frames(100 + v, n_frames, scenes, h, w, 80):
            writer.write(frame[..., ::-1])
        writer.release()
        return path

    with cf.ThreadPoolExecutor(max_workers=n_videos) as pool:
        return list(pool.map(write, range(n_videos)))


def tree_digest(root: Path) -> dict[str, str]:
    """Relative path -> sha256 of every file under ``root``."""
    import hashlib

    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def check_masks_on_cpu(steps: list, threshold: float, where: str) -> int:
    """Each recorded device step's keep mask against ``sequential_dedup_carry``
    run on the CPU over the card's own embeddings, from the card's own carry.
    Where the two differ, every decision of the card is replayed in f64: one
    whose cosine lies within NEAR of the threshold may go either way (it is
    printed), any other must be the card's. Returns the steps checked."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import dedup
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.normalize import (
        l2_normalize,
    )

    carry = None
    for new_video, emb, active, keep in steps:
        emb = l2_normalize(emb.float().cpu())
        if new_video:
            carry = torch.zeros(emb.shape[1])
        if active is None:
            want, _ = dedup.sequential_dedup_carry(emb, carry, threshold)
        else:
            want, _ = dedup.sequential_dedup_carry_masked(emb, carry, torch.from_numpy(active),
                                                          threshold)
        if not np.array_equal(keep, want.numpy()):
            last = carry.double().numpy()
            for i, e in enumerate(emb.double().numpy()):
                if active is not None and not active[i]:
                    continue
                sim = float(last @ e)
                if bool(keep[i]) != (sim < threshold):
                    if abs(sim - threshold) > NEAR:
                        raise AssertionError(f"{where}: the card's keep mask differs from the "
                                             f"CPU scan at row {i} (cosine {sim} vs threshold "
                                             f"{threshold})")
                    log("ingest", f"{where}: row {i} decided apart from the CPU scan at cosine "
                        f"{sim:.9f} (within {NEAR} of {threshold})")
                if keep[i]:
                    last = e
        kept = np.nonzero(keep)[0]
        if len(kept):
            carry = emb[kept[-1]]
    return len(steps)


def recording(ff) -> list:
    """Wrap ``ff.dedup_step`` and its embedder's ``device_fn`` so that each
    step's (new video, card embeddings, active, keep) is kept; the embeddings
    stay on the card until the run ends."""
    steps, seen = [], {}
    device_fn = ff.embed_fn.device_fn
    step = ff.dedup_step

    def embed(batch):
        seen["emb"] = device_fn(batch)
        return seen["emb"]

    def dedup_step(batch, carry, active=None):
        keep, new_carry = step(batch, carry, active)
        steps.append((carry is None, seen.pop("emb"), active, keep))
        return keep, new_carry

    ff.embed_fn.device_fn = embed
    ff.dedup_step = dedup_step
    return steps


def write_stage2_keyframes(root: Path, n_folders: int, per_folder: int, size: int = 256) -> None:
    """``root/video_XX/N.jpg`` (PIL, quality 95): runs of 1-6 near-duplicate
    frames (jitter of 0-3 levels) of seeded boards with 8-64 pixel cells,
    every fifth run blurred (a box filter), so that both stages of
    ``apply_filters`` have work."""
    import concurrent.futures as cf

    from PIL import Image

    def folder_frames(f: int) -> list[np.ndarray]:
        rng = np.random.default_rng([7, f])
        frames, run = [], 0
        while len(frames) < per_folder:
            cell = int(rng.choice([8, 16, 32, 64]))
            board = rng.integers(0, 256, (size // cell, size // cell, 3), dtype=np.uint8)
            base = np.kron(board, np.ones((cell, cell, 1), np.uint8)).astype(np.int16)
            if run % 5 == 4:
                k = 9
                pad = np.pad(base, ((k // 2, k // 2), (k // 2, k // 2), (0, 0)), mode="edge")
                base = sum(pad[i:i + size, j:j + size]
                           for i in range(k) for j in range(k)) // (k * k)
            for _ in range(int(rng.integers(1, 7))):
                jitter = rng.integers(0, 4, base.shape, dtype=np.int16)
                frames.append(np.clip(base + jitter, 0, 255).astype(np.uint8))
            run += 1
        return frames[:per_folder]

    def write(f: int) -> None:
        out = root / f"video_{f:02d}"
        out.mkdir(parents=True, exist_ok=True)
        for n, frame in enumerate(folder_frames(f)):
            Image.fromarray(frame).save(out / f"{n}.jpg", format="JPEG", quality=95)

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(n_folders)))


def near_threshold_cases(ff, keyframes: Path, folder: str, images: list[str]) -> list[str]:
    """What could let a card's stage 2 decide a folder apart from the CPU's:
    scores within NEAR (relative) of their percentile thresholds, and
    similarities within NEAR of the dedup, clustering or scene thresholds
    (CPU values; every pair of the folder, a superset of the scans')."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quality

    cfg = ff.config
    pixels = ff._load_uniform([keyframes / folder / img for img in images])
    metrics = quality.quality_metrics(torch.from_numpy(pixels))
    cases = []
    for key, p in (("blur", cfg.blur_drop_percentile), ("edges", cfg.edge_drop_percentile)):
        scores = metrics[key].numpy().astype(np.float64)
        thr = float(np.percentile(scores, p))
        for i in np.nonzero((np.abs(scores - thr) <= NEAR * abs(thr)) & (scores != thr))[0]:
            cases.append(f"{folder}/{images[i]} {key} {scores[i]:.9g} vs threshold {thr:.9g}")
    emb = ff.embed_fn(pixels).astype(np.float64)
    unit = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    sims = unit @ unit.T
    for name, thr in (("in-scene similarity", cfg.in_scene_similarity),
                      ("cluster distance", 1.0 - cfg.cluster_eps),
                      ("scene cut", cfg.scene_threshold)):
        for i, j in zip(*np.nonzero(np.triu(np.abs(sims - thr) <= NEAR, k=1))):
            cases.append(f"{folder}/{images[i]} ~ {images[j]} {name}: cosine {sims[i, j]:.9f} "
                         f"vs {thr}")
    return cases


def run_ingest_phase(device, require_kernels: bool, timer: Timer, clip_config=None,
                     n_videos: int = INGEST_VIDEOS, n_frames: int = INGEST_FRAMES,
                     scenes: int = INGEST_SCENES, size: tuple[int, int] = INGEST_SIZE,
                     frame_batch: int = 128, stage2_folders: int = STAGE2_FOLDERS,
                     stage2_per_folder: int = STAGE2_PER_FOLDER,
                     workdir: Path | None = None) -> dict:
    """Keyframe ingest on the card: the DINO ViT-S/16 tower against its plain
    attention route and its f32 twin, B3 and B5 at DINO's shapes, stage 1
    (``extract_frames_batch`` over seeded videos, sequential and with two
    decode workers, with the pixel embedder and with DINO; or, without cv2,
    the same fused device step over frames made with numpy), stage 2
    (``apply_filters`` against a CPU run over the same JPEGs) and
    ``index_videos``. Every check is fatal."""
    import importlib.util
    import shutil

    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ingest import (
        FrameFilter,
        FrameFilterConfig,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ingest.frames import (
        dino_embedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (
        MultiHeadAttention,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.dino import (
        DINO_IMAGE_MEAN,
        DINO_IMAGE_STD,
        DINOConfig,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import (
        attention,
        preprocess,
    )

    t_phase = time.perf_counter()
    workdir = workdir or ROOT / "build" / "chip_smoke" / "ingest"
    shutil.rmtree(workdir, ignore_errors=True)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(8)
    cv2, route = probe_cv2()
    log("ingest", f"route: {route}: " + (
        "videos are decoded, shrunk and keyframes written by cv2" if cv2 else
        "video decode and the JPEG writes of stage 1 do not run on this machine; the "
        "fused device step of extract_frames runs over frames made with numpy"))

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    # DINO at full width, one batch of frame_batch frames: B3 and B5 at its
    # shapes, then the tower against its plain attention route and in f32
    cfg = DINOConfig.vit_s_16()
    t = cfg.num_patches + 1
    b3 = check_mha(device, gen, timer, frame_batch, t, cfg.hidden_size, cfg.num_heads,
                   timed=True)
    b5 = check_normalize(pixels_for_b5(device, gen, frame_batch, cfg.image_size,
                                       torch.float32),
                         torch.bfloat16, DINO_IMAGE_MEAN, DINO_IMAGE_STD, timer)
    t0 = time.perf_counter()
    dino = dino_embedder(device=device)
    dino32 = dino_embedder(dtype="float32", device=device)
    log("ingest", f"DINO ViT-S/16 towers (bf16 and f32, seeded) built in "
        f"{time.perf_counter() - t0:.1f} s: {cfg.num_layers} x {cfg.hidden_size}, "
        f"{cfg.num_heads} heads, {t} tokens")
    # frames as stage 1 hands them to DINO (shrunk to its input size on the host)
    frames = torch.from_numpy(scene_frames(3, frame_batch, 8, cfg.image_size,
                                           cfg.image_size, 16)).to(device)
    counts = (attention.fused_mha.launches, preprocess.normalize_images.launches)
    got = dino.device_fn(frames)
    sync()
    launched = (attention.fused_mha.launches - counts[0],
                preprocess.normalize_images.launches - counts[1])
    if require_kernels and launched != (cfg.num_layers, 1):
        raise AssertionError(f"one DINO batch launched B3 {launched[0]} and B5 {launched[1]} "
                             f"times, expected {cfg.num_layers} and 1")
    plain_layers = [m for tower in (dino.tower, dino32.tower) for m in tower.modules()
                    if isinstance(m, MultiHeadAttention)]
    for m in plain_layers:
        m.fused_attn = False
    try:
        plain = dino.device_fn(frames)
        full = dino32.device_fn(frames)
    finally:
        for m in plain_layers:
            m.fused_attn = True
    if got.shape != (frame_batch, cfg.hidden_size) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"DINO embeddings {tuple(got.shape)} or not finite")
    cos_plain = float(torch.nn.functional.cosine_similarity(got, plain, dim=-1).min())
    cos_f32 = float(torch.nn.functional.cosine_similarity(got, full, dim=-1).min())
    if min(cos_plain, cos_f32) < COS_DINO:
        raise AssertionError(f"DINO through B3: min cosine {cos_plain} against the plain "
                             f"attention route, {cos_f32} against f32 (< {COS_DINO})")
    log("ingest", f"DINO bf16 B={frame_batch}: launches B3 {launched[0]}, B5 {launched[1]}; "
        f"min cosine {cos_plain:.6f} against the plain attention route, {cos_f32:.6f} "
        f"against the f32 tower (>= {COS_DINO})")

    def per_batch_ms(batch) -> float:
        dino.device_fn(batch)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            dino.device_fn(batch)
        sync()
        return (time.perf_counter() - t0) * 1e3 / 5

    # frames of another size go through the bicubic resize, whose
    # interpolation matrices resize_bilinear builds on the host at every call
    dino_ms = per_batch_ms(frames)
    resized_ms = per_batch_ms(torch.nn.functional.pad(frames, (0, 0, 0, 32, 0, 32)))
    log("numbers", f"DINO ViT-S/16 bf16: {dino_ms:.2f} ms per batch of {frame_batch} "
        f"({frame_batch / dino_ms * 1e3:.0f} frames/s; device_fn on {cfg.image_size}x"
        f"{cfg.image_size} frames, the stage-1 input); {resized_ms:.2f} ms on "
        f"{cfg.image_size + 32}x{cfg.image_size + 32} frames (with the resize)")
    del frames, got, plain, full, dino32

    pixel_cfg = FrameFilterConfig(frame_batch=frame_batch)
    dino_cfg = FrameFilterConfig(frame_batch=frame_batch, dedup_resize=cfg.image_size)
    out = {"route": route, "dino_ms_per_batch": dino_ms,
           "dino_resized_ms_per_batch": resized_ms, "cos_plain": cos_plain,
           "cos_f32": cos_f32, "b3": b3, "b5": b5, "stage1": {}}

    # stage 1; the ingest path's launch counts start here
    attention.fused_mha.launches = 0
    preprocess.normalize_images.launches = 0
    videos = None
    if cv2 is not None:
        t0 = time.perf_counter()
        videos = write_scene_videos(cv2, workdir / "videos", n_videos, n_frames, scenes, size)
        log("ingest", f"{n_videos} videos of {size[1]}x{size[0]}, {n_frames} frames at 25 fps, "
            f"{scenes} static scenes each, MJPG, written in {time.perf_counter() - t0:.1f} s")
        batches = n_videos * -(-n_frames // frame_batch)
        for name, fcfg, embed in (("pixel", pixel_cfg, None), ("dino", dino_cfg, dino)):
            ff = FrameFilter(fcfg, embed_fn=embed, device=device)
            steps = recording(ff)
            runs = {}
            for mode, workers in (("sequential", 0), ("workers=2", 2)):
                root = workdir / name / mode.replace("=", "")
                before = attention.fused_mha.launches, preprocess.normalize_images.launches
                t0 = time.perf_counter()
                reps = ff.extract_frames_batch(videos, root / "kf", root / "map",
                                               workers=workers)
                sync()
                wall = time.perf_counter() - t0
                seen = sum(r.frames_seen for r in reps)
                runs[mode] = (root, reps, wall)
                b3_n = attention.fused_mha.launches - before[0]
                b5_n = preprocess.normalize_images.launches - before[1]
                if require_kernels and name == "dino" and (b3_n, b5_n) != (
                        batches * cfg.num_layers, batches):
                    raise AssertionError(f"DINO extraction ({mode}) launched B3 {b3_n} and B5 "
                                         f"{b5_n} times for {batches} batches")
                log("numbers", f"stage 1 {name} {mode}: {seen} frames of {size[1]}x{size[0]} "
                    f"in {wall:.2f} s ({seen / wall:.1f} frames/s), kept "
                    f"{[r.frames_kept for r in reps]}; launches B3 {b3_n}, B5 {b5_n}")
                out["stage1"][f"{name} {mode}"] = {"frames": seen, "wall_s": wall,
                                                   "frames_per_s": seen / wall,
                                                   "kept": [r.frames_kept for r in reps]}
            (seq_root, seq, _), (par_root, par, _) = runs["sequential"], runs["workers=2"]
            if [(r.video, r.frames_seen, r.frames_kept) for r in par] != \
                    [(r.video, r.frames_seen, r.frames_kept) for r in seq]:
                raise AssertionError(f"stage 1 {name}: the workers' reports differ")
            digest_seq, digest_par = tree_digest(seq_root), tree_digest(par_root)
            if digest_par != digest_seq:
                raise AssertionError(f"stage 1 {name}: keyframes or maps of workers=2 differ "
                                     "from the sequential run's")
            n_checked = check_masks_on_cpu(steps[:batches], fcfg.dedup_threshold,
                                           f"stage 1 {name}")
            if any(r.frames_seen != n_frames for r in seq):
                raise AssertionError(f"stage 1 {name}: frames seen {[r.frames_seen for r in seq]}")
            if name == "pixel" and [r.frames_kept for r in seq] != [scenes] * n_videos:
                raise AssertionError(f"stage 1 pixel: kept {[r.frames_kept for r in seq]}, one "
                                     f"keyframe per scene expected ({scenes})")
            for r in seq:
                lines = (seq_root / "map" / f"{r.video}.csv").read_text().splitlines()
                if lines[0] != "n,pts_time,fps,frame_idx" or len(lines) != r.frames_kept + 1:
                    raise AssertionError(f"map of {r.video}: {lines[:3]}")
                n_, pts, fps, idx = lines[1].split(",")
                if (int(n_), float(fps)) != (0, 25.0) or float(pts) != int(idx) / 25.0:
                    raise AssertionError(f"map of {r.video}: row {lines[1]}")
            log("ingest", f"stage 1 {name}: workers=2 wrote the sequential run's "
                f"{len(digest_seq)} files byte for byte; {n_checked} keep masks equal "
                "sequential_dedup_carry on the CPU over the card's embeddings; map schema "
                "n,pts_time,fps,frame_idx")
    else:
        for name, fcfg, embed in (("pixel", pixel_cfg, None), ("dino", dino_cfg, dino)):
            ff = FrameFilter(fcfg, embed_fn=embed, device=device)
            steps = recording(ff)
            before = attention.fused_mha.launches, preprocess.normalize_images.launches
            t0, kept = time.perf_counter(), []
            for v in range(n_videos):
                video = scene_frames(100 + v, n_frames, scenes, cfg.image_size,
                                     cfg.image_size, 32)
                carry, k = None, 0
                for s in range(0, n_frames, frame_batch):
                    batch = video[s:s + frame_batch]
                    b = len(batch)
                    if b < frame_batch:
                        batch = np.concatenate([batch, np.repeat(batch[-1:], frame_batch - b, 0)])
                    keep, carry = ff.dedup_step(batch, carry)
                    k += int(keep[:b].sum())
                kept.append(k)
            sync()
            wall = time.perf_counter() - t0
            b3_n = attention.fused_mha.launches - before[0]
            b5_n = preprocess.normalize_images.launches - before[1]
            batches = len(steps)
            if require_kernels and name == "dino" and (b3_n, b5_n) != (
                    batches * cfg.num_layers, batches):
                raise AssertionError(f"DINO fused step launched B3 {b3_n} and B5 {b5_n} times "
                                     f"for {batches} batches")
            check_masks_on_cpu(steps, fcfg.dedup_threshold, f"stage 1 {name}")
            if name == "pixel" and kept != [scenes] * n_videos:
                raise AssertionError(f"fused step, pixel embedder: kept {kept}")
            seen = n_videos * n_frames
            log("numbers", f"stage 1 {name} (fused device step only): {seen} frames of "
                f"{cfg.image_size}x{cfg.image_size} in {wall:.2f} s ({seen / wall:.1f} frames/s), "
                f"kept {kept}; launches B3 {b3_n}, B5 {b5_n}; keep masks equal "
                "sequential_dedup_carry on the CPU over the card's embeddings")
            out["stage1"][name] = {"frames": seen, "wall_s": wall, "frames_per_s": seen / wall,
                                   "kept": kept}
    out["launches"] = {"b3": attention.fused_mha.launches,
                       "b5": preprocess.normalize_images.launches}

    # stage 2: apply_filters on the card against the same run on the CPU
    keyframes = workdir / "stage2" / "keyframes"
    t0 = time.perf_counter()
    write_stage2_keyframes(keyframes, stage2_folders, stage2_per_folder)
    n2 = stage2_folders * stage2_per_folder
    log("ingest", f"stage 2: {n2} JPEG keyframes of 256x256 in {stage2_folders} folders "
        f"written with PIL in {time.perf_counter() - t0:.1f} s")
    out["stage2"] = {}
    for mode, fcfg in (("copy", FrameFilterConfig()),
                       ("cluster", FrameFilterConfig(use_clustering=True))):
        reps = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            ff = FrameFilter(fcfg, device=dev)
            t0 = time.perf_counter()
            reps[where] = ff.apply_filters(
                keyframes, output_dir=workdir / "stage2" / f"{mode}_{where}").as_dict()
            sync()
            reps[where + "_s"] = time.perf_counter() - t0
        differ = [f for f in reps["card"]["per_folder"]
                  if reps["card"]["per_folder"][f] != reps["cpu"]["per_folder"][f]]
        ff = FrameFilter(fcfg, device="cpu")
        scanned = ff.fm.scan_keyframes(keyframes)
        for folder in differ:
            cases = near_threshold_cases(ff, keyframes, folder, scanned[folder])
            if not cases:
                raise AssertionError(f"stage 2 {mode}: {folder} card "
                                     f"{reps['card']['per_folder'][folder]} vs CPU "
                                     f"{reps['cpu']['per_folder'][folder]}, and no score or "
                                     f"similarity within {NEAR} of its threshold")
            for case in cases:
                log("ingest", f"stage 2 {mode}: {folder} decided apart near a threshold: {case}")
        rep = reps["card"]
        if rep["frames_in"] != n2 or not 0 < rep["frames_out"] < n2 or \
                rep["dropped_quality"] == 0 or rep["dropped_similarity"] == 0:
            raise AssertionError(f"stage 2 {mode}: report {rep}")
        log("ingest", f"stage 2 {mode}: {n2} -> {rep['frames_out']} frames (quality "
            f"-{rep['dropped_quality']}, similarity -{rep['dropped_similarity']}); "
            f"{len(differ)} of {stage2_folders} folders differ from the CPU run")
        log("numbers", f"stage 2 {mode}: apply_filters {n2 / reps['card_s']:.1f} frames/s on "
            f"the card ({reps['card_s']:.2f} s), {n2 / reps['cpu_s']:.1f} on the CPU")
        out["stage2"][mode] = {"frames": n2, "wall_s": reps["card_s"],
                               "frames_per_s": n2 / reps["card_s"],
                               "cpu_frames_per_s": n2 / reps["cpu_s"],
                               "frames_out": rep["frames_out"], "folders_apart": len(differ)}

    # index_videos: videos -> keyframes -> the seeded ViT-L/14 build -> each
    # keyframe found first by its own image
    if videos is not None:
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
        base = workdir / "index_videos"
        system = EnhancedRetrievalSystem(
            Config(config_file=None, base_dir=base,
                   overrides={"ingest": {"frame_batch": frame_batch}}),
            embedder=CLIPEmbedder(config=clip_config, device=device), device=device)
        system.builder_class = smoke_builder_class(have_pil, have_h5py)
        t0 = time.perf_counter()
        res = system.index_videos(videos, output_path=base / "index" / "videos.rvdb")
        sync()
        wall = time.perf_counter() - t0
        kept = [r["frames_kept"] for r in res["extract"]]
        if res["report"]["processed"] != sum(kept) or res["report"]["failed"] or \
                system.index.ntotal != sum(kept):
            raise AssertionError(f"index_videos: extract {kept}, build {res['report']}")
        builder = system._make_builder()
        kf = system.config.path("keyframes_dir")
        worst = 1.0
        for path in sorted(kf.rglob("*.jpg")):
            hits = system.search_by_image(builder._decode_one(path)[0], SearchOptions(limit=2))
            top = hits[0]
            if (top["folder"], top["image"]) != (path.parent.name, path.name) or \
                    top["similarity_score"] < 0.99:
                raise AssertionError(f"index_videos: {path.parent.name}/{path.name} finds "
                                     f"{top['folder']}/{top['image']} at "
                                     f"{top['similarity_score']}")
            worst = min(worst, top["similarity_score"])
        log("ingest", f"index_videos: {len(videos)} videos -> {sum(kept)} keyframes -> a "
            f"{system.embedder.config.vision.num_layers}-layer ViT build in {wall:.1f} s; "
            f"every keyframe found first by its own image (lowest score {worst:.6f})")
        system.cleanup()
        out["index_videos_s"] = wall
    log("ingest", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def profile_ingest(device, n_frames: int = INGEST_FRAMES, scenes: int = INGEST_SCENES,
                   size: tuple[int, int] = INGEST_SIZE, frame_batch: int = 128) -> dict:
    """Where DINO extraction's time goes: one seeded video through
    ``extract_frames`` with ``--dino``'s configuration (or, without cv2, the
    same frames at 224 x 224 through its fused device step) under a
    ``torch.profiler`` trace: wall, device busy, idle share, device ops per
    batch and the seconds of B3 and B5."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from intelligent_video_analysis_retrieval_system_tpu_torch.ingest import (
        FrameFilter,
        FrameFilterConfig,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ingest.frames import (
        dino_embedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.dino import DINOConfig

    on_card = device.type == "cuda"
    workdir = ROOT / "build" / "chip_smoke" / "profile_ingest"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    cv2, route = probe_cv2()
    edge = DINOConfig.vit_s_16().image_size
    ff = FrameFilter(FrameFilterConfig(frame_batch=frame_batch, dedup_resize=edge),
                     embed_fn=dino_embedder(device=device), device=device)
    if cv2 is not None:
        video = write_scene_videos(cv2, workdir / "videos", 1, n_frames, scenes, size)[0]

        def run() -> None:
            ff.extract_frames(video, workdir / "kf", workdir / "map")
    else:
        frames = scene_frames(100, n_frames, scenes, edge, edge, 32)

        def run() -> None:
            carry = None
            for s in range(0, n_frames, frame_batch):
                batch = frames[s:s + frame_batch]
                if len(batch) < frame_batch:
                    batch = np.concatenate([batch, np.repeat(batch[-1:],
                                                             frame_batch - len(batch), 0)])
                _, carry = ff.dedup_step(batch, carry)
    run()   # warm
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
                 ) as prof:
        t0 = time.perf_counter()
        run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = workdir / "trace_ingest.json"
    prof.export_chrome_trace(str(path))
    busy, ops, per_kernel = device_time(json.loads(path.read_text()))
    path.unlink()
    batches = -(-n_frames // frame_batch)
    row = {"phase": "ingest_dino", "route": route, "frames": n_frames, "batches": batches,
           "wall_s": wall, "frames_per_s": n_frames / wall, "device_busy_s": busy / 1e3,
           "idle_share": 1.0 - busy / 1e3 / wall, "device_ops": ops,
           "ops_per_batch": ops / batches, "b3_s": per_kernel["b3"] / 1e3,
           "b5_s": per_kernel["b5"] / 1e3,
           "other_device_s": (busy - per_kernel["b3"] - per_kernel["b5"]) / 1e3}
    print(json.dumps(row), flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 8: multi-device search (the mesh)
# ---------------------------------------------------------------------------

MESH_SHARDS = 4   # logical shards on the one card: ["cuda:0"] * MESH_SHARDS


def mesh_counters() -> dict:
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk

    return {"b1": topk.chunk_max_sweep, "b2": quant.int8_chunk_max_sweep}


def uncounted(fn):
    """``fn()`` with the kernels' launch counts left as they were: the
    single-device references the mesh's answers are held against are not
    the mesh's path."""
    saved = {k: f.launches for k, f in mesh_counters().items()}
    try:
        return fn()
    finally:
        for k, f in mesh_counters().items():
            f.launches = saved[k]


def smoke_meshes(device) -> dict:
    """``create_mesh()`` (every visible card: one here) and MESH_SHARDS
    logical shards on the same device. A CPU rehearsal passes the CPU."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
    )

    one = create_mesh() if device.type == "cuda" else create_mesh(devices=[device])
    many = create_mesh(MeshSpec(axis_names=("index",), shape=(MESH_SHARDS,)),
                       devices=[device] * MESH_SHARDS)
    return {one.shape["index"]: one, MESH_SHARDS: many}


def wall_p50_p95(fn, device, n: int = 20) -> tuple[float, float]:
    """p50/p95 wall milliseconds of ``fn``, each call ended by a
    synchronize, after one warm call."""
    import torch

    def call():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    wall = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        wall.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(wall, 50)), float(np.percentile(wall, 95))


def run_mesh_int8(device, rows: dict, require_kernels: bool, k: int = 20) -> dict:
    """Phase 8, int8 half: ``sharded_topk_int8`` over the int8 kernel phase's
    rows (shards are views of them) on the one-device mesh and on
    MESH_SHARDS logical shards, B = 1 and 8, ``torch.equal`` to the
    single-device ``topk_search_int8`` (ids and scores); B2 launches per
    call; p50 of each at B=1 beside the single-device search's. Then
    ``sharded_ivf_topk`` on the IVF phase's structure partitioned over the
    MESH_SHARDS shards, nprobe 16 and 64, B = 1 and 8, ``torch.equal`` to
    ``ivf_topk``."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann, quant
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import bucket_b
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_ann import (
        make_sharded_ivf,
        sharded_ivf_topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
        place_rows,
        sharded_topk_int8,
    )

    x_i8, xs, dead, n_valid, state = (rows[key] for key in ("x_i8", "xs", "dead", "n_valid",
                                                           "state"))
    n_pad, dim = x_i8.shape
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(8)
    t_phase = time.perf_counter()
    for f in mesh_counters().values():       # the mesh path starts here
        f.launches = 0
    out: dict = {"int8": {}, "ivf": {}}
    for n_sh, mesh in smoke_meshes(device).items():
        xsh, ssh, dsh = (place_rows(mesh, t, n_pad) for t in (x_i8, xs, dead))
        if xsh.buffer is not x_i8 or ssh.buffer is not xs:
            raise AssertionError("the shards are not views of the int8 rows")
        per_call = {}
        for b in (1, 8):
            q = torch.randn(b, dim, generator=gen, device=device)
            before = quant.int8_chunk_max_sweep.launches
            got = sharded_topk_int8(mesh, xsh, ssh, q, k, n_valid, deleted_sharded=dsh)
            per_call[b] = quant.int8_chunk_max_sweep.launches - before
            want = n_sh * len(quant.int8_sweep_plan(bucket_b(b), dim))
            if require_kernels and per_call[b] != want:
                raise AssertionError(f"int8 mesh of {n_sh}: {per_call[b]} B2 launches for B={b}, "
                                     f"not {want}")
            ref = uncounted(lambda: quant.topk_search_int8(x_i8, xs, q, k, n_valid=n_valid,
                                                           deleted=dead))
            if not (torch.equal(got.indices, ref.indices) and torch.equal(got.scores, ref.scores)):
                raise AssertionError(f"int8 mesh of {n_sh} shards, B={b}: not equal to the "
                                     "single-device topk_search_int8")
        q1 = torch.randn(1, dim, generator=gen, device=device)
        p50, p95 = wall_p50_p95(lambda: sharded_topk_int8(mesh, xsh, ssh, q1, k, n_valid,
                                                          deleted_sharded=dsh), device)
        s50, _ = uncounted(lambda: wall_p50_p95(
            lambda: quant.topk_search_int8(x_i8, xs, q1, k, n_valid=n_valid, deleted=dead),
            device))
        out["int8"][n_sh] = {"p50_ms": p50, "p95_ms": p95, "single_p50_ms": s50,
                             "b2_per_call": per_call}
        log("mesh", f"sharded_topk_int8 over {n_valid} x {dim} int8 rows on {n_sh} shard(s) "
            f"({mesh}): B=1 and 8 torch.equal to topk_search_int8; B2 launches per call "
            f"{per_call}; B=1 p50 {p50:.3f} ms, p95 {p95:.3f} ms (single device p50 "
            f"{s50:.3f} ms)")
    mesh = smoke_meshes(device)[MESH_SHARDS]
    xsh, ssh, dsh = (place_rows(mesh, t, n_pad) for t in (x_i8, xs, dead))
    sivf = make_sharded_ivf(mesh, "index", state, xsh.shard_rows)
    for nprobe in (16, 64):
        for b in (1, 8):
            q = torch.randn(b, dim, generator=gen, device=device)
            got = sharded_ivf_topk(mesh, xsh, sivf, q, k, nprobe=nprobe, n_valid=n_valid,
                                   deleted_sharded=dsh, scales_sharded=ssh)
            ref = uncounted(lambda: ann.ivf_topk(x_i8, state, q, k, nprobe=nprobe,
                                                 n_valid=n_valid, deleted=dead, x_scales=xs))
            if not (torch.equal(got.indices, ref.indices) and torch.equal(got.scores, ref.scores)):
                raise AssertionError(f"sharded IVF nprobe={nprobe} B={b}: not equal to ivf_topk")
        q1 = torch.randn(1, dim, generator=gen, device=device)
        p50, p95 = wall_p50_p95(lambda: sharded_ivf_topk(
            mesh, xsh, sivf, q1, k, nprobe=nprobe, n_valid=n_valid, deleted_sharded=dsh,
            scales_sharded=ssh), device)
        s50, _ = wall_p50_p95(lambda: ann.ivf_topk(x_i8, state, q1, k, nprobe=nprobe,
                                                   n_valid=n_valid, deleted=dead, x_scales=xs),
                              device)
        out["ivf"][nprobe] = {"p50_ms": p50, "p95_ms": p95, "single_p50_ms": s50}
        log("mesh", f"sharded_ivf_topk over {MESH_SHARDS} shards, nprobe {nprobe}: B=1 and 8 "
            f"torch.equal to ivf_topk; B=1 p50 {p50:.3f} ms, p95 {p95:.3f} ms (ivf_topk p50 "
            f"{s50:.3f} ms)")
    out["launches"] = {k_: f.launches for k_, f in mesh_counters().items()}
    if require_kernels and out["launches"]["b2"] == 0:
        raise AssertionError("the int8 mesh path never launched B2")
    out["seconds"] = time.perf_counter() - t_phase
    log("mesh", f"int8 half in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


def _mesh_reference(index, q, k: int):
    """The exact masked reference over the mesh index's rows (one shard:
    its buffer) for the f32 query ``q`` (rounded to the rows' dtype, as the
    search rounds it)."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_masked_reference,
    )

    rows = index._sharded._x.buffer
    dead = None if index._sharded._dead is None else index._sharded._dead.buffer
    return topk_masked_reference(rows, q.to(rows.device, rows.dtype), k, index.ntotal,
                                 deleted=dead)


def run_mesh_slice(device, bits: np.ndarray, single: dict, require_kernels: bool,
                   config=None, k: int = 20) -> dict:
    """Phase 8, bf16 half: ``create_system(mesh=create_mesh())`` over the
    slice's rows (a writable in-memory stand-in): text requests through
    ``search`` checked against the exact reference over the shard's rows,
    p50/p95 of warm B=1 queries beside the single-device facade's
    (``single``, phase 4); ``sharded_topk`` over the same rows on the
    one-device mesh (the index's own shard) and on MESH_SHARDS logical shards
    (views of a copy padded to split in MESH_SHARDS), B = 1 and 8, against
    the single-device ``topk_search`` (tie-aware; one shard: ``torch.equal``),
    B1 launches per call; then a delete and an in-place append through the
    facade's index, the answers checked again."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import topk
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
        place_rows,
        sharded_topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    t_phase = time.perf_counter()
    meshes = smoke_meshes(device)
    one = next(m for n, m in meshes.items() if n != MESH_SHARDS)
    for f in mesh_counters().values():       # the mesh path starts here
        f.launches = 0
    system = create_system(torch_device=device, mesh=one)
    if config is not None:
        system.embedder._config_override = config
    system.embedder.ensure_loaded()
    t0 = time.perf_counter()
    index = UnifiedIndex(system._index_config(), device=device, mesh=one)
    index.attach_container(AppendableMemoryContainer(bits))
    system.attach_index(index)
    n, dim = index.ntotal, index.dim
    log("mesh", f"facade on {one}: index of {n} rows on {index._sharded.stats()} in "
        f"{time.perf_counter() - t0:.1f} s")

    def check(hits, qvec, limit: int) -> None:
        rows = np.array([index.row_for(h["folder"], h["image"]) for h in hits])
        scores = np.array([h["similarity_score"] for h in hits], np.float32)
        q = torch.from_numpy(qvec[None] / max(float(np.linalg.norm(qvec)), 1e-12))
        ref = uncounted(lambda: _mesh_reference(index, q.float(), limit))
        tie_aware_equal(rows, scores, ref.indices[0].cpu().numpy(), ref.scores[0].cpu().numpy())

    opts = SearchOptions(limit=10, use_cache=False)
    for i in range(N_REQUESTS):
        text = f"mesh {i}: a red car driving at night past neon signs"
        before = topk.chunk_max_sweep.launches
        hits = system.search(text, opts)
        if require_kernels and topk.chunk_max_sweep.launches != before + 1:
            raise AssertionError("a mesh facade query did not launch B1 once (one shard)")
        check(hits, system.embedder.encode_text([system._clip_prompt(text, opts)[0]])[0], 10)
    lat = []
    for i in range(N_LATENCY + 4):
        t0 = time.perf_counter()
        hits = system.search(f"mesh latency {i}: a crowded market street in the rain", opts)
        if i >= 4:
            lat.append((time.perf_counter() - t0) * 1e3)
        if len(hits) != 10:
            raise AssertionError("a mesh facade query returned a short answer")
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    log("mesh", f"{N_REQUESTS} facade requests tie-aware equal to the exact reference; B=1 e2e "
        f"over {n} rows, {len(lat)} warm queries: p50 {p50:.3f} ms, p95 {p95:.3f} ms "
        f"(single-device facade, phase 4: p50 {single['p50_ms']:.3f} ms, p95 "
        f"{single['p95_ms']:.3f} ms)")

    # the sharded sweep itself over the same rows, one shard and MESH_SHARDS
    buf = index._sharded._x.buffer
    n_pad4 = -(-n // (topk.TILE_N * MESH_SHARDS)) * topk.TILE_N * MESH_SHARDS
    x4 = torch.zeros((n_pad4, dim), dtype=buf.dtype, device=buf.device)
    x4[:buf.shape[0]].copy_(buf)
    gen = torch.Generator(device=device).manual_seed(9)
    sweeps = {}
    for n_sh, mesh in meshes.items():
        xsh = index._sharded._x if mesh is one else place_rows(mesh, x4, n_pad4)
        rows_all = xsh.buffer
        per_call = {}
        for b in (1, 8):
            q = torch.randn(b, dim, generator=gen, device=device)
            q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
            before = topk.chunk_max_sweep.launches
            got = sharded_topk(mesh, xsh, q, k, n)
            per_call[b] = topk.chunk_max_sweep.launches - before
            if require_kernels and per_call[b] != n_sh:
                raise AssertionError(f"bf16 mesh of {n_sh}: {per_call[b]} B1 launches a call")
            ref = uncounted(lambda: topk.topk_search(rows_all, q, k, n_valid=n))
            if n_sh == 1 and not torch.equal(got.indices, ref.indices):
                raise AssertionError("one shard: not the single-device topk_search")
            for i in range(b):
                tie_aware_equal(got.indices[i].cpu().numpy(), got.scores[i].cpu().numpy(),
                                ref.indices[i].cpu().numpy(), ref.scores[i].cpu().numpy())
        q1 = torch.randn(1, dim, generator=gen, device=device).to(torch.bfloat16)
        s_p50, s_p95 = wall_p50_p95(lambda: sharded_topk(mesh, xsh, q1, k, n), device)
        d_p50, _ = uncounted(lambda: wall_p50_p95(
            lambda: topk.topk_search(rows_all, q1, k, n_valid=n), device))
        sweeps[n_sh] = {"p50_ms": s_p50, "p95_ms": s_p95, "single_p50_ms": d_p50,
                        "b1_per_call": per_call}
        log("mesh", f"sharded_topk over {n} x {dim} bf16 rows on {n_sh} shard(s): B=1 and 8 "
            f"tie-aware equal to topk_search; B1 launches per call {per_call}; B=1 p50 "
            f"{s_p50:.3f} ms, p95 {s_p95:.3f} ms (single device p50 {d_p50:.3f} ms)")
    del x4

    # a delete and an in-place append through the facade's index
    text = "mesh maintenance: a dog catching a frisbee in a park"
    qvec = system.embedder.encode_text([system._clip_prompt(text, opts)[0]])[0]
    first = system.search(text, opts)
    top = index.row_for(first[0]["folder"], first[0]["image"])
    index.delete_rows([top])
    after = system.search(text, opts)
    if top in [index.row_for(h["folder"], h["image"]) for h in after]:
        raise AssertionError("a deleted row came back from the mesh facade")
    check(after, qvec, 10)
    searcher, cap = index._sharded, index._capacity
    new = np.random.default_rng(11).standard_normal((8, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    index.incremental_update(new, [{"folder": "mesh_append", "image": f"{i}.jpg",
                                    "frame_id": i} for i in range(8)])
    if index._sharded is not searcher or index._capacity != cap:
        raise AssertionError("the append did not land in place")
    got = index.search_vectors(new, top_k=5)
    if [h[0].metadata.row_id for h in got] != list(range(n, n + 8)):
        raise AssertionError("an appended row is not its own nearest neighbour")
    for i, hits in enumerate(got):
        rows = np.array([h.metadata.row_id for h in hits])
        scores = np.array([h.similarity_score for h in hits], np.float32)
        ref = uncounted(lambda: _mesh_reference(index, torch.from_numpy(new[i:i + 1]), 5))
        tie_aware_equal(rows, scores, ref.indices[0].cpu().numpy(), ref.scores[0].cpu().numpy())
    log("mesh", f"delete of row {top}: gone from the answer, which equals the masked reference; "
        f"8 rows appended in place (capacity {cap}), each its own nearest neighbour, answers "
        "equal to the exact reference")
    launches = {k_: f.launches for k_, f in mesh_counters().items()}
    if require_kernels and launches["b1"] == 0:
        raise AssertionError("the bf16 mesh path never launched B1")
    system.cleanup()
    seconds = time.perf_counter() - t_phase
    log("mesh", f"bf16 half in {seconds:.1f} s; launches {launches}")
    return {"p50_ms": p50, "p95_ms": p95, "sweeps": sweeps, "launches": launches,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phases 9 and 10: the bench in this process, every answer and probe checked
# ---------------------------------------------------------------------------

TOL_P2 = 1e-5   # x max |score|: bf16 products summed in f32 in another order
COS_TOWER = 0.999   # image tower through B3 against the plain attention route


class ProbeChecks:
    """The bench's ``check_probes`` hook: holds what the timed probes returned
    against their plain versions on the same inputs (P1 also against B2), and
    times what the bench does not report: the plain versions and the library
    yardsticks (timed only: the port never calls them), beside each bound.
    Launches made here are taken off the counts again."""

    def __init__(self, device, timer: Timer) -> None:
        self.device, self.timer = device, timer
        self.p1, self.p2, self.p3 = ({"max_abs_err": 0.0} for _ in range(3))
        self.calls: list[str] = []

    def __call__(self, kind: str, **given) -> None:
        before = {k: fn.launches for k, fn in bench_counters().items()}
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        {"sweeps": self.sweeps, "stream": self.stream}[kind](**given)
        for k, fn in bench_counters().items():   # comparisons are not the bench's path
            fn.launches = before[k]

    def sweeps(self, x_i8, xs, q_i8, q_bf16, n_valid, outs) -> None:
        import torch

        from intelligent_video_analysis_retrieval_system_tpu_torch.bench import probes
        from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk

        timer, p1, p2 = self.timer, self.p1, self.p2
        n_pad, dim = x_i8.shape
        dead = torch.zeros(n_pad, dtype=torch.int8, device=x_i8.device)
        plain1 = probes.probe_int8_mma_sweep_plain(x_i8, xs, q_i8, n_valid)
        plain2 = probes.probe_int8_convert_sweep_plain(x_i8, xs, q_bf16, n_valid)
        b2 = quant.int8_chunk_max_sweep(x_i8, xs, q_i8, n_valid, dead)
        live, fin = torch.isfinite(plain1), torch.isfinite(plain2)
        top = float(plain2[fin].abs().max())
        if sorted(outs) != sorted(probes.ROWS_PER_BLOCK):
            raise AssertionError(f"the bench ran the sweeps at {sorted(outs)} rows per block")
        for rpb, (got1, got2) in outs.items():
            if not (torch.equal(got1, plain1) and torch.equal(got1, b2)):
                raise AssertionError(f"P1 rows_per_block={rpb}: chunk maxima differ from the "
                                     "plain version or from B2 with an all-zero tombstone mask")
            p1["max_abs_err"] = max(p1["max_abs_err"],
                                    float((got1[live] - plain1[live]).abs().max()))
            if not torch.equal(torch.isfinite(got2), fin):
                raise AssertionError(f"P2 rows_per_block={rpb}: masked chunks differ")
            err = float((got2[fin] - plain2[fin]).abs().max())
            if err > TOL_P2 * top:
                raise AssertionError(f"P2 rows_per_block={rpb}: max abs err {err} > {TOL_P2} x "
                                     f"max |score| {top}")
            p2["max_abs_err"] = max(p2["max_abs_err"], err)
            log("kernels", f"P1 probe_int8_mma_sweep N={n_pad} D={dim} n_valid={n_valid} "
                f"rows_per_block={rpb}: torch.equal to plain and to B2 (zero tombstones); P2 "
                f"probe_int8_convert_sweep: max_abs_err={err:.3e} vs plain (<= {TOL_P2} x max "
                f"|score| {top:.3f})")
        b2_ms = timer(lambda: quant.int8_chunk_max_sweep(x_i8, xs, q_i8, n_valid, dead), iters=20)
        b2_open = timer(lambda: quant.int8_chunk_max_sweep(x_i8, xs, q_i8, n_valid), iters=20)
        p1["plain_ms"] = timer(
            lambda: probes.probe_int8_mma_sweep_plain(x_i8, xs, q_i8, n_valid), iters=3)
        p2["plain_ms"] = timer(
            lambda: probes.probe_int8_convert_sweep_plain(x_i8, xs, q_bf16, n_valid), iters=3)
        lib1 = None
        if self.device.type == "cuda":
            def int_mm():
                dots = torch._int_mm(x_i8, q_i8.T.contiguous()).float()
                return (dots * xs[:, None]).view(n_pad // topk.CHUNK, topk.CHUNK, 8).amax(dim=1)
            lib1 = timer(int_mm, iters=5)
        chain2 = timer(lambda: ((x_i8.to(torch.bfloat16) @ q_bf16.T).float() * xs[:, None]).view(
            n_pad // topk.CHUNK, topk.CHUNK, 8).amax(dim=1), iters=5)
        out_bytes = n_pad // topk.CHUNK * 8 * 4
        p1.update(library_ms=lib1, **bound(n_pad * dim + n_pad * 4 + 8 * dim + out_bytes,
                                           2.0 * n_pad * dim * 8, "int8"))
        # no one call computes P2: a bf16 matmul rounds the product to bf16
        p2.update(library_ms=None, **bound(n_pad * dim + n_pad * 4 + 8 * dim * 2 + out_bytes,
                                           2.0 * n_pad * dim * 8, "bf16"))
        log("numbers", f"P1 bound {p1['bound_ms']:.4f} ms ({p1['bound_by']}), plain "
            f"{p1['plain_ms']:.4f} ms, library _int_mm + scale + amax {lib1} ms; B2 on the same "
            f"rows {b2_ms:.4f} ms with a tombstone mask, {b2_open:.4f} ms without")
        log("numbers", f"P2 bound {p2['bound_ms']:.4f} ms ({p2['bound_by']}), plain "
            f"{p2['plain_ms']:.4f} ms; a bf16 cast + matmul + scale + amax (rounds the product "
            f"to bf16, so not the same function) {chain2:.4f} ms")
        self.calls.append("sweeps")

    def stream(self, name, x, tile, outs) -> None:
        import torch

        from intelligent_video_analysis_retrieval_system_tpu_torch.bench import probes

        timer, p3 = self.timer, self.p3
        want = probes.probe_stream_plain(x, tile)
        if sorted(outs) != sorted(probes.BLOCKS_PER_SM):
            raise AssertionError(f"the bench ran the stream at {sorted(outs)} blocks per "
                                 "multiprocessor")
        for bpsm, got in outs.items():
            if not torch.equal(got, want):
                raise AssertionError(f"P3 {name} tile={tile} blocks_per_sm={bpsm}: differs "
                                     "from the head of the last tile")
        # another tile height moves the last tile: compared here, not timed
        for other in (8192,):
            if other <= x.shape[0]:
                for bpsm in probes.BLOCKS_PER_SM:
                    if not torch.equal(probes.probe_stream(x, other, bpsm),
                                       probes.probe_stream_plain(x, other)):
                        raise AssertionError(f"P3 {name} tile={other} blocks_per_sm={bpsm}: "
                                             "differs from the head of the last tile")
        log("kernels", f"P3 probe_stream {name} {tuple(x.shape)}: torch.equal to the head of "
            f"the last tile at tiles of {tile} and (where the rows hold one) 8192 rows, at 1, 2 "
            "and 4 blocks per multiprocessor")
        if name == "i8":   # the probes' int8 rows: the kernels line reports this case
            n_bytes = x.shape[0] // tile * tile * x.shape[1] * x.element_size()
            # yardsticks: a copy streams the bytes in and out again (its time is for
            # twice the bytes); PyTorch's integer sum reads them once but is no stream
            clone = timer(lambda: x.clone(), iters=10)
            isum = timer(lambda: x.view(torch.int32).sum(), iters=10)
            p3.update(plain_ms=timer(lambda: probes.probe_stream_plain(x, tile), iters=10),
                      library_ms=clone, library="clone (reads and writes the bytes)",
                      **bound(n_bytes + 8 * 128 * 4, 0.0, "f32"))
            log("numbers", f"P3 i8: library clone {clone:.4f} ms ({2 * n_bytes / clone / 1e6:.0f} "
                f"GB/s read + written; {n_bytes / clone / 1e6:.0f} GB/s counting the bytes "
                f"once), int32 sum of the same bytes {isum:.4f} ms "
                f"({n_bytes / isum / 1e6:.0f} GB/s), bound {p3['bound_ms']:.4f} ms "
                f"({p3['bound_by']})")
        self.calls.append(name)

    def finish(self, report: dict) -> tuple[dict, dict, dict]:
        """The three kernels' records, their times taken from the bench's own
        report (the wrappers' defaults: 128 rows per block, 2 blocks per
        multiprocessor over the int8 rows)."""
        if self.calls != ["sweeps", "bf16", "i8", "i32"]:
            raise AssertionError(f"the bench's probes were checked as {self.calls}")
        v = report["variants"]
        self.p1["ms"] = v["P1_int8_mma_rows128"]["ms"]
        self.p2["ms"] = v["P2_int8_convert_rows128"]["ms"]
        self.p3["ms"] = v["P3_stream_i8_blocks2"]["ms"]
        self.p3["stream_gbps"] = report["stream_gbps"]
        for name, row in v.items():
            log("numbers", f"bench probe {name}: {row['ms']:.4f} ms, {row['gbps']:.0f} GB/s")
        log("numbers", f"P3 measured stream rate: {report['stream_gbps']:.0f} GB/s, "
            f"{report['stream_gbps'] / (HBM_BYTES_PER_S / 1e9):.1%} of the published "
            f"{HBM_BYTES_PER_S / 1e12} TB/s that the bounds use")
        return self.p1, self.p2, self.p3


def bench_counters() -> dict:
    from intelligent_video_analysis_retrieval_system_tpu_torch.bench import probes
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import (
        attention, preprocess, quant, topk,
    )

    return {"b1": topk.chunk_max_sweep, "b2": quant.int8_chunk_max_sweep,
            "b3": attention.fused_mha, "b5": preprocess.normalize_images,
            "p1": probes.probe_int8_mma_sweep, "p2": probes.probe_int8_convert_sweep,
            "p3": probes.probe_stream}


def run_bench_phase(device, require_kernels: bool, argv: list[str], timer: Timer) -> dict:
    """``bench.main(argv)`` with every answer held against its reference, one
    batch of the image tower against the plain attention route, and with
    ``--probes`` every probe against its plain version; prints the bench's
    JSON line and returns it with the launch counts and the probes' records."""
    import contextlib
    import io

    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch import bench
    from intelligent_video_analysis_retrieval_system_tpu_torch.bench import served
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (
        MultiHeadAttention,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import int8_reference
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_exact_reference,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
        ivf_candidate_reference,
    )

    checked = {"headline_1M": 0, "int8_10M": 0, "ivf_10M": 0, "image_tower": 0,
               "image_tower_int8_static": 0, "served_1M": 0, "served_10M_int8_ann": 0,
               "served_10M_int8_dense": 0, "sharded_1M": 0, "anchor_1M25": 0,
               "anchor_1M25_int8": 0, "sharded_ivf_10M": 0}

    def verify_tower(model, pixels, got) -> None:
        """The timed batch again, from the bench's own normalized pixels, with
        every attention layer of the vision tower on its plain route (same
        weights): no kernel is launched."""
        counters = {k: fn.launches for k, fn in bench_counters().items()}
        layers = [m for m in model.vision_model.modules()
                  if isinstance(m, MultiHeadAttention)]
        for m in layers:
            m.fused_attn = False
        try:
            ref = model.encode_image(pixels)
        finally:
            for m in layers:
                m.fused_attn = True
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"image tower: embeddings {tuple(got.shape)} or not finite")
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float(), dim=-1)
        low = float(cos.min())
        if low < COS_TOWER:
            raise AssertionError(f"image tower through B3: cosine {low} < {COS_TOWER} against "
                                 "the plain attention route")
        checked["image_tower"] += len(got)
        log("bench", f"image tower: {len(got)} embeddings {tuple(got.shape)} through B3 in "
            f"{len(layers)} attention layers, min cosine "
            f"{low:.6f} against the plain attention route (>= {COS_TOWER})")
        for k, fn in bench_counters().items():
            if fn.launches != counters[k]:
                raise AssertionError(f"the plain attention route launched kernel {k}")

    def verify_static(model, scales, pixels, got) -> None:
        """The timed W8A8-static tower's first rows again on the CPU, with the
        same weights and scales."""
        from intelligent_video_analysis_retrieval_system_tpu_torch.models.calibrate import (
            set_act_scales,
        )
        from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
            empty_model,
        )

        cpu = empty_model(model.config, "cpu", dtype=model.dtype, w8a8=True, w8a8_static=True)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        set_act_scales(cpu, scales)
        with torch.inference_mode():
            ref = cpu.encode_image(pixels.cpu())
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"static tower: embeddings {tuple(got.shape)} or not finite")
        low = float(torch.nn.functional.cosine_similarity(got.float().cpu(), ref.float(),
                                                          dim=-1).min())
        if low < COS_TOWER:
            raise AssertionError(f"W8A8-static image tower: card vs CPU cosine {low} < "
                                 f"{COS_TOWER}")
        checked["image_tower_int8_static"] += len(got)
        log("bench", f"W8A8-static image tower: the timed model's first {len(got)} embeddings "
            f"against the same weights and scales on the CPU, min cosine {low:.6f} "
            f"(>= {COS_TOWER})")

    def rounded(ref_scores: np.ndarray, decimals: int | None) -> np.ndarray:
        """A reference's scores as a served answer carries them (``round``)."""
        if decimals is None:
            return ref_scores
        return np.array([[round(float(v), decimals) for v in row] for row in ref_scores],
                        np.float32)

    def verify(section, x, scales, n_valid, queries, result, ivf=None,
               decimals=None) -> None:
        counters = {k: fn.launches for k, fn in bench_counters().items()}
        ids, scores = result.indices.cpu().numpy(), result.scores.cpu().numpy()
        if ivf is not None:   # the IVF answers: bit for bit the candidate-set reference
            state, nprobe = ivf
            ref_s, ref_i = ivf_candidate_reference(x, state, queries, ids.shape[1], nprobe,
                                                   n_valid, x_scales=scales)
            ref_s = rounded(ref_s, decimals)
            for i in range(len(queries)):
                if not np.array_equal(scores[i], ref_s[i]):
                    raise AssertionError(f"{section} nprobe={nprobe}: scores differ from the "
                                         "candidate-set reference")
                tie_aware_equal(ids[i], scores[i], ref_i[i], ref_s[i], atol=0.0)
            checked[section] += len(queries)
            return
        for s in range(0, len(queries), 32):   # bounds the reference's score matrix
            q = queries[s:s + 32]
            if scales is None:
                ref, atol = topk_exact_reference(x[:n_valid], q, ids.shape[1]), 5e-4
            else:
                ref, atol = int8_reference(x[:n_valid], scales[:n_valid], q, ids.shape[1]), 0.0
            ref_ids = ref.indices.cpu().numpy()
            ref_scores = rounded(ref.scores.cpu().numpy(), decimals)
            for i in range(len(q)):
                tie_aware_equal(ids[s + i], scores[s + i], ref_ids[i], ref_scores[i], atol=atol)
        checked[section] += len(queries)
        for k, fn in bench_counters().items():   # the references launch no kernel
            if fn.launches != counters[k]:
                raise AssertionError(f"checking the bench's answers launched kernel {k}")

    # the bench's path starts here: every launch count from zero
    for fn in bench_counters().values():
        fn.launches = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    probe_checks = ProbeChecks(device, timer)
    global _LOG_TO
    _LOG_TO = sys.stdout   # the hooks log as every phase does
    try:
        with contextlib.redirect_stdout(stdout):
            rc = bench.main(argv, verify=verify, verify_tower=verify_tower,
                            check_probes=probe_checks, verify_static=verify_static)
    finally:
        _LOG_TO = None
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in bench_counters().items()}
    lines = stdout.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench.main returned {rc} and printed {len(lines)} lines")
    print(lines[0], flush=True)
    result = json.loads(lines[0])
    extra = result["extra"]
    want = ["metric", "value", "p95", "queries", "vs_baseline"]
    want_extra = ["gpu", "image_tower_fps", "image_tower_fps_int8_static",
                  "facade_search_p50_ms", "search_batch_b32_ms",
                  "served_qps_1M", "served_p50_ms", "served_p95_ms", "served_avg_batch",
                  "latency_1M_sharded_1dev_p50_ms", "latency_10M_8chip_anchor_ms",
                  "latency_10M_8chip_anchor_p95_ms", "latency_10M_8chip_anchor_int8_ms",
                  "not_ported"]
    served_10m = ["served_10M_int8_ann", "served_10M_int8_dense"]
    if "--skip-10m" not in argv:
        want_extra += ["latency_10M_int8_1chip_p50_ms", "latency_10M_int8_1chip_p95_ms",
                       "queries_10M", "qps_10M_int8_1chip_b128", "qps_10M_int8_1chip_b32",
                       "latency_2M5_int8_1chip_p50_ms", "latency_5M_int8_1chip_p50_ms",
                       "ivf_build_10M_s", "latency_10M_int8_ivf_np16_p50_ms",
                       "latency_10M_int8_ivf_np64_p50_ms",
                       "latency_10M_int8_sharded_ivf_np32_p50_ms"]
        for name in served_10m:
            suffix = name[len("served_"):]
            want_extra += [f"served_qps_{suffix}", f"served_p50_{suffix}_ms",
                           f"served_p95_{suffix}_ms", f"served_avg_batch_{suffix}"]
    if "--probes" in argv:
        want_extra.append("probes")
    missing = [k for k in want if result.get(k) is None] + \
        [k for k in want_extra if k not in extra]
    if missing or not result["metric"].startswith("e2e_text_query_latency_"):
        raise AssertionError(f"the bench's JSON line lacks {missing}: {lines[0][:300]}")
    log("bench", f"bench.main({argv}) in {seconds:.1f} s: {result['metric']} p50 "
        f"{result['value']} ms, p95 {result['p95']} ms; {checked['headline_1M']} headline "
        f"answers tie-aware equal to the exact f32 reference, {checked['int8_10M']} int8 "
        f"answers equal to int8_reference (atol 0), {checked['ivf_10M']} IVF answers bit for "
        f"bit the candidate-set reference; sharded answers checked (one-device mesh): "
        f"{ {k: v for k, v in checked.items() if 'sharded' in k or 'anchor' in k} }; "
        f"served answers checked: "
        f"{ {k: v for k, v in checked.items() if k.startswith('served')} }; "
        f"launches {launches}")
    if checked["headline_1M"] < result["queries"]:
        raise AssertionError("the bench timed headline answers that were not checked")
    if checked["image_tower"] != extra["image_tower_batch"]:
        raise AssertionError("the bench's image tower batch was not checked")
    if checked["image_tower_int8_static"] != min(8, extra["image_tower_batch"]):
        raise AssertionError("the bench's W8A8-static image tower was not checked")
    if extra["not_ported"] != []:
        raise AssertionError(f"the bench lists {extra['not_ported']} as not ported")
    sharded_short = {k: checked[k] for k in ("sharded_1M", "anchor_1M25", "anchor_1M25_int8")
                     if checked[k] < result["queries"]}
    if "--skip-10m" not in argv and checked["sharded_ivf_10M"] < result["queries"]:
        sharded_short["sharded_ivf_10M"] = checked["sharded_ivf_10M"]
    if sharded_short:
        raise AssertionError(f"the bench timed sharded answers that were not checked: "
                             f"{sharded_short}")
    log("numbers", f"bench sharded sections (one-device mesh): 1M sharded p50 "
        f"{extra['latency_1M_sharded_1dev_p50_ms']} ms; anchor ({extra['anchor_rows']} rows) "
        f"bf16 p50 {extra['latency_10M_8chip_anchor_ms']} ms, p95 "
        f"{extra['latency_10M_8chip_anchor_p95_ms']} ms, int8 p50 "
        f"{extra['latency_10M_8chip_anchor_int8_ms']} ms; sharded IVF nprobe 32 p50 "
        f"{extra.get('latency_10M_int8_sharded_ivf_np32_p50_ms')} ms")
    log("numbers", f"bench image tower ({extra['image_tower']}, B={extra['image_tower_batch']}):"
        f" bf16 {extra['image_tower_fps']} frames/s ({extra['image_tower_ms_per_batch']} ms per "
        f"batch), W8A8-static {extra['image_tower_fps_int8_static']} frames/s "
        f"({extra['image_tower_int8_static_ms_per_batch']} ms per batch)")
    if "--skip-10m" not in argv and checked["ivf_10M"] < 2 * result["queries"]:
        raise AssertionError("the bench timed IVF answers that were not checked")
    if {"ivf_10M", "served_qps", "served_10M"} & set(extra["not_ported"]):
        raise AssertionError(f"the bench still lists {extra['not_ported']} as not ported")
    served_sections = ["served_1M"] + (served_10m if "--skip-10m" not in argv else [])
    short = {k: checked[k] for k in served_sections if checked[k] != served.TIMED}
    if short:
        raise AssertionError(f"served sections checked {short} of {served.TIMED} answers")
    if require_kernels:
        idle = [k for k, n in launches.items() if n == 0
                and not (k == "b2" and "--skip-10m" in argv)
                and not (k.startswith("p") and "--probes" not in argv)]
        if idle:
            raise AssertionError(f"kernels of the bench's path never launched: {idle}")
    out = {"result": result, "launches": launches, "seconds": seconds}
    if "--probes" in argv:
        out["probes"] = probe_checks.finish(extra["probes"])
    return out


# ---------------------------------------------------------------------------
# phase 11: the int8 facade opened record by record, then through its sidecars
# ---------------------------------------------------------------------------


def run_open_phase(device, bits: np.ndarray, config=None, workdir: Path | None = None) -> dict:
    import shutil

    from intelligent_video_analysis_retrieval_system_tpu_torch.index.metacols import (
        ColumnarMetadata,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
        SearchOptions,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    workdir = workdir or ROOT / "build" / "chip_smoke" / "open_phase"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    # the rows have no file, only a path for the index to keep its sidecars at
    container = Int8MemoryContainer(bits, workdir / "open.rvdb")
    log("open", f"{len(bits)} rows quantized into an int8 stand-in container in "
        f"{time.perf_counter() - t0:.1f} s")
    embedder = CLIPEmbedder(config=config, device=device)
    embedder.ensure_loaded()
    queries = [f"open {i}: a red car driving at night past neon signs" for i in range(8)]
    opts = SearchOptions(limit=10, use_cache=False)
    runs = {}
    for route in ("records", "sidecars"):
        system = EnhancedRetrievalSystem(Config(config_file=None, base_dir=workdir),
                                         embedder=embedder, device=device)
        index = UnifiedIndex(system._index_config(), device=device)
        t0 = time.perf_counter()
        index.attach_container(container)
        t1 = time.perf_counter()
        system.attach_index(index)
        t2 = time.perf_counter()
        columnar = isinstance(index._metadata, ColumnarMetadata)
        if columnar != (route == "sidecars"):
            raise AssertionError(f"open by {route}: metadata is {type(index._metadata)}")
        hits = [[(h["folder"], h["image"], h["similarity_score"])
                 for h in system.search(q, opts)] for q in queries]
        if any(len(h) != 10 for h in hits):
            raise AssertionError(f"open by {route}: a short answer")
        sidecars = sorted(f.name for f in workdir.glob("open.rvdb.*"))
        log("open", f"int8 facade over {index.ntotal} rows by {route}: index open "
            f"{t1 - t0:.2f} s (metadata {type(index._metadata).__name__}), facade attach "
            f"{t2 - t1:.2f} s; sidecars now {sidecars}")
        runs[route] = {"open_s": t1 - t0, "attach_s": t2 - t1, "hits": hits}
        system.cleanup()   # the stand-in's close does nothing: it serves the next open
    if runs["records"]["hits"] != runs["sidecars"]["hits"]:
        raise AssertionError("the two opens answered differently")
    log("open", "the same 8 x 10 hits from both opens")
    shutil.rmtree(workdir, ignore_errors=True)
    return {k: {"open_s": v["open_s"], "attach_s": v["attach_s"]} for k, v in runs.items()}


# ---------------------------------------------------------------------------
# phase 12: the IVF approximate mode
# ---------------------------------------------------------------------------

ANN_CENTRES = 4096   # clusters of the 1M-row corpus (on uniform rows the recall
                     # guard climbs to nprobe = nlist, which tests nothing)
N_APPEND = 1000
ANN_LADDER = (1, 2, 4, 8, 16)


def clustered_rows_bf16_bits(noise_bits: np.ndarray, centres: int = ANN_CENTRES,
                             noise: float = 0.35, seed: int = 1) -> np.ndarray:
    """Rows around ``centres`` unit directions from numpy.random.default_rng(
    seed), each moved by ``noise`` times the unit direction of its row of
    ``noise_bits`` (the slice's standard-normal rows, as bf16 bits: drawing
    as many normals again takes the host tens of seconds), L2-normalized, as
    bf16 bits; made in blocks to bound host memory."""
    n, dim = noise_bits.shape
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, dim), dtype=np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    out = np.empty((n, dim), np.uint16)
    for s in range(0, n, 131_072):
        e = min(s + 131_072, n)
        z = native.bf16_to_f32(noise_bits[s:e])
        x = c[rng.integers(0, centres, e - s)]
        x += (noise / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-12)) * z
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        out[s:e] = native.f32_to_bf16(x)
    return out


class AppendableMemoryContainer(MemoryContainer):
    """``MemoryContainer`` opened for writing: it also takes appended rows
    and records, tombstones and checkpoints, and holds its ``ann`` group."""

    def __init__(self, bits: np.ndarray) -> None:
        super().__init__(bits, mode="a")
        self._base = len(bits)
        self._records: list[dict] = []
        self._dead: set[int] = set()

    def append_embeddings(self, rows: np.ndarray) -> tuple[int, int]:
        start = self.num_rows
        self._bits = np.concatenate(
            [self._bits, native.f32_to_bf16(np.ascontiguousarray(rows, np.float32))])
        return start, self.num_rows

    def append_metadata(self, records: list[dict]) -> None:
        self._records.extend(dict(r) for r in records)

    def get_metadata(self, row_id: int) -> dict:
        return (synthetic_record(row_id) if row_id < self._base
                else dict(self._records[row_id - self._base]))

    def iter_metadata(self):
        return (self.get_metadata(i) for i in range(self.num_rows))

    def append_journal(self, hashes: list[str]) -> None:
        pass

    def append_deleted(self, row_ids: list[int]) -> None:
        self._dead.update(int(r) for r in row_ids)

    def deleted_rows(self) -> set:
        return set(self._dead)

    def flush_checkpoint(self, extra: dict | None = None) -> None:
        pass


def _hit_rows(index, hits: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    rows = [index.row_for(h["folder"], h["image"]) for h in hits]
    if None in rows:
        raise AssertionError("a hit names no indexed keyframe")
    return np.array(rows), np.array([h["similarity_score"] for h in hits], np.float32)


def _answer_rows(answers) -> tuple[np.ndarray, np.ndarray]:
    return (np.array([h.metadata.row_id for h in answers]),
            np.array([h.similarity_score for h in answers], np.float32))


def check_ivf_answer(index, qvec: np.ndarray, rows: np.ndarray, scores: np.ndarray,
                     k: int) -> None:
    """One answer against the plain candidate-set reference over the index's
    own IVF state (tie-aware, atol 5e-4)."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
        ivf_candidate_reference,
    )

    q = np.asarray(qvec, np.float32).reshape(1, -1)
    q = q / max(float(np.linalg.norm(q)), 1e-12)
    ref_s, ref_i = ivf_candidate_reference(
        index._dev_x, index._ann, torch.from_numpy(q).to(index.device), k,
        index.config.ann_nprobe, index.ntotal, deleted=index._dev_deleted,
        x_scales=index._dev_scales)
    tie_aware_equal(rows, scores, ref_i[0], ref_s[0])


def run_ann_slice(device, require_kernels: bool, bits: np.ndarray, config=None,
                  batch_sizes=(1, 2, 4, 8, 16, 32, 64)) -> dict:
    """The IVF mode through the facade: ``index_type="IndexIVFFlat"`` over
    clustered bf16 rows (``clustered_rows_bf16_bits``) in a writable
    in-memory stand-in. Every answer is checked; returns the launch and call
    counts and the times."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
        UnifiedIndexConfig,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann, attention, topk
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the IVF rescore would not be full f32")
    dim = bits.shape[1]
    # the ANN path starts here: every count from zero
    topk.chunk_max_sweep.launches = 0
    attention.fused_mha.launches = 0
    ann.ivf_topk.calls = 0
    system = create_system(torch_device=device, index={"index_type": "IndexIVFFlat"})
    if config is not None:
        system.embedder._config_override = config
    system.embedder.ensure_loaded()
    container = AppendableMemoryContainer(bits)
    index = UnifiedIndex(system._index_config(), device=device)
    t0 = time.perf_counter()
    index.attach_container(container)
    opened = time.perf_counter() - t0
    system.attach_index(index)
    if not index.ann_active:
        raise AssertionError("the IVF index type opened without the ANN mode")
    first = index._ann
    t0 = time.perf_counter()
    report = index.build_ann(check_recall=True)
    build_s = time.perf_counter() - t0
    if not index.ann_active or not all(torch.equal(a, b) for a, b in zip(
            (first.centroids, first.bucket_ids, first.tail_ids),
            (index._ann.centroids, index._ann.bucket_ids, index._ann.tail_ids))):
        raise AssertionError("a second build_ann over the same rows differs from the first")
    nlist = report["nlist"]
    log("ann", f"IndexIVFFlat over {index.ntotal} rows: attach (upload + build + recall guard) "
        f"{opened:.1f} s; build_ann again {build_s:.2f} s, bit for bit the first: nlist "
        f"{nlist}, bucket_cap {report['bucket_cap']}, leftover {report['leftover']}; recall "
        f"guard ladder {report['recall_check']['ladder']} -> nprobe {index.config.ann_nprobe}")

    nosave = SearchOptions(limit=10, use_cache=False)
    for i in range(N_REQUESTS):
        text = f"ann {i}: a red car driving at night past neon signs"
        before = ann.ivf_topk.calls
        hits = system.search(text, nosave)
        if ann.ivf_topk.calls != before + 1:
            raise AssertionError("a facade query at B=1 did not take the IVF path")
        prompt, _ = system._clip_prompt(text, nosave)
        check_ivf_answer(index, system.embedder.encode_text([prompt])[0],
                         *_hit_rows(index, hits), 10)
    log("ann", f"{N_REQUESTS} facade queries at B=1 through ivf_topk (nprobe "
        f"{index.config.ann_nprobe}), tie-aware equal to the candidate-set reference")

    rng = np.random.default_rng(2)
    q8 = rng.standard_normal((8, dim)).astype(np.float32)
    q8 /= np.linalg.norm(q8, axis=1, keepdims=True)
    # the dense bf16 sweep scores with the query rounded to bf16, the IVF
    # rescore with the f32 query (as in the reference): unit rows move a
    # score by at most the rounding's norm
    q8_bf16 = torch.from_numpy(q8).to(torch.bfloat16).float().numpy()
    slack = np.linalg.norm(q8 - q8_bf16, axis=1)
    exact8 = index.search_vectors(q8, top_k=20, exact=True)
    full8 = index.search_vectors(q8, top_k=20, nprobe=nlist)
    full1 = [index.search_vectors(q8[i:i + 1], top_k=20, nprobe=nlist)[0] for i in range(8)]
    for i, (e, f, g) in enumerate(zip(exact8, full8, full1)):
        tie_aware_equal(*_answer_rows(f), *_answer_rows(e), atol=5e-4 + float(slack[i]))
        tie_aware_equal(*_answer_rows(g), *_answer_rows(f))
    batched = index.search_vectors(q8, top_k=20, nprobe=index.config.ann_nprobe)
    for i, hits in enumerate(batched):
        one = index.search_vectors(q8[i:i + 1], top_k=20, nprobe=index.config.ann_nprobe)[0]
        tie_aware_equal(*_answer_rows(hits), *_answer_rows(one))
        check_ivf_answer(index, q8[i], *_answer_rows(hits), 20)
    big = index.config.ann_max_batch + 1
    before = (topk.chunk_max_sweep.launches, ann.ivf_topk.calls)
    over = index.search_vectors(q8[:big] if big <= 8 else rng.standard_normal(
        (big, dim)).astype(np.float32), top_k=20)
    if require_kernels and topk.chunk_max_sweep.launches <= before[0]:
        raise AssertionError("a batch above ann_max_batch launched no B1 kernel")
    if ann.ivf_topk.calls != before[1]:
        raise AssertionError("a batch above ann_max_batch took the IVF path")
    for e, o in zip(index.search_vectors(q8[:big], top_k=20, exact=True), over):
        tie_aware_equal(*_answer_rows(o), *_answer_rows(e), atol=0.0)
    log("ann", f"nprobe = nlist at B=1 and B=8 equal to exact=True; B=8 equal to eight B=1 "
        f"calls and to the reference; B={big} (above ann_max_batch) took B1, equal to exact")

    lat = {"ann": [], "exact": [], "facade": []}
    for i in range(N_LATENCY + 4):
        qv = rng.standard_normal((1, dim)).astype(np.float32)
        for key, fn in (("ann", lambda: index.search_vectors(qv, top_k=20)),
                        ("exact", lambda: index.search_vectors(qv, top_k=20, exact=True)),
                        ("facade", lambda: system.search(f"ann latency {i}: a market", nosave))):
            t0 = time.perf_counter()
            fn()
            if i >= 4:
                lat[key].append((time.perf_counter() - t0) * 1e3)
    times = {k: (float(np.percentile(v, 50)), float(np.percentile(v, 95)))
             for k, v in lat.items()}
    log("numbers", f"ANN over {index.ntotal} bf16 rows, {N_LATENCY} warm queries at B=1: "
        f"search_vectors IVF p50 {times['ann'][0]:.3f} ms p95 {times['ann'][1]:.3f} ms; "
        f"exact=True p50 {times['exact'][0]:.3f} ms p95 {times['exact'][1]:.3f} ms; facade "
        f"search p50 {times['facade'][0]:.3f} ms p95 {times['facade'][1]:.3f} ms")

    n0 = index.ntotal
    new = rng.standard_normal((N_APPEND, dim)).astype(np.float32)
    index.incremental_update(new, [{"folder": "appended", "image": f"{i:04d}.jpg",
                                    "frame_id": i} for i in range(N_APPEND)])
    if not index.ann_active or index._ann.tail_count < N_APPEND:
        raise AssertionError("the appended rows did not land in the IVF tail")
    for s in range(0, N_APPEND, 4):
        found = [h[0].metadata.row_id for h in index.search_vectors(new[s:s + 4], top_k=1,
                                                                     nprobe=1)]
        if found != list(range(n0 + s, n0 + s + len(found))):
            raise AssertionError(f"appended rows {s}..: found {found}")
    top = index.search_vectors(q8[:4], top_k=5)
    dead = sorted({h.metadata.row_id for hits in top for h in hits})
    index.delete_rows(dead)
    for i, hits in enumerate(index.search_vectors(q8[:4], top_k=50)):
        if {h.metadata.row_id for h in hits} & set(dead):
            raise AssertionError("a deleted row came back")
        check_ivf_answer(index, q8[i], *_answer_rows(hits), 50)
    log("ann", f"{N_APPEND} appended rows in the tail (tail_count {index._ann.tail_count}), each "
        f"found first by its own vector at nprobe 1; {len(dead)} deleted rows never returned")

    t0 = time.perf_counter()
    cx = index.measure_ann_crossover(batch_sizes=batch_sizes)
    log("ann", f"measure_ann_crossover in {time.perf_counter() - t0:.1f} s: ann_max_batch "
        f"{cx['max_batch']} at nprobe {cx['nprobe']}; ladder {cx['ladder']}")
    tuned = (index.config.ann_nprobe, index.config.ann_max_batch)
    launches = {"b1": topk.chunk_max_sweep.launches, "b3": attention.fused_mha.launches,
                "ivf_topk": ann.ivf_topk.calls}
    system.cleanup()
    reopened = UnifiedIndex(UnifiedIndexConfig(), device=device).attach_container(container)
    got = (reopened.config.ann_nprobe, reopened.config.ann_max_batch)
    if not reopened.ann_active or got != tuned or not reopened._ann_crossover_measured:
        raise AssertionError(f"reopened with a default config: ann_active "
                             f"{reopened.ann_active}, (nprobe, max_batch) {got} != {tuned}")
    hits = reopened.search_vectors(new[:1], top_k=1, nprobe=1)[0]
    if hits[0].metadata.row_id != n0:
        raise AssertionError("the reopened index lost an appended row")
    reopened.close()
    log("ann", f"persisted, closed and reopened with a default config: ann_active, nprobe "
        f"{got[0]} and max_batch {got[1]} restored; launches {launches}")
    if require_kernels and (launches["ivf_topk"] == 0 or launches["b1"] == 0
                            or launches["b3"] == 0):
        raise AssertionError(f"the ANN path missed a step: {launches}")
    return {"launches": launches, "build_s": build_s, "open_s": opened, "nlist": nlist,
            "nprobe": tuned[0], "max_batch": tuned[1], "crossover": cx["ladder"],
            "times": times}


def run_ann_int8(device, rows: dict, timer: Timer, n_valid: int | None = None,
                 nlist: int = 8192, batch_sizes=ANN_LADDER) -> dict:
    """``build_ivf`` below the facade over the int8 kernel phase's rows with
    the bench's parameters; answers at nprobe 16 and 64, B = 1 and 8, bit for
    bit the candidate-set reference; then ``ivf_topk`` against
    ``topk_search_int8`` (B2) over the batch sizes, wall and CUDA-event time."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann, quant
    from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
        ivf_candidate_reference,
    )

    x_i8, xs, dead = rows["x_i8"], rows["xs"], rows["dead"]
    n_valid = rows["n_valid"] if n_valid is None else n_valid
    on_card = device.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    calls0 = ann.ivf_topk.calls
    sync()
    t0 = time.perf_counter()
    state, report = ann.build_ivf(x_i8, n_rows=n_valid, x_scales=xs, nlist=nlist,
                                  sample_per_list=48, kmeans_iters=6)
    sync()
    build_s = time.perf_counter() - t0
    log("ann", f"build_ivf over {n_valid} x {x_i8.shape[1]} int8 rows: {build_s:.2f} s, nlist "
        f"{report.nlist}, bucket_cap {report.bucket_cap}, leftover {report.leftover}")
    gen = torch.Generator(device=device).manual_seed(3)
    for nprobe in (16, 64):
        for b in (1, 8):
            q = torch.randn(b, x_i8.shape[1], generator=gen, device=device)
            got = ann.ivf_topk(x_i8, state, q, 20, nprobe=nprobe, n_valid=n_valid,
                               deleted=dead, x_scales=xs)
            ref_s, ref_i = ivf_candidate_reference(x_i8, state, q, 20, nprobe, n_valid,
                                                   deleted=dead, x_scales=xs)
            for i in range(b):
                scores = got.scores[i].cpu().numpy()
                if not np.array_equal(scores, ref_s[i]):
                    raise AssertionError(f"int8 IVF nprobe={nprobe} B={b}: scores differ from "
                                         "the candidate-set reference")
                tie_aware_equal(got.indices[i].cpu().numpy(), scores, ref_i[i], ref_s[i],
                                atol=0.0)
    log("ann", "int8 IVF at nprobe 16 and 64, B = 1 and 8: bit for bit the candidate-set "
        "reference")
    ladder = []
    for b in batch_sizes:
        q = torch.randn(b, x_i8.shape[1], generator=gen, device=device)
        row = {"batch": b}
        for key, fn in (("ivf", lambda: ann.ivf_topk(x_i8, state, q, 10, nprobe=64,
                                                     n_valid=n_valid, deleted=dead,
                                                     x_scales=xs)),
                        ("b2", lambda: quant.topk_search_int8(x_i8, xs, q, 10, n_valid=n_valid,
                                                              deleted=dead))):
            fn()
            sync()
            wall = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                sync()
                wall.append((time.perf_counter() - t0) * 1e3)
            row[f"{key}_wall_ms"] = float(np.median(wall))
            row[f"{key}_event_ms"] = timer(fn, iters=10)
        ladder.append(row)
        log("numbers", f"10M int8 B={b}: ivf_topk nprobe 64 wall {row['ivf_wall_ms']:.3f} ms "
            f"(events {row['ivf_event_ms']:.3f}), topk_search_int8 (B2) wall "
            f"{row['b2_wall_ms']:.3f} ms (events {row['b2_event_ms']:.3f})")
    wins = [r["batch"] for r in ladder if r["ivf_wall_ms"] < r["b2_wall_ms"]]
    crossover = 0
    for r in ladder:
        if r["ivf_wall_ms"] >= r["b2_wall_ms"]:
            break
        crossover = r["batch"]
    log("ann", f"10M int8 crossover by wall time: {crossover} (IVF wins at {wins})")
    rows["state"] = state   # the mesh phase partitions this structure
    return {"build_s": build_s, "nlist": report.nlist, "bucket_cap": report.bucket_cap,
            "leftover": report.leftover, "ladder": ladder, "crossover": crossover,
            "calls": ann.ivf_topk.calls - calls0}


# ---------------------------------------------------------------------------
# phase 13: CLIP contrastive training (parallel/train.py; B3 on its path)
# ---------------------------------------------------------------------------

TRAIN_BATCH = 64
TRAIN_STEPS = 6
TOL_TRAIN_LOSS = 2e-3   # bf16 loss of another attention route or layout, relative
COS_TRAIN_GRAD = 0.999  # first-step gradients per tower, B3 against its plain version
# bf16 first-step gradients of two roundings (the bf16-logit route, the (2, 2)
# layout's partial sums): at the seeded init the softmax is near uniform, the
# gradients are small differences of near-equal terms, and their cosine sits
# at 0.9989-0.9993 on an H100 (text tower lowest; PERF.md section 6)
COS_TRAIN_GRAD_ROUNDING = 0.998
TOL_TRAIN_LOSS_F32 = 1e-5     # f32 (1, 1) against (2, 2): the order of f32 sums only
COS_TRAIN_GRAD_F32 = 0.99999


@contextmanager
def b3_plain_version():
    """The towers' B3 calls run the kernel's plain version on the card (f32
    scores and softmax, as the kernel computes them), so that a training
    step through B3 is held against the same step through its oracle."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention

    kernel = clip.fused_mha
    clip.fused_mha = attention._einsum_attention
    try:
        yield
    finally:
        clip.fused_mha = kernel


def check_train_mha(device, gen, timer: Timer, b: int, t: int, d: int, h: int) -> dict:
    """B3 at a training shape: the forward against its plain version and
    timed beside SDPA (``check_mha``); the gradients through ``fused_mha``
    ``torch.equal`` to ``_einsum_attention``'s on the same q, k, v and output
    gradient (the backward is that einsum, recomputed); the einsum-recompute
    backward timed beside SDPA's backward and SDPA's forward + backward."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention

    out = check_mha(device, gen, timer, b, t, d, h, timed=True)
    q, k, v = (torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    g = torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
    fused = attention.fused_mha(q, k, v, h)
    got = torch.autograd.grad(fused, (q, k, v), g, retain_graph=True)
    want = torch.autograd.grad(attention._einsum_attention(q, k, v, h), (q, k, v), g)
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"B3 B={b} T={t} D={d} H={h}: the gradients through fused_mha "
                             "are not the einsum's")
    g4 = g.view(b, t, h, d // h).transpose(1, 2)
    lib = sdpa(q, k, v, h)
    out.update(
        bwd_ms=timer(lambda: torch.autograd.grad(fused, (q, k, v), g, retain_graph=True),
                     iters=5),
        library_bwd_ms=timer(lambda: torch.autograd.grad(lib, (q, k, v), g4, retain_graph=True),
                             iters=5),
        library_fwd_bwd_ms=timer(lambda: torch.autograd.grad(sdpa(q, k, v, h), (q, k, v), g4),
                                 iters=5),
        # read q, k, v and the output gradient once, write the three gradients;
        # the scores again (2 B T^2 D) and the four gradient products (8 B T^2 D)
        bwd_bound=bound(7 * b * t * d * 2, 10.0 * b * t * t * d, "bf16"))
    log("numbers", f"B3 backward (einsum recompute) B={b} T={t} D={d} H={h}: "
        f"{out['bwd_ms']:.4f} ms; SDPA backward {out['library_bwd_ms']:.4f} ms, SDPA forward + "
        f"backward {out['library_fwd_bwd_ms']:.4f} ms; bound {out['bwd_bound']['bound_ms']:.4f} "
        f"ms ({out['bwd_bound']['bound_by']}); gradients torch.equal to the einsum's")
    return out


def tower_cosines(a: dict, b: dict) -> dict:
    """Cosine between two gradient state dicts, flattened per tower (the
    projections with their towers; ``logit_scale`` with neither)."""
    import torch

    sums = {}
    for name, x in a.items():
        tower = ("vision" if name.startswith(("vision_model", "visual_projection")) else
                 "text" if name.startswith(("text_model", "text_projection")) else None)
        if tower is None:
            continue
        x, y = x.double(), b[name].to(x.device).double()
        s = sums.setdefault(tower, [0.0, 0.0, 0.0])
        s[0] += float(torch.sum(x * y))
        s[1] += float(torch.sum(x * x))
        s[2] += float(torch.sum(y * y))
    return {tower: s[0] / (s[1] * s[2]) ** 0.5 for tower, s in sums.items()}


def train_setup(device, cfg, batch: int):
    """A bf16 trainer with the reference's defaults (remat, B3) on a ``(1,
    1)`` mesh of ``device`` (``create_mesh`` on a card), ``init(0)``, and one
    seeded batch: raw pixels and tokens ending in the EOT id, the largest,
    as the reference's tests build them."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        CLIPTrainer,
        MeshSpec,
        create_mesh,
    )

    spec = MeshSpec(("data", "model"), (1, 1))
    mesh = create_mesh(spec) if device.type == "cuda" else create_mesh(spec, devices=[device])
    trainer = CLIPTrainer(cfg, mesh)
    params, opt_state = trainer.init(0)
    return (trainer, params, opt_state) + train_batch(cfg, batch)


def train_batch(cfg, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """One seeded batch from ``default_rng(0)``: raw pixels and tokens
    ending in the EOT id, the largest, as the reference's tests build them."""
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    pixels = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    eot = cfg.text.vocab_size - 1
    tokens = rng.integers(1, eot, (batch, cfg.text.max_length)).astype(np.int32)
    tokens[:, -1] = eot
    return pixels, tokens


def run_train_phase(device, require_kernels: bool, timer: Timer, config=None,
                    batch: int = TRAIN_BATCH, steps: int = TRAIN_STEPS,
                    workdir: Path | None = None) -> dict:
    """Phase 13: ``CLIPTrainer`` at ViT-L/14 width in bf16 with remat and B3
    (the reference's defaults). B3 at the training shapes first. Then on a
    ``(1, 1)`` mesh: ``init(0)`` and ``steps`` steps on one seeded batch
    (the launch counts start here): every loss finite, the last below the
    first, step ms p50 over steps 2 on, pairs/s, peak memory, B3 launches
    per step = 2 x vision layers. The first step's loss and gradients again
    with B3 on its plain version (``COS_TRAIN_GRAD``), on the reference's
    ``fused_attn=False`` route and on a ``(2, 2)`` mesh of logical shards (B3
    launches = vision layers x 2 x 2 x 2; every split tensor held as 2 shards
    of the right shape; one update applied; ``COS_TRAIN_GRAD_ROUNDING``), and
    the two layouts in f32. A checkpoint after the last step under ``workdir`` (deleted at
    the end): restored bit for bit, the next step's loss ``==`` the live
    state's. Train -> deploy: ``state_dict`` into ``CLIPEmbedder``, its
    ``encode_images`` against the trainer's ``encode_image``."""
    import shutil

    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.preprocess import (
        normalize_images,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        CLIPTrainer,
        MeshSpec,
        TrainConfig,
        create_mesh,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.train import param_spec
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )

    cfg = config or CLIPConfig.vit_l_14()
    vis = cfg.vision
    on_card = device.type == "cuda"
    workdir = workdir or ROOT / "build" / "chip_smoke" / "train_phase"
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # B3 at the shapes of a step: the whole batch, a (2, 2) shard, a 4-way shard
    gen = torch.Generator(device=device).manual_seed(13)
    t = vis.num_patches + 1
    out: dict = {"b3": []}
    for b, d, h in ((batch, vis.hidden_size, vis.num_heads),
                    (batch // 2, vis.hidden_size // 2, vis.num_heads // 2),
                    (batch // 2, vis.hidden_size // 4, vis.num_heads // 4)):
        out["b3"].append(check_train_mha(device, gen, timer, b, t, d, h))
    if on_card:
        torch.cuda.empty_cache()

    trainer, params0, opt0, pixels, tokens = train_setup(device, cfg, batch)
    mesh11 = trainer.mesh
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    attention.fused_mha.launches = 0         # the training path starts here
    params, opt_state, losses, wall = params0, opt0, [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = trainer.train_step(params, opt_state, pixels, tokens)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = attention.fused_mha.launches
    per_step = 2 * vis.num_layers            # forward + remat recompute
    if require_kernels and launches != per_step * steps:
        raise AssertionError(f"B3 launched {launches} times in {steps} steps, not "
                             f"{per_step} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite, or not falling")
    step_ms = float(np.percentile(wall[1:], 50))
    out.update(launches=launches, launches_per_step=launches / steps, losses=losses,
               step_ms=wall, step_ms_p50=step_ms, pairs_per_s=batch / step_ms * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
               accuracy=float(metrics["accuracy"]), scale=float(metrics["scale"]))
    log("train", f"CLIP towers (vision {vis.num_layers} x {vis.hidden_size}, "
        f"{vis.num_heads} heads; text {cfg.text.num_layers} x {cfg.text.hidden_size}) bf16, "
        f"remat, B3, mesh (1, 1), batch {batch}: losses {losses}; step ms {wall}; p50 over "
        f"steps 2-{steps} {step_ms:.1f} ms, {out['pairs_per_s']:.1f} image-text pairs/s; "
        f"peak memory {out['peak_gb']} GB; B3 launches {launches} ({launches / steps:g} a step)")

    def compare(where, loss_a, grads_a, loss_b, grads_b, tol, min_cos):
        rel = abs(float(loss_b) - float(loss_a)) / abs(float(loss_a))
        cos = tower_cosines(grads_a, grads_b)
        if rel > tol or min(cos.values()) < min_cos:
            raise AssertionError(f"{where}: loss {float(loss_b)} vs {float(loss_a)} (rel "
                                 f"{rel:.3e} > {tol}?), gradient cosines {cos} (< {min_cos}?)")
        log("train", f"{where}: loss {float(loss_b):.6f} vs {float(loss_a):.6f} (rel {rel:.3e} "
            f"<= {tol}); gradient cosine per tower {cos} (>= {min_cos})")
        return {"loss": float(loss_b), "rel": rel, "cos": cos}

    # the first step again with B3 on its plain version, and on the reference's
    # other route (fused_attn=False: bf16 logits)
    loss_f, _, g_f = trainer.value_and_grad(params0, pixels, tokens)
    g_f = trainer.state_dict(g_f)
    with b3_plain_version():
        loss_p, _, g_p = trainer.value_and_grad(params0, pixels, tokens)
    out["plain"] = compare("first step, B3 on its plain version", loss_f, g_f, loss_p,
                           trainer.state_dict(g_p), TOL_TRAIN_LOSS, COS_TRAIN_GRAD)
    bmm = CLIPTrainer(cfg, mesh11, TrainConfig(fused_attn=False))
    loss_p, _, g_p = bmm.value_and_grad(params0, pixels, tokens)
    out["unfused"] = compare("first step, fused_attn=False", loss_f, g_f, loss_p,
                             bmm.state_dict(g_p), TOL_TRAIN_LOSS, COS_TRAIN_GRAD_ROUNDING)
    del g_p

    # the same step on a (2, 2) mesh of logical shards of the device
    t22 = CLIPTrainer(cfg, create_mesh(MeshSpec(("data", "model"), (2, 2)),
                                       devices=[device] * 4))
    p22 = t22.shard_params(trainer.state_dict(params0))
    for name, shards in p22.items():
        spec, full = param_spec(name, params0[name][0]), params0[name][0].shape
        dim = spec.index("model") if spec else None
        want = [full] if dim is None else [full[:dim] + (full[dim] // 2,) + full[dim + 1:]] * 2
        if [s.shape for s in shards] != want:
            raise AssertionError(f"(2, 2) mesh: {name} held as {[s.shape for s in shards]}")
    attention.fused_mha.launches = 0
    loss22, _, g22 = t22.value_and_grad(p22, pixels, tokens)
    launches22 = attention.fused_mha.launches
    if require_kernels and launches22 != per_step * 4:
        raise AssertionError(f"(2, 2) mesh: {launches22} B3 launches, not {per_step * 4}")
    sd22 = t22.state_dict(g22)
    out["mesh22"] = compare("(2, 2) mesh, bf16", loss_f, g_f, loss22, sd22,
                            TOL_TRAIN_LOSS, COS_TRAIN_GRAD_ROUNDING)
    out["mesh22"]["launches"] = launches22
    # the reference of phase 13b's first step across processes, on the host
    out["ref22"] = {"loss": float(loss22), "grads": {k: v.cpu() for k, v in sd22.items()}}
    del sd22
    zeros = {name: [torch.zeros_like(s) for s in shards] for name, shards in p22.items()}
    p22, _ = t22.apply_gradients(p22, g22, {"count": 0, "mu": zeros, "nu": zeros})
    if not all(bool(torch.isfinite(s).all()) for shards in p22.values() for s in shards):
        raise AssertionError("(2, 2) mesh: the update is not finite")
    del g22, g_f, p22, zeros
    # in f32 the layouts differ only in the order of f32 sums
    f32 = [CLIPTrainer(cfg, mesh, dtype=torch.float32) for mesh in (mesh11, t22.mesh)]
    (l11, _, g11), (l22, _, g22) = (t.value_and_grad(t.shard_params(trainer.state_dict(params0)),
                                                     pixels, tokens) for t in f32)
    out["mesh22_f32"] = compare("(2, 2) mesh, f32", l11, f32[0].state_dict(g11), l22,
                                f32[1].state_dict(g22), TOL_TRAIN_LOSS_F32, COS_TRAIN_GRAD_F32)
    del g11, g22
    log("train", f"(2, 2) mesh of logical shards: every split tensor in 2 shards; B3 launches "
        f"{launches22}; one update applied, finite")
    if on_card:
        torch.cuda.empty_cache()

    # a checkpoint after the last step, restored bit for bit; the next loss is the same
    try:
        t0 = time.perf_counter()
        path = trainer.save_checkpoint(workdir / "ckpt", params, opt_state, step=steps)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        r_params, r_opt, r_step = trainer.restore_checkpoint(workdir / "ckpt")
        restore_s = time.perf_counter() - t0
        if r_step != steps or r_opt["count"] != opt_state["count"]:
            raise AssertionError(f"checkpoint: step {r_step}, count {r_opt['count']}")
        for live, back in ((params, r_params), (opt_state["mu"], r_opt["mu"]),
                           (opt_state["nu"], r_opt["nu"])):
            for name, shards in live.items():
                if not all(a.device == r.device and torch.equal(a, r)
                           for a, r in zip(shards, back[name])):
                    raise AssertionError(f"checkpoint: {name} not restored bit for bit")
        _, _, m_live = trainer.train_step(params, opt_state, pixels, tokens)
        _, _, m_back = trainer.train_step(r_params, r_opt, pixels, tokens)
        if not float(m_back["loss"]) == float(m_live["loss"]):
            raise AssertionError(f"step {steps + 1} from the restored state: loss "
                                 f"{float(m_back['loss'])}, live {float(m_live['loss'])}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del r_params, r_opt
    out["ckpt"] = {"bytes": size, "save_s": save_s, "restore_s": restore_s,
                   "next_loss": float(m_live["loss"])}
    log("train", f"checkpoint of step {steps}: {size / 1e9:.2f} GB written in {save_s:.1f} s, "
        f"restored in {restore_s:.1f} s, every tensor torch.equal on its device; step "
        f"{steps + 1}'s loss {float(m_live['loss'])!r} from both")

    # train -> deploy
    embedder = CLIPEmbedder(config=cfg, device=device)
    embedder.load_params(trainer.state_dict(params))
    images = pixels[:8]
    got = embedder.encode_images(images)
    with torch.no_grad():
        normed = normalize_images(torch.from_numpy(images).to(device), dtype=trainer.dtype)
        want = torch.nn.functional.normalize(trainer.encode_image(params, normed).float(),
                                             dim=-1).cpu().numpy()
    cos_deploy = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                         * np.linalg.norm(want, axis=-1))
    if cos_deploy.min() < COS_TRAIN_GRAD:
        raise AssertionError(f"train -> deploy: cosines {cos_deploy}")
    out["deploy_cos_min"] = float(cos_deploy.min())
    out["seconds"] = time.perf_counter() - t_phase
    log("train", f"train -> deploy: CLIPEmbedder.load_params(state_dict), encode_images of 8 "
        f"against the trainer's encode_image: min cosine {out['deploy_cos_min']:.6f}; phase "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13b: training across processes (four gloo ranks on the one card)
# ---------------------------------------------------------------------------

TRAIN_MP_WORLD = 4       # ranks of one logical shard each, on a (2, 2) mesh
TRAIN_MP_STEPS = 2
TRAIN_MP_TIMEOUT_S = 420  # all ranks, from the spawn to the last exit


def _config_from(d: dict):
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (
        CLIPConfig,
        CLIPTextConfig,
        CLIPVisionConfig,
    )

    return CLIPConfig(vision=CLIPVisionConfig(**d["vision"]), text=CLIPTextConfig(**d["text"]),
                      logit_scale_init=d["logit_scale_init"])


def _digest(t) -> str:
    import hashlib

    return hashlib.sha1(t.detach().contiguous().cpu().view(-1).numpy().tobytes()).hexdigest()


def train_rank(rank: int, port: int, workdir: Path) -> int:
    """One rank of phase 13b (``chip_smoke.py --train-rank R``): joins the
    gloo group, trains ``steps`` steps on its shard of the ``(2, 2)`` mesh
    from ``init(0)`` and the seeded batch, and writes what it saw to
    ``workdir``: the gathered first-step gradients (rank 0), a digest of
    every shard it holds after the last step, the step walls, its B3
    launches and peak memory, and the checkpoint (written by rank 0)."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention, kernels
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        CLIPTrainer,
        MeshSpec,
        collectives,
        create_mesh,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    job = json.loads((workdir / "job.json").read_text())
    device, world = torch.device(job["device"]), job["world"]
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo on the one card (NCCL refuses two ranks on one device); the port's
    # initialize_distributed then finds the group and keeps it
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=world, rank=rank)
    info = initialize_distributed()
    if (info["process_index"], info["process_count"]) != (rank, world):
        raise AssertionError(f"rank {rank}: process group {info}")
    if on_card:
        kernels.load()
        if kernels.last_build_seconds() is not None:
            raise AssertionError(f"rank {rank} ran nvcc: the parent builds the kernels")
    cfg = _config_from(job["config"])
    mesh = create_mesh(MeshSpec(("data", "model"), (2, 2)), devices=[device])
    trainer = CLIPTrainer(cfg, mesh)
    params, opt_state = trainer.init(0)
    pixels, tokens = train_batch(cfg, job["batch"])

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # the rate of the tensor-parallel collective alone: one vision activation
    # of a data position gathered over the position's two ranks
    act = torch.zeros((job["batch"] // 2, cfg.vision.num_patches + 1, cfg.vision.hidden_size),
                      dtype=trainer.dtype, device=device)
    group = trainer._row_groups[trainer._rows[0]]
    collectives.all_gather(act, group)
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        collectives.all_gather(act, group)
    sync()
    gather_ms = (time.perf_counter() - t0) * 1e3 / 5
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    attention.fused_mha.launches = 0       # the training path starts here
    wall, metrics_seen = [], []
    for step in range(job["steps"]):
        t0 = time.perf_counter()
        if step == 0:   # train_step, with the gradients kept for the check
            _, metrics, grads = trainer.value_and_grad(params, pixels, tokens)
            params, opt_state = trainer.apply_gradients(params, grads, opt_state)
        else:
            params, opt_state, metrics = trainer.train_step(params, opt_state, pixels, tokens)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        metrics_seen.append({k: float(v) for k, v in metrics.items()})
    launches = attention.fused_mha.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    t0 = time.perf_counter()
    full = trainer.state_dict(grads)
    gather_s = time.perf_counter() - t0
    if rank == 0:
        torch.save({"loss": metrics_seen[0]["loss"],
                    "grads": {k: v.cpu() for k, v in full.items()}}, workdir / "first_step.pt")
    del full, grads
    digests = {f"{name}/{j}": _digest(s) for name, shards in params.items()
               for j, s in zip(trainer._held(name), shards)}
    t0 = time.perf_counter()
    trainer.save_checkpoint(workdir / "ckpt", params, opt_state, step=job["steps"])
    ckpt_s = time.perf_counter() - t0
    (workdir / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "rows": trainer._rows, "cols": trainer._cols, "launches": launches,
        "step_ms": wall, "metrics": metrics_seen, "peak_gb": peak_gb,
        "gather_mb": act.numel() * act.element_size() / 1e6, "gather_ms": gather_ms,
        "gather_grads_s": gather_s, "ckpt_s": ckpt_s, "digests": digests}))
    torch.distributed.destroy_process_group()
    return 0


def run_train_multiproc_phase(device, require_kernels: bool, ref: dict, config=None,
                              batch: int = TRAIN_BATCH, steps: int = TRAIN_MP_STEPS,
                              workdir: Path | None = None) -> dict:
    """Phase 13b: ``CLIPTrainer`` across processes. Four ranks (this
    script with ``--train-rank``; the kernels built here first, so no rank
    runs nvcc), one logical shard of ``device`` each, a gloo group, a
    ``(2, 2)`` mesh: data and model both cross the processes. ``steps``
    steps from ``init(0)`` on phase 13's batch. The first step's loss and
    gradients against phase 13's one-process ``(2, 2)`` step (``ref``;
    ``TOL_TRAIN_LOSS``, ``COS_TRAIN_GRAD_ROUNDING``); the metrics of every
    step and every shard after the last equal on every rank that holds it;
    the ranks' checkpoint restored here by a one-process ``(2, 2)`` trainer
    equal to their shards; B3 launches per rank = 2 x vision layers a step.
    Each rank also times one all_gather of a vision activation over its
    data position's two ranks alone (the transfer a step repeats in every
    layer). A rank that fails, or outlives ``TRAIN_MP_TIMEOUT_S``, fails the
    phase."""
    import dataclasses
    import shutil

    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        CLIPTrainer,
        MeshSpec,
        create_mesh,
    )

    cfg = config or CLIPConfig.vit_l_14()
    on_card = device.type == "cuda"
    workdir = workdir or ROOT / "build" / "chip_smoke" / "train_multiproc"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t_phase = time.perf_counter()
    (workdir / "job.json").write_text(json.dumps({
        "config": dataclasses.asdict(cfg), "batch": batch, "steps": steps,
        "device": "cuda:0" if on_card else str(device), "world": TRAIN_MP_WORLD}))
    if on_card:
        torch.cuda.empty_cache()
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(TRAIN_MP_WORLD):
            logs.append(open(workdir / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--train-rank", str(r),
                 "--port", str(port), "--workdir", str(workdir)],
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TRAIN_MP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t_phase
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r}:\n" + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r in failed)
        raise AssertionError(f"phase 13b: ranks {failed} failed\n{tails}")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(TRAIN_MP_WORLD)]
    if [(r["rows"], r["cols"]) for r in ranks] != [([0], [0]), ([0], [1]), ([1], [0]),
                                                   ([1], [1])]:
        raise AssertionError(f"phase 13b: layout {[(r['rows'], r['cols']) for r in ranks]}")

    # B3 on every rank: each launch over half the heads of a vision layer
    per_step = 2 * cfg.vision.num_layers
    launches = [r["launches"] for r in ranks]
    if require_kernels and launches != [per_step * steps] * TRAIN_MP_WORLD:
        raise AssertionError(f"phase 13b: B3 launches per rank {launches}, not "
                             f"{per_step} a step")

    # every rank alike: the metrics of each step, and each shard among its holders
    for r in ranks[1:]:
        if r["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"phase 13b: rank {r['rank']} metrics {r['metrics']} vs "
                                 f"rank 0's {ranks[0]['metrics']}")
    digests: dict = {}
    for r in ranks:
        for key, h in r["digests"].items():
            digests.setdefault(key, set()).add(h)
    differ = sorted(k for k, hs in digests.items() if len(hs) > 1)
    if differ:
        raise AssertionError(f"phase 13b: shards differ between ranks: {differ[:5]}")
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 13b: losses {losses}")

    # the first step against phase 13's one-process (2, 2) step
    first = torch.load(workdir / "first_step.pt", weights_only=True)
    rel = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
    cos = tower_cosines(ref["grads"], first["grads"])
    if rel > TOL_TRAIN_LOSS or min(cos.values()) < COS_TRAIN_GRAD_ROUNDING:
        raise AssertionError(f"phase 13b: first loss {first['loss']} vs one process "
                             f"{ref['loss']} (rel {rel:.3e}), gradient cosines {cos}")
    del first

    # the ranks' checkpoint, restored in this process
    t22 = CLIPTrainer(cfg, create_mesh(MeshSpec(("data", "model"), (2, 2)),
                                       devices=[device] * 4))
    r_params, r_opt, r_step = t22.restore_checkpoint(workdir / "ckpt")
    if r_step != steps or r_opt["count"] != steps:
        raise AssertionError(f"phase 13b: checkpoint step {r_step}, count {r_opt['count']}")
    back = {f"{name}/{j}": _digest(s) for name, shards in r_params.items()
            for j, s in zip(t22._held(name), shards)}
    if set(back) != set(digests) or any({back[k]} != digests[k] for k in back):
        raise AssertionError("phase 13b: the restored checkpoint differs from the ranks' "
                             "shards")
    del r_params, r_opt, t22
    shutil.rmtree(workdir / "ckpt", ignore_errors=True)
    (workdir / "first_step.pt").unlink()
    if on_card:
        torch.cuda.empty_cache()
    step_ms = [float(np.percentile([r["step_ms"][i] for r in ranks], 50))
               for i in range(steps)]
    out = {"launches": launches, "losses": losses, "step_ms": [r["step_ms"] for r in ranks],
           "step_ms_p50": float(np.percentile([ms for r in ranks for ms in r["step_ms"]], 50)),
           "peak_gb": [r["peak_gb"] for r in ranks], "rel": rel, "cos": cos,
           "gather_grads_s": [r["gather_grads_s"] for r in ranks],
           "tp_gather_mb": ranks[0]["gather_mb"], "tp_gather_ms": [r["gather_ms"] for r in ranks],
           "ckpt_s": [r["ckpt_s"] for r in ranks], "ranks_s": ranks_s,
           "seconds": time.perf_counter() - t_phase}
    log("train-mp", f"{TRAIN_MP_WORLD} gloo ranks, (2, 2) mesh of one shard each, bf16, remat, "
        f"B3, batch {batch}: losses {losses}; step ms per rank {out['step_ms']} (median by "
        f"step {step_ms}); peak memory per rank {out['peak_gb']} GB; B3 launches per rank "
        f"{launches} ({per_step} a step expected); first step against one process: loss "
        f"rel {rel:.3e} (<= {TOL_TRAIN_LOSS}), gradient cosine per tower {cos} (>= "
        f"{COS_TRAIN_GRAD_ROUNDING}); metrics and every shard equal on every rank; "
        f"checkpoint ({out['ckpt_s']} s a rank) restored here equal to the ranks' shards; "
        f"gradients gathered in {out['gather_grads_s']} s; one TP all_gather of "
        f"{out['tp_gather_mb']:.1f} MB over 2 ranks alone {out['tp_gather_ms']} ms; ranks "
        f"{ranks_s:.1f} s, phase "
        f"{out['seconds']:.1f} s")
    return out


def run_entry_phase(device, require_kernels: bool, timer: Timer) -> dict:
    """``graft_entry.entry()``: the seeded ViT-L/14 image tower in bf16 over
    four 224 x 224 images of zeros, then the f32 L2 normalize. One call
    counted (B3 once per vision layer), its output of shape (4, 768), finite
    and of unit norm, held to the same call with B3 on its plain version
    (cosine >= ``COS_TOWER``); then timed."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.graft_entry import entry
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention

    t0 = time.perf_counter()
    fn, (model, pixels) = entry(device)
    setup_s = time.perf_counter() - t0
    attention.fused_mha.launches = 0
    out = fn(model, pixels)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = attention.fused_mha.launches
    layers = model.config.vision.num_layers
    if require_kernels and launches != layers:
        raise AssertionError(f"entry(): B3 launched {launches} times, not {layers}")
    norms = torch.linalg.norm(out, dim=-1)
    if (out.shape != (4, model.config.vision.projection_dim) or out.dtype != torch.float32
            or not bool(torch.isfinite(out).all()) or float((norms - 1).abs().max()) > 1e-5):
        raise AssertionError(f"entry(): output {tuple(out.shape)} {out.dtype}, norms {norms}")
    with b3_plain_version():
        plain = fn(model, pixels)
    cos = float((out * plain).sum(-1).min())
    if cos < COS_TOWER:
        raise AssertionError(f"entry(): cosine to the plain version {cos} < {COS_TOWER}")
    ms = timer(lambda: fn(model, pixels), iters=10)
    res = {"launches": launches, "cos_plain": cos, "ms": ms, "setup_s": setup_s}
    log("entry", f"graft_entry.entry(): ViT-L/14 image tower bf16 over (4, 224, 224, 3) zeros "
        f"-> {tuple(out.shape)} f32, unit norms, cosine to B3's plain version {cos:.6f}; B3 "
        f"launches {launches}; {ms:.3f} ms a call; set-up {setup_s:.1f} s")
    del model
    return res


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


def profile_train(device, config=None, batch: int = TRAIN_BATCH, warm: int = 3,
                  iters: int = 3) -> dict:
    """PERF.md section 5's training row: the phase 13 trainer after ``warm``
    steps; wall p50 of ``iters`` steps and of their two halves
    (``value_and_grad``, ``apply_gradients``), each ended by a synchronize;
    then a ``torch.profiler`` trace of one step: device busy, idle share
    against the untraced step, device ops, B3's forward and the costliest
    kernels by device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig

    trainer, params, opt_state, pixels, tokens = train_setup(
        device, config or CLIPConfig.vit_l_14(), batch)
    for _ in range(warm):
        params, opt_state, _ = trainer.train_step(params, opt_state, pixels, tokens)
    _, _, grads = trainer.value_and_grad(params, pixels, tokens)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def p50(fn):
        wall = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            wall.append((time.perf_counter() - t0) * 1e3)
        return float(np.percentile(wall, 50))

    row = {"phase": "train", "batch": batch,
           "step_p50_ms": p50(lambda: trainer.train_step(params, opt_state, pixels, tokens)),
           "value_and_grad_p50_ms": p50(lambda: trainer.value_and_grad(params, pixels, tokens)),
           "apply_gradients_p50_ms": p50(lambda: trainer.apply_gradients(params, grads,
                                                                         opt_state))}
    del grads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(params, opt_state, pixels, tokens)
        sync()
    path = ROOT / "build" / "chip_smoke" / "train_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    busy, ops, per = device_time(trace)
    by_name: dict = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "kernel":
            by_name[ev["name"][:80]] = by_name.get(ev["name"][:80], 0.0) + float(ev["dur"]) / 1e3
    row.update(device_busy_ms=busy, idle_share=1 - busy / row["step_p50_ms"], device_ops=ops,
               b3_fwd_ms=per["b3"],
               top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]))
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


def profile_ann(device, bits: np.ndarray, n_int8: int = N_INT8, config=None,
                iters: int = 20) -> list[dict]:
    """PERF.md section 5's rows of the IVF mode: search_vectors at B=1 over
    the clustered bf16 rows behind the facade (IVF, exact=True, and the
    facade's search), then ivf_topk at B=1 over 10M int8 rows made on the
    card (nprobe 16 and 64) beside topk_search_int8."""
    import torch

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench.data import gen_db_int8
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann, quant
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    workdir = ROOT / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    rows = []
    system = create_system(torch_device=device, index={"index_type": "IndexIVFFlat"})
    if config is not None:
        system.embedder._config_override = config
    system.embedder.ensure_loaded()
    dim = system.embedder.embed_dim
    index = UnifiedIndex(system._index_config(), device=device)
    index.attach_container(AppendableMemoryContainer(clustered_rows_bf16_bits(bits)))
    system.attach_index(index)
    log("profile", f"ann bf16: {index.ntotal} rows, nlist "
        f"{int(index._ann.bucket_ids.shape[0])}, nprobe {index.config.ann_nprobe}")
    qv1 = system.embedder.encode_text(["profile: a crowded market street in the rain"])
    fresh = iter(range(10**9))
    nosave = SearchOptions(limit=20, use_cache=False)
    for name, fn in (("search_vectors_B1_ann", lambda: index.search_vectors(qv1, top_k=20)),
                     ("search_vectors_B1_exact",
                      lambda: index.search_vectors(qv1, top_k=20, exact=True)),
                     ("search_e2e_B1_ann", lambda: system.search(
                         f"profile {next(fresh)}: a crowded market street", nosave))):
        row = {"dtype": "bf16", **profile_phase(name, fn, device, workdir, iters)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    system.cleanup()
    del index, system
    torch.cuda.empty_cache()
    x, xs = gen_db_int8(-(-n_int8 // 2048) * 2048, dim, 0, device)
    state, report = ann.build_ivf(x, n_rows=n_int8, x_scales=xs,
                                  nlist=min(8192, ann.default_nlist(n_int8)),
                                  sample_per_list=48, kmeans_iters=6)
    log("profile", f"ann int8: {n_int8} rows, nlist {report.nlist}, cap {report.bucket_cap}")
    q = torch.nn.functional.normalize(torch.randn(1, dim, device=device), dim=-1)
    for name, fn in (("ivf_topk_B1_np16", lambda: ann.ivf_topk(x, state, q, 20, nprobe=16,
                                                                n_valid=n_int8, x_scales=xs)),
                     ("ivf_topk_B1_np64", lambda: ann.ivf_topk(x, state, q, 20, nprobe=64,
                                                                n_valid=n_int8, x_scales=xs)),
                     ("topk_search_int8_B1", lambda: quant.topk_search_int8(
                         x, xs, q, 20, n_valid=n_int8))):
        row = {"dtype": "int8", **profile_phase(name, fn, device, workdir, iters)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="print the per-phase time breakdown instead of the smoke")
    # one rank of phase 13b, spawned by the smoke itself
    parser.add_argument("--train-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.train_rank is not None:
        return train_rank(args.train_rank, args.port, Path(args.workdir))
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
        profile_ingest(device)
        torch.cuda.empty_cache()
        bits = make_rows(N_ROWS)
        run_profile(device, bits)
        torch.cuda.empty_cache()
        profile_ann(device, bits)
        del bits
        torch.cuda.empty_cache()
        profile_train(device)
        print(smi, flush=True)
        return 0

    timer = Timer(device)
    b1, b3 = check_kernels(device, N_ROWS, DIM, timer, require_kernels=True)
    torch.cuda.empty_cache()
    rows10 = {}
    b2 = check_int8_kernels(device, N_INT8, DIM, timer, require_kernels=True, keep=rows10)
    ann10 = run_ann_int8(device, rows10, timer)
    mesh8 = run_mesh_int8(device, rows10, require_kernels=True)
    del rows10
    torch.cuda.empty_cache()
    bits = make_rows(N_ROWS)
    result = run_slice(device, N_ROWS, require_kernels=True, bits=bits)
    p2p = run_p2p_phase(device, result["system"], require_kernels=True,
                        single_p50_ms=result["p50_ms"])
    torch.cuda.empty_cache()
    serve = run_serve_phase(device, result.pop("system"), require_kernels=True)
    torch.cuda.empty_cache()
    result8 = run_int8_slice(device, bits, require_kernels=True)
    torch.cuda.empty_cache()
    opened = run_open_phase(device, bits)
    torch.cuda.empty_cache()
    mesh1 = run_mesh_slice(device, bits, result, require_kernels=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ann_bits = clustered_rows_bf16_bits(bits)
    log("ann", f"made {len(ann_bits)} x {ann_bits.shape[1]} rows around {ANN_CENTRES} centres "
        f"in {time.perf_counter() - t0:.1f} s")
    del bits
    torch.cuda.empty_cache()
    ann1 = run_ann_slice(device, require_kernels=True, bits=ann_bits)
    del ann_bits
    torch.cuda.empty_cache()
    b4, b5 = check_build_kernels(device, timer, require_kernels=True)
    torch.cuda.empty_cache()
    built = run_build_slice(device, require_kernels=True)
    torch.cuda.empty_cache()
    w8a8_ops = check_w8a8_ops(device, timer)
    torch.cuda.empty_cache()
    w8a8_emb = run_w8a8_embedders(device, timer)
    torch.cuda.empty_cache()
    w8a8 = run_w8a8_facade(device, require_kernels=True)
    torch.cuda.empty_cache()
    ingested = run_ingest_phase(device, require_kernels=True, timer=timer)
    torch.cuda.empty_cache()
    benched = run_bench_phase(device, require_kernels=True, argv=["--probes"], timer=timer)
    p1, p2, p3 = benched["probes"]
    torch.cuda.empty_cache()
    train = run_train_phase(device, require_kernels=True, timer=timer)
    ref22 = train.pop("ref22")
    torch.cuda.empty_cache()
    train_mp = run_train_multiproc_phase(device, require_kernels=True, ref=ref22)
    del ref22
    torch.cuda.empty_cache()
    entered = run_entry_phase(device, require_kernels=True, timer=timer)
    torch.cuda.empty_cache()

    record = {"kernels": [
        {"name": "chunk_max_sweep (B1)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/chunk_max.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/topk.py:134",
         "launches": result["launches"]["b1"], **b1,
         "serve_launches": serve["launches"]["b1"], "p2p_launches": p2p["launches"]["b1"],
         "w8a8_launches": w8a8["launches"]["b1"], "mesh_launches": mesh1["launches"]["b1"]},
        {"name": "int8_chunk_max_sweep (B2)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/int8_sweep.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/quant.py:167",
         "launches": result8["launches"]["b2"], **b2,
         "mesh_launches": mesh8["launches"]["b2"]},
        {"name": "fused_mha (B3)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/mha.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/attention.py:32",
         "launches": result["launches"]["b3"], **b3, "dino_vit_s_16": ingested["b3"],
         "ingest_launches": ingested["launches"]["b3"],
         "serve_launches": serve["launches"]["b3"], "p2p_launches": p2p["launches"]["b3"],
         "w8a8_launches": w8a8["launches"]["b3"],
         "train_launches": train["launches"], "train": train["b3"],
         "train_multiproc_launches": train_mp["launches"],
         "entry_launches": entered["launches"]},
        {"name": "fused_ln_mlp (B4)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/ln_mlp.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/block.py:78",
         "launches": built["launches"]["b4"], **b4},
        {"name": "normalize_images (B5)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/normalize.cu",
         "replaces": "intelligent_video_analysis_retrieval_system_tpu/ops/preprocess.py:127",
         "launches": built["launches"]["b5"], **b5, "dino_f32": ingested["b5"],
         "ingest_launches": ingested["launches"]["b5"],
         "serve_launches": serve["launches"]["b5"], "p2p_launches": p2p["launches"]["b5"],
         "w8a8_launches": w8a8["launches"]["b5"]},
        {"name": "probe_int8_mma_sweep (P1)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/probes.cu",
         "replaces": "benchmarks/exp_int8.py:37",
         "launches": benched["launches"]["p1"], **p1},
        {"name": "probe_int8_convert_sweep (P2)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/probes.cu",
         "replaces": "benchmarks/exp_int8.py:279",
         "launches": benched["launches"]["p2"], **p2},
        {"name": "probe_stream (P3)", "route": "cuda",
         "source": "intelligent_video_analysis_retrieval_system_tpu_torch/csrc/probes.cu",
         "replaces": "benchmarks/exp_stream_bw.py:32",
         "launches": benched["launches"]["p3"], **p3},
    ]}
    log("serve", f"launches on the serve path: {serve['launches']}; p50 {serve['p50_ms']:.3f} "
        f"ms, p95 {serve['p95_ms']:.3f} ms, QPS {serve['qps']}, avg batch "
        f"{serve['avg_batch']:.2f}, idle share {serve['idle_share']:.4f}")
    log("p2p", f"launches on the P2P path: {p2p['launches']}; numbers {p2p['numbers']}; "
        f"phase {p2p['seconds']:.1f} s")
    log("build", f"launches on the build path: {built['launches']}")
    log("w8a8", f"launches on the int8_static facade path: {w8a8['launches']}; build "
        f"{w8a8['images_per_s']:.1f} images/s; int8 attention {w8a8_ops['attention']}; "
        f"embedders {w8a8_emb['numbers']}")
    log("ingest", f"launches on the ingest path: {ingested['launches']}")
    log("train", f"ViT-L/14 bf16 trainer, batch {TRAIN_BATCH}: step p50 "
        f"{train['step_ms_p50']:.1f} ms, {train['pairs_per_s']:.1f} pairs/s, peak "
        f"{train['peak_gb']:.2f} GB, B3 {train['launches_per_step']:g} launches a step; "
        f"checkpoint {train['ckpt']}; phase {train['seconds']:.1f} s")
    log("train-mp", f"across {TRAIN_MP_WORLD} processes: step p50 {train_mp['step_ms_p50']:.1f} "
        f"ms, peak {train_mp['peak_gb']} GB a rank, B3 {train_mp['launches']} launches a rank; "
        f"phase {train_mp['seconds']:.1f} s; entry() {entered['ms']:.3f} ms, B3 "
        f"{entered['launches']} launches")
    log("open", f"1M-row int8 facade open: {opened}")
    log("mesh", f"bf16 facade on the one-device mesh: p50 {mesh1['p50_ms']:.3f} ms, p95 "
        f"{mesh1['p95_ms']:.3f} ms (single device {result['p50_ms']:.3f} / "
        f"{result['p95_ms']:.3f} ms); sweeps {mesh1['sweeps']}; int8 {mesh8['int8']}; "
        f"sharded IVF {mesh8['ivf']}; phase {mesh1['seconds'] + mesh8['seconds']:.1f} s")
    log("ann", f"1M bf16 facade: build {ann1['build_s']:.2f} s, nprobe {ann1['nprobe']}, "
        f"ann_max_batch {ann1['max_batch']}, launches {ann1['launches']}; 10M int8: build "
        f"{ann10['build_s']:.2f} s, crossover {ann10['crossover']}, ivf_topk calls "
        f"{ann10['calls']}")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
