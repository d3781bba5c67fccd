"""Command-line interface of the PyTorch port.

``extract`` — videos into deduplicated keyframes and map CSVs:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch extract \
        a.mp4 b.mp4 --keyframes-dir keyframes/ --map-dir map/ [--dino] \
        [--phash] [--workers 2] [--device cuda]

``filter`` — refine extracted keyframes (quality percentiles, in-scene
dedup or ``--cluster``; presets ``--gentle``, ``--ultra-gentle``,
``--similarity-only``), in place or into ``--output-dir``:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch filter \
        keyframes/ [--output-dir refined/] [--map-dir map/ --output-map-dir map2/]

``build`` — a ``keyframes/<video>/<n>.jpg`` tree into one ``.rvdb`` index
(chunked and resumable; every keyframe through the vision tower):

    python -m intelligent_video_analysis_retrieval_system_tpu_torch build \\
        keyframes/ --output index/index.rvdb [--map-dir map/] [--dtype int8]

``search`` — one text query against an ``.rvdb`` index:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch search \\
        index.rvdb "a red car at night" [--limit 10] [--device cuda] [--mesh]

``--mesh`` (``search``, ``serve``) shards the index's rows over every
visible CUDA device (a one-device mesh on one card; with ``--device cpu``
one shard on the CPU) and merges their answers: the multi-device search.

``stats`` — the index's statistics as JSON.

``evaluate`` — retrieval quality on the index's own corpus: the served
search against an exact f32 oracle (recall@k, rank agreement), the quality
gate of the int8 capacity mode and of the IVF mode:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch evaluate \
        index.rvdb [--search auto|exact|ann|int8_rescore] [--nprobe N] \
        [--tune-nprobe RECALL] [--queries 64] [--top-k 10]

``tune`` — tune the IVF mode's knobs on the index's own corpus and persist
them: nprobe to a recall target, then the IVF/dense crossover batch:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch tune \
        index.rvdb [--target-recall 0.95] [--skip-crossover] [--build]

``compact`` — drop tombstoned rows from an index, in place.

``bench`` — the end-to-end bench (``bench/``): one JSON line on stdout:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch bench \
        [--device cuda] [--rows N] [--full] [--probes] [--skip-10m]

``serve`` — the REST/WebSocket server over an index (the console at ``/``),
until interrupted:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch serve \
        [index.rvdb] [--host 0.0.0.0] [--port 5000] [--device cuda] [--mesh]

``share`` — a P2P peer server sharing an index on the LAN (``serve/p2p.py``;
the index opens on ``--device``), until interrupted:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch share \
        index.rvdb [--host 0.0.0.0] [--port 5001] [--index-id shared] [--device cuda]

``doctor`` — diagnostics: the CUDA cards torch sees and ``nvidia-smi``'s name
and power limit, the tokenizer and weights the config names, the host's
network and ports, and with ``--probe host:port`` a peer:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch doctor \
        [--port 5001] [--probe 10.0.0.2:5001] [--config config.json]

``validate`` — the peer server's lifecycle self-test on a loopback port
(start, ping, info, status, discovery, clean shutdown):

    python -m intelligent_video_analysis_retrieval_system_tpu_torch validate \
        [--port 0] [--device cuda]

``parity`` — the real-weight gate: the tokenizer's ids and both towers'
embeddings against HF ``transformers`` on a local ``openai/clip-vit-*``
checkpoint directory (weights and vocab; nothing is downloaded); exit code 0
when every check passes (cosine >= ``--threshold``), else 1:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch parity \
        --weights clip-vit-large-patch14/ [--threshold 0.999] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ivars-torch",
        description="Intelligent video analysis & retrieval on PyTorch + CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)
    ex = sub.add_parser("extract", help="extract keyframes from videos")
    ex.add_argument("videos", nargs="+", help="video files")
    ex.add_argument("--keyframes-dir", default="keyframes")
    ex.add_argument("--map-dir", default="map")
    ex.add_argument("--dedup-threshold", type=float, default=0.98)
    ex.add_argument("--sample-every", type=int, default=1)
    ex.add_argument("--batch", type=int, default=128)
    ex.add_argument("--phash", action="store_true",
                    help="enable perceptual-hash prefilter")
    ex.add_argument("--dedup-resize", type=int, default=64,
                    help="host-side shrink edge for dedup embeddings "
                         "(0 disables; use 224 with a DINO embedder)")
    ex.add_argument("--dino", action="store_true",
                    help="use the DINO ViT-S/16 dedup tower (reference parity; slower)")
    ex.add_argument("--workers", type=int, default=0,
                    help="decode worker processes (>=2 enables the multi-process "
                         "ingest pipeline; 0 = sequential)")
    ex.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")

    fl = sub.add_parser("filter", help="refine extracted keyframes")
    fl.add_argument("keyframes_dir")
    fl.add_argument("--output-dir", default=None,
                    help="copy survivors here (default: filter in place)")
    fl.add_argument("--map-dir", default=None)
    fl.add_argument("--output-map-dir", default=None)
    fl.add_argument("--blur-percentile", type=float, default=10.0)
    fl.add_argument("--edge-percentile", type=float, default=10.0)
    fl.add_argument("--similarity", type=float, default=0.95)
    fl.add_argument("--window", type=int, default=5)
    fl.add_argument("--cluster", action="store_true",
                    help="density-cluster scenes and keep centroid-nearest "
                         "representatives (filter_research_update parity)")
    preset = fl.add_mutually_exclusive_group()
    preset.add_argument("--gentle", action="store_true")
    preset.add_argument("--ultra-gentle", action="store_true")
    preset.add_argument("--similarity-only", action="store_true")
    fl.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")

    b = sub.add_parser("build", help="build the index from keyframes")
    b.add_argument("keyframes_dir")
    b.add_argument("--output", default="index/index.rvdb")
    b.add_argument("--map-dir", default=None)
    b.add_argument("--model-path", default=None,
                   help="local HF CLIP checkpoint directory")
    b.add_argument("--no-resume", action="store_true")
    b.add_argument("--chunk-size", type=int, default=1024)
    b.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float16", "float32", "int8"),
                   help="stored index row dtype; int8 = capacity mode")
    b.add_argument("--compute-dtype", default=None,
                   choices=("bfloat16", "float16", "float32", "int8", "int8_static"),
                   help="tower activation mode; int8/int8_static = W8A8 "
                        "(int8 products; static: calibrated scales)")
    b.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")

    se = sub.add_parser("search", help="query an index")
    se.add_argument("index_path")
    se.add_argument("query")
    se.add_argument("--limit", type=int, default=10)
    se.add_argument("--mode", default="clip_only",
                    choices=("clip_only", "llm_enhanced", "hybrid"))
    se.add_argument("--model-path", default=None,
                    help="local HF CLIP checkpoint directory")
    se.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    se.add_argument("--compute-dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32", "int8", "int8_static"),
                    help="tower activation mode (int8_static reads the scales "
                         "the build saved beside the index)")
    se.add_argument("--mesh", action="store_true",
                    help="shard the index over all visible devices")
    se.add_argument("--json", action="store_true", dest="as_json")

    st = sub.add_parser("stats", help="index statistics")
    st.add_argument("index_path")
    st.add_argument("--device", default="cuda")

    cp = sub.add_parser("compact", help="drop tombstoned rows from an index")
    cp.add_argument("index_path")
    cp.add_argument("--device", default="cuda")

    tu = sub.add_parser(
        "tune",
        help="self-tune the index's ANN knobs on its own corpus and persist them: nprobe "
             "to a recall target (tune_nprobe) and the IVF/dense crossover batch cap "
             "(measure_ann_crossover); a reopened index serves with the tuned values")
    tu.add_argument("index_path")
    tu.add_argument("--target-recall", type=float, default=0.95)
    tu.add_argument("--skip-crossover", action="store_true", help="only tune nprobe")
    tu.add_argument("--build", action="store_true",
                    help="build the IVF structure first if absent")
    tu.add_argument("--device", default="cuda")

    sv = sub.add_parser("serve", help="start the REST/WebSocket server (console at /)")
    sv.add_argument("index_path", nargs="?", default=None)
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=5000)
    sv.add_argument("--model-path", default=None,
                    help="local HF CLIP checkpoint directory")
    sv.add_argument("--mesh", action="store_true",
                    help="shard the index over all visible devices")
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")

    sh = sub.add_parser("share", help="share an index on the LAN (P2P)")
    sh.add_argument("index_path")
    sh.add_argument("--host", default="0.0.0.0")
    sh.add_argument("--port", type=int, default=5001)
    sh.add_argument("--name", default=None, help="node name")
    sh.add_argument("--index-id", default="shared")
    sh.add_argument("--device", default="cuda",
                    help="torch device the shared index opens on (default cuda)")

    dr = sub.add_parser("doctor", help="diagnose network & device setup")
    dr.add_argument("--port", type=int, default=5001)
    dr.add_argument("--probe", default=None, help="host:port of a peer to probe")
    dr.add_argument("--config", default=None,
                    help="config.json to check model/vocab provenance from")

    va = sub.add_parser("validate", help="peer server lifecycle self-test")
    va.add_argument("--port", type=int, default=0, help="port (0 = ephemeral)")
    va.add_argument("--device", default="cuda", help="torch device of the peer server")

    # the bench parses its own flags (bench.main)
    sub.add_parser("bench", help="end-to-end bench: one JSON line on stdout",
                   add_help=False)

    ev = sub.add_parser(
        "evaluate",
        help="retrieval quality on YOUR corpus: the index's search vs an exact "
             "f32 oracle (recall@k / rank agreement; run after building an int8 "
             "capacity-mode index)",
    )
    ev.add_argument("index_path")
    ev.add_argument("--queries", type=int, default=64,
                    help="number of probe queries sampled from the corpus")
    ev.add_argument("--top-k", type=int, default=10)
    ev.add_argument("--noise", type=float, default=0.05,
                    help="perturbation added to sampled rows (0 = exact "
                         "self-retrieval probes)")
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--search", choices=["auto", "exact", "ann", "int8_rescore"],
                    default="auto",
                    help="candidate path: auto = what the index serves; ann = force IVF "
                         "probing (batches chunked to the ANN batch limit); exact = the "
                         "dense sweep; int8_rescore = the int8 exact-rescore mode")
    ev.add_argument("--nprobe", type=int, default=None,
                    help="override ann_nprobe for --search ann")
    ev.add_argument("--tune-nprobe", type=float, default=None, metavar="RECALL",
                    help="pick the smallest nprobe reaching this recall@k target before "
                         "evaluating (implies --search ann; prints the tested ladder)")
    ev.add_argument("--device", default="cuda")

    pa = sub.add_parser(
        "parity",
        help="validate real HF CLIP weights + vocab against our towers "
        "(cosine >= 0.999 gate)",
    )
    pa.add_argument("--weights", required=True,
                    help="local openai/clip-vit-* checkpoint directory")
    pa.add_argument("--threshold", type=float, default=0.999)
    pa.add_argument("--device", default="cuda",
                    help="torch device of the port's towers (default cuda)")
    return p


def cmd_extract(args) -> int:
    from .ingest import FrameFilter, FrameFilterConfig

    cfg = FrameFilterConfig(
        dedup_threshold=args.dedup_threshold,
        frame_batch=args.batch,
        sample_every=args.sample_every,
        use_phash_prefilter=args.phash,
        dedup_resize=args.dedup_resize if not args.dino else max(args.dedup_resize, 224),
    )
    embed_fn = None
    if args.dino:
        from .ingest.frames import dino_embedder

        embed_fn = dino_embedder(device=args.device)
    ff = FrameFilter(cfg, embed_fn=embed_fn, device=args.device)
    reports = ff.extract_frames_batch(
        args.videos, args.keyframes_dir, args.map_dir, workers=args.workers
    )
    for report in reports:
        print(
            f"{report.video}: kept {report.frames_kept}/{report.frames_seen} "
            f"frames ({report.frames_per_s:.0f} fps decode+dedup)"
        )
    return 0


def cmd_filter(args) -> int:
    from .ingest import FrameFilter, FrameFilterConfig

    if args.gentle:
        cfg = FrameFilterConfig.gentle()
    elif args.ultra_gentle:
        cfg = FrameFilterConfig.ultra_gentle()
    elif args.similarity_only:
        cfg = FrameFilterConfig.similarity_only()
    else:
        cfg = FrameFilterConfig(
            blur_drop_percentile=args.blur_percentile,
            edge_drop_percentile=args.edge_percentile,
            in_scene_similarity=args.similarity,
            dedup_window=args.window,
            use_clustering=args.cluster,
        )
    ff = FrameFilter(cfg, device=args.device)
    report = ff.apply_filters(
        args.keyframes_dir,
        output_dir=args.output_dir,
        map_dir=args.map_dir,
        output_map_dir=args.output_map_dir,
    )
    print(
        f"{report.folders} folders: {report.frames_in} -> {report.frames_out} "
        f"frames (quality -{report.dropped_quality}, "
        f"similarity -{report.dropped_similarity})"
    )
    return 0


def cmd_build(args) -> int:
    from .system.facade import EnhancedRetrievalSystem
    from .utils.config import Config

    overrides: dict = {
        "index": {"dtype": args.dtype, "chunk_size": args.chunk_size}}
    if args.model_path:
        overrides["model"] = {"path": args.model_path}
    if args.compute_dtype:
        overrides["device"] = {"compute_dtype": args.compute_dtype}
    system = EnhancedRetrievalSystem(
        Config(config_file="config.json", overrides=overrides),
        device=args.device,
    )
    try:
        out = system.build_system(
            args.keyframes_dir, map_dir=args.map_dir, output_path=args.output,
            resume=not args.no_resume,
        )
    finally:
        system.cleanup()
    report = out["report"]
    print(
        f"indexed {report['processed']} images "
        f"({report['images_per_s']:.0f} img/s, "
        f"skipped {report['skipped_resume']} already-processed, "
        f"{report['failed']} failures) -> {out['index_path']}"
    )
    return 0


def _index_mesh(device: str):
    """A mesh of one ``"index"`` axis over every visible CUDA device (on one
    card a one-device mesh: the same code path), or one CPU shard where
    ``device`` is the CPU."""
    import torch

    from .parallel import MeshSpec, create_mesh

    if torch.device(device).type == "cpu":
        return create_mesh(MeshSpec(axis_names=("index",), shape=(1,)), devices=["cpu"])
    if not torch.cuda.is_available():
        raise RuntimeError(f"--mesh on {device}: no CUDA device is visible")
    n = torch.cuda.device_count()
    return create_mesh(MeshSpec(axis_names=("index",), shape=(n,)))


def cmd_search(args) -> int:
    from .system.facade import EnhancedRetrievalSystem, SearchOptions
    from .utils.config import Config

    overrides: dict = {"device": {"compute_dtype": args.compute_dtype}}
    if args.model_path:
        overrides["model"] = {"path": args.model_path}
    system = EnhancedRetrievalSystem(
        Config(config_file="config.json", overrides=overrides),
        device=args.device, mesh=_index_mesh(args.device) if args.mesh else None,
    )
    try:
        system.load_system(args.index_path)
        t0 = time.perf_counter()
        results = system.search(args.query, SearchOptions(mode=args.mode,
                                                          limit=args.limit))
        dt = (time.perf_counter() - t0) * 1e3
    finally:
        system.cleanup()
    if args.as_json:
        print(json.dumps(results, ensure_ascii=False, indent=2))
    else:
        print(f"{len(results)} hits in {dt:.1f} ms for {args.query!r}:")
        for r in results:
            print(f"  #{r['rank']:<3} {r['folder']}/{r['image']:<16} "
                  f"score={r['similarity_score']:.4f} frame={r.get('frame_id')}")
    return 0


def cmd_stats(args) -> int:
    from .index.unified import UnifiedIndex

    index = UnifiedIndex(device=args.device)
    index.load_unified_index(args.index_path)
    print(json.dumps(index.get_stats(), indent=2, default=str))
    index.close()
    return 0


def cmd_compact(args) -> int:
    from .index.unified import UnifiedIndex

    index = UnifiedIndex(device=args.device)
    index.load_unified_index(args.index_path, mode="a")
    try:
        out = index.compact()
    finally:
        index.close()
    print(f"compacted {out['compacted']} tombstoned rows; "
          f"{out['ntotal']} live rows remain")
    return 0


def cmd_tune(args) -> int:
    """Tune and persist the ANN knobs on the index's own corpus."""
    from .index.unified import UnifiedIndex

    index = UnifiedIndex(device=args.device)
    index.load_unified_index(args.index_path, mode="a")
    try:
        if not index.ann_active:
            if not args.build:
                print("ANN not active on this index; pass --build to build the IVF "
                      "structure first")
                return 1
            rep = index.build_ann()
            print(f"built IVF: nlist={rep['nlist']}")
        tune = index.tune_nprobe(target_recall=args.target_recall)
        if tune.get("raced_mutation"):
            print("tune raced a concurrent mutation; re-run when the index is quiescent")
            return 1
        print(f"nprobe={tune['nprobe']} at recall@{tune['top_k']} {tune['recall']:.4f} "
              f"(target {args.target_recall}); ladder {tune['ladder']}")
        if not args.skip_crossover:
            cx = index.measure_ann_crossover()
            if cx.get("raced_mutation"):
                print("crossover measurement raced a mutation; cap unchanged")
                return 1
            rungs = ", ".join(f"B={r['batch']}: ivf {r['ann_ms']} / dense {r['dense_ms']} ms"
                              for r in cx["ladder"])
            verdict = ("IVF never wins — serving stays dense" if cx["max_batch"] == 0
                       else "persisted")
            print(f"ann_max_batch={cx['max_batch']} ({verdict}); {rungs}")
        print("tuned values persisted; reopened indexes serve with them")
        return 0
    finally:
        index.close()


def cmd_evaluate(args) -> int:
    from .index.unified import UnifiedIndex
    from .retrieval.evaluation import evaluate_backends

    index = UnifiedIndex(device=args.device)
    index.load_unified_index(args.index_path)
    try:
        n = index.ntotal
        if n == 0:
            print("empty index", file=sys.stderr)
            return 1
        # streamed f32 ground truth, block by block (a capacity-mode index
        # is 10M rows: a whole f32 copy would not fit the host)
        block = 131_072
        dead = np.zeros(n, bool)
        for row in index.deleted_rows:
            if 0 <= row < n:
                dead[row] = True
        rng = np.random.default_rng(args.seed)
        m = min(args.queries, n)
        picks = np.sort(rng.choice(n, size=m, replace=False))
        sampled = np.concatenate([index.read_rows_f32(int(i), int(i) + 1) for i in picks])
        sampled /= np.maximum(np.linalg.norm(sampled, axis=-1, keepdims=True), 1e-12)
        q = sampled + args.noise * rng.standard_normal(sampled.shape).astype(np.float32)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        k = min(args.top_k, int((~dead).sum()))

        search_mode = args.search
        if search_mode == "int8_rescore":
            # needs a container written with keep_fp (the bf16 copy)
            if not getattr(index._container, "has_fp_rows", False):
                print("index has no embeddings_fp copy — rebuild with "
                      "index.int8_rescore=true", file=sys.stderr)
                return 1
            index.config.int8_rescore = True
            search_mode = "auto"
        if args.tune_nprobe:
            search_mode = "ann"
        if search_mode == "ann":
            if not index.ann_active:
                index.build_ann(persist=False)
            if args.nprobe:
                index.config.ann_nprobe = int(args.nprobe)
        tune_report = None
        if args.tune_nprobe:
            tune_report = index.tune_nprobe(target_recall=float(args.tune_nprobe), top_k=k,
                                            seed=args.seed)

        def candidate(queries):
            if search_mode == "ann":
                # chunks of the ANN batch limit, so that every query probes
                step = max(1, index.config.ann_max_batch)
                per_query = []
                for s in range(0, len(queries), step):
                    per_query.extend(index.search_vectors(queries[s:s + step], top_k=k))
            else:
                per_query = index.search_vectors(queries, top_k=k,
                                                 exact=search_mode == "exact")
            ids = np.array([[h.metadata.row_id for h in hits] for hits in per_query])
            scores = np.array([[h.similarity_score for h in hits] for hits in per_query],
                              np.float64)
            return scores, ids

        def oracle(queries):
            # running top-k over row blocks: O(block * dim) resident memory
            best_s = np.full((len(queries), 0), -np.inf, np.float32)
            best_i = np.zeros((len(queries), 0), np.int64)
            for start in range(0, n, block):
                end = min(start + block, n)
                rows_blk = index.read_rows_f32(start, end)
                rows_blk /= np.maximum(np.linalg.norm(rows_blk, axis=-1, keepdims=True),
                                       1e-12)
                s_blk = queries @ rows_blk.T
                s_blk[:, dead[start:end]] = -np.inf
                ids_blk = np.broadcast_to(np.arange(start, end), s_blk.shape)
                best_s = np.concatenate([best_s, s_blk], axis=1)
                best_i = np.concatenate([best_i, ids_blk], axis=1)
                if best_s.shape[1] > k:
                    part = np.argpartition(-best_s, k - 1, axis=1)[:, :k]
                    best_s = np.take_along_axis(best_s, part, axis=1)
                    best_i = np.take_along_axis(best_i, part, axis=1)
            order = np.argsort(-best_s, axis=1)
            return (np.take_along_axis(best_s, order, axis=1).astype(np.float64),
                    np.take_along_axis(best_i, order, axis=1))

        out = evaluate_backends(candidate, oracle, q, k).as_dict()
        out["index"] = str(args.index_path)
        out["dtype"] = index.get_stats()["container"]["dtype"]
        out["rows"] = n
        out["search"] = search_mode
        if index.ann_active:
            out["ann"] = index.get_stats()["ann"]
        if tune_report is not None:
            out["tuned"] = tune_report
        print(json.dumps(out, indent=2))
        return 0
    finally:
        index.close()


def cmd_serve(args) -> int:
    from .system.facade import EnhancedRetrievalSystem
    from .utils.config import Config

    overrides = {"model": {"path": args.model_path}} if args.model_path else None
    system = EnhancedRetrievalSystem(Config(config_file="config.json", overrides=overrides),
                                     device=args.device,
                                     mesh=_index_mesh(args.device) if args.mesh else None)
    try:
        if args.index_path:
            system.load_system(args.index_path)
        print(f"serving on http://{args.host}:{args.port} (console at /)", flush=True)
        system.start_server(host=args.host, port=args.port, block=True)
    finally:
        system.cleanup()
    return 0


def cmd_share(args) -> int:
    from .serve.p2p import NetworkServer

    server = NetworkServer(args.host, args.port, node_name=args.name, device=args.device)
    server.register_index_file(args.index_id, args.index_path)
    server.start_server()
    print(f"sharing {args.index_path!r} as {args.index_id!r} on {args.host}:{server.port} "
          f"(discovery on {server.port + 1}); Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop_server()
    return 0


def _doctor_device() -> None:
    """The CUDA cards torch sees, and nvidia-smi's name and power limit in
    a bounded subprocess."""
    import subprocess

    import torch

    print("== device ==")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"  cuda devices: {torch.cuda.device_count()}")
        for i in range(torch.cuda.device_count()):
            print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    else:
        print("  cuda devices: 0 (torch.cuda.is_available() is False; pass --device cpu)")
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           timeout=30, capture_output=True, text=True)
        lines = r.stdout.strip().splitlines() if r.returncode == 0 else []
        for line in lines:
            print(f"  nvidia-smi: {line}")
        if not lines:
            tail = (r.stderr or "").strip().splitlines()
            print(f"  nvidia-smi failed: {tail[-1] if tail else r.returncode}")
    except FileNotFoundError:
        print("  nvidia-smi: not found")
    except subprocess.TimeoutExpired:
        print("  nvidia-smi: no answer within 30 s")


def cmd_doctor(args) -> int:
    """Diagnostics: device, model, network, and optionally one peer."""
    import socket

    _doctor_device()
    print("== model ==")
    try:
        from pathlib import Path

        from .models.tokenizer import load_tokenizer
        from .utils.config import Config

        cfg = Config(config_file=args.config, create_dirs=False)
        model_path = cfg.get("model.path")
        tok = load_tokenizer(cfg.get("model.vocab_dir") or model_path)
        print(f"  tokenizer: {tok.kind}"
              + ("" if tok.kind == "clip_bpe" else
                 "  (DEGRADED: text search will not match real CLIP semantics — set "
                 "model.vocab_dir to a dir with merges.txt)"))
        has_weights = model_path is not None and Path(str(model_path)).exists()
        print("  weights: " + (f"pretrained at {model_path}" if has_weights
                               else "random init (no model.path)"))
    except Exception as exc:
        print(f"  model check failed: {exc}")
    print("== network ==")
    host = socket.gethostname()
    print(f"  hostname: {host}")
    try:
        print(f"  ip: {socket.gethostbyname(host)}")
    except OSError:
        print("  ip: unresolvable")
    for port in (args.port, args.port + 1):
        with socket.socket() as s:
            s.settimeout(0.5)
            in_use = s.connect_ex(("127.0.0.1", port)) == 0
        print(f"  port {port}: {'IN USE' if in_use else 'free'}")
    if args.probe:
        from .serve.p2p import NetworkClient

        try:
            h, p = args.probe.rsplit(":", 1)
            record = NetworkClient(timeout_s=3).connect_to_server(h, int(p))
            print(f"  probe {args.probe}: OK (node {record['info'].get('node_name')})")
        except Exception as exc:
            print(f"  probe {args.probe}: FAILED ({exc})")
            return 1
    print("== checklist ==")
    print("  - peers must share a subnet for UDP broadcast discovery")
    print("  - firewalls must allow the service port and port+1/udp")
    print("  - use `share` on the serving node, `doctor --probe` from peers")
    return 0


def cmd_parity(args) -> int:
    from .models.parity import run_parity

    report = run_parity(args.weights, threshold=args.threshold, device=args.device)
    print(report.summary())
    return 0 if report.ok else 1


def cmd_validate(args) -> int:
    """The peer server's lifecycle self-test."""
    import socket
    import urllib.request

    from .serve.p2p import NetworkClient, NetworkServer

    port = args.port
    if port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    checks: list[tuple[str, bool]] = []
    server = NetworkServer("127.0.0.1", port, node_name="validate", enable_discovery=True,
                           device=args.device)
    server.start_server()
    try:
        client = NetworkClient(timeout_s=5)
        checks.append(("server starts", server.is_running))
        checks.append(("/api/ping answers", client.health_check("127.0.0.1", port)))
        info = client._get(f"http://127.0.0.1:{port}", "/api/node/info")
        checks.append(("/api/node/info answers", "node_id" in info))
        status = client._get(f"http://127.0.0.1:{port}", "/api/status")
        checks.append(("/api/status running", status.get("status") == "running"))
        checks.append(("discovery threads alive", server.discovery.is_running))
    finally:
        server.stop_server()
    time.sleep(0.3)
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/api/ping", timeout=1)
        stopped = False
    except Exception:
        stopped = True
    checks.append(("clean shutdown", stopped))
    ok = all(passed for _, passed in checks)
    for name, passed in checks:
        print(f"  [{'PASS' if passed else 'FAIL'}] {name}")
    print("ALL CHECKS PASSED" if ok else "VALIDATION FAILED")
    return 0 if ok else 1


_COMMANDS = {"extract": cmd_extract, "filter": cmd_filter, "build": cmd_build,
             "search": cmd_search, "stats": cmd_stats, "evaluate": cmd_evaluate,
             "compact": cmd_compact, "tune": cmd_tune, "serve": cmd_serve,
             "share": cmd_share, "doctor": cmd_doctor, "validate": cmd_validate,
             "parity": cmd_parity}


def main(argv: list[str] | None = None) -> int:
    args, rest = _build_parser().parse_known_args(argv)
    if args.command == "bench":
        from . import bench

        return bench.main(rest)
    if rest:
        _build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
