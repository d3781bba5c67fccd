"""Command-line interface of the PyTorch port.

``build`` — a ``keyframes/<video>/<n>.jpg`` tree into one ``.rvdb`` index
(chunked and resumable; every keyframe through the vision tower):

    python -m intelligent_video_analysis_retrieval_system_tpu_torch build \\
        keyframes/ --output index/index.rvdb [--map-dir map/] [--dtype int8]

``search`` — one text query against an ``.rvdb`` index:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch search \\
        index.rvdb "a red car at night" [--limit 10] [--device cuda]

``stats`` — the index's statistics as JSON.

``evaluate`` — retrieval quality on the index's own corpus: the served
search against an exact f32 oracle (recall@k, rank agreement), the quality
gate of the int8 capacity mode:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch evaluate \
        index.rvdb [--search auto|exact|int8_rescore] [--queries 64] [--top-k 10]

The other commands of the JAX package's CLI (extract, filter, serve, ...)
are ported with their subsystems in later changes.
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
                   choices=("bfloat16", "float32", "int8", "int8_static"),
                   help="tower compute dtype (the W8A8 modes int8 and "
                        "int8_static are not ported yet and raise)")
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
                    choices=("bfloat16", "float32"))
    se.add_argument("--json", action="store_true", dest="as_json")

    st = sub.add_parser("stats", help="index statistics")
    st.add_argument("index_path")
    st.add_argument("--device", default="cuda")

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
                    help="candidate path: auto = what the index serves; exact = "
                         "the dense sweep (the same here: IVF is not ported); "
                         "int8_rescore = the int8 exact-rescore mode")
    ev.add_argument("--device", default="cuda")
    return p


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


def cmd_search(args) -> int:
    from .system.facade import EnhancedRetrievalSystem, SearchOptions
    from .utils.config import Config

    overrides: dict = {"device": {"compute_dtype": args.compute_dtype}}
    if args.model_path:
        overrides["model"] = {"path": args.model_path}
    system = EnhancedRetrievalSystem(
        Config(config_file="config.json", overrides=overrides),
        device=args.device,
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


def cmd_evaluate(args) -> int:
    from .index.unified import UnifiedIndex
    from .retrieval.evaluation import evaluate_backends

    if args.search == "ann":
        raise NotImplementedError("evaluate --search ann: IVF ANN search is ported "
                                  "in a later change")
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

        def candidate(queries):
            per_query = index.search_vectors(queries, top_k=k)
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
        print(json.dumps(out, indent=2))
        return 0
    finally:
        index.close()


_COMMANDS = {"build": cmd_build, "search": cmd_search, "stats": cmd_stats, "evaluate": cmd_evaluate}


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
