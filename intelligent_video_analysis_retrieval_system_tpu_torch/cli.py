"""Command-line interface of the PyTorch port.

``search`` — one text query against an ``.rvdb`` index:

    python -m intelligent_video_analysis_retrieval_system_tpu_torch search \\
        index.rvdb "a red car at night" [--limit 10] [--device cuda]

The other commands of the JAX package's CLI (extract, filter, build,
serve, ...) are ported with their subsystems in later changes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ivars-torch",
        description="Intelligent video analysis & retrieval on PyTorch + CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)
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
    return p


def cmd_search(args) -> int:
    from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config

    from .system.facade import EnhancedRetrievalSystem, SearchOptions

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


_COMMANDS = {"search": cmd_search}


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
