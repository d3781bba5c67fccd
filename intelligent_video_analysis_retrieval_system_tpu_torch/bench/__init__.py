"""The port's bench: one JSON line of end-to-end numbers on one GPU.

    python -m intelligent_video_analysis_retrieval_system_tpu_torch.bench \\
        [--device cuda] [--rows N] [--full] [--probes] [--skip-10m]

Counterpart of the JAX package's root ``bench.py`` and of its
``benchmarks/exp_int8.py`` / ``exp_stream_bw.py`` experiments. It runs the
sections of :mod:`.headline` (the headline text query over ``--rows`` bf16
rows, 1,000,000 by default, also through the sharded search on a one-device
mesh; the multi-device anchor, one card's shard of ten times ``--rows`` over
8 cards; the image tower, ViT-B/32 or with ``--full`` ViT-L/14, in bf16 and
in W8A8 with static scales; the int8 capacity mode over ten times
``--rows`` and the IVF approximate mode over the same rows, also through the
sharded IVF on a one-device mesh, unless ``--skip-10m``), the served
sections of :mod:`.served` (the REST server with the batcher on over
``--rows`` fresh bf16 rows; unless ``--skip-10m``, over the IVF section's
int8 rows with its structure attached and dense) and with ``--probes`` the
kernels of :mod:`.probes`, logs to stderr, and prints one
JSON line on stdout with the JAX bench's key names
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``p95``, ``queries``,
``extra``). ``extra`` starts with the card's name and power limit as
``nvidia-smi`` gives them, and ends with ``not_ported``: the sections of the
JAX bench whose modules the port does not have yet (none now: an empty
list).

It runs on the card unless ``--device cpu`` is asked for (then ``--rows``
defaults to 20,000); without a card and without that flag it raises. A
section that fails raises: the process exits non-zero and prints no JSON.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import torch

from ..index.unified import resolve_device
from ..system.embedder import CLIPEmbedder
from . import headline, served
from .headline import log
from .probes import ProbeCheck, run_probes

__all__ = ["run_bench", "main"]


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def run_bench(device: torch.device | str = "cuda", rows: int | None = None,
              full: bool = False, probes: bool = False, skip_10m: bool = False,
              verify: headline.Verify | None = None,
              verify_tower: headline.VerifyTower | None = None,
              check_probes: ProbeCheck | None = None,
              verify_static: headline.VerifyStatic | None = None) -> dict:
    """Run the sections and return the result (see the module docstring).
    The hooks let a caller hold what the sections computed against
    references of its own (``headline`` and ``probes`` say what each gets)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if rows is None:
        rows = 1_000_000 if on_card else 20_000
    t_start = time.perf_counter()
    extra: dict = {"gpu": gpu_line() if on_card else None, "device": str(device),
                   "torch": torch.__version__}
    embedder = CLIPEmbedder(device=device)   # ViT-L/14, bf16, seeded
    embedder.ensure_loaded()
    head = headline.headline_1M(device, embedder, rows, verify)
    extra.update(head.pop("extra"))
    result: dict = {**head, "unit": "ms", "extra": extra}
    gc.collect()
    extra.update(headline.anchor_1M25(device, embedder, rows, verify))
    extra.update(headline.image_tower(device, full, verify_tower, verify_static))
    kept: dict = {}
    if not skip_10m:
        # the 1M bf16 rows are gone by now (headline_1M frees them)
        extra.update(headline.int8_10M(device, embedder, 10 * rows, verify))
        extra.update(headline.ivf_10M(device, embedder, 10 * rows, verify, keep=kept))
    # the served sections run last, as in the JAX bench; the 10M one over the
    # IVF section's rows and structure
    extra.update(served.served_qps(device, embedder, rows, verify))
    if not skip_10m:
        extra.update(served.served_10M(device, embedder, 10 * rows, kept, verify))
    kept.clear()
    if probes:
        del embedder
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        extra["probes"] = run_probes(device, check=check_probes) if on_card else run_probes(
            device, rows=rows, stream_bytes=rows * 768, check=check_probes)
    extra["seconds"] = round(time.perf_counter() - t_start, 1)
    extra["not_ported"] = list(headline.NOT_PORTED)
    return result


def main(argv: list[str] | None = None, verify: headline.Verify | None = None,
         verify_tower: headline.VerifyTower | None = None,
         check_probes: ProbeCheck | None = None,
         verify_static: headline.VerifyStatic | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m intelligent_video_analysis_retrieval_system_tpu_torch.bench",
        description="end-to-end bench of the PyTorch port: one JSON line on stdout")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' must be asked for)")
    parser.add_argument("--rows", type=int, default=None,
                        help="bf16 rows of the headline index (default 1,000,000; 20,000 "
                             "on the CPU); the int8 section sweeps ten times as many")
    parser.add_argument("--full", action="store_true",
                        help="image tower: ViT-L/14 at B=128, not ViT-B/32 at B=256")
    parser.add_argument("--probes", action="store_true",
                        help="also time the int8 sweep probes and the memory-stream probe")
    parser.add_argument("--skip-10m", action="store_true",
                        help="leave out the int8 capacity, IVF and served 10M sections")
    args = parser.parse_args(argv)
    result = run_bench(args.device, args.rows, args.full, args.probes, args.skip_10m,
                       verify=verify, verify_tower=verify_tower, check_probes=check_probes,
                       verify_static=verify_static)
    log(f"bench done in {result['extra']['seconds']} s")
    print(json.dumps(result), flush=True)
    return 0
