"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's configuration is the file its
``configs`` entry names, its traffic mix is ``perfbench/traffic/<traffic>.json``
(the ``driver`` it names is a module of ``perfbench/drivers/``), and each
per-layer metric is read by ``perfbench/metrics/<metric>.py``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and traced
seconds. ``correct`` is the comparison of the window's answers with the
plain reference (``perfbench/reference``), each number beside its limit
from the traffic file; the numbers are also the last lines on standard
error. Without a card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, the run prints
no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "intelligent_video_analysis_retrieval_system_tpu"})


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind any library the program loads."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton_cache"))
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"


def forbidden_modules() -> list[str]:
    """Top-level names of JAX or the JAX package in ``sys.modules``, each
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def _load_metric(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    """A metric with ``workloads`` belongs to the cells it lists; an
    end-to-end one without belongs to every cell, a per-layer one to every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple[dict, list[str], list[tuple[str, float, float | None]]]:
    """(result line, notes, checks) of one run of ``workload`` on ``device``."""
    import torch

    from .drivers.common import Context
    from .reference import compare
    from .trace import Tracer

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(root=root, workload=cell, config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device, tracer=Tracer(trace, device),
                  t_start=t_start)
    ctx.log(f"{workload}: seed {seed}, {seconds} s, trace {int(trace)}")
    out = driver.run(ctx)
    ctx.tracer.finish()
    if ctx.tracer.summary is not None and ctx.tracer.summary.tie != "markers":
        out.notes.append(f"trace: slice bounded by the {ctx.tracer.summary.tie} of the device work")
    if "call_ends" in out.records:
        from .drivers.common import slice_note

        note = slice_note(out.records, ctx.tracer.host_bounds)
        if note:
            out.notes.append(note)
    checks = compare.judge(out.numbers, traffic["limits"])
    correct = compare.passed(checks) and out.failed == 0
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    values = dict(out.end_to_end, setup_s=ctx.setup_s)
    metrics: dict[str, dict] = {}
    if not trace:
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        reported = {m["name"] for m in e2e}
        for m in bench["per_layer"]:
            if not _applies(m, workload, reported):
                continue
            value = _load_metric(root, m["name"])(ctx, out, ctx.tracer.summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for v in metrics.values():
        if not math.isfinite(v["value"]):
            v["value"] = 1e12
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace:
        s = ctx.tracer.summary
        if s is None or (device.type == "cuda" and s.busy_s <= 0):
            raise RuntimeError("the traced slice recorded no device work")
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["checks"] = {name: {"value": value if math.isfinite(value) else 1e12, "limit": limit}
                        for name, value, limit in checks}
    return result, out.notes, checks


def main(argv: list[str] | None = None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(prog="perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"perfbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, notes, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                     bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for line in notes:
        print(line, flush=True)
    for name, value, limit in checks:
        verdict = "ok" if limit is not None and value <= limit else "FAILED"
        print(f"check {name} {value!r} limit {limit!r} {verdict}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
