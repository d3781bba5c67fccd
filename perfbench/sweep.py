"""The rate sweep of a served cell: one set-up, then one open-loop window
per offered rate, each with its own seed, to find the knee (the highest
rate whose backlog does not grow and whose p95 stays under the limit).

    python3 -m perfbench.sweep --workload <served cell> --seed <n> --seconds <s> --rates <r> ...

For every rate it prints the offered and answered rates, p50, p95 and p99,
the failures, how late the generator ran, and the growth: the median
latency of the last quarter of due requests over that of the first.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .drivers import serve
from .drivers.common import Context, nearest_rank
from .run import ROOT, cache_env
from .trace import Tracer


def main() -> int:
    p = argparse.ArgumentParser(prog="perfbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    cache_env(ROOT)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    dev = torch.device("cuda", 0)
    ctx = Context(root=ROOT, workload=cell, config=json.loads((ROOT / conf["file"]).read_text()),
                  traffic=traffic, seed=args.seed, seconds=args.seconds, trace=False, device=dev,
                  tracer=Tracer(False, dev), t_start=time.perf_counter())
    served = serve.Served(ctx)
    try:
        for i, rate in enumerate(args.rates):
            w = served.window(rate, args.seconds, args.seed + 1 + i)
            lat = w["latencies_ms"]
            q = max(1, len(lat) // 4)
            finite = [x for x in lat if np.isfinite(x)]
            print(json.dumps({
                "rate": rate, "requests": len(lat), "answered_per_s": len(finite) / w["window_s"],
                "p50_ms": nearest_rank(lat, 50), "p95_ms": nearest_rank(lat, 95),
                "p99_ms": nearest_rank(lat, 99), "failed": len(lat) - len(finite),
                "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
                "avg_batch": w["batch_requests"] / max(w["batches"], 1),
                "loadgen": json.loads(w["summary"])}), flush=True)
    finally:
        served.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
