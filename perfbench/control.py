"""The control of each cell: its comparison run with a lower precision in
the program's place, which must come out not correct.

    python3 -m perfbench.control --workload <name> --seeds <n> [<n> ...]

For every seed it builds the cell's inputs at the cell's own size and
prints, beside the cell's limits, the numbers of the ``control`` and of the
``program`` as the cell runs it, through the same calls without the window,
as a second witness beside the runs. Each driver module of
``perfbench/drivers/`` says what its control is, in its ``control(ctx)``;
the traffic's ``driver`` names the module.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from .drivers import common
from .reference import compare
from .run import ROOT, cache_env
from .trace import Tracer


def readings(root, workload: str, seed: int, device: torch.device) -> dict:
    """The program's and the control's numbers of one seed, with the limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    ctx = common.Context(root=root, workload=cell, config=json.loads((root / conf["file"]).read_text()),
                         traffic=traffic, seed=seed, seconds=0.0, trace=False, device=device,
                         tracer=Tracer(False, device), t_start=time.perf_counter())
    out = importlib.import_module(f"perfbench.drivers.{traffic['driver']}").control(ctx)
    out["limits"] = traffic["limits"]
    out["control_fails"] = not compare.passed(compare.judge(out["control"], traffic["limits"]))
    return out


def main() -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = readings(ROOT, args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        common.free_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
