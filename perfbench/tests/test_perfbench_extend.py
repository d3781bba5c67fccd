"""A configuration, a traffic mix and a per-layer metric added as new files
and new entries of ``BENCHMARK.json`` run with no edit to any file that
was there."""

from __future__ import annotations

import json
import time

import torch

from perfbench.run import run_cell

TOY_METRIC = '''"""Vectors answered per call: a counter of the driver's records."""


def read(ctx, out, summary):
    return float(out.records["queries_per_call"])
'''


def test_new_files_only(toy_root):
    pb = toy_root / "perfbench"
    cfg = json.loads((pb / "configs" / "toy8.json").read_text())
    cfg["index"]["rows"] = 4096
    (pb / "configs" / "toy8-small.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "toy-knn-96M-int8.json").read_text())
    traffic.update(queries_per_call=16, top_k=5)
    (pb / "traffic" / "toy-knn-small.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "vectors_per_call.knn.py").write_text(TOY_METRIC)
    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy8-small", "source": "test",
                             "file": "perfbench/configs/toy8-small.json", "reduced": ["index"],
                             "why": "half the rows"})
    bench["workloads"].append({"name": "toy-knn-small", "config": "toy8-small",
                               "traffic": "toy-knn-small", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append("toy-knn-small")
    bench["per_layer"].append({"name": "vectors_per_call.knn", "unit": "queries",
                               "better": "higher", "source": "program_counter", "layer": "index",
                               "moves": "queries_per_s", "workloads": ["toy-knn-small"]})
    (toy_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _, _ = run_cell(toy_root, "toy-knn-small", 3, 1.0, False, torch.device("cpu"),
                            time.perf_counter())
    assert result["correct"] and set(result["metrics"]) == {"queries_per_s", "setup_s"}
    result, _, _ = run_cell(toy_root, "toy-knn-small", 4, 1.0, True, torch.device("cpu"),
                            time.perf_counter())
    assert result["metrics"]["vectors_per_call.knn"]["value"] == 16.0
