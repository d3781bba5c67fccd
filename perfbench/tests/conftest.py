"""A toy checkout for the harness's CPU tests: ``BENCHMARK.json`` with the
real cells pointed at tiny configurations and traffic files, the real
metric readers beside them, and a served cell (``toy-serve``, the open-loop
mix ``serve-32M-open`` that waits under Open questions) so that the served
driver runs too. Everything is new files, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
# limits of the toy widths (2 layers of 48 and 64, 8,192 rows of 32), from
# their sound readings on the CPU (serve ~0.005, k-NN 0, encode ~0.01)
TOY_LIMITS = {"serve": {"hit_shortfall": 0.03, "score_gap": 0.03},
              "knn": {"hit_shortfall": 1e-6, "score_gap": 1e-6},
              "encode": {"embed_gap": 0.05}}
TOY_TRAFFIC = {"serve": dict(rate=20.0, warm_requests=8, check_sample=16, drain_s=20,
                             connections=8),
               "knn": dict(queries_per_call=64, pool_calls=4, check_sample=32),
               "encode": dict(batch=8, pool_batches=2, check_sample=8)}
CELLS = {"b32-knn-96M-int8": ("toy8", "knn-96M-int8"),
         "l14-encode-256": ("toy", "encode-256"),
         "toy-serve": ("toy", "serve-32M-open")}


def _toy_config(name: str, dtype: str) -> dict:
    cfg = json.loads((REPO / "perfbench" / "configs" / name).read_text())
    cfg["text_config"].update(hidden_size=48, intermediate_size=192, max_position_embeddings=16,
                              num_attention_heads=4, num_hidden_layers=2, vocab_size=512,
                              projection_dim=32)
    cfg["vision_config"].update(hidden_size=64, intermediate_size=256, image_size=32,
                                patch_size=8, num_attention_heads=4, num_hidden_layers=2,
                                projection_dim=32)
    cfg["projection_dim"] = 32
    cfg["index"] = {"rows": 8192, "dim": 32, "dtype": dtype}
    return cfg


@pytest.fixture
def toy_root(tmp_path: Path) -> Path:
    pb = tmp_path / "perfbench"
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics")
    (pb / "configs" / "toy.json").write_text(json.dumps(_toy_config("clip-vit-l-14.json", "bfloat16")))
    (pb / "configs" / "toy8.json").write_text(json.dumps(_toy_config("clip-vit-b-32.json", "int8")))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": "toy", "source": "test", "file": "perfbench/configs/toy.json", "reduced": [],
         "why": "tiny widths"},
        {"name": "toy8", "source": "test", "file": "perfbench/configs/toy8.json", "reduced": [],
         "why": "tiny widths, int8 rows"}]
    bench["workloads"].append({"name": "toy-serve", "chips": 1, "why": "the served driver"})
    bench["end_to_end"].append({"name": "query_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": ["toy-serve"]})
    for w in bench["workloads"]:
        config, traffic = CELLS[w["name"]]
        t = json.loads((REPO / "perfbench" / "traffic" / f"{traffic}.json").read_text())
        t.update(TOY_TRAFFIC[t["driver"]])
        t["limits"] = dict(TOY_LIMITS[t["driver"]])
        (pb / "traffic" / f"toy-{traffic}.json").write_text(json.dumps(t))
        w["config"], w["traffic"] = config, f"toy-{traffic}"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp_path
