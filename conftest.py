"""The DeepSeek-V2-Lite translate cell in the harness tests' toy checkout.

``perfbench/tests/conftest.py``'s ``toy_root`` maps every cell of
``BENCHMARK.json`` by name to a tiny configuration (its ``CELLS``,
``TOY_TRAFFIC`` and ``TOY_LIMITS``), and ``perfbench/conftest.py`` adds the
SigLIP cell's entries the same way. This hook gives the fixture the
entries of ``dsv2-lite-translate-64`` before it runs, and afterwards writes
the tiny DeepSeek-V2 configuration the cell then names. It lives at the
repository's root, which pytest loads for ``perfbench/tests`` too, so that
the benchmark's files stay as they were; it acts on that fixture alone.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent
CELL = "dsv2-lite-translate-64"
TOY = "toy-dsv2"
# the widths of models.deepseek_v2.DeepseekV2Config.tiny_test: one dense
# layer and two MoE layers of 64, 8 experts (top 3) and 2 shared
TOY_WIDTHS = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                  num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
                  num_experts_per_tok=3, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
TOY_TRAFFIC = dict(queries_per_call=4, query_tokens=[8, 16], new_tokens=[4, 8], pool_calls=400,
                   warm_calls=1, check_sample=4)
# the toy's readings on the CPU over 30 seeds (4 rows of 4-8 new tokens
# each), bf16 / the float8 control: logit_gap (a row's mean, the largest
# row) up to 0.064 / from 0.058: a router near-tie that bf16 flips weighs
# a quarter of a 4-token row, so at this size only lse_gap (up to 0.0032 /
# from 0.0061) tells the control apart; token_shortfall up to 0.28 (a
# near-tie of the head)
TOY_LIMIT = {"logit_gap": 0.1, "lse_gap": 0.0045, "token_shortfall": 0.5}


def toy_config() -> dict:
    cfg = json.loads((REPO / "perfbench" / "configs" / "deepseek-v2-lite.json").read_text())
    cfg.update(TOY_WIDTHS)
    return cfg


@pytest.hookimpl(hookwrapper=True)
def pytest_fixture_setup(fixturedef, request):
    toy = fixturedef.argname == "toy_root"
    if toy:
        tables = fixturedef.func.__globals__
        tables["CELLS"].setdefault(CELL, (TOY, "llm-translate-64"))
        tables["TOY_TRAFFIC"].setdefault("translate", TOY_TRAFFIC)
        tables["TOY_LIMITS"].setdefault("translate", TOY_LIMIT)
    outcome = yield
    if toy and outcome.excinfo is None:
        root = outcome.get_result()
        (root / "perfbench" / "configs" / f"{TOY}.json").write_text(json.dumps(toy_config()))
        bench = json.loads((root / "BENCHMARK.json").read_text())
        bench["configs"].append({"name": TOY, "source": "test",
                                 "file": f"perfbench/configs/{TOY}.json", "reduced": [],
                                 "why": "tiny DeepSeek-V2 widths"})
        (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
