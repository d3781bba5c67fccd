"""The SigLIP cell in the harness tests' toy checkout.

``tests/conftest.py``'s ``toy_root`` maps every cell of ``BENCHMARK.json``
by name to a tiny configuration (its ``CELLS``, ``TOY_TRAFFIC`` and
``TOY_LIMITS``). This hook gives it the entries of ``so400m-encode-256``
before the fixture runs, and afterwards writes the tiny SigLIP
configuration the cell then names, so every test of the toy checkout runs
with the cell in ``BENCHMARK.json`` as the real checkout has it.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CELL = "so400m-encode-256"
TOY = "toy-siglip"
# the widths of models.siglip.SiglipConfig.tiny_test: an MLP 136 wide over 48,
# 38 px in patches of 8 (6 px past the last whole patch, as 384 in 14)
TOY_WIDTHS = dict(hidden_size=48, intermediate_size=136, num_attention_heads=4,
                  num_hidden_layers=2)
# the toy's sound readings on the CPU in bf16 lie near 0.01 (the CLIP toy's
# limit, 0.05, for the same widths and depth)
TOY_LIMIT = {"embed_gap": 0.05}


def toy_config() -> dict:
    cfg = json.loads((REPO / "perfbench" / "configs" / "siglip-so400m-patch14-384.json").read_text())
    cfg["text_config"].update(TOY_WIDTHS, max_position_embeddings=16, vocab_size=512)
    cfg["vision_config"].update(TOY_WIDTHS, image_size=38, patch_size=8)
    return cfg


@pytest.hookimpl(hookwrapper=True)
def pytest_fixture_setup(fixturedef, request):
    toy = fixturedef.argname == "toy_root"
    if toy:
        tables = fixturedef.func.__globals__
        tables["CELLS"].setdefault(CELL, (TOY, "siglip-encode-256"))
        tables["TOY_TRAFFIC"].setdefault("encode_siglip",
                                         dict(batch=8, pool_batches=2, check_sample=8))
        tables["TOY_LIMITS"].setdefault("encode_siglip", TOY_LIMIT)
    outcome = yield
    if toy and outcome.excinfo is None:
        root = outcome.get_result()
        (root / "perfbench" / "configs" / f"{TOY}.json").write_text(json.dumps(toy_config()))
        bench = json.loads((root / "BENCHMARK.json").read_text())
        bench["configs"].append({"name": TOY, "source": "test",
                                 "file": f"perfbench/configs/{TOY}.json", "reduced": [],
                                 "why": "tiny SigLIP widths"})
        (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
