"""The SigLIP cell (``so400m-encode-256``) on the CPU at tiny widths: a sound
run is correct, a run with the embeddings altered is not, a traced run
reports the program counter's metric; the four readers on a synthetic
device trace and synthetic program spans, and with no program spans (a
program that records none). On a card, the traced toy cell reports all
four."""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from perfbench import roofline, roofline_siglip
from perfbench.conftest import TOY_LIMIT
from perfbench.run import ROOT, _load_metric, run_cell
from perfbench.trace import Summary

CELL = "so400m-encode-256"
CPU = torch.device("cpu")
METRICS = ("b3_roofline.siglip", "attn_share.siglip", "mfu.siglip", "device_idle.siglip")
B3 = "void (anonymous namespace)::mha_fwd_bf16_stream_kernel<96>(...)"


def _run(root, trace=False, seed=2**31 + 17, device=CPU):
    result, _, checks = run_cell(root, CELL, seed, 2.0, trace, device, time.perf_counter())
    return result, checks


def test_cell_runs_correct(toy_root):
    result, checks = _run(toy_root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"images_per_s", "setup_s"}
    assert [name for name, _, _ in checks] == ["embed_gap"]
    assert 0 <= result["checks"]["embed_gap"]["value"] <= TOY_LIMIT["embed_gap"]


def test_cell_traced_reports_the_counter(toy_root):
    result, _ = _run(toy_root, trace=True)
    assert result["correct"]
    # the CPU has no device trace: the device readers find nothing and stay out
    assert set(result["metrics"]) == {"mfu.siglip"}
    assert result["metrics"]["mfu.siglip"]["value"] > 0


def test_altered_embedding_is_not_correct(toy_root, monkeypatch):
    encode = CLIPEmbedder.encode_images

    def altered(self, *args, **kwargs):
        return np.roll(encode(self, *args, **kwargs), 1, axis=1)

    monkeypatch.setattr(CLIPEmbedder, "encode_images", altered)
    result, _ = _run(toy_root, seed=5)
    assert result["correct"] is False, result["checks"]


def _synthetic(config, with_program=True):
    """A 1 s slice of 27 B3 launches of 10 ms and 0.5 s of GEMMs, busy
    0.8 s; 4 calls of 256 images before it, over 2 s; the program's spans of
    one call of the slice."""
    b3 = [(B3, 0.01 * i, 0.01) for i in range(27)]
    summary = Summary(kernels=b3 + [("sm90_gemm", 0.3, 0.5)], window_s=1.0, busy_s=0.8)
    spans = []
    if with_program:
        shape = dict(batch=256, tokens=729, dim=1152, heads=16, variant="stream")
        spans = [{"name": "attn.b3", "start": 0.0, "end": 0.0, "attrs": shape, "counts": {}}
                 for _ in range(27)]
        spans.append({"name": "embed.images", "start": 0.0, "end": 1.0,
                      "attrs": {"images": 256}, "counts": {"embed.tokens": 256 * 729}})
    out = SimpleNamespace(records={"t0": 10.0, "call_ends": [10.5, 11.0, 11.5, 12.0, 13.5],
                                   "batch": 256, "program_spans": spans})
    ctx = SimpleNamespace(config=config, tracer=SimpleNamespace(host_bounds=(12.2, 13.2)))
    return ctx, out, summary


@pytest.fixture
def so400m():
    return json.loads((ROOT / "perfbench" / "configs" / "siglip-so400m-patch14-384.json").read_text())


def test_readers_on_a_synthetic_slice(so400m):
    ctx, out, summary = _synthetic(so400m)
    got = {m: _load_metric(ROOT, m)(ctx, out, summary) for m in METRICS}
    one = roofline.bound_s(4.0 * 256 * 729 * 729 * 1152, 4.0 * 256 * 729 * 1152 * 2)
    assert math.isclose(one, 0.634e-3, rel_tol=1e-3)     # by operations
    assert math.isclose(got["b3_roofline.siglip"], 100.0 * 27 * one / 0.27)
    assert math.isclose(got["attn_share.siglip"], 100.0 * 0.27 / 0.8)
    assert math.isclose(got["device_idle.siglip"], 20.0)
    per_call = roofline.bound_s(*roofline_siglip.vision_tower(so400m, 256))
    assert math.isclose(per_call, 171.6e12 / roofline.BF16_FLOPS, rel_tol=1e-3)
    assert math.isclose(got["mfu.siglip"], 100.0 * 4 * per_call / 2.0)


def test_readers_without_program_spans(so400m):
    ctx, out, summary = _synthetic(so400m, with_program=False)
    got = {m: _load_metric(ROOT, m)(ctx, out, summary) for m in METRICS}
    assert got["b3_roofline.siglip"] is None and got["mfu.siglip"] is None
    del out.records["program_spans"]                     # a driver that keeps none
    assert _load_metric(ROOT, "mfu.siglip")(ctx, out, summary) is None
    assert got["attn_share.siglip"] is not None and got["device_idle.siglip"] is not None


def test_flops_of_the_published_shape(so400m):
    v = so400m["vision_config"]
    ops = roofline_siglip.vision_flops(v, 256)
    blocks = 27 * roofline._block_flops(256 * 729, 1152, 4304, 729)
    assert math.isclose(blocks, 170.4e12, rel_tol=1e-3)
    patch = 2.0 * 256 * 729 * 3 * 14 * 14 * 1152
    assert math.isclose(ops, blocks + patch + roofline_siglip.head_flops(1152, 4304, 256, 729))
    assert math.isclose(roofline_siglip.head_flops(1152, 4304, 256, 729), 0.99e12, rel_tol=0.02)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace and B3 are the card's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_traced_on_the_card(toy_root, card):
    result, _ = _run(toy_root, trace=True, device=card)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == set(METRICS)
    for name in METRICS:
        assert 0 < result["metrics"][name]["value"] <= 100, (name, result["metrics"])
