"""The translate cell (``dsv2-lite-translate-64``) on the CPU at tiny widths:
a sound run is correct, a traced run reports the program counter's metric,
a path with a shared expert dropped or RoPE one position off is not
correct, and the float8 control fails the toy's limits; the three readers
on a synthetic device trace and synthetic program spans, and with no
program spans (a program that records none). On a card, the traced toy
cell reports all three."""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch.models import deepseek_v2
from perfbench import roofline, roofline_deepseek_v2
from perfbench.control import readings
from perfbench.run import ROOT, _load_metric, run_cell
from perfbench.trace import Summary

CELL = "dsv2-lite-translate-64"
CPU = torch.device("cpu")
METRICS = ("mfu.translate", "device_idle.translate", "moe_roofline.translate")
GEMM = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<"
        "cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<...>>>>")


def _run(root, trace=False, seed=2**31 + 29, device=CPU):
    # a traced run takes its slice from 40% of the window: room for a few
    # toy calls (~0.1 s each here) on either side of it
    result, _, checks = run_cell(root, CELL, seed, 3.0 if trace else 1.5, trace, device,
                                 time.perf_counter())
    return result, checks


def test_cell_runs_correct(toy_root):
    result, checks = _run(toy_root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"queries_per_s", "setup_s"}
    assert [name for name, _, _ in checks] == ["logit_gap", "lse_gap", "token_shortfall"]
    limits = json.loads((toy_root / "perfbench" / "traffic" / "toy-llm-translate-64.json")
                        .read_text())["limits"]
    for name, limit in limits.items():
        assert result["checks"][name]["limit"] == limit
        assert 0 <= result["checks"][name]["value"] <= limit


def test_cell_traced_reports_the_counter(toy_root):
    result, _ = _run(toy_root, trace=True, seed=7)
    assert result["correct"], result["checks"]
    # the CPU has no device trace: the device readers find nothing and stay out
    assert set(result["metrics"]) == {"mfu.translate"}
    assert 0 < result["metrics"]["mfu.translate"]["value"] < 100


def test_a_dropped_shared_expert_is_not_correct(toy_root, monkeypatch):
    def routed_only(self, x):
        flat = x.reshape(-1, x.shape[-1])
        idx, weight = self.gate(flat)
        y, counts = deepseek_v2.routed_experts(flat, idx, weight, self.experts.gate_up,
                                               self.experts.down)
        f = self.shared_experts.down_proj.weight.shape[1] // 2    # one of the two shared
        g = self.shared_experts.gate_proj.weight[:f]
        u = self.shared_experts.up_proj.weight[:f]
        d = self.shared_experts.down_proj.weight[:, :f]
        y = y + torch.nn.functional.silu(flat @ g.t()) * (flat @ u.t()) @ d.t()
        return y.view(x.shape), counts

    monkeypatch.setattr(deepseek_v2.DeepseekV2MoE, "forward", routed_only)
    result, _ = _run(toy_root, seed=11)
    assert result["correct"] is False, result["checks"]


def test_rope_one_position_off_is_not_correct(toy_root, monkeypatch):
    decode = deepseek_v2.DeepseekV2ForCausalLM.decode

    def one_ahead(self, tokens, slot, cache, hits=None):
        at = self.rope.at
        self.rope.at = lambda pos: at(pos + 1)         # decoded tokens' rotation only
        try:
            return decode(self, tokens, slot, cache, hits)
        finally:
            del self.rope.at

    monkeypatch.setattr(deepseek_v2.DeepseekV2ForCausalLM, "decode", one_ahead)
    result, _ = _run(toy_root, seed=13)
    assert result["correct"] is False, result["checks"]


def test_the_float8_control_fails(toy_root):
    out = readings(toy_root, CELL, 17, CPU)
    assert out["control_fails"], out
    assert all(out["program"][k] <= v for k, v in out["limits"].items()), out


def _synthetic(config, with_program=True):
    """A 1 s slice with 0.3 s of grouped GEMMs, busy 0.8 s; 4 calls before
    it over 6 s; the program's spans of one call of the slice."""
    summary = Summary(kernels=[(GEMM, 0.01 * i, 0.006) for i in range(50)]
                      + [("sm90_gemm", 0.5, 0.5)], window_s=1.0, busy_s=0.8)
    counts = {"llm.prefill_tokens": 64 * 48, "llm.decode_tokens": 64 * 63, "llm.steps": 63,
              "moe.experts_hit": 26 * 64 * 64}
    spans = []
    if with_program:
        spans = [{"name": "llm.generate", "start": 0.0, "end": 1.0,
                  "attrs": {"rows": 64, "prompt_tokens": 64 * 28, "new_tokens": 64 * 40},
                  "counts": counts}]
    out = SimpleNamespace(records={"t0": 10.0, "call_ends": [11.5, 13.0, 14.5, 16.0, 17.5],
                                   "program_spans": spans, "prefix_tokens": 730})
    ctx = SimpleNamespace(config=config, tracer=SimpleNamespace(host_bounds=(16.2, 17.2)))
    return ctx, out, summary, counts


@pytest.fixture
def lite():
    return json.loads((ROOT / "perfbench" / "configs" / "deepseek-v2-lite.json").read_text())


def test_readers_on_a_synthetic_slice(lite):
    ctx, out, summary, counts = _synthetic(lite)
    got = {m: _load_metric(ROOT, m)(ctx, out, summary) for m in METRICS}
    assert math.isclose(got["device_idle.translate"], 20.0)
    per_call = roofline_deepseek_v2.call_bound_s(lite, counts, 64, 64 * 28, 730)
    assert 0.55 < per_call < 0.65                       # ~2.0 TB at 3.35 TB/s
    assert math.isclose(got["mfu.translate"], 100.0 * 4 * per_call / 6.0)
    experts = roofline_deepseek_v2.expert_bound_s(lite, counts)
    weights = 26 * 64 * 64 * 3 * 2048 * 1408 * 2 / roofline.HBM_BYTES
    assert weights < experts < 1.02 * weights            # the experts' bytes, and the pairs'
    assert math.isclose(got["moe_roofline.translate"], 100.0 * experts / 0.3)


def test_readers_without_program_spans(lite):
    ctx, out, summary, _ = _synthetic(lite, with_program=False)
    got = {m: _load_metric(ROOT, m)(ctx, out, summary) for m in METRICS}
    assert got["mfu.translate"] is None and got["moe_roofline.translate"] is None
    assert got["device_idle.translate"] is not None
    del out.records["program_spans"]                     # a driver that keeps none
    assert _load_metric(ROOT, "moe_roofline.translate")(ctx, out, summary) is None


def test_work_of_the_published_shape(lite):
    assert roofline_deepseek_v2.expert_params(lite) * 64 * 26 == 14_394_851_328
    # 15.7B parameters: the experts, the rest and the embedding
    total = (roofline_deepseek_v2.expert_params(lite) * 64 * 26
             + roofline_deepseek_v2.dense_params(lite) + 102400 * 2048)
    assert math.isclose(total, 15.706e9, rel_tol=1e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace and the grouped products are the card's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_traced_on_the_card(toy_root, card):
    result, _ = _run(toy_root, trace=True, device=card)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == set(METRICS)
    for name in METRICS:
        assert 0 < result["metrics"][name]["value"] <= 100, (name, result["metrics"])
