"""The port's DeepSeek-V2 decoder (``models/deepseek_v2.py``), its grouped
experts (``ops/moe.py``) and the local translator (``system/local_llm.py``)
against the plain reference the benchmark's ``correct`` uses
(``perfbench/reference/deepseek_v2.py``).

On the CPU at ``DeepseekV2Config.tiny_test()`` size, over seeded weights in
the checkpoint's names (``perfbench/weights_deepseek_v2.py``):

- in float32, the full pass, prefill after the cached prefix, and decode
  through the latent cache at every position, each within 1e-4 of the
  reference's logits (the same operations in another order: the latent
  path folds ``W_UK`` into the query and applies ``W_UV`` after the
  softmax, so its sums run over 32 latent dims where the reference sums
  over 16-wide heads; the logits spread by about 1);
- the absorbed decode attention against the up-projected prefill attention
  of the same token, within 1e-5 (one layer, the same two orders);
- a ragged batch against each row alone, prefix reuse against a cold
  full pass, a second call on the same cache against the first: tokens
  equal, logits within 1e-5 (rows of another batch differ only in
  padding, which the causal mask keeps out);
- routing ids and weights against the reference's; the MoE layer against
  the reference's experts looped one by one with the shared experts
  counted once, within 1e-5, and against a copy with one shared
  expert dropped, which must differ;
- in bfloat16, every generated position within 0.05 of the reference's
  spread (two layers of bf16 rounding read ~0.02);
- ``lite()`` against the catalog's values, YaRN's correction range (10, 23)
  and softmax scale 0.114721 for the published config;
- ``translate_queries`` sends every cache miss to the backend once per
  batch, and the serving batcher calls it once per batch.

On a card (``cuda`` marker): a decode step at ``lite()``'s widths (two
layers: the dense layer and one MoE layer of 64 experts) against the
float32 reference, with ``moe.experts_hit`` and the spans.
"""

import dataclasses
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch import trace
from intelligent_video_analysis_retrieval_system_tpu_torch.models import deepseek_v2 as ds
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import moe
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.translator import (
    UniversalQueryTranslator,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.serve.batching import QueryBatcher, _Pending
from intelligent_video_analysis_retrieval_system_tpu_torch.system import local_llm
from perfbench import weights_deepseek_v2 as wds
from perfbench.reference import deepseek_v2 as ref

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LITE = json.loads((REPO / "perfbench" / "configs" / "deepseek-v2-lite.json").read_text())
SEED = 2**31 + 1234


def hf_dict(cfg: ds.DeepseekV2Config) -> dict:
    """The configuration file's keys with ``cfg``'s shapes."""
    out = dict(LITE)
    out.update({k: v for k, v in dataclasses.asdict(cfg).items() if k in LITE})
    return out


TINY = ds.DeepseekV2Config.tiny_test()
TINY_HF = hf_dict(TINY)


@pytest.fixture(scope="module")
def sd():
    return wds.make(TINY_HF, SEED, CPU)


@pytest.fixture(scope="module")
def sd32(sd):
    return {k: v.float() for k, v in sd.items()}


def model_of(sd, dtype=torch.float32, cfg=TINY):
    m = ds.DeepseekV2ForCausalLM(cfg, device="meta", dtype=dtype).to_empty(device=CPU)
    m.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
    return m


@pytest.fixture(scope="module")
def m32(sd):
    return model_of(sd)


def backend(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_query_tokens", 12)
    kw.setdefault("max_new_tokens", 6)
    return local_llm.LocalTranslator(model, stop_ids=(), **kw)


QUERIES = ["con chó đang chạy trên bãi biển", "xe máy màu đỏ",
           "người đàn ông đang hát trên sân khấu lớn với đèn", "mưa"]


def test_lite_is_the_catalog_row():
    cfg = ds.DeepseekV2Config.lite()
    assert ds.DeepseekV2Config.from_hf(LITE) == cfg
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size) == (27, 2048, 102400)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts) == (64, 6, 2)
    assert (cfg.moe_intermediate_size, cfg.intermediate_size, cfg.kv_lora_rank) == (1408, 10944, 512)
    assert (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == (128, 64, 128)
    assert cfg.latent_dim == 576 and cfg.q_lora_rank is None
    assert [cfg.is_moe(i) for i in range(27)] == [False] + [True] * 26


def test_yarn_of_the_published_config():
    cfg = ds.DeepseekV2Config.lite()
    assert ds.yarn_correction_range(cfg) == (10, 23)
    assert round(cfg.softmax_scale, 6) == 0.114721
    assert math.isclose(cfg.softmax_scale, ref.softmax_scale(LITE), rel_tol=1e-12)
    rope = ds.YarnRope(cfg)
    rot = rope.table(300, CPU)[:300]
    rcos, rsin = ref.rope_tables(LITE, 300, CPU)
    assert torch.allclose(rot.real, rcos[:, :32], atol=1e-6)
    assert torch.allclose(rot.imag, rsin[:, :32], atol=1e-6)
    assert rope.mscale == 1.0     # mscale and mscale_all_dim are equal
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(2))
    pos = torch.tensor([0, 3, 17, 250, 299])
    assert torch.allclose(ds.apply_rope(x, rope.at(pos)), ref.rope(x, rcos[pos], rsin[pos]),
                          atol=1e-6)


@pytest.mark.parametrize("change", [{"q_lora_rank": 1536}, {"scoring_func": "sigmoid"},
                                    {"topk_method": "group_limited_greedy"},
                                    {"rope_scaling": {"type": "linear"}}], ids=str)
def test_unbuilt_variants_refused(change):
    cfg = dict(LITE, **change)
    with pytest.raises(ValueError):
        ds.DeepseekV2Config.from_hf(cfg)


def test_names_are_the_checkpoints(m32, sd):
    names = set(m32.state_dict())
    assert names == set(sd)
    assert "model.layers.1.mlp.experts.7.down_proj.weight" in names
    assert "model.layers.1.mlp.shared_experts.up_proj.weight" in names
    assert "model.layers.0.mlp.gate_proj.weight" in names
    assert not any("gate_up" in n for n in names)
    for n, v in m32.state_dict().items():
        assert torch.equal(v, sd[n].float()), n


def test_experts_refuse_missing_and_misshapen_leaves(sd):
    m = ds.DeepseekV2ForCausalLM(TINY, dtype=torch.float32)
    part = {k: v for k, v in sd.items() if "experts.3.up_proj" not in k}
    with pytest.raises(RuntimeError, match="experts.3.up_proj"):
        m.load_state_dict(part)
    bad = dict(sd)
    bad["model.layers.1.mlp.experts.0.down_proj.weight"] = torch.zeros(3, 3)
    with pytest.raises(RuntimeError, match="shape"):
        m.load_state_dict(bad)


def test_full_pass_against_the_reference(m32, sd32):
    ids = torch.randint(0, TINY.vocab_size, (40,), generator=torch.Generator().manual_seed(1))
    got = m32(ids[None])[0]
    want = ref.logits(sd32, TINY_HF, ids)
    assert (got - want).abs().max() < 1e-4 * want.std()


def test_prefill_and_decode_against_the_reference(m32, sd32):
    lt = backend(m32)
    rows = [lt.row_ids(q) for q in QUERIES]
    gen = lt.generate(rows, [6, 2, 5, 6])
    for b, row in enumerate(rows):
        seq = torch.tensor(lt.prefix_ids + row + gen.tokens[b][:-1])
        want = ref.logits(sd32, TINY_HF, seq)[len(lt.prefix_ids) + len(row) - 1:]
        assert len(gen.tokens[b]) == [6, 2, 5, 6][b]
        for j, tok in enumerate(gen.tokens[b]):
            w = want[j]
            assert tok == int(w.argmax()), (b, j)
            assert abs(gen.logits[b][j] - float(w[tok])) < 1e-4 * float(w.std())
            assert abs(gen.lse[b][j] - float(torch.logsumexp(w, 0))) < 1e-4 * float(w.std())


def test_absorbed_attention_against_up_projected(m32):
    attn = m32.model.layers[1].self_attn
    g = torch.Generator().manual_seed(3)
    n_pre, t = 9, 5
    m32.rope.table(64, CPU)
    x = torch.randn(2, t, TINY.hidden_size, generator=g)
    prefix = attn.latent(torch.randn(n_pre, TINY.hidden_size, generator=g),
                         m32.rope.at(torch.arange(n_pre)))
    pos = n_pre + torch.arange(t).expand(2, -1)
    with torch.inference_mode():
        full, lat = attn.prefill(x, m32.rope.at(pos), prefix)
        rows = torch.zeros(2, 8, TINY.latent_dim)
        rows[:, :t - 1] = lat[:, :t - 1]
        slot = torch.full((2,), t - 1)
        invalid = (torch.arange(8)[None, :] > slot[:, None]).unsqueeze(1)
        one = attn.decode(x[:, -1], m32.rope.at(n_pre + slot), prefix, rows, slot, invalid)
    assert torch.allclose(rows[:, t - 1], lat[:, t - 1], atol=1e-6)
    assert (one - full[:, -1]).abs().max() < 1e-5 * full.abs().max()


def test_ragged_batch_against_each_row_alone(m32):
    lt = backend(m32)
    rows = [lt.row_ids(q) for q in QUERIES]
    budgets = [6, 3, 4, 6]
    together = lt.generate(rows, budgets)
    for b, row in enumerate(rows):
        alone = lt.generate([row], [budgets[b]])
        assert alone.tokens[0] == together.tokens[b]
        assert max(abs(x - y) for x, y in zip(alone.logits[0], together.logits[b])) < 1e-5


def test_prefix_reuse_against_a_cold_pass(m32):
    lt = backend(m32)
    rows = [lt.row_ids(q) for q in QUERIES[:2]]
    first = lt.generate(rows, [5, 5])
    again = lt.generate(rows, [5, 5])
    assert first.tokens == again.tokens and first.logits == again.logits
    for b, row in enumerate(rows):
        seq = torch.tensor(lt.prefix_ids + row + first.tokens[b][:-1])
        cold = m32(seq[None])[0][len(lt.prefix_ids) + len(row) - 1:]
        got = torch.tensor(first.logits[b])
        assert (got - cold[torch.arange(5), torch.tensor(first.tokens[b])]).abs().max() < 1e-5


def test_stop_ids_cut_a_row_after_its_stop(m32):
    lt = backend(m32)
    rows = [lt.row_ids(QUERIES[0])]
    free = lt.generate(rows, [6]).tokens[0]
    cut = lt.generate(rows, [6], stop_ids=(free[2],)).tokens[0]
    assert cut == free[:free.index(free[2]) + 1]


def test_stop_ids_end_the_call_at_a_check(m32):
    lt = backend(m32, max_new_tokens=20)
    rows = [lt.row_ids(q) for q in QUERIES[:2]]
    every = tuple(range(TINY.vocab_size))            # each row stops at its first token
    trace.take()
    trace.enable()
    try:
        gen = lt.generate(rows, [20, 20], stop_ids=every)
    finally:
        trace.disable()
    spans = {s.name: s for s in trace.take()}
    assert [len(t) for t in gen.tokens] == [1, 1]
    # the first check, after STOP_CHECK of the 19 steps, ends the call
    assert spans["llm.generate"].counts["llm.steps"] == local_llm.STOP_CHECK
    assert spans["llm.decode"].attrs == {"steps": local_llm.STOP_CHECK}
    assert gen.tokens == [t[:1] for t in lt.generate(rows, [20, 20]).tokens]


def test_generate_refuses_what_the_cache_cannot_hold(m32):
    lt = backend(m32)
    with pytest.raises(ValueError):
        lt.generate([[1] * 13], [2])
    with pytest.raises(ValueError):
        lt.generate([[1]] * 5, [2] * 5)
    with pytest.raises(ValueError):
        lt.generate([[1]], [7])


def test_routing_against_the_reference(m32, sd32):
    layer = m32.model.layers[2]
    x = torch.randn(33, TINY.hidden_size, generator=torch.Generator().manual_seed(5))
    idx, w = layer.mlp.gate(x)
    p = {k[len("model.layers.2."):]: v for k, v in sd32.items() if k.startswith("model.layers.2.")}
    ridx, rw = ref.route(p, TINY_HF, x)
    assert torch.equal(idx, ridx) and torch.allclose(w, rw, atol=1e-7)
    assert w.dtype == torch.float32 and idx.shape == (33, TINY.num_experts_per_tok)
    assert (w.sum(-1) < 1).all()               # top-k of a softmax, not renormalised
    with torch.inference_mode():
        y, counts = layer.mlp(x)
    assert int(counts.sum()) == 33 * TINY.num_experts_per_tok
    assert torch.equal(counts, torch.bincount(idx.flatten(), minlength=TINY.n_routed_experts))
    want = ref.moe(p, TINY_HF, x, ref.dense_f32)
    assert (y - want).abs().max() < 1e-5 * want.abs().max()
    shared = ref.mlp(p, "mlp.shared_experts.", x, ref.dense_f32)
    assert (y - (want + shared)).abs().max() > 1e-2 * shared.abs().max()   # not twice
    f = TINY.moe_intermediate_size
    one = dict(p)
    for name in ("gate_proj", "up_proj"):
        one[f"mlp.shared_experts.{name}.weight"] = p[f"mlp.shared_experts.{name}.weight"][:f]
    one["mlp.shared_experts.down_proj.weight"] = p["mlp.shared_experts.down_proj.weight"][:, :f]
    assert (y - ref.moe(one, TINY_HF, x, ref.dense_f32)).abs().max() > 1e-2 * shared.abs().max()


def test_grouped_mm_plain_against_a_loop():
    g = torch.Generator().manual_seed(9)
    w = torch.randn(5, 7, 6, generator=g)
    idx = torch.tensor([3, 0, 3, 4, 0, 0, 1])
    order = torch.argsort(idx, stable=True)
    ends = torch.bincount(idx, minlength=5).cumsum(0).to(torch.int32)
    x = torch.randn(7, 6, generator=g)
    got = moe.grouped_mm(x[order], w, ends)
    want = torch.stack([x[i] @ w[idx[i]].t() for i in order.tolist()])
    assert torch.allclose(got, want, atol=1e-6)


def test_bf16_generation_against_the_reference(sd, sd32):
    lt = backend(model_of(sd, torch.bfloat16))
    rows = [lt.row_ids(q) for q in QUERIES]
    gen = lt.generate(rows, [6, 6, 6, 6])
    refs = []
    for b, row in enumerate(rows):
        seq = torch.tensor(lt.prefix_ids + row + gen.tokens[b][:-1])
        refs.append(ref.logits(sd32, TINY_HF, seq)[len(lt.prefix_ids) + len(row) - 1:])
    nums = ref.generation_numbers(list(zip(gen.tokens, gen.logits, gen.lse)), refs)
    assert max(nums.values()) < 0.05, nums


def test_generation_numbers_read_a_flip_and_a_gap():
    r = torch.tensor([[0.0, 1.0, 2.0, 3.0], [1.0, 0.0, 0.0, 0.0]])
    spread = r.std(-1)
    exact = ref.generation_numbers([([3, 0], [3.0, 1.0], torch.logsumexp(r, -1).tolist())], [r])
    assert max(exact.values()) < 1e-6       # float32 log-sum-exps against float64
    flip = ref.generation_numbers([([2, 0], [2.5, 1.0], torch.logsumexp(r, -1).tolist())], [r])
    assert math.isclose(flip["token_shortfall"], 1.0 / float(spread[0]), rel_tol=1e-6)
    assert math.isclose(flip["logit_gap_max"], 0.5 / float(spread[0]), rel_tol=1e-6)
    assert math.isclose(flip["logit_gap"], 0.25 / float(spread[0]), rel_tol=1e-6)   # the mean
    assert ref.generation_numbers([([2], [float("nan")], [0.0])], [r[:1]])["lse_gap"] == math.inf
    # a gap in one row of four is that row's mean, not diluted by the sound rows
    lse = torch.logsumexp(r, -1).tolist()
    sound = ([3, 0], [3.0, 1.0], lse)
    one_bad = ref.generation_numbers([sound, sound, ([3, 0], [3.5, 1.5], lse), sound], [r] * 4)
    assert math.isclose(one_bad["logit_gap"], 0.5 * float((1 / spread).mean()), rel_tol=1e-6)


def test_spans_and_counters(m32):
    lt = backend(m32)
    rows = [lt.row_ids(q) for q in QUERIES[:3]]
    trace.take()
    trace.enable()
    try:
        gen = lt.generate(rows, [4, 2, 3])
    finally:
        trace.disable()
    spans = {s.name: s for s in trace.take()}
    g = spans["llm.generate"]
    t = max(len(r) for r in rows)
    assert g.attrs == {"rows": 3, "prompt_tokens": sum(map(len, rows)), "new_tokens": 9}
    assert g.counts["llm.prefill_tokens"] == 3 * t and g.counts["llm.decode_tokens"] == 3 * 3
    assert g.counts["llm.steps"] == 3
    assert g.counts["moe.experts_hit"] == gen.experts_hit
    # two MoE layers, four passes (prefill and three steps): at least top-k
    # distinct experts a layer pass, at most all of them
    assert 2 * 4 * TINY.num_experts_per_tok <= gen.experts_hit <= 2 * 4 * TINY.n_routed_experts
    assert spans["llm.decode"].attrs == {"steps": 3} and spans["llm.prefill"].parent == g.id


def test_prefix_span_and_cache_size(m32):
    trace.take()
    trace.enable()
    try:
        lt = backend(m32)
    finally:
        trace.disable()
    (span,) = [s for s in trace.take() if s.name == "llm.prefix"]
    assert span.attrs == {"tokens": len(lt.prefix_ids)}
    assert 512 <= len(lt.prefix_ids) <= 768
    assert lt.cache.prefix.shape == (TINY.num_hidden_layers, len(lt.prefix_ids), TINY.latent_dim)
    assert lt.cache.rows.shape == (TINY.num_hidden_layers, 4, 18, TINY.latent_dim)


def test_render_ids_is_one_word_an_id():
    text = local_llm.render_ids([0, 74, 75, 102399, 74])
    words = text.split()
    assert len(words) == 5 and words[1] == words[4] and len(set(words)) == 4
    assert local_llm.render_ids([]) == ""


def test_translate_queries_sends_the_misses_once_per_batch():
    calls = []

    def batch_fn(queries):
        calls.append(list(queries))
        return [f"caption {len(q)}" for q in queries]

    t = UniversalQueryTranslator(llm_batch_translate_fn=batch_fn)
    first = t.translate_queries(["con chó", "a red car", "con chó", "xe máy màu đỏ"])
    assert calls == [["con chó", "xe máy màu đỏ"]]
    assert [r.method for r in first] == ["llm", "passthrough", "llm", "llm"]
    assert first[0].clip_prompt == "a photo of caption 7"
    again = t.translate_queries(["con chó", "mưa", "xe máy màu đỏ"])
    assert calls[-1] == ["mưa"] and again[0] is first[0]
    assert t.translate_query("mưa") is again[1] and len(calls) == 2


def test_translate_queries_falls_back_per_query():
    t = UniversalQueryTranslator(llm_batch_translate_fn=lambda qs: [None, "a cat"])
    out = t.translate_queries(["người đang chạy trên bãi biển", "con mèo"])
    assert [r.method for r in out] == ["dictionary", "llm"]
    broken = UniversalQueryTranslator(llm_batch_translate_fn=lambda qs: 1 / 0)
    assert broken.translate_query("con chó").method in ("dictionary", "passthrough")
    short = UniversalQueryTranslator(llm_batch_translate_fn=lambda qs: ["x"])
    assert [r.method for r in short.translate_queries(["con chó", "con mèo"])] == ["dictionary"] * 2


def test_translate_batch_span():
    t = UniversalQueryTranslator(llm_batch_translate_fn=lambda qs: ["a"] * len(qs))
    trace.take()
    trace.enable()
    try:
        t.translate_queries(["con chó", "a dog", "xe máy"])
    finally:
        trace.disable()
    (span,) = [s for s in trace.take() if s.name == "translate.batch"]
    assert span.attrs == {"queries": 3, "llm": 2}


def test_local_backend_through_the_translator(m32):
    lt = backend(m32, max_batch=2)
    calls = []
    generate = lt.generate

    def counted(*a, **k):
        calls.append(len(a[0]))
        return generate(*a, **k)

    lt.generate = counted
    t = UniversalQueryTranslator(llm_batch_translate_fn=lt.translate)
    out = t.translate_queries(QUERIES[:3] + ["a red car"])
    assert calls == [2, 1]                      # max_batch rows a call
    assert [r.method for r in out] == ["llm", "llm", "llm", "passthrough"]
    assert all(r.clip_prompt.startswith("a photo of ") for r in out)


def test_batcher_translates_once_per_batch():
    calls = []

    class Translator:
        min_confidence = 0.3

        def translate_queries(self, queries):
            calls.append(list(queries))
            return [SimpleNamespace(clip_prompt=f"p {q}", confidence=0.9) for q in queries]

    class Index:
        def search_vectors(self, qvecs, top_k):
            return [[] for _ in qvecs]

    class Embedder:
        def encode_text(self, prompts):
            assert prompts == ["p a", "p b", "p c"]
            return [0, 1, 2]

    system = SimpleNamespace(translator=Translator(), index=Index(), embedder=Embedder())
    batcher = QueryBatcher(system)
    batch = [_Pending(query=q, top_k=5) for q in "abc"]
    batcher._run_batch(batch)
    assert calls == [["a", "b", "c"]] and all(p.done.is_set() for p in batch)


def test_facade_attaches_the_local_backend(tmp_path):
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    def system(**local):
        cfg = Config(config_file=None, base_dir=str(tmp_path))
        cfg.set("api.batching_max_batch", 8)         # the backend's rows a call
        for k, v in local.items():
            cfg.set(f"llm.local.{k}", v)
        return EnhancedRetrievalSystem(
            cfg, embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), device="cpu"), device="cpu")

    off = system()
    assert off.local_llm is None and off.translator.llm_batch_translate_fn is None
    on = system(enabled=True, model="tiny-test", max_new_tokens=4)
    assert on.local_llm.model.config == TINY and on.local_llm.cache.rows.shape[1] == 8
    assert on.local_llm.budget == 4
    res = on.translator.translate_queries(["con chó đang chạy", "a red car"])
    assert [r.method for r in res] == ["llm", "passthrough"]
    with pytest.raises(ValueError):
        system(enabled=True, model="deepseek-v3")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._grouped_mm runs on the card alone")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_lite_widths_decode_on_the_card(card):
    """Two layers at lite()'s widths (the dense layer and one MoE layer of
    64 experts 1,408 wide, 102,400 ids): 64 rows through prefill and three
    decode steps on the grouped products, against the float32 reference of
    the same bf16 weights (bf16 rounding of two layers: within 0.05 of the
    reference's spread)."""
    cfg = dataclasses.replace(ds.DeepseekV2Config.lite(), num_hidden_layers=2)
    hf = hf_dict(cfg)
    model = ds.DeepseekV2ForCausalLM(cfg, device="meta").to_empty(device=card)
    wds.load(model, hf, SEED)
    lt = local_llm.LocalTranslator(model, max_batch=64, max_query_tokens=48, max_new_tokens=4,
                                   stop_ids=())
    g = torch.Generator().manual_seed(11)
    rows = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g).tolist()
            for n in torch.randint(8, 49, (64,), generator=g)]
    launches = moe.grouped_mm.launches
    trace.take()
    trace.enable()
    try:
        gen = lt.generate(rows, [4] * 64)    # captures the decode step of 64 rows first
    finally:
        trace.disable()
    spans = {s.name: s for s in trace.take()}
    first = moe.grouped_mm.launches - launches
    again = lt.generate(rows, [4] * 64)
    # gate_up and down of one MoE layer from the host for the prefill alone:
    # the three steps replay the captured graph
    assert moe.grouped_mm.launches - launches - first == 2
    assert again.tokens == gen.tokens
    # a decode step reads nothing back to the host (made ready first: the
    # uploads themselves wait on the card)
    tok = torch.zeros(64, dtype=torch.long, device=card)
    slot = torch.tensor([len(r) + 3 for r in rows], device=card)
    hits = torch.zeros((), dtype=torch.int64, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode(tok, slot, lt.cache, hits)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = spans["llm.generate"].counts
    assert counts["llm.steps"] == 3 and counts["llm.decode_tokens"] == 64 * 3
    # 64 rows x 6 pairs a step leave few of 64 experts idle: every pass
    # touches nearly all of them
    assert 4 * 56 <= counts["moe.experts_hit"] == gen.experts_hit <= 4 * 64
    assert {"llm.prefill", "llm.decode", "llm.generate"} <= set(spans)
    del lt, model
    torch.cuda.empty_cache()
    outer = {k: v.float() for k, v in wds.outer(hf, SEED, card).items()}
    pick = [0, 17, 42, 63]
    prefix = local_llm.SimpleTokenizer(vocab_size=cfg.vocab_size).encode(local_llm.TEMPLATE)[:-1]
    seqs = [torch.tensor(prefix + rows[b] + gen.tokens[b][:-1]) for b in pick]
    at = [torch.arange(len(prefix) + len(rows[b]) - 1, len(prefix) + len(rows[b]) + 3) for b in pick]
    want = ref.logits_at(hf, seqs, at,
                         lambda i: {k: v.float() for k, v in wds.layer(hf, SEED, i, card).items()},
                         outer)
    nums = ref.generation_numbers([(gen.tokens[b], gen.logits[b], gen.lse[b]) for b in pick], want)
    assert max(nums.values()) < 0.05, nums


def _served_translator(device, tmp_path, model, max_new_tokens):
    """A facade over 4,096 seeded rows (tiny CLIP towers) with the local
    translator on (``llm.local.*``) and the batcher in front of it."""
    import numpy as np

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench.data import MemoryContainer
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    rows = np.random.default_rng(0).standard_normal((4096, 32), dtype=np.float32)
    bits = torch.from_numpy(rows).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    local = {"enabled": True, "model": model, "max_new_tokens": max_new_tokens}
    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=tmp_path,
               overrides={"llm": {"local": local}, "logging": {"file": False}}),
        embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), device=device), device=device)
    index = UnifiedIndex(system._index_config(), device=device)
    index.attach_container(MemoryContainer(bits))
    system.attach_index(index)
    return system


def _batched_searches(system, queries):
    """The queries through one ``QueryBatcher`` at once; the backend's
    calls (rows each) and the answers."""
    import threading

    calls = []
    generate = system.local_llm.generate

    def counted(rows, *args, **kwargs):
        calls.append(len(rows))
        return generate(rows, *args, **kwargs)

    system.local_llm.generate = counted
    batcher = QueryBatcher(system, window_ms=200.0)
    batcher.start()
    answers = [None] * len(queries)

    def one(i):
        answers[i] = batcher.search(queries[i], top_k=5, timeout_s=600.0)

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.stop()
    return calls, answers


def test_facade_and_batcher_on_the_local_translator(tmp_path):
    system = _served_translator("cpu", tmp_path, "tiny-test", 4)
    queries = QUERIES + ["a red car"]
    calls, answers = _batched_searches(system, queries)
    assert sum(calls) == 4          # the four Vietnamese queries, each sent once
    assert all(len(a) == 5 for a in answers)
    methods = [system.translator.translate_query(q).method for q in queries]   # cached now
    assert methods == ["llm"] * 4 + ["passthrough"]


@pytest.mark.cuda
def test_facade_and_batcher_at_published_widths_on_the_card(card, tmp_path):
    """``llm.local`` on with DeepSeek-V2-Lite whole (27 layers, 64 + 2
    experts, 102,400 ids) behind the facade's translator and the batcher:
    eight Vietnamese queries at once, one generation call each batch."""
    system = _served_translator(card, tmp_path, "deepseek-v2-lite", 8)
    cfg = system.local_llm.model.config
    assert cfg == ds.DeepseekV2Config.lite()
    assert system.local_llm.cache.prefix.shape[-1] == 576
    queries = [f"{q} số {i}" for i, q in enumerate(QUERIES * 2)]
    calls, answers = _batched_searches(system, queries)
    assert sum(calls) == 8 and all(len(a) == 5 for a in answers)
    assert all(system.translator.translate_query(q).method == "llm" for q in queries)
