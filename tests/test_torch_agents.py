"""The port's agent layer (``agents/*``, copies of the JAX package's) over the
port's facade, and the facade's ``enable_llm`` hooks, against the JAX
package's, on the CPU. No network: every provider is a scripted
``complete_fn``.

One tiny corpus: five seeded JPEG keyframes indexed by the JAX facade
(``CLIPConfig.tiny_test()``, f32, 32-px thumbnails); the port's facade gets
the JAX tower weights through ``models.convert.from_jax_params`` and opens
the same ``.rvdb``.

- Twins of the JAX package's ``tests/test_agents.py``, on the port's facade.
- Parity: the same scripted provider through both facades. Tool calls,
  ``method``, the response text and ``search_results`` agree (hits under
  the f32 rule: tie-aware, atol 5e-4); ``llm_enhanced`` with a scripted
  ``expand_query`` equals the JAX facade's and the merge of its variants'
  exact references.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from intelligent_video_analysis_retrieval_system_tpu.models.clip import (
    CLIPConfig as JaxCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    SearchOptions as JaxOptions,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config as JaxConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.agents import (
    AgentManager,
    LLMConfig,
    LLMProcessor,
    get_agent_tools,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.agents.tools import to_openai_tools
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
    from_jax_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import topk_exact_reference
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
    SearchOptions,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
    ATOL_TOPK,
    tie_aware_equal,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

torch.set_num_threads(2)

OVERRIDES = {"index": {"dtype": "float32", "thumbnail_size": 32}, "logging": {"file": False}}


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """(JAX facade, port facade) over one JAX-built index of five frames."""
    root = tmp_path_factory.mktemp("agents")
    rng = np.random.default_rng(4)
    folder = root / "keyframes" / "vid0"
    folder.mkdir(parents=True)
    for n in range(5):
        arr = rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)
        Image.fromarray(arr).save(folder / f"{n}.jpg", quality=95)
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), compute_dtype="float32")
    jsys = JaxSystem(JaxConfig(config_file=None, base_dir=root / "jax", create_dirs=True,
                               overrides=OVERRIDES), embedder=jemb)
    index_path = jsys.build_system(root / "keyframes")["index_path"]
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="float32", device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    tsys = EnhancedRetrievalSystem(Config(config_file=None, base_dir=root / "port",
                                          create_dirs=True, overrides=OVERRIDES),
                                   embedder=temb, device="cpu")
    tsys.load_system(index_path)
    yield jsys, tsys
    jsys.cleanup()
    tsys.cleanup()


@pytest.fixture(scope="module")
def agent_system(systems):
    return systems[1]


def make_fake_provider(script):
    """A complete_fn replaying scripted replies; records all message lists."""
    calls = []

    def complete(messages, tools=None):
        calls.append({"messages": messages, "tools": tools})
        return script[min(len(calls) - 1, len(script) - 1)]

    complete.calls = calls
    return complete


def same_hits(want: list[dict], got: list[dict]) -> None:
    assert len(got) == len(want)
    assert [set(h) for h in got] == [set(h) for h in want]
    if not want:
        return
    key = {k: i for i, k in enumerate(sorted({(h["folder"], h["image"]) for h in want + got}))}
    tie_aware_equal([key[h["folder"], h["image"]] for h in got],
                    [h["similarity_score"] for h in got],
                    [key[h["folder"], h["image"]] for h in want],
                    [h["similarity_score"] for h in want], atol=ATOL_TOPK)


# -- twins of TestTools ---------------------------------------------------------------------


def test_tool_registry(agent_system):
    tools = get_agent_tools(agent_system)
    assert {t.name for t in tools} == {"search_keyframes", "analyze_keyframes",
                                       "get_system_status", "chat_about_frames"}
    oa = to_openai_tools(tools)
    assert oa[0]["type"] == "function"
    assert "parameters" in oa[0]["function"]


def test_search_tool(agent_system):
    tools = {t.name: t for t in get_agent_tools(agent_system)}
    out = tools["search_keyframes"](query="a scene", limit=3)
    assert out["count"] == 3
    assert out["results"][0]["similarity_score"] > -1


def test_search_tool_coerces_bad_limit(agent_system):
    tools = {t.name: t for t in get_agent_tools(agent_system)}
    out = tools["search_keyframes"](query="x", limit="not a number")
    assert out["count"] <= 10
    out = tools["search_keyframes"](query="x", limit=99999)
    assert out["count"] <= 50


def test_analyze_tool(agent_system):
    tools = {t.name: t for t in get_agent_tools(agent_system)}
    out = tools["analyze_keyframes"](folder="vid0", image="2.jpg")
    assert out["frame_id"] == 2
    assert "1.jpg" in out["temporal_neighbors"]
    out = tools["analyze_keyframes"](folder="vid0", image="nope.jpg")
    assert "error" in out


def test_status_tool(agent_system):
    tools = {t.name: t for t in get_agent_tools(agent_system)}
    out = tools["get_system_status"]()
    assert out["index_frames"] == 5 and out["remote_indexes"] == 0


def test_invoke_json_tolerant(agent_system):
    tools = {t.name: t for t in get_agent_tools(agent_system)}
    out = json.loads(tools["search_keyframes"].invoke_json('{"query": "cat", "limit": 2}'))
    assert out["count"] == 2
    out = json.loads(tools["search_keyframes"].invoke_json("a dog"))
    assert out["query"] == "a dog"
    out = json.loads(tools["analyze_keyframes"].invoke_json('{"x": 1}'))
    assert "error" in out


# -- twins of TestLLMProcessor --------------------------------------------------------------------


def test_no_provider_falls_back_to_search(agent_system, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    proc = LLMProcessor(agent_system, complete_fn=None)
    assert not proc.available
    out = proc.chat_with_user("find a dark scene")
    assert out["method"] == "search"


def test_tool_call_loop(agent_system):
    provider = make_fake_provider([
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "search_keyframes",
             "arguments": '{"query": "a scene", "limit": 2}'}]},
        {"content": "I found 2 matching frames.", "tool_calls": None},
    ])
    proc = LLMProcessor(agent_system, complete_fn=provider)
    out = proc.chat_with_user("what scenes are there?")
    assert out["method"] == "agent"
    assert out["tool_calls"] == ["search_keyframes"]
    assert len(out["search_results"]) == 2
    roles = [m["role"] for m in provider.calls[1]["messages"]]
    assert "tool" in roles


def test_unknown_tool_handled(agent_system):
    provider = make_fake_provider([
        {"content": None, "tool_calls": [{"id": "c1", "name": "not_a_tool", "arguments": "{}"}]},
        {"content": "ok", "tool_calls": None},
    ])
    out = LLMProcessor(agent_system, complete_fn=provider).chat_with_user("hi")
    assert out["method"] == "agent"


def test_tool_round_limit(agent_system):
    looping = {"content": None, "tool_calls": [
        {"id": "c", "name": "get_system_status", "arguments": "{}"}]}
    proc = LLMProcessor(agent_system, complete_fn=make_fake_provider([looping]),
                        config=LLMConfig(max_tool_rounds=2))
    out = proc.chat_with_user("loop forever")
    assert out["method"] == "agent_truncated"
    assert len(out["tool_calls"]) == 2


def test_provider_crash_degrades(agent_system):
    def boom(messages, tools=None):
        raise RuntimeError("provider down")

    out = LLMProcessor(agent_system, complete_fn=boom).chat_with_user("anything")
    assert out["method"] == "search"


def test_timeout_degrades(agent_system):
    def slow(messages, tools=None):
        time.sleep(2.0)
        return {"content": "late", "tool_calls": None}

    proc = LLMProcessor(agent_system, complete_fn=slow,
                        config=LLMConfig(timeout_base_s=0.2, timeout_per_image_s=0.0))
    assert proc.chat_with_user("slow")["method"] == "search"


def test_frames_attached_as_images(agent_system):
    provider = make_fake_provider([{"content": "nice frames", "tool_calls": None}])
    proc = LLMProcessor(agent_system, complete_fn=provider)
    out = proc.chat_with_user("describe these", [{"folder": "vid0", "image": "1.jpg"}])
    assert out["method"] == "agent"
    parts = provider.calls[0]["messages"][-1]["content"]
    assert isinstance(parts, list)
    assert any(p.get("type") == "image_url" for p in parts)
    assert parts[1]["image_url"]["url"].startswith("data:image/jpeg;base64,")


def test_session_clearing(agent_system):
    provider = make_fake_provider([{"content": "ok", "tool_calls": None}])
    proc = LLMProcessor(agent_system, complete_fn=provider,
                        config=LLMConfig(session_clear_every=2))
    proc.chat_with_user("one")
    assert proc._history
    proc.chat_with_user("two")
    proc.chat_with_user("three")
    assert len(proc._history) <= 4


def test_expand_query(agent_system, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert LLMProcessor(agent_system, complete_fn=None).expand_query("cat") == ["cat"]
    provider = make_fake_provider([
        {"content": "a photo of a cat\na cat sitting", "tool_calls": None}])
    out = LLMProcessor(agent_system, complete_fn=provider).expand_query("cat")
    assert out[0] == "cat" and len(out) == 3


def test_explain_and_rank_shims(agent_system):
    proc = LLMProcessor(agent_system, complete_fn=None)
    results = [{"folder": "v", "image": "1.jpg", "similarity_score": 0.4}]
    assert proc.rank_results("q", results) == results
    assert "v/1.jpg" in proc.explain_results("q", results)
    assert "No keyframes" in proc.explain_results("q", [])


def test_facade_enable_llm(agent_system):
    provider = make_fake_provider([{"content": "hello from agent", "tool_calls": None}])
    proc = agent_system.enable_llm(complete_fn=provider)
    try:
        assert agent_system.llm_processor is proc
        assert agent_system.chat("tell me about the videos")["response"] == "hello from agent"
    finally:
        agent_system.llm_processor = None


# -- twins of TestLLMErrorPaths ---------------------------------------------------------------


def test_malformed_arguments_json_full_loop(agent_system):
    provider = make_fake_provider([
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "search_keyframes",
             "arguments": '{"query": "a scene", "limit": NOT_JSON}'}]},
        {"content": "done", "tool_calls": None},
    ])
    out = LLMProcessor(agent_system, complete_fn=provider).chat_with_user("find scenes")
    assert out["method"] == "agent"
    assert out["tool_calls"] == ["search_keyframes"]
    tool_msgs = [m for m in provider.calls[1]["messages"] if m["role"] == "tool"]
    assert tool_msgs and json.loads(tool_msgs[0]["content"]) is not None


def test_arguments_wrong_types_returns_error_payload(agent_system):
    provider = make_fake_provider([
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "search_keyframes",
             "arguments": json.dumps({"bogus_kwarg": 1})}]},
        {"content": "ok", "tool_calls": None},
    ])
    out = LLMProcessor(agent_system, complete_fn=provider).chat_with_user("hi")
    assert out["method"] == "agent"
    tool_msgs = [m for m in provider.calls[1]["messages"] if m["role"] == "tool"]
    assert "error" in json.loads(tool_msgs[0]["content"])


def test_tool_raising_mid_loop_continues(agent_system, monkeypatch):
    proc = LLMProcessor(agent_system, complete_fn=make_fake_provider([
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "get_system_status", "arguments": "{}"}]},
        {"content": "recovered", "tool_calls": None},
    ]))

    def boom(**kwargs):
        raise RuntimeError("index exploded")

    monkeypatch.setattr(proc._tools_by_name["get_system_status"], "fn", boom)
    out = proc.chat_with_user("status?")
    assert out["method"] == "agent"
    assert out["response"] == "recovered"


def test_timeout_mid_tool_degrades(agent_system, monkeypatch):
    def provider(messages, tools=None):
        if tools is not None:  # agent pass: request the slow tool
            return {"content": None, "tool_calls": [
                {"id": "c1", "name": "get_system_status", "arguments": "{}"}]}
        return {"content": "toolless answer", "tool_calls": None}

    def slow_tool(**kwargs):
        time.sleep(5.0)
        return {"status": "late"}

    proc = LLMProcessor(agent_system, complete_fn=provider,
                        config=LLMConfig(timeout_base_s=0.3, timeout_per_image_s=0.0))
    monkeypatch.setattr(proc._tools_by_name["get_system_status"], "fn", slow_tool)
    out = proc.chat_with_user("status?")
    assert out["method"] == "toolless"
    assert out["response"] == "toolless answer"


def test_provider_returns_garbage_shape(agent_system):
    proc = LLMProcessor(agent_system, complete_fn=make_fake_provider([{"unexpected": "shape"}]))
    out = proc.chat_with_user("hello")
    assert "response" in out and out["method"] in ("agent", "toolless")


def test_tool_call_missing_name_key_degrades(agent_system):
    proc = LLMProcessor(agent_system, complete_fn=make_fake_provider([
        {"content": None, "tool_calls": [{"id": "c1"}]},
        {"content": "fallback ok", "tool_calls": None},
    ]))
    assert proc.chat_with_user("hello")["method"] in ("toolless", "search")


def test_session_clear_boundary_drops_history(agent_system):
    provider = make_fake_provider([{"content": "a", "tool_calls": None}])
    proc = LLMProcessor(agent_system, complete_fn=provider,
                        config=LLMConfig(session_clear_every=2, history_turns=4))
    proc.chat_with_user("turn one")
    proc.chat_with_user("turn two")
    msgs = provider.calls[-1]["messages"]
    assert [m["role"] for m in msgs] == ["system", "user"]
    assert msgs[-1]["content"] == "turn two"
    proc.chat_with_user("turn three")
    user_texts = [m["content"] for m in provider.calls[-1]["messages"] if m["role"] == "user"]
    assert "turn one" not in user_texts


# -- twins of TestVisionAnalysis ---------------------------------------------------------------


def test_offline_metadata_fallback(agent_system):
    out = LLMProcessor(agent_system, complete_fn=None).analyze_frames_vision(
        [{"folder": "vid0", "image": "1.jpg"}])
    assert out["method"] == "metadata_fallback"
    assert "frame 1" in out["frames"][0]["description"]


def test_structured_vision(agent_system):
    reply = {"content": json.dumps({
        "frames": [{"name": "vid0/1.jpg", "description": "a colorful test pattern",
                    "objects": ["noise"], "scene": "synthetic"}],
        "summary": "one synthetic frame"}), "tool_calls": None}
    provider = make_fake_provider([reply])
    out = LLMProcessor(agent_system, complete_fn=provider).analyze_frames_vision(
        [{"folder": "vid0", "image": "1.jpg"}], question="what is shown?")
    assert out["method"] == "vision_structured"
    assert out["frames"][0]["objects"] == ["noise"]
    content = provider.calls[0]["messages"][-1]["content"]
    assert any(p.get("type") == "image_url" for p in content)


def test_unparseable_reply_degrades(agent_system):
    provider = make_fake_provider([{"content": "it is a picture of things",
                                    "tool_calls": None}])
    out = LLMProcessor(agent_system, complete_fn=provider).analyze_frames_vision(
        [{"folder": "vid0", "image": "1.jpg"}])
    assert out["method"] == "vision_unstructured"
    assert "picture" in out["summary"]


# -- twins of TestAgentManager -----------------------------------------------------------------


def test_create_agent_with_tool_subset(agent_system, tmp_path, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    mgr = AgentManager(agent_system, db_path=tmp_path / "agents.db")
    agent = mgr.create_agent("searcher", description="finds frames",
                             tool_names=["search_keyframes"])
    assert [t.name for t in agent.processor.tools] == ["search_keyframes"]
    listed = mgr.list_agents()
    assert listed[0]["name"] == "searcher"
    assert not listed[0]["online"]


def test_agent_run_persists_sessions(agent_system, tmp_path, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    mgr = AgentManager(agent_system, db_path=tmp_path / "agents.db")
    agent = mgr.create_agent("helper")
    out = agent.run("find a scene", session_id="s1")
    assert out["method"] == "search"
    history = mgr.store.history("s1")
    assert history[0]["role"] == "user" and history[1]["role"] == "assistant"
    assert mgr.store.sessions() == ["s1"]
    mgr.store.clear("s1")
    assert mgr.store.sessions() == []


def test_system_prompt_persona_wrapped(agent_system):
    provider = make_fake_provider([{"content": "persona reply", "tool_calls": None}])
    mgr = AgentManager(agent_system, complete_fn=provider)
    agent = mgr.create_agent("vn", system_prompt="Answer in Vietnamese.")
    assert agent.run("hello there friend")["response"] == "persona reply"
    assert provider.calls[0]["messages"][0]["content"].startswith("Answer in Vietnamese.")


def test_sequential_team_chains_answers(agent_system):
    provider = make_fake_provider([{"content": "first answer", "tool_calls": None}])
    mgr = AgentManager(agent_system, complete_fn=provider)
    mgr.create_agent("a")
    mgr.create_agent("b")
    out = mgr.create_team("duo", ["a", "b"]).run("analyze the videos")
    assert len(out["responses"]) == 2
    assert "first answer" in str(provider.calls[1]["messages"][-1]["content"])


def test_parallel_team(agent_system, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    mgr = AgentManager(agent_system)
    mgr.create_agent("x")
    mgr.create_agent("y")
    out = mgr.create_team("pair", ["x", "y"], mode="parallel").run("find scenes")
    assert {r["agent"] for r in out["responses"]} == {"x", "y"}
    assert mgr.get_stats()["total_runs"] == 2


def test_team_validation(agent_system):
    mgr = AgentManager(agent_system)
    with pytest.raises(KeyError):
        mgr.create_team("ghost", ["nope"])
    mgr.create_agent("a")
    with pytest.raises(ValueError):
        mgr.create_team("bad", ["a"], mode="circular")


# -- parity with the JAX facade -----------------------------------------------------------------

SCRIPTS = {
    "search_then_answer": [
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "search_keyframes",
             "arguments": '{"query": "a colorful scene", "limit": 3, "mode": "clip_only"}'}]},
        {"content": "Three frames match.", "tool_calls": None}],
    "two_tools": [
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "get_system_status", "arguments": "{}"},
            {"id": "c2", "name": "search_keyframes",
             "arguments": {"query": "a dark room", "limit": 5, "mode": "hybrid"}}]},
        {"content": None, "tool_calls": [
            {"id": "c3", "name": "analyze_keyframes",
             "arguments": '{"folder": "vid0", "image": "3.jpg"}'}]},
        {"content": "Frame 3 stands out.", "tool_calls": None}],
    "llm_enhanced_tool": [
        {"content": None, "tool_calls": [
            {"id": "c1", "name": "search_keyframes",
             "arguments": '{"query": "sunset over the sea", "limit": 4, '
                          '"mode": "llm_enhanced"}'}]},
        {"content": "Done.", "tool_calls": None}],
    "toolless": [{"content": "Just text.", "tool_calls": None}],
    "truncated": [{"content": None, "tool_calls": [
        {"id": "c", "name": "search_keyframes", "arguments": '{"query": "loop"}'}]}],
}


def _provider(script: list[dict]):
    calls = []

    def complete(messages, tools=None):
        calls.append([m["role"] for m in messages])
        return json.loads(json.dumps(script[min(len(calls) - 1, len(script) - 1)]))

    complete.calls = calls
    return complete


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripted_chat_matches_the_jax_facade(systems, name):
    """The same scripted provider through ``chat`` of both facades: the same
    tool calls, method, response text, messages and search results."""
    outs = []
    for system in systems:
        provider = _provider(SCRIPTS[name])
        system.enable_llm(complete_fn=provider)
        try:
            out = system.chat("what is in the videos?",
                              [{"folder": "vid0", "image": "2.jpg"}])
        finally:
            system.llm_processor = None
        outs.append((out, provider.calls))
    (jout, jcalls), (tout, tcalls) = outs
    assert tcalls == jcalls
    assert set(tout) == set(jout)
    for key in ("method", "response", "tool_calls"):
        assert tout.get(key) == jout.get(key), key
    same_hits(jout["search_results"], tout["search_results"])
    if name == "search_then_answer":
        assert len(tout["search_results"]) == 3


def test_agent_search_results_equal_the_facades_search(agent_system):
    """The search tool's hits are ``system.search`` with the tool's options."""
    provider = _provider(SCRIPTS["search_then_answer"])
    agent_system.enable_llm(complete_fn=provider)
    try:
        out = agent_system.chat("find something colorful")
    finally:
        agent_system.llm_processor = None
    want = agent_system.search("a colorful scene", SearchOptions(mode="clip_only", limit=3))
    assert [(h["folder"], h["image"], round(h["similarity_score"], 4), h["frame_id"])
            for h in want] == [(h["folder"], h["image"], h["similarity_score"], h["frame_id"])
                               for h in out["search_results"]]


def _exact_merge(system, variants: list[str], limit: int) -> tuple[list, np.ndarray]:
    """The max-merge of each variant's exact top-k over the index's rows."""
    index = system.index
    qv = system.embedder.encode_text(variants)
    qv = qv / np.linalg.norm(qv, axis=1, keepdims=True)
    ref = topk_exact_reference(index._dev_x[:index.ntotal],
                               torch.from_numpy(qv.astype(np.float32)), limit)
    best: dict[int, float] = {}
    for ids, scores in zip(ref.indices.numpy(), ref.scores.numpy()):
        for i, s in zip(ids, scores):
            best[int(i)] = max(best.get(int(i), -np.inf), float(s))
    rows = sorted(best, key=lambda i: -best[i])[:limit]
    return rows, np.array([best[i] for i in rows])


@pytest.mark.parametrize("script", [
    "a photo of a cat\na cat sitting on a sofa\nan orange cat",
    "one variant only",
    "",                                       # no lines: the query alone
])
def test_llm_enhanced_with_scripted_expansion_matches_jax(systems, script):
    """``llm_enhanced`` with an attached processor: the query and up to 3
    expansions, max-merged; equal to the JAX facade and to the merge of the
    variants' exact references."""
    jsys, tsys = systems
    outs = []
    for system, opts in ((jsys, JaxOptions), (tsys, SearchOptions)):
        system.enable_llm(complete_fn=_provider([{"content": script, "tool_calls": None}]))
        try:
            variants = system.llm_processor.expand_query("cats")
            outs.append(system.search("cats", opts(mode="llm_enhanced", limit=4,
                                                   use_cache=False)))
        finally:
            system.llm_processor = None
    assert variants == (["cats"] + [ln for ln in script.splitlines() if ln])[:4]
    same_hits(outs[0], outs[1])
    rows, scores = _exact_merge(tsys, variants, 4)
    tie_aware_equal([tsys.index.row_for(h["folder"], h["image"]) for h in outs[1]],
                    [h["similarity_score"] for h in outs[1]], rows, scores, atol=ATOL_TOPK)


def test_enable_llm_reads_the_llm_config_keys(agent_system, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    saved = agent_system.config.section("llm")
    for key, value in (("llm.model", "local-model"), ("llm.timeout_base_s", 3.0),
                       ("llm.timeout_per_image_s", 1.0), ("llm.max_images", 2),
                       ("llm.session_clear_every", 7)):
        agent_system.config.set(key, value)
    try:
        proc = agent_system.enable_llm()
        assert (proc.config.model, proc.config.timeout_base_s, proc.config.timeout_per_image_s,
                proc.config.max_images, proc.config.session_clear_every) == \
            ("local-model", 3.0, 1.0, 2, 7)
        assert not proc.available               # no provider, no key: offline
        assert agent_system.chat("a colorful scene")["method"] == "search"
        # without a provider, llm_enhanced expands with the text analyzer
        assert proc.expand_query("cat") == ["cat"]
    finally:
        agent_system.llm_processor = None
        agent_system.config.set("llm", saved)


def test_a_processor_that_raises_falls_back_to_chat_search(agent_system):
    class Broken:
        def chat_with_user(self, message, frames=None):
            raise RuntimeError("agent down")

        def expand_query(self, query):
            raise RuntimeError("agent down")

    agent_system.llm_processor = Broken()
    try:
        assert agent_system.chat("a colorful scene")["method"] == "search"
        got = agent_system.search("a colorful scene",
                                  SearchOptions(mode="llm_enhanced", limit=3, use_cache=False))
        want = agent_system.search("a colorful scene",
                                   SearchOptions(mode="clip_only", limit=3, use_cache=False))
        assert [(h["folder"], h["image"]) for h in got] == \
            [(h["folder"], h["image"]) for h in want]
    finally:
        agent_system.llm_processor = None
