"""The query translator on DeepSeek-V2-Lite:
``UniversalQueryTranslator.translate_queries`` over the program's local
backend (``system/local_llm.py``), closed loop, one client.

Set-up builds the model at the configuration's widths on the card, loads
the seeded weights a layer at a time (``perfbench/weights_deepseek_v2.py``),
builds the backend (which prefills the instruction prefix once) and the
translator, makes every call's queries from the seed, and warms the path.
A call sends ``queries_per_call`` distinct Vietnamese queries, made from
the translator's own Vietnamese phrases so that each is detected as
Vietnamese, of ``query_tokens`` prompt tokens each (words and the end
token), with a budget of ``new_tokens`` greedy tokens each and no stop
ids; no query repeats, so the translator's cache never answers. The rate
is the queries translated over the time from the window's start to the
last call's end.

After the window the program is freed. For ``check_sample`` rows of the
window, drawn from the seed, the float32 reference
(``reference/deepseek_v2.py``) runs the full sequence (prefix, query and
the generated tokens), one layer's weights at a time, and every generated
position is compared (``reference.deepseek_v2.generation_numbers``):
``logit_gap`` and ``lse_gap`` (the program's logit of its token and its
log-sum-exp against the reference's, over the reference row's spread, the
mean over a row's positions, the largest of the rows) and ``token_shortfall`` (how far below the
reference's best logit the program's greedy token lies, over the spread,
the largest); the largest logit gap goes into the notes. The prompt ids are the
reference tokenizer's (``reference/tokenizer.py``) of the program's
template and of each query; the program's are held to them.

With ``--trace 1`` the program's spans and counters are recorded over the
traced slice alone (``records["program_spans"]``), with
``records["prefix_tokens"]``, the prefix's length.

The control (:func:`control`) puts the reference with float8 (e4m3)
products in the program's place: each position's greedy token, logit and
log-sum-exp of the float8 pass against the float32 pass.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights_deepseek_v2
from ..reference import deepseek_v2 as ref_dsv2
from ..reference import tokenizer as ref_tok
from . import common
from .encode_siglip import _program_trace, _recording, _spans

CONTEXT = 4096


def row_tokens(text: str, vocab: int) -> list[int]:
    """The reference tokenizer's ids of a query as a prompt row: its
    words, then the end token."""
    ids, pos = ref_tok.tokenize([text], vocab, CONTEXT)
    return ids[0, 1:pos[0] + 1].tolist()


def prefix_tokens(text: str, vocab: int) -> list[int]:
    """The start token and the template's words."""
    ids, pos = ref_tok.tokenize([text], vocab, CONTEXT)
    return ids[0, :pos[0]].tolist()


def make_calls(tr, vocab: int, seed: int, calls: int, salt: int) -> tuple[list[list[str]], dict[str, int]]:
    """``calls`` lists of ``queries_per_call`` distinct Vietnamese queries,
    none repeated across calls, and each query's budget."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.translator import (
        _VI_EN, UniversalQueryTranslator)

    phrases = sorted(_VI_EN)
    lo, hi = tr["query_tokens"]
    new_lo, new_hi = tr["new_tokens"]
    rng = np.random.default_rng([seed & ((1 << 63) - 1), salt])
    seen: set[str] = set()
    out, budgets = [], {}
    for _ in range(calls):
        batch = []
        while len(batch) < int(tr["queries_per_call"]):
            n = int(rng.integers(lo, hi + 1)) - 1              # words; the end token is the last
            words: list[str] = []
            while len(words) < n:
                words += phrases[int(rng.integers(len(phrases)))].split()
            text = " ".join(words[:n])
            if (text in seen or len(row_tokens(text, vocab)) != n + 1
                    or UniversalQueryTranslator.detect_language(text)[0] != "vi"):
                continue
            seen.add(text)
            batch.append(text)
            budgets[text] = int(rng.integers(new_lo, new_hi + 1))
        out.append(batch)
    return out, budgets


def model_of(ctx: common.Context):
    """The program's model at the configuration's widths on the device,
    handed the seeded weights a layer at a time."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.deepseek_v2 import (
        DeepseekV2Config, DeepseekV2ForCausalLM)

    model = DeepseekV2ForCausalLM(DeepseekV2Config.from_hf(ctx.config), device="meta")
    model = model.to_empty(device=ctx.device)
    weights_deepseek_v2.load(model, ctx.config, ctx.seed)
    return model


def backend_of(ctx: common.Context, model, budgets: dict[str, int]):
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.local_llm import (
        LocalTranslator)

    tr = ctx.traffic
    return LocalTranslator(model, max_batch=int(tr["queries_per_call"]),
                           max_query_tokens=int(tr["query_tokens"][1]),
                           max_new_tokens=int(tr["new_tokens"][1]), budget=budgets.__getitem__,
                           stop_ids=())


def reference_numbers(ctx: common.Context, rows: list[tuple[list[int], list[int], list[float],
                                                             list[float]]],
                      dense=ref_dsv2.dense_f32, own_choice: bool = False) -> dict[str, float]:
    """The comparison over ``rows`` of (prompt ids, generated ids, logits,
    log-sum-exps): the reference runs each full sequence, one layer's
    float32 weights at a time. With ``own_choice`` the ``dense`` pass
    stands in for the program: its own greedy tokens, logits and
    log-sum-exps at the same positions are compared with the float32 pass."""
    cfg, dev = ctx.config, ctx.device
    seqs = [torch.tensor(p + g[:-1]) for p, g, _, _ in rows]
    at = [torch.arange(len(p) - 1, len(p) - 1 + len(g)) for p, g, _, _ in rows]
    outer = {k: v.float() for k, v in weights_deepseek_v2.outer(cfg, ctx.seed, dev).items()}

    def params(i: int) -> dict:
        return {k: v.float() for k, v in weights_deepseek_v2.layer(cfg, ctx.seed, i, dev).items()}

    ref = ref_dsv2.logits_at(cfg, seqs, at, params, outer)
    if own_choice:
        low = ref_dsv2.logits_at(cfg, seqs, at, params, outer, dense=dense)
        rows = [(p, lg.argmax(-1).tolist(), lg.max(-1).values.tolist(),
                 torch.logsumexp(lg, -1).tolist()) for (p, _, _, _), lg in zip(rows, low)]
    del outer
    return ref_dsv2.generation_numbers([(g, lo, ls) for _, g, lo, ls in rows], ref)


def run(ctx: common.Context) -> common.Outcome:
    from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.translator import (
        UniversalQueryTranslator)
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.local_llm import TEMPLATE

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    vocab = cfg["vocab_size"]
    per_call = int(tr["queries_per_call"])
    pool, budgets = make_calls(tr, vocab, ctx.seed, int(tr["pool_calls"]), salt=1)
    warm, warm_budgets = make_calls(tr, vocab, ctx.seed, int(tr["warm_calls"]), salt=2)
    budgets.update(warm_budgets)
    ctx.log(f"{len(pool)} calls of {per_call} queries made")
    model = model_of(ctx)
    ctx.log("model loaded")
    backend = backend_of(ctx, model, budgets)
    translator = UniversalQueryTranslator(llm_batch_translate_fn=backend.translate)
    ctx.log(f"backend loaded, prefix of {len(backend.prefix_ids)} tokens")
    gens: list = []
    generate = backend.generate

    def kept(*args, **kwargs):
        g = generate(*args, **kwargs)
        gens.append(g)
        return g

    backend.generate = kept
    unwrap = ctx.tracer.wrap(translator, "translate_queries", "translate_queries")
    for batch in warm:
        translator.translate_queries(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del gens[:]
    ctx.log("warmed")
    program = _program_trace() if ctx.trace else None
    ctx.setup_done()
    outs: list = []
    ends: list[float] = []
    start, length = ctx.slice_bounds()

    def call() -> None:
        if len(outs) == len(pool):
            raise RuntimeError(f"the window outran its {len(pool)} calls: raise pool_calls")
        outs.append(translator.translate_queries(pool[len(outs)]))
        ends.append(time.perf_counter())

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and not ctx.tracer.taken and time.perf_counter() - t0 >= start:
            with ctx.tracer.slice(), _recording(program):
                s0 = time.perf_counter()
                while time.perf_counter() - s0 < length:
                    call()
            continue
        call()
    window_s = ends[-1] - t0
    unwrap()
    memory = common.peak_bytes(dev)
    prefix_ids = list(backend.prefix_ids)
    del translator, backend, model, generate, kept
    common.free_device()

    calls = len(outs)
    bad = sum(1 for res in outs for r in res if r.method != "llm")
    pick = common.sample(calls * per_call, int(tr["check_sample"]), ctx.seed)
    want_prefix = prefix_tokens(TEMPLATE, vocab)
    rows = []
    for c, b in zip(pick // per_call, pick % per_call):
        g = gens[c]
        want = want_prefix + row_tokens(pool[c][b], vocab)
        prompt = prefix_ids + g.prompts[b]
        rows.append((want, g.tokens[b], g.logits[b] if prompt == want else [float("inf")] * len(g.tokens[b]),
                     g.lse[b]))
    numbers = reference_numbers(ctx, rows)
    common.free_device()
    return common.Outcome(
        attempted=calls * per_call, failed=bad,
        end_to_end={"queries_per_s": calls * per_call / window_s},
        numbers=numbers,
        records={"calls": calls, "window_s": window_s, "t0": t0, "call_ends": ends,
                 "program_spans": _spans(program), "prefix_tokens": len(prefix_ids)},
        notes=[f"window {window_s:.3f} s, {calls} calls of {per_call} queries, "
               f"{len(pick)} rows compared ({sum(len(r[1]) for r in rows)} positions), "
               f"largest logit gap {numbers['logit_gap_max']:.6f}"],
        memory_peak_bytes=memory)


def control(ctx: common.Context) -> dict:
    """The program's numbers and the control's over ``check_sample`` rows of
    one call: the float32 reference with float8 (e4m3) products, each
    product's input scaled per token and its weight per output channel."""
    tr, vocab = ctx.traffic, ctx.config["vocab_size"]
    (batch,), budgets = make_calls(tr, vocab, ctx.seed, 1, salt=3)
    model = model_of(ctx)
    backend = backend_of(ctx, model, budgets)
    gen = backend.generate([backend.row_ids(q) for q in batch], [budgets[q] for q in batch])
    prefix = list(backend.prefix_ids)
    del backend, model
    common.free_device()
    pick = common.sample(len(batch), int(tr["check_sample"]), ctx.seed)
    rows = [(prefix + gen.prompts[b], gen.tokens[b], gen.logits[b], gen.lse[b]) for b in pick]
    program = reference_numbers(ctx, rows)
    low = reference_numbers(ctx, rows, dense=ref_dsv2.fp8_dense, own_choice=True)
    return {"program": {k: program[k] for k in tr["limits"]},
            "control": {k: low[k] for k in tr["limits"]}}
