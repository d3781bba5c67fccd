"""The local query translator: DeepSeek-V2-Lite on the card, with no egress.

The reference sent every non-English query to GPT-4o (7.23 s a search,
most of it that call). :class:`LocalTranslator` runs the translation model
in the process instead, for the batches the serving batcher gathers:

- the model (:mod:`..models.deepseek_v2`);
- the instruction template (:data:`TEMPLATE`, the port's own, after the
  reference's 7-section prompt), prefilled ONCE when the backend loads:
  its latent cache is shared by every row of every call;
- a latent cache for ``max_batch`` rows of up to ``max_query_tokens`` +
  ``max_new_tokens`` tokens each.

:meth:`LocalTranslator.generate` prefills each row's own tokens after the
shared prefix in one batched pass, then decodes greedily, one token for
every row a step, until each row's budget or stop id. A step has the same
shapes at every position (it attends over the whole of each row's cache,
the slots after its own masked), so on a card it is captured once per
number of rows as a CUDA graph and replayed: one launch a step in place of
~2,000. The tokens, their logits, the log-sum-exps and the experts touched
are read back once, after the last step.

A prompt is ``[SOT] + words(TEMPLATE)`` (the prefix), then a row's
``words(query) + [EOT]``, in ids of the tokenizer (the hash-bucket
fallback over the model's 102,400 ids while DeepSeek's ``tokenizer.json``
is not in the repository). Generated ids are rendered as text by
:func:`render_ids`, one syllable word an id, stop ids dropped.

Spans (:mod:`..trace`): ``llm.prefix`` (``tokens``) at load; ``llm.generate``
(``rows``, ``prompt_tokens`` and ``new_tokens``: the rows' real and
returned tokens) with the counters ``llm.prefill_tokens`` and
``llm.decode_tokens`` (tokens the card computes: the prefill's rows padded
to the longest, every row at every step), ``llm.steps`` and
``moe.experts_hit`` (distinct experts touched, summed over MoE layer
passes); inside it ``llm.prefill`` and ``llm.decode`` (``steps``).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import torch

from .. import trace
from ..models.deepseek_v2 import (DeepseekV2Config, DeepseekV2ForCausalLM, LatentCache,
                                  init_seeded)
from ..models.tokenizer import SimpleTokenizer

__all__ = ["Generation", "LocalTranslator", "TEMPLATE", "render_ids"]

TEMPLATE = """You are the query translator of a video keyframe search engine. Each
request holds one search query that a user typed, usually in Vietnamese, sometimes in another
language. Your answer is fed to a CLIP text encoder that ranks keyframes by how well they match
it, so the answer must be one short English caption of what the frames should show.

1. Role. You translate and rewrite; you never answer the query, ask a question back or explain
your choice. You write nothing but the caption.

2. Objects. Keep every visible object the query names: people, animals, vehicles, buildings,
signs, food, clothing and tools. Keep counts when they are given ("two dogs", "a crowd of
people") and drop counts that cannot be seen.

3. Scene and setting. Keep the place (street, market, beach, stage, studio, classroom,
hospital, countryside, river) and the time of day or the weather when the query gives them:
"at night", "in the rain", "at sunset", "in the morning".

4. Actions and relations. Keep what the people or animals are doing (running, talking,
eating, driving, dancing, holding, pointing) and where things are relative to each other (on
the table, next to the car, behind the man, in front of the building).

5. Attributes. Keep colours, sizes, materials, text written on signs and shirts, and
distinctive clothing such as the ao dai or the conical hat. Translate proper names of places
and events, and keep names of people as they are written.

6. Style. Write a caption of 5 to 25 English words in the present tense. Begin with the main
subject. Use plain visual words a photo caption would use. Do not use the words video, frame,
image, scene, clip or keyframe, do not add quotation marks, and do not end with a full stop.
If the query is already English, only clean it up.

7. Examples.
Query: người đàn ông mặc áo đỏ đang đi xe máy trên đường phố
Caption: a man in a red shirt riding a motorbike on a city street
Query: hai đứa trẻ đang chơi bóng đá trên bãi biển lúc hoàng hôn
Caption: two children playing football on a beach at sunset
Query: phát thanh viên nữ đang đọc tin tức trong trường quay
Caption: a female news anchor reading the news in a studio
Query: đám đông người đang xem pháo hoa trong lễ hội ban đêm
Caption: a crowd of people watching fireworks at a night festival
Query: cô gái mặc áo dài trắng đội nón lá đi bên bờ sông
Caption: a girl in a white ao dai and a conical hat walking along a river bank
Query: xe buýt màu vàng dừng trước trường học vào buổi sáng
Caption: a yellow bus stopped in front of a school in the morning
Query: bác sĩ đang nói chuyện với bệnh nhân trong bệnh viện
Caption: a doctor talking with a patient in a hospital room
Query: con chó nhỏ màu đen đang chạy trên cánh đồng xanh
Caption: a small black dog running across a green field
Query: người bán hàng đang xếp trái cây ở chợ nổi
Caption: a vendor arranging fruit at a floating market
Query: cảnh sát giao thông đứng giữa ngã tư trong mưa
Caption: a traffic police officer standing in the middle of an intersection in the rain
Query: một chiếc thuyền nhỏ trên hồ với núi phía sau
Caption: a small boat on a lake with mountains behind it
Query: ca sĩ đang hát trên sân khấu lớn với đèn màu xanh
Caption: a singer performing on a large stage under blue lights

Now translate the next query. Answer with the caption alone.
Query:"""


@dataclass
class Generation:
    """One call's output, per row: the generated ids (cut at the row's
    budget and after its first stop id), each one's logit, and the
    log-sum-exp of the logits it was chosen from; with the prompt ids
    of each row and the experts the call touched."""

    tokens: list[list[int]]
    logits: list[list[float]]
    lse: list[list[float]]
    prompts: list[list[int]]
    experts_hit: int


_CONSONANTS = "bcdghklmnprstvx"
_VOWELS = "aeiou"


def render_ids(ids: Sequence[int]) -> str:
    """Generated ids as text while the model's own vocabulary is missing:
    each id one word of syllables (consonant + vowel, base 75), the same
    word for the same id."""
    words = []
    for i in ids:
        syl = []
        n = int(i)
        while True:
            n, d = divmod(n, len(_CONSONANTS) * len(_VOWELS))
            syl.append(_CONSONANTS[d // len(_VOWELS)] + _VOWELS[d % len(_VOWELS)])
            if n == 0:
                break
        words.append("".join(reversed(syl)))
    return " ".join(words)


STOP_CHECK = 8       # decode steps between two reads of the tokens, where a call has stop ids


def _kept(row: list[int], budget: int, stop: set[int]) -> int:
    """How many of a row's tokens so far it keeps: up to its first stop id
    or its budget; 0 while it has neither."""
    for j, tok in enumerate(row[:budget]):
        if tok in stop:
            return j + 1
    return budget if len(row) >= budget else 0


class LocalTranslator:
    """The model, the prefilled instruction prefix, the rows' cache and the
    decode step's buffers.

    ``max_batch``: the most rows a call, the serving batcher's
    ``max_batch`` (the facade passes ``api.batching_max_batch``);
    ``budget``: new tokens for a query, an int for every query or a
    function of the query (the benchmark draws each query's from its
    seed), at most ``max_new_tokens``; ``stop_ids``: ids that end a row
    (the tokenizer's EOT by default)."""

    def __init__(self, model: DeepseekV2ForCausalLM, max_batch: int = 64,
                 max_query_tokens: int = 64, max_new_tokens: int = 64,
                 budget: int | Callable[[str], int] = 64,
                 stop_ids: Sequence[int] | None = None) -> None:
        cfg = model.config
        self.model = model
        self.tokenizer = SimpleTokenizer(vocab_size=cfg.vocab_size)
        self.max_batch = max_batch
        self.max_query_tokens = max_query_tokens
        self.max_new_tokens = max_new_tokens
        self.budget = budget
        self.stop_ids = (self.tokenizer.eot_id,) if stop_ids is None else tuple(stop_ids)
        self.device = dev = model.lm_head.weight.device
        self.prefix_ids = self.tokenizer.encode(TEMPLATE)[:-1]
        self._lock = threading.Lock()        # one call at a time: the rows' cache is shared
        with trace.span("llm.prefix", tokens=len(self.prefix_ids)):
            # held for the life of the backend: a captured step reads it
            self._rope = model.rope.table(len(self.prefix_ids) + max_query_tokens + max_new_tokens,
                                          dev)
            prefix = model.encode_prefix(torch.tensor(self.prefix_ids, device=dev))
            self.cache = LatentCache.allocate(cfg, prefix, max_batch,
                                              max_query_tokens + max_new_tokens)
        # the decode step's inputs and outputs, in place: each row's last
        # token and its slot, the step, the experts touched
        self._tok = torch.zeros(max_batch, dtype=torch.long, device=dev)
        self._slot = torch.zeros(max_batch, dtype=torch.long, device=dev)
        self._at = torch.zeros(1, dtype=torch.long, device=dev)
        self._hits = torch.zeros((), dtype=torch.int64, device=dev)
        self._steps: dict[int, tuple[Callable[[], None], torch.Tensor]] = {}
        self._pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    @classmethod
    def from_config(cls, section: Mapping[str, Any], device: torch.device | str,
                    max_batch: int) -> LocalTranslator:
        """From the ``llm.local`` config section: ``model`` (``deepseek-v2-lite``
        or ``tiny-test``), ``seed`` (of the random weights: the published
        checkpoint is not in the repository; its state dict, in the same
        names, loads into the model as it is), ``max_query_tokens``,
        ``max_new_tokens`` (also every query's budget)."""
        name = section.get("model", "deepseek-v2-lite")
        presets = {"deepseek-v2-lite": DeepseekV2Config.lite, "tiny-test": DeepseekV2Config.tiny_test}
        if name not in presets:
            raise ValueError(f"llm.local.model {name!r}: one of {sorted(presets)}")
        model = DeepseekV2ForCausalLM(presets[name](), device="meta").to_empty(device=device)
        init_seeded(model, int(section.get("seed", 0)))
        new = int(section.get("max_new_tokens", 64))
        return cls(model, max_batch=max_batch,
                   max_query_tokens=int(section.get("max_query_tokens", 64)),
                   max_new_tokens=new, budget=new)

    def row_ids(self, query: str) -> list[int]:
        """A query's own prompt ids, ``words + [EOT]``, cut to fit."""
        ids = self.tokenizer.encode(query)[1:]
        if len(ids) > self.max_query_tokens:
            ids = ids[: self.max_query_tokens - 1] + [self.tokenizer.eot_id]
        return ids

    @staticmethod
    def _pick(logits: torch.Tensor, out: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """The greedy tokens of (n, V) logits; each token, its logit and the
        log-sum-exp go into column ``at`` (a device index) of ``out``."""
        tok = logits.argmax(-1)
        picked = torch.stack((tok.double(), logits.gather(1, tok[:, None])[:, 0].double(),
                              torch.logsumexp(logits, -1).double()))
        out.index_copy_(2, at, picked[..., None])
        return tok

    def _decode_step(self, n: int, out: torch.Tensor) -> None:
        """One decode step of rows 0..n-1, in place: the last tokens at
        their slots in, the next tokens and the slots after them out."""
        logits = self.model.decode(self._tok[:n], self._slot[:n], self.cache, self._hits)
        self._at += 1
        self._tok[:n] = self._pick(logits, out, self._at)
        self._slot[:n] += 1

    def _step_of(self, n: int) -> tuple[Callable[[], None], torch.Tensor]:
        """The decode step of ``n`` rows and its output buffer (3, n,
        ``max_new_tokens``). On a card the step is captured once per ``n``
        as a CUDA graph, so a step is one launch from the host: eagerly it
        is ~2,000 launches, and the host, not the card, set the pace."""
        if n in self._steps:
            return self._steps[n]
        out = torch.zeros(3, n, self.max_new_tokens, dtype=torch.float64, device=self.device)
        step = functools.partial(self._decode_step, n, out)
        if self.device.type == "cuda" and self.max_new_tokens > 1:
            # two steps on a side stream first (the libraries' workspaces);
            # their latents go to slot 0 of the rows, which every call's
            # prefill writes before a step reads it
            side, main = torch.cuda.Stream(self.device), torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._at.zero_()
                    self._slot.zero_()
                    step()
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                step()
            step = graph.replay
        self._steps[n] = (step, out)
        return step, out

    def generate(self, rows: Sequence[Sequence[int]], budgets: Sequence[int],
                 stop_ids: Sequence[int] = ()) -> Generation:
        """Greedy continuations of up to ``max_batch`` rows of prompt ids
        (each after the shared prefix), ``budgets[b]`` new tokens at most.

        Every row decodes up to ``max(budgets) - 1`` steps. With stop ids,
        the tokens so far are read back every :data:`STOP_CHECK` steps (one
        readback, not one a step) and the call ends once every row has its
        stop id or its budget; a row that is done runs on until then, and
        the host cuts its tokens."""
        n = len(rows)
        lengths = [len(r) for r in rows]
        if not 1 <= n <= self.max_batch or len(budgets) != n:
            raise ValueError(f"{n} rows and {len(budgets)} budgets (at most {self.max_batch})")
        if min(lengths) < 1 or max(lengths) > self.max_query_tokens:
            raise ValueError(f"row lengths {min(lengths)}-{max(lengths)}: 1-{self.max_query_tokens}")
        if min(budgets) < 1 or max(budgets) > self.max_new_tokens:
            raise ValueError(f"budgets {min(budgets)}-{max(budgets)}: 1-{self.max_new_tokens}")
        t, steps, dev, model = max(lengths), max(budgets) - 1, self.device, self.model
        with self._lock, torch.inference_mode(), trace.span(
                "llm.generate", rows=n, prompt_tokens=sum(lengths), new_tokens=0) as span:
            step, out = self._step_of(n)
            ids = torch.tensor([list(r) + [0] * (t - len(r)) for r in rows]).to(dev, non_blocking=True)
            lens = torch.tensor(lengths).to(dev, non_blocking=True)
            self._hits.zero_()
            self._at.zero_()
            with trace.span("llm.prefill", rows=n, tokens=n * t):
                self._tok[:n] = self._pick(model.prefill(ids, lens, self.cache, self._hits),
                                           out, self._at)
                self._slot[:n] = lens
            stop, ran = set(stop_ids), 0
            with trace.span("llm.decode", steps=steps) as decode:
                while ran < steps:
                    step()
                    ran += 1
                    if stop and ran % STOP_CHECK == 0 and ran < steps:
                        sofar = out[0, :, :ran + 1].long().tolist()
                        if all(_kept(r, k, stop) for r, k in zip(sofar, budgets)):
                            break
                decode.note(steps=ran)
            host = torch.cat((out[:, :, :ran + 1].flatten(), self._hits.double()[None])).cpu()
            trace.count("llm.prefill_tokens", n * t)
            trace.count("llm.decode_tokens", n * ran)
            trace.count("llm.steps", ran)
            trace.count("moe.experts_hit", int(host[-1]))
        grid = host[:-1].view(3, n, ran + 1)
        toks, logits, lse = grid[0].long().tolist(), grid[1].tolist(), grid[2].tolist()
        keep = [_kept(toks[b], budgets[b], stop) for b in range(n)]
        span.note(new_tokens=sum(keep))
        return Generation(tokens=[toks[b][:k] for b, k in enumerate(keep)],
                          logits=[logits[b][:k] for b, k in enumerate(keep)],
                          lse=[lse[b][:k] for b, k in enumerate(keep)],
                          prompts=[list(r) for r in rows], experts_hit=int(host[-1]))

    def translate(self, queries: Sequence[str]) -> list[str | None]:
        """English captions of ``queries``, ``max_batch`` rows a call; None
        for a query whose answer is empty."""
        out: list[str | None] = []
        for s in range(0, len(queries), self.max_batch):
            chunk = queries[s:s + self.max_batch]
            budgets = [min(self.budget(q) if callable(self.budget) else self.budget,
                           self.max_new_tokens) for q in chunk]
            gen = self.generate([self.row_ids(q) for q in chunk], budgets, self.stop_ids)
            stop = set(self.stop_ids)
            out += [render_ids([i for i in toks if i not in stop]) or None for toks in gen.tokens]
        return out
