"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/agents/llm.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

LLMProcessor: the conversational multimodal agent.

Parity with the reference ``LLMProcessor`` (``core.py:1869-3006``):
- a tool-calling chat loop over the agent tools (the reference used Agno
  over GPT-4o with the same four tools, ``core.py:1976-2049``);
- graceful degradation chain: tool-agent -> toolless completion -> local
  deterministic answer (``core.py:1917-2127``);
- selected-frame context: thumbnails are recovered from the index and
  attached as images, capped at 5 (``core.py:2747-2841``, cap at 2292);
- per-request timeout budget ``base + per_image * n`` (``core.py:2298``);
- session memory with clearing every N turns (``core.py:2300-2308``);
- ``expand_query`` / ``rank_results`` / ``explain_results`` shims used by
  the search pipeline (``core.py:2901-2946``).

Provider integration is a single injectable ``complete_fn`` with the
OpenAI chat-completions shape; no SDK is imported unless configured (the
tests exercise everything here through a scripted provider).
"""

from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Sequence

from .tools import AgentTool, get_agent_tools, to_openai_tools

if TYPE_CHECKING:
    from ..system.facade import EnhancedRetrievalSystem

__all__ = ["LLMProcessor", "LLMConfig"]

# complete_fn(messages, tools?) -> assistant message dict:
#   {"content": str|None, "tool_calls": [{"id", "name", "arguments"}] | None}
CompleteFn = Callable[..., dict[str, Any]]

_SYSTEM_PROMPT = (
    "You are a video retrieval assistant. You can search keyframes, "
    "analyze frames, and report system status using the provided tools. "
    "Answer concisely; cite frames as folder/image."
)


@dataclass(slots=True)
class LLMConfig:
    model: str = "gpt-4o"
    timeout_base_s: float = 15.0     # core.py:2298
    timeout_per_image_s: float = 8.0
    max_images: int = 5              # core.py:2292
    session_clear_every: int = 5     # core.py:2300-2308
    max_tool_rounds: int = 4
    history_turns: int = 1           # reference history=1 (core.py:2030)


class LLMProcessor:
    def __init__(
        self,
        system: "EnhancedRetrievalSystem",
        complete_fn: CompleteFn | None = None,
        config: LLMConfig | None = None,
    ) -> None:
        self.system = system
        self.config = config or LLMConfig()
        self.complete_fn = complete_fn or self._build_provider()
        self.tools: list[AgentTool] = get_agent_tools(system)
        self._tools_by_name = {t.name: t for t in self.tools}
        self._history: list[dict[str, Any]] = []
        self._runs = 0
        self._lock = threading.RLock()

    # -- provider ------------------------------------------------------------

    def _build_provider(self) -> CompleteFn | None:
        """OpenAI-compatible provider iff a key is configured; else None."""
        import os

        api_key = os.environ.get("OPENAI_API_KEY") or self.system.config.get(
            "llm.api_key"
        )
        if not api_key:
            return None
        try:
            import openai  # type: ignore
        except ImportError:
            return None
        client = openai.OpenAI(api_key=api_key)
        model = self.config.model

        def complete(messages, tools=None):
            kwargs: dict[str, Any] = {"model": model, "messages": messages}
            if tools:
                kwargs["tools"] = tools
            resp = client.chat.completions.create(**kwargs)
            msg = resp.choices[0].message
            return {
                "content": msg.content,
                "tool_calls": [
                    {
                        "id": tc.id,
                        "name": tc.function.name,
                        "arguments": tc.function.arguments,
                    }
                    for tc in (msg.tool_calls or [])
                ] or None,
            }

        return complete

    @property
    def available(self) -> bool:
        return self.complete_fn is not None

    # -- chat ---------------------------------------------------------------

    def chat_with_user(
        self,
        message: str,
        context_frames: Sequence[dict[str, Any]] | None = None,
    ) -> dict[str, Any]:
        """One chat turn. Degradation chain: tool agent -> toolless ->
        local search answer. Never raises."""
        frames = list(context_frames or [])[: self.config.max_images]
        timeout = (
            self.config.timeout_base_s
            + self.config.timeout_per_image_s * len(frames)
        )
        if self.complete_fn is not None:
            try:
                return self._run_with_timeout(
                    lambda: self._chat_with_agent(message, frames), timeout
                )
            except TimeoutError:
                self.system.logger.warning("agent chat timed out", timeout_s=timeout)
            except Exception:
                self.system.logger.exception("agent chat failed")
            # toolless fallback (reference core.py:2059-2099)
            try:
                return self._run_with_timeout(
                    lambda: self._chat_toolless(message), timeout
                )
            except Exception:
                self.system.logger.exception("toolless chat failed")
        return self.system.chat_search(message)

    def _run_with_timeout(self, fn: Callable[[], dict], timeout_s: float) -> dict:
        """Daemon-thread execution with a result container (reference
        pattern, ``core.py:2310-2345``)."""
        result: dict[str, Any] = {}
        error: list[BaseException] = []

        def target() -> None:
            try:
                result.update(fn())
            except BaseException as exc:  # noqa: BLE001 — relayed below
                error.append(exc)

        thread = threading.Thread(target=target, daemon=True)
        thread.start()
        thread.join(timeout=timeout_s)
        if thread.is_alive():
            raise TimeoutError(f"chat exceeded {timeout_s}s")
        if error:
            raise error[0]
        return result

    def _frame_content(self, frames: Sequence[dict[str, Any]]) -> list[dict]:
        """Attach selected-frame thumbnails from the index as image parts
        (reference recovers images from the .rvdb, ``core.py:2747-2841``)."""
        parts: list[dict] = []
        index = self.system.index
        if index is None:
            return parts
        for f in frames:
            folder, image = f.get("folder"), f.get("image")
            if not (folder and image):
                continue
            row = index.row_for(folder, image)
            if row is None:
                continue
            try:
                thumb = index.get_thumbnail(row)
            except Exception:
                continue
            if thumb:
                parts.append(
                    {
                        "type": "image_url",
                        "image_url": {
                            "url": "data:image/jpeg;base64,"
                            + base64.b64encode(thumb).decode()
                        },
                    }
                )
        return parts

    def _chat_with_agent(
        self, message: str, frames: Sequence[dict[str, Any]]
    ) -> dict[str, Any]:
        with self._lock:
            self._runs += 1
            if self._runs % self.config.session_clear_every == 0:
                self._history.clear()
            history = list(self._history[-2 * self.config.history_turns :])

        content: Any = message
        image_parts = self._frame_content(frames)
        if image_parts:
            content = [{"type": "text", "text": message}, *image_parts]
        messages: list[dict[str, Any]] = [
            {"role": "system", "content": _SYSTEM_PROMPT},
            *history,
            {"role": "user", "content": content},
        ]
        openai_tools = to_openai_tools(self.tools)
        tool_results: list[dict[str, Any]] = []
        for _ in range(self.config.max_tool_rounds):
            reply = self.complete_fn(messages, tools=openai_tools)
            calls = reply.get("tool_calls")
            if not calls:
                answer = reply.get("content") or ""
                with self._lock:
                    self._history.append({"role": "user", "content": message})
                    self._history.append({"role": "assistant", "content": answer})
                return {
                    "response": answer,
                    "search_results": self._extract_search_results(tool_results),
                    "method": "agent",
                    "tool_calls": [t["name"] for t in tool_results],
                }
            messages.append(
                {
                    "role": "assistant",
                    "content": reply.get("content"),
                    "tool_calls": [
                        {
                            "id": c["id"],
                            "type": "function",
                            "function": {
                                "name": c["name"],
                                "arguments": c["arguments"]
                                if isinstance(c["arguments"], str)
                                else json.dumps(c["arguments"]),
                            },
                        }
                        for c in calls
                    ],
                }
            )
            for call in calls:
                tool = self._tools_by_name.get(call["name"])
                output = (
                    tool.invoke_json(call.get("arguments") or {})
                    if tool is not None
                    else json.dumps({"error": f"unknown tool {call['name']}"})
                )
                tool_results.append({"name": call["name"], "output": output})
                messages.append(
                    {
                        "role": "tool",
                        "tool_call_id": call["id"],
                        "content": output,
                    }
                )
        return {
            "response": "I hit the tool-call limit before finishing — "
            "please narrow the request.",
            "search_results": self._extract_search_results(tool_results),
            "method": "agent_truncated",
            "tool_calls": [t["name"] for t in tool_results],
        }

    def _chat_toolless(self, message: str) -> dict[str, Any]:
        reply = self.complete_fn(
            [
                {"role": "system", "content": _SYSTEM_PROMPT},
                {"role": "user", "content": message},
            ]
        )
        return {
            "response": reply.get("content") or "",
            "search_results": [],
            "method": "toolless",
        }

    @staticmethod
    def _extract_search_results(tool_results: list[dict]) -> list[dict]:
        for t in reversed(tool_results):
            if t["name"] == "search_keyframes":
                try:
                    return json.loads(t["output"]).get("results", [])
                except json.JSONDecodeError:
                    return []
        return []

    # -- structured vision analysis (reference core.py:2489-2697) -------------

    def analyze_frames_vision(
        self, frames: Sequence[dict[str, Any]], question: str | None = None
    ) -> dict[str, Any]:
        """Structured per-frame visual analysis via the multimodal provider.

        Returns {"frames": [{folder, image, description, objects, scene}],
        "summary": str, "method": ...}. Degrades to metadata-only
        descriptions without a provider (the reference's canned fallback).
        """
        frames = list(frames)[: self.config.max_images]
        if self.complete_fn is not None:
            try:
                timeout = (
                    self.config.timeout_base_s
                    + self.config.timeout_per_image_s * len(frames)
                )
                return self._run_with_timeout(
                    lambda: self._vision_structured(frames, question), timeout
                )
            except Exception:
                self.system.logger.exception("vision analysis failed")
        # offline fallback: metadata descriptions
        described = []
        index = self.system.index
        for f in frames:
            folder, image = f.get("folder"), f.get("image")
            row = index.row_for(folder, image) if index else None
            meta = index.get_metadata(row) if row is not None else None
            described.append(
                {
                    "folder": folder,
                    "image": image,
                    "description": (
                        f"keyframe at frame {meta.frame_id}"
                        + (f", t={meta.pts_time:.1f}s" if meta.pts_time >= 0 else "")
                        if meta
                        else "unknown frame"
                    ),
                    "objects": [],
                    "scene": "",
                }
            )
        return {
            "frames": described,
            "summary": f"{len(described)} frame(s); no vision provider "
            "configured — metadata descriptions only.",
            "method": "metadata_fallback",
        }

    def _vision_structured(
        self, frames: Sequence[dict[str, Any]], question: str | None
    ) -> dict[str, Any]:
        image_parts = self._frame_content(frames)
        names = [f"{f.get('folder')}/{f.get('image')}" for f in frames]
        prompt = (
            "Analyze each attached keyframe. Respond with STRICT JSON: "
            '{"frames": [{"name": str, "description": str, '
            '"objects": [str], "scene": str}], "summary": str}. '
            f"Frame names in order: {names}."
        )
        if question:
            prompt += f" Focus on: {question}"
        reply = self.complete_fn(
            [
                {"role": "system", "content": _SYSTEM_PROMPT},
                {
                    "role": "user",
                    "content": [{"type": "text", "text": prompt}, *image_parts],
                },
            ]
        )
        raw = reply.get("content") or "{}"
        # tolerate fenced JSON
        raw = raw.strip()
        if raw.startswith("```"):
            raw = raw.strip("`")
            raw = raw[raw.find("{") :]
        try:
            parsed = json.loads(raw[raw.find("{") : raw.rfind("}") + 1])
        except (json.JSONDecodeError, ValueError):
            return {
                "frames": [
                    {"folder": f.get("folder"), "image": f.get("image"),
                     "description": raw[:500], "objects": [], "scene": ""}
                    for f in frames
                ],
                "summary": raw[:500],
                "method": "vision_unstructured",
            }
        out_frames = []
        parsed_frames = parsed.get("frames", [])
        for i, f in enumerate(frames):
            p = parsed_frames[i] if i < len(parsed_frames) else {}
            out_frames.append(
                {
                    "folder": f.get("folder"),
                    "image": f.get("image"),
                    "description": p.get("description", ""),
                    "objects": p.get("objects", []),
                    "scene": p.get("scene", ""),
                }
            )
        return {
            "frames": out_frames,
            "summary": parsed.get("summary", ""),
            "method": "vision_structured",
        }

    # -- pipeline shims (reference core.py:2901-2946) -------------------------

    def expand_query(self, query: str) -> list[str]:
        """Prompt variants for llm_enhanced search. With a provider, ask for
        paraphrases; otherwise heuristic variants via the text analyzer
        (upgrading the reference's identity shim, ``core.py:2901-2913``)."""
        if self.complete_fn is None:
            from ..retrieval.textproc import expand_variants

            return expand_variants(query)
        try:
            reply = self.complete_fn(
                [
                    {
                        "role": "system",
                        "content": "Rewrite the query as up to 3 short CLIP-style "
                        "English captions, one per line. No numbering.",
                    },
                    {"role": "user", "content": query},
                ]
            )
            lines = [
                line.strip()
                for line in (reply.get("content") or "").splitlines()
                if line.strip()
            ]
            return ([query] + lines)[:4] if lines else [query]
        except Exception:
            return [query]

    def rank_results(self, query: str, results: list[dict]) -> list[dict]:
        """Passthrough (reference ``core.py:2915-2928``): CLIP similarity is
        the ranking signal; an LLM re-ranker slot kept for API parity."""
        return results

    def explain_results(self, query: str, results: list[dict]) -> str:
        if not results:
            return f"No keyframes matched {query!r}."
        top = results[0]
        return (
            f"Top match for {query!r}: {top.get('folder')}/{top.get('image')} "
            f"with cosine similarity {top.get('similarity_score', 0):.3f} "
            f"({len(results)} results total)."
        )

    def chat_about_frames(
        self, question: str, frames: Sequence[dict[str, Any]]
    ) -> dict[str, Any]:
        tool = self._tools_by_name["chat_about_frames"]
        return json.loads(tool.invoke_json({"question": question,
                                            "frames": list(frames)}))
