"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/agents/tools.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Agent tool definitions over the retrieval system.

Parity with the reference ``agent_tools.py``: four tools exposed to the
conversational agent — ``search_keyframes`` (re-enters ``system.search``,
``agent_tools.py:141-190``), ``analyze_keyframes``, ``get_system_status``,
``chat_about_frames`` — with forgiving string-input parsing
(``agent_tools.py:39-127``).

Framework-agnostic design: each tool is a plain :class:`AgentTool` record
(name, description, JSON schema, callable). ``to_openai_tools`` renders
the OpenAI function-calling format; any other agent framework can consume
the records directly.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from ..system.facade import EnhancedRetrievalSystem

__all__ = ["AgentTool", "get_agent_tools", "to_openai_tools"]


@dataclass(slots=True)
class AgentTool:
    name: str
    description: str
    parameters: dict[str, Any]
    fn: Callable[..., Any]

    def __call__(self, **kwargs: Any) -> Any:
        return self.fn(**kwargs)

    def invoke_json(self, arguments: str | dict[str, Any]) -> str:
        """Tolerant invocation from LLM-produced arguments (string or dict);
        always returns a JSON string (tool-call convention)."""
        if isinstance(arguments, str):
            try:
                arguments = json.loads(arguments) if arguments.strip() else {}
            except json.JSONDecodeError:
                # forgiving parse: treat the raw string as the first
                # required parameter (reference's lenient input models)
                required = self.parameters.get("required", [])
                arguments = {required[0]: arguments} if required else {}
        try:
            result = self.fn(**arguments)
            return json.dumps(result, ensure_ascii=False, default=str)
        except TypeError as exc:
            return json.dumps({"error": f"bad arguments: {exc}"})
        except Exception as exc:
            return json.dumps({"error": str(exc)})


def _coerce_int(value: Any, default: int, lo: int, hi: int) -> int:
    try:
        return max(lo, min(hi, int(value)))
    except (TypeError, ValueError):
        return default


def get_agent_tools(system: "EnhancedRetrievalSystem") -> list[AgentTool]:
    """The four reference tools bound to a live system."""

    def search_keyframes(query: str, limit: Any = 10, mode: str = "hybrid") -> dict:
        from ..system.facade import SearchOptions, VALID_MODES

        if mode not in VALID_MODES:
            mode = "hybrid"
        limit = _coerce_int(limit, 10, 1, 50)  # reference caps at 50
        results = system.search(query, SearchOptions(mode=mode, limit=limit))
        return {
            "query": query,
            "count": len(results),
            "results": [
                {
                    "folder": r["folder"],
                    "image": r["image"],
                    "similarity_score": round(r["similarity_score"], 4),
                    "frame_id": r.get("frame_id"),
                }
                for r in results
            ],
        }

    def analyze_keyframes(folder: str, image: str) -> dict:
        index = system.index
        if index is None:
            return {"error": "no index loaded"}
        row = index.row_for(folder, image)
        if row is None:
            return {"error": f"unknown keyframe {folder}/{image}"}
        meta = index.get_metadata(row)
        context = index.get_temporal_context(row, window=3)
        similar = system.metadata.get_similar_frames(folder, image)
        return {
            "folder": folder,
            "image": image,
            "frame_id": meta.frame_id,
            "pts_time": meta.pts_time,
            "temporal_neighbors": [c["image"] for c in context],
            "similar_frames": [
                {"image": img, "similarity": round(s, 3)} for img, s in similar[:5]
            ],
        }

    def get_system_status() -> dict:
        stats = system.get_system_stats()
        return {
            "built": stats["built"],
            "index_frames": stats.get("index", {}).get("ntotal", 0),
            "cache_hit_rate": round(stats["cache"].get("hit_rate", 0.0), 3),
            "remote_indexes": stats["remote_indexes"],
        }

    def chat_about_frames(question: str, frames: Any = None) -> dict:
        frame_list: list[dict] = []
        if isinstance(frames, str):
            try:
                frames = json.loads(frames)
            except json.JSONDecodeError:
                frames = None
        if isinstance(frames, list):
            frame_list = [f for f in frames if isinstance(f, dict)]
        descriptions = []
        for f in frame_list[:5]:
            folder, image = f.get("folder"), f.get("image")
            if folder and image and system.index is not None:
                row = system.index.row_for(folder, image)
                if row is not None:
                    meta = system.index.get_metadata(row)
                    descriptions.append(
                        f"{folder}/{image} (frame {meta.frame_id}, "
                        f"t={meta.pts_time:.1f}s)"
                    )
        answer = (
            f"Discussing {len(descriptions)} frame(s): "
            + "; ".join(descriptions)
            if descriptions
            else "No valid frames selected — select frames or run a search first."
        )
        return {"question": question, "frames": descriptions, "answer": answer}

    return [
        AgentTool(
            name="search_keyframes",
            description=(
                "Search video keyframes by a natural-language description. "
                "Returns ranked matches with similarity scores."
            ),
            parameters={
                "type": "object",
                "properties": {
                    "query": {"type": "string", "description": "visual description"},
                    "limit": {"type": "integer", "minimum": 1, "maximum": 50},
                    "mode": {"type": "string",
                             "enum": ["clip_only", "llm_enhanced", "hybrid"]},
                },
                "required": ["query"],
            },
            fn=search_keyframes,
        ),
        AgentTool(
            name="analyze_keyframes",
            description="Inspect one keyframe: metadata, temporal neighbors, similar frames.",
            parameters={
                "type": "object",
                "properties": {
                    "folder": {"type": "string"},
                    "image": {"type": "string"},
                },
                "required": ["folder", "image"],
            },
            fn=analyze_keyframes,
        ),
        AgentTool(
            name="get_system_status",
            description="Current retrieval-system status (index size, cache).",
            parameters={"type": "object", "properties": {}},
            fn=get_system_status,
        ),
        AgentTool(
            name="chat_about_frames",
            description="Discuss specific selected frames.",
            parameters={
                "type": "object",
                "properties": {
                    "question": {"type": "string"},
                    "frames": {
                        "type": "array",
                        "items": {"type": "object"},
                    },
                },
                "required": ["question"],
            },
            fn=chat_about_frames,
        ),
    ]


def to_openai_tools(tools: list[AgentTool]) -> list[dict[str, Any]]:
    """Render tools in OpenAI function-calling format."""
    return [
        {
            "type": "function",
            "function": {
                "name": t.name,
                "description": t.description,
                "parameters": t.parameters,
            },
        }
        for t in tools
    ]
