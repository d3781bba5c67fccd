"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/agents/manager.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

AgentManager: agent/team factory with persistent session storage.

Parity with the reference ``AgnoManager`` (``utils.py:809-1200``): create
and register named agents and teams, SQLite-backed session storage (the
reference configured Agno's sqlite storage, ``config.json`` ``agno``
section), and usage stats. Framework-agnostic like the rest of the agent
layer: an agent is a system prompt + tool subset + provider ``complete_fn``;
a team runs members sequentially (each sees the previous member's answer)
or in parallel.

Everything degrades offline: without a provider, agents answer through the
deterministic local search fallback.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Any, Sequence

from .llm import CompleteFn, LLMConfig, LLMProcessor
from .tools import AgentTool, get_agent_tools

if TYPE_CHECKING:
    from ..system.facade import EnhancedRetrievalSystem

__all__ = ["AgentManager", "Agent", "AgentTeam", "SessionStore"]


class SessionStore:
    """SQLite-backed chat session storage (reference used Agno's sqlite
    storage, ``agno_storage.db``)."""

    def __init__(self, db_path: str | Path = "agents.db") -> None:
        self.db_path = str(db_path)
        self._lock = threading.Lock()
        with self._conn() as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS messages ("
                " session_id TEXT, agent TEXT, role TEXT, content TEXT,"
                " ts REAL)"
            )

    def _conn(self) -> sqlite3.Connection:
        return sqlite3.connect(self.db_path)

    def append(self, session_id: str, agent: str, role: str, content: Any) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                "INSERT INTO messages VALUES (?, ?, ?, ?, ?)",
                (session_id, agent, role,
                 json.dumps(content, ensure_ascii=False, default=str),
                 time.time()),
            )

    def history(self, session_id: str, limit: int = 50) -> list[dict[str, Any]]:
        with self._lock, self._conn() as conn:
            rows = conn.execute(
                "SELECT agent, role, content, ts FROM messages"
                " WHERE session_id = ? ORDER BY ts DESC LIMIT ?",
                (session_id, limit),
            ).fetchall()
        return [
            {"agent": a, "role": r, "content": json.loads(c), "ts": ts}
            for a, r, c, ts in reversed(rows)
        ]

    def sessions(self) -> list[str]:
        with self._lock, self._conn() as conn:
            rows = conn.execute(
                "SELECT DISTINCT session_id FROM messages"
            ).fetchall()
        return [r[0] for r in rows]

    def clear(self, session_id: str | None = None) -> None:
        with self._lock, self._conn() as conn:
            if session_id is None:
                conn.execute("DELETE FROM messages")
            else:
                conn.execute("DELETE FROM messages WHERE session_id = ?",
                             (session_id,))


@dataclass
class Agent:
    """A named conversational agent over a tool subset."""

    name: str
    processor: LLMProcessor
    description: str = ""
    store: SessionStore | None = None
    runs: int = 0

    def run(
        self,
        message: str,
        session_id: str = "default",
        context_frames: Sequence[dict] | None = None,
    ) -> dict[str, Any]:
        self.runs += 1
        out = self.processor.chat_with_user(message, context_frames)
        if self.store is not None:
            self.store.append(session_id, self.name, "user", message)
            self.store.append(session_id, self.name, "assistant",
                              out.get("response", ""))
        return out


@dataclass
class AgentTeam:
    """A named group of agents; ``mode`` is sequential (each member sees
    the previous answer appended to the task) or parallel."""

    name: str
    members: list[Agent]
    mode: str = "sequential"  # or "parallel"
    description: str = ""
    runs: int = 0

    def run(self, message: str, session_id: str = "default") -> dict[str, Any]:
        self.runs += 1
        outputs: list[dict[str, Any]] = []
        if self.mode == "parallel":
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(max_workers=len(self.members)) as pool:
                futures = [
                    pool.submit(m.run, message, session_id) for m in self.members
                ]
                outputs = [f.result() for f in futures]
        else:
            task = message
            for member in self.members:
                out = member.run(task, session_id)
                outputs.append(out)
                task = (
                    f"{message}\n\n[{member.name}] answered: "
                    f"{out.get('response', '')}\nRefine or extend."
                )
        return {
            "team": self.name,
            "mode": self.mode,
            "responses": [
                {"agent": m.name, **o} for m, o in zip(self.members, outputs)
            ],
            "response": outputs[-1].get("response", "") if outputs else "",
        }


class AgentManager:
    """Factory/registry for agents and teams over one retrieval system."""

    def __init__(
        self,
        system: "EnhancedRetrievalSystem",
        db_path: str | Path | None = None,
        complete_fn: CompleteFn | None = None,
    ) -> None:
        self.system = system
        self.store = SessionStore(db_path) if db_path else None
        self.default_complete_fn = complete_fn
        self.agents: dict[str, Agent] = {}
        self.teams: dict[str, AgentTeam] = {}
        self._lock = threading.Lock()

    # -- factories (reference utils.py:858, 944) ---------------------------

    def create_agent(
        self,
        name: str,
        description: str = "",
        tool_names: Sequence[str] | None = None,
        system_prompt: str | None = None,
        complete_fn: CompleteFn | None = None,
        config: LLMConfig | None = None,
    ) -> Agent:
        processor = LLMProcessor(
            self.system,
            complete_fn=complete_fn or self.default_complete_fn,
            config=config,
        )
        if tool_names is not None:
            wanted = set(tool_names)
            processor.tools = [t for t in processor.tools if t.name in wanted]
            processor._tools_by_name = {t.name: t for t in processor.tools}
        if system_prompt:
            # prepend persona to the processor's prompt by wrapping complete_fn
            base = processor.complete_fn
            if base is not None:
                def wrapped(messages, tools=None, _base=base, _sp=system_prompt):
                    msgs = list(messages)
                    if msgs and msgs[0].get("role") == "system":
                        msgs[0] = {
                            "role": "system",
                            "content": f"{_sp}\n\n{msgs[0]['content']}",
                        }
                    return _base(msgs, tools=tools)

                processor.complete_fn = wrapped
        agent = Agent(name=name, processor=processor, description=description,
                      store=self.store)
        with self._lock:
            self.agents[name] = agent
        return agent

    def create_team(
        self,
        name: str,
        member_names: Sequence[str],
        mode: str = "sequential",
        description: str = "",
    ) -> AgentTeam:
        if mode not in ("sequential", "parallel"):
            raise ValueError(f"mode must be sequential/parallel, got {mode!r}")
        with self._lock:
            missing = [m for m in member_names if m not in self.agents]
            if missing:
                raise KeyError(f"unknown agents: {missing}")
            team = AgentTeam(
                name=name,
                members=[self.agents[m] for m in member_names],
                mode=mode,
                description=description,
            )
            self.teams[name] = team
        return team

    # -- registry ------------------------------------------------------------

    def list_agents(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {
                    "name": a.name,
                    "description": a.description,
                    "tools": [t.name for t in a.processor.tools],
                    "runs": a.runs,
                    "online": a.processor.available,
                }
                for a in self.agents.values()
            ]

    def list_teams(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {
                    "name": t.name,
                    "mode": t.mode,
                    "members": [m.name for m in t.members],
                    "runs": t.runs,
                }
                for t in self.teams.values()
            ]

    def get_stats(self) -> dict[str, Any]:
        return {
            "agents": len(self.agents),
            "teams": len(self.teams),
            "total_runs": sum(a.runs for a in self.agents.values()),
            "sessions": len(self.store.sessions()) if self.store else 0,
        }
