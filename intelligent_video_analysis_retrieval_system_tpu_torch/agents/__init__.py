"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/agents/__init__.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Agent layer: conversational LLM processor + tool definitions.

Parity with the reference's ``LLMProcessor`` (``core.py:1869-3006``) and
``agent_tools.py``. The LLM is optional and pluggable: with no provider
configured every entry point degrades to deterministic local behaviour
(the reference's own fallback chain, ``core.py:1917-2127``), so the system
is fully functional offline.
"""

from .tools import AgentTool, get_agent_tools
from .llm import LLMProcessor, LLMConfig
from .manager import Agent, AgentManager, AgentTeam, SessionStore

__all__ = [
    "AgentTool",
    "get_agent_tools",
    "LLMProcessor",
    "LLMConfig",
    "Agent",
    "AgentManager",
    "AgentTeam",
    "SessionStore",
]
