"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/config.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Layered JSON configuration.

Capability parity with the reference's ``Config`` (``utils.py:149-545``):
typed defaults deep-merged with an optional ``config.json``, dotted-path
``get``/``set``, validation with auto-fix, and automatic creation of the
directories named in the ``paths`` section.

Differences from the reference (deliberate):
- defaults describe the TPU pipeline (mesh axes, dtypes, Pallas tile sizes)
  instead of torch/CUDA knobs;
- no mutable global singleton required — ``get_config()`` offers one for
  convenience but every component accepts an explicit ``Config``.
"""

from __future__ import annotations

import copy
import json
import threading
from pathlib import Path
from typing import Any, Callable

__all__ = ["Config", "get_config", "DEFAULT_CONFIG"]


# Mirrors the *sections* of the reference DEFAULT_CONFIG (utils.py:157-243):
# system/paths/retrieval/llm/gui/api/performance/logging — with TPU-native
# contents. New sections: device, index, ingest.
DEFAULT_CONFIG: dict[str, Any] = {
    "system": {
        "name": "IVARS-TPU",
        "version": "0.2.0",
        "language_support": ["vi", "en"],
    },
    "paths": {
        "data_dir": "data",
        "keyframes_dir": "keyframes",
        "map_dir": "map",
        "index_dir": "index",
        "cache_dir": ".cache",
        "logs_dir": "logs",
        "export_dir": "exports",
        "temp_dir": ".tmp",
    },
    "device": {
        # mesh axes for pjit/shard_map; "data" shards batches, "index"
        # shards the embedding matrix rows across chips.
        "mesh_axes": ["data", "index"],
        "mesh_shape": None,  # None -> (1, n_devices)
        "compute_dtype": "bfloat16",
        "param_dtype": "float32",
        "parity_mode": False,  # True -> fp32 everywhere for golden tests
    },
    "model": {
        "name": "clip-vit-large-patch14",
        "path": None,       # converted-checkpoint dir (None = random init)
        "vocab_dir": None,  # dir with merges.txt(+vocab.json): real BPE
        # tokenizer even without weights (hash fallback otherwise)
        "image_size": 224,
        "embed_dim": 768,
        "text_max_len": 77,
        "image_batch_size": 256,
        "text_batch_size": 64,
    },
    "retrieval": {
        "default_top_k": 20,
        "max_top_k": 1000,
        "similarity_threshold": 0.0,
        "search_modes": ["clip_only", "llm_enhanced", "hybrid"],
        "hybrid_clip_weight": 0.7,  # reference blend (system.py:1868-1897)
        "hybrid_llm_weight": 0.3,
        "temporal_window": 3,
    },
    "index": {
        "shard_rows": 1 << 20,      # rows per on-disk shard file
        "chunk_size": 1024,          # build chunk (reference default 1000)
        "checkpoint_every_chunks": 5,  # reference unified_index.py:298
        "store_thumbnails": True,
        "thumbnail_size": 224,
        "store_full_images": False,
        "incremental_rebuild_threshold": 0.10,  # unified_index.py:55
        "dtype": "bfloat16",
        # "flat" = exact (reference default IndexFlatIP); "ivf" = the
        # TPU-native ANN latency mode (ops.ann). Reference FAISS names
        # (IndexFlatIP/IndexIVFFlat/IndexHNSW/IndexLSH, core.py:1213-1216)
        # are accepted and mapped in the facade.
        "index_type": "flat",
        "ann_nlist": None,           # None = ops.ann.default_nlist(n)
        "ann_nprobe": 32,
        # dense/IVF crossover: batches above it fall back to the dense
        # sweep. Chip-measured at 10M (round 5, exp_ivf_10m): IVF wins
        # 2.15x at B=4, break-even-to-losing at B=8, loses at B>=16.
        # measure_ann_crossover() replaces this guess per index.
        "ann_max_batch": 4,
        # None = the default-on build-time recall guard at 0.95
        # (UnifiedIndexConfig.ann_target_recall); a number retargets the
        # guard AND makes the facade retune on every load; 0 disables
        "ann_target_recall": None,
        # int8 exact-rescore mode: keep a bf16 copy on disk and rescore
        # the int8 top-(k*factor) at full precision per query (recovers
        # the exact bf16 ranking; HBM capacity win untouched)
        "int8_rescore": False,
        "int8_rescore_factor": 4,
        "int8_rescore_cache": False,
    },
    "ingest": {
        "dedup_threshold": 0.98,     # video_frame_filter.py:63-70
        "scene_threshold": 0.75,     # filter.py:16
        "phash_threshold": 5,        # filter_research_update.py:43
        "blur_drop_percentile": 10.0,  # filter.py:20-21
        "edge_drop_percentile": 10.0,
        "min_scene_length": 5,
        "in_scene_similarity": 0.95,  # filter.py:178-316
        "decode_workers": 4,
        "frame_batch": 128,
    },
    "llm": {
        "enabled": False,            # off the hot path by default
        "provider": "openai",
        "model": "gpt-4o",
        "timeout_base_s": 15.0,      # core.py:2298
        "timeout_per_image_s": 8.0,
        "max_images": 5,
        "session_clear_every": 5,
    },
    "api": {
        "host": "0.0.0.0",
        "port": 5000,
        "rate_limit_per_minute": 100,   # api.py:1811-1868
        "detail_levels": ["minimal", "standard", "rich", "full"],
        "discovery_port_offset": 1,
        "discovery_interval_s": 15.0,   # api.py:475-505
        "node_timeout_s": 300.0,        # api.py:535-555
        # mutation-surface hardening (None keeps the reference's LAN-trust
        # model; see docs/DEPLOYMENT.md): admin_token gates /api/open,
        # /api/maintenance and /api/build (X-Admin-Token or Bearer);
        # open_root confines /api/open to paths under one directory
        "admin_token": None,
        "open_root": None,
    },
    "performance": {
        "slow_op_threshold_s": 5.0,     # utils.py:2471
        "cache_memory_mb": 512,
        "cache_ttl_s": 3600,
        "profile_dir": None,            # set to enable torch.profiler traces
    },
    "logging": {
        "level": "INFO",
        "console": True,
        "file": True,
        "max_bytes": 10 * 1024 * 1024,  # utils.py:634-659
        "backup_count": 5,
        "performance_log": True,
    },
}


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into a copy of ``base``."""
    out = copy.deepcopy(base)
    for key, val in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


class Config:
    """Thread-safe layered configuration with dotted-path access."""

    def __init__(
        self,
        config_file: str | Path | None = "config.json",
        overrides: dict[str, Any] | None = None,
        base_dir: str | Path | None = None,
        create_dirs: bool = False,
    ) -> None:
        self._lock = threading.RLock()
        self.base_dir = Path(base_dir) if base_dir else Path.cwd()
        self._data = copy.deepcopy(DEFAULT_CONFIG)
        self.config_file = None
        if config_file is not None:
            path = Path(config_file)
            if not path.is_absolute():
                path = self.base_dir / path
            if path.is_file():
                self.config_file = path
                with path.open("r", encoding="utf-8") as f:
                    loaded = json.load(f)
                if not isinstance(loaded, dict):
                    raise ValueError(f"config file {path} must hold a JSON object")
                self._data = _deep_merge(self._data, loaded)
        if overrides:
            # warn on unknown top-level sections: create_system(storage=...)
            # when the schema says paths.index_dir otherwise no-ops
            # SILENTLY and builds land in the default location (a real
            # debugging trap, found round 5). Warning not error — config
            # files may carry extra sections on purpose.
            unknown = [k for k in overrides if k not in DEFAULT_CONFIG]
            if unknown:
                import logging

                logging.getLogger("ivars").warning(
                    "config override section(s) %s not in the schema — "
                    "they merge but nothing reads them (known sections: "
                    "%s)", unknown, sorted(DEFAULT_CONFIG),
                )
            self._data = _deep_merge(self._data, overrides)
        self.validate(auto_fix=True)
        if create_dirs:
            self.ensure_dirs()

    # -- dotted-path access (reference utils.py:330-365 semantics) --------

    def get(self, dotted: str, default: Any = None) -> Any:
        with self._lock:
            node: Any = self._data
            for part in dotted.split("."):
                if not isinstance(node, dict) or part not in node:
                    return default
                node = node[part]
            return node

    def set(self, dotted: str, value: Any) -> None:
        with self._lock:
            parts = dotted.split(".")
            node = self._data
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise KeyError(f"{dotted}: {part} is not a section")
            node[parts[-1]] = value

    def section(self, name: str) -> dict[str, Any]:
        with self._lock:
            return copy.deepcopy(self._data.get(name, {}))

    def as_dict(self) -> dict[str, Any]:
        with self._lock:
            return copy.deepcopy(self._data)

    # -- validation (reference utils.py:378-489 semantics) ----------------

    _VALIDATORS: list[tuple[str, Callable[[Any], bool], Any]] = [
        ("retrieval.default_top_k", lambda v: isinstance(v, int) and 1 <= v, 20),
        ("retrieval.max_top_k", lambda v: isinstance(v, int) and 1 <= v, 1000),
        ("retrieval.hybrid_clip_weight", lambda v: 0.0 <= float(v) <= 1.0, 0.7),
        ("index.chunk_size", lambda v: isinstance(v, int) and v >= 1, 1024),
        ("index.checkpoint_every_chunks", lambda v: isinstance(v, int) and v >= 1, 5),
        ("index.incremental_rebuild_threshold", lambda v: 0.0 < float(v) <= 1.0, 0.10),
        ("ingest.dedup_threshold", lambda v: 0.0 <= float(v) <= 1.0, 0.98),
        ("ingest.scene_threshold", lambda v: 0.0 <= float(v) <= 1.0, 0.75),
        ("api.rate_limit_per_minute", lambda v: isinstance(v, int) and v >= 1, 100),
        ("performance.cache_memory_mb", lambda v: isinstance(v, int) and v >= 1, 512),
        (
            "device.compute_dtype",
            lambda v: v in ("bfloat16", "float32", "float16", "int8",
                            "int8_static"),
            "bfloat16",
        ),
        (
            "index.dtype",
            lambda v: v in ("bfloat16", "float32", "float16", "int8"),
            "bfloat16",
        ),
    ]

    def validate(self, auto_fix: bool = True) -> list[str]:
        """Check invariants; fix in place when ``auto_fix``.

        Returns the list of problems found (post-fix list is informative,
        mirrors the reference's validate-and-repair behaviour).
        """
        problems: list[str] = []
        for dotted, ok, default in self._VALIDATORS:
            val = self.get(dotted)
            try:
                valid = ok(val)
            except Exception:
                valid = False
            if not valid:
                problems.append(f"{dotted}={val!r} invalid")
                if auto_fix:
                    self.set(dotted, default)
        # cross-field invariant
        if self.get("retrieval.default_top_k") > self.get("retrieval.max_top_k"):
            problems.append("retrieval.default_top_k > max_top_k")
            if auto_fix:
                self.set("retrieval.default_top_k", self.get("retrieval.max_top_k"))
        return problems

    # -- path handling (reference utils.py:509-524) ------------------------

    def path(self, name: str) -> Path:
        """Resolve ``paths.<name>`` relative to ``base_dir``."""
        rel = self.get(f"paths.{name}")
        if rel is None:
            raise KeyError(f"paths.{name} not configured")
        p = Path(rel)
        return p if p.is_absolute() else self.base_dir / p

    def ensure_dirs(self) -> None:
        for name in self.section("paths"):
            self.path(name).mkdir(parents=True, exist_ok=True)

    def save(self, path: str | Path | None = None) -> Path:
        target = Path(path) if path else (self.config_file or self.base_dir / "config.json")
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(target.suffix + ".tmp")
        with tmp.open("w", encoding="utf-8") as f:
            json.dump(self.as_dict(), f, indent=2, ensure_ascii=False)
        tmp.replace(target)  # atomic, like reference utils.py safe_write
        return target


_GLOBAL: Config | None = None
_GLOBAL_LOCK = threading.Lock()


def get_config(reload: bool = False, **kwargs: Any) -> Config:
    """Process-wide default Config (lazy singleton)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None or reload:
            _GLOBAL = Config(**kwargs)
        return _GLOBAL
