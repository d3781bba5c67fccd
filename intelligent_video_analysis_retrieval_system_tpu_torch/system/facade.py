"""EnhancedRetrievalSystem: the user-facing facade, build and serving paths.

Port of ``intelligent_video_analysis_retrieval_system_tpu/system/facade.py``:
``build_system`` (validate -> embed every keyframe through the vision tower
-> write the ``.rvdb`` container and its sidecar -> metadata -> consistency
check, with ``build_progress`` events), ``load_system`` -> ``search`` /
``search_batch`` (cache -> translate -> CLIP text encode -> exact top-k over
the device rows -> post processing -> cache), ``search_by_image`` over pixel
arrays, ``get_system_stats`` and ``cleanup``.

Everything runs on the facade's explicit ``torch.device`` (default
``"cuda"``, which raises where CUDA is missing; pass ``"cpu"`` for the
kernels' plain versions); the embedder and the index share it. Not ported
yet, each raising ``NotImplementedError`` that names the later change:
``index_videos`` (video ingest), chat, portable export and the REST server
(``start_server``); P2P fan-in over remote indexes comes with the REST
server.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..index.builder import RAGBuilder
from ..index.metadata import MetadataManager
from ..index.unified import UnifiedIndex, UnifiedIndexConfig, resolve_device
from ..retrieval.translator import UniversalQueryTranslator
from ..retrieval.validator import DataConsistencyValidator
from ..utils.cache import CacheManager
from ..utils.config import Config
from ..utils.dataproc import DataProcessor
from ..utils.files import FileManager
from ..utils.logging import Logger, get_logger
from ..utils.perf import PerformanceMonitor
from .embedder import CLIPEmbedder
from .health import SystemHealthMonitor

__all__ = ["SearchOptions", "EnhancedRetrievalSystem", "create_system", "quick_search"]

VALID_MODES = ("clip_only", "llm_enhanced", "hybrid")

_LATER_INGEST = ("video ingest (FrameFilter, the DINO tower) is ported in a later "
                 "change; extract keyframes with the JAX package, then build_system")


@dataclass(slots=True)
class SearchOptions:
    """Validated search parameters."""

    mode: str = "clip_only"
    limit: int = 20
    include_temporal: bool = False
    temporal_window: int = 3
    include_explanations: bool = False
    min_similarity: float = -1.0
    folder_filter: str | None = None
    use_cache: bool = True
    translate: bool = True

    def validate(self) -> None:
        if self.mode not in VALID_MODES:
            raise ValueError(f"mode must be one of {VALID_MODES}, got {self.mode!r}")
        if not 1 <= self.limit <= 1000:
            raise ValueError(f"limit must be in [1, 1000], got {self.limit}")
        if self.temporal_window < 0:
            raise ValueError("temporal_window must be >= 0")


class EnhancedRetrievalSystem:
    """Build / load / search / stats over one index on one device."""

    # the builder ``build_system`` runs (a subclass may replace the decode
    # or the container, as the chip smoke does where h5py is missing)
    builder_class = RAGBuilder

    def __init__(
        self,
        config: Config | None = None,
        embedder: CLIPEmbedder | None = None,
        logger: Logger | None = None,
        device: torch.device | str = "cuda",
        mesh: Any | None = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "multi-device search is ported in a later change")
        self.config = config or Config(config_file=None)
        self.device = resolve_device(device)
        self.logger = logger or get_logger(
            "ivars",
            logs_dir=self.config.path("logs_dir")
            if self.config.get("logging.file") else None,
        )
        perf_cfg = self.config.section("performance")
        self.perf = PerformanceMonitor(
            logger=self.logger,
            slow_op_threshold_s=perf_cfg.get("slow_op_threshold_s", 5.0),
            profile_dir=perf_cfg.get("profile_dir"),
        )
        self.cache = CacheManager(
            cache_dir=self.config.path("cache_dir"),
            memory_budget_mb=perf_cfg.get("cache_memory_mb", 512),
            default_ttl_s=perf_cfg.get("cache_ttl_s", 3600),
        )
        self.fm = FileManager(temp_dir=self.config.path("temp_dir"))
        self.dp = DataProcessor()
        self.validator = DataConsistencyValidator()
        self.translator = UniversalQueryTranslator(cache=self.cache)
        self.embedder = embedder or CLIPEmbedder(
            model_path=self.config.get("model.path"),
            compute_dtype=self.config.get("device.compute_dtype", "bfloat16"),
            parity_mode=bool(self.config.get("device.parity_mode", False)),
            image_batch_size=int(self.config.get("model.image_batch_size", 256)),
            logger=self.logger,
            vocab_dir=self.config.get("model.vocab_dir"),
            device=self.device,
        )
        self.index: UnifiedIndex | None = None
        self.metadata = MetadataManager(device=self.device)
        self.health = SystemHealthMonitor(self)
        self._callbacks: dict[str, list[Callable[..., None]]] = {}
        self._lock = threading.RLock()
        self.is_built = False

    # -- events ---------------------------------------------------------------

    def on(self, event: str, callback: Callable[..., None]) -> None:
        self._callbacks.setdefault(event, []).append(callback)

    def _emit(self, event: str, **payload: Any) -> None:
        for cb in self._callbacks.get(event, []):
            try:
                cb(**payload)
            except Exception:
                self.logger.warning(f"event callback failed: {event}")

    # -- build / load ---------------------------------------------------------

    def build_system(
        self,
        keyframe_folder: str | Path,
        map_dir: str | Path | None = None,
        output_path: str | Path | None = None,
        resume: bool = True,
    ) -> dict[str, Any]:
        """Validated end-to-end build, the reference's six steps: every
        keyframe of ``keyframes/<video>/<n>.jpg`` through the vision tower
        into one ``.rvdb`` container (chunked, resumable), which is then
        attached and served."""
        with self.perf.timer("build_system"):
            keyframe_folder = Path(keyframe_folder)
            # step 1: pre-build validation
            folder_report = self.validator.validate_keyframes_folder(keyframe_folder)
            if not folder_report.ok:
                raise ValueError(f"invalid keyframes folder: {folder_report.errors}")
            self._emit("build_progress", stage="validate", done=1, total=6)
            # step 2-3: embed + write index (chunked, resumable)
            if output_path is None:
                output_path = self.config.path("index_dir") / "index.rvdb"
            if map_dir is None:
                candidate = self.config.path("map_dir")
                map_dir = candidate if candidate.is_dir() else None
            builder = self._make_builder()
            index, report = builder.build_index(
                keyframe_folder, output_path, map_dir=map_dir, resume=resume
            )
            with self._lock:
                if self.index is not None:
                    self.index.close()
                self.index = index
            self._emit("build_progress", stage="index", done=4, total=6)
            # step 4: metadata graphs
            self._rebuild_metadata()
            # step 5: consistency validation
            consistency = self.validator.validate_index_metadata_consistency(
                index.ntotal, index._metadata
            )
            if not consistency.ok:
                raise RuntimeError(f"post-build inconsistency: {consistency.errors}")
            # step 6: finalize
            self.is_built = True
            self._emit("build_progress", stage="done", done=6, total=6)
            self.logger.info("build complete", **report.as_dict())
            return {"report": report.as_dict(), "index_path": str(output_path)}

    def _make_builder(self) -> RAGBuilder:
        """The builder ``build_system`` runs: this system's embedder, index
        config and device, its progress forwarded as ``build_progress``."""
        index_cfg = self._index_config()
        self.embedder.ensure_loaded()
        return self.builder_class(
            self.embedder.as_embed_fn(),
            self.embedder.embed_dim,
            input_size=self.embedder.input_size,
            config=index_cfg,
            file_manager=self.fm,
            progress_fn=lambda stage, done, total: self._emit(
                "build_progress", stage=stage, done=done, total=total
            ),
            device=self.device,
        )

    def load_system(self, index_path: str | Path, writable: bool = False) -> None:
        """Open an ``.rvdb`` index on the device and rebuild metadata."""
        with self.perf.timer("load_system"):
            index = UnifiedIndex(self._index_config(), device=self.device)
            index.load_unified_index(index_path, mode="a" if writable else "r")
            self._adopt_index(index)

    def attach_index(self, index: UnifiedIndex) -> None:
        """Serve an index the caller opened (e.g. over
        ``UnifiedIndex.attach_container``)."""
        if index.device != self.device:
            raise ValueError(f"index on {index.device}, system on {self.device}")
        self._adopt_index(index)

    def _adopt_index(self, index: UnifiedIndex) -> None:
        with self._lock:
            if self.index is not None:
                self.index.close()
            self.index = index
        self._rebuild_metadata()
        self.is_built = True
        self.logger.info("system loaded", ntotal=index.ntotal,
                         load_time_s=round(index.load_time_s or 0, 3))

    def _index_config(self) -> UnifiedIndexConfig:
        sec = self.config.section("index")
        index_type = str(sec.get("index_type", "flat"))
        if index_type in ("ivf", "ann", "IndexIVFFlat", "IndexHNSW", "IndexLSH"):
            raise NotImplementedError(
                f"index_type {index_type!r}: IVF ANN is ported in a later change")
        if index_type not in ("flat", "exact", "IndexFlatIP", "IndexFlatL2"):
            self.logger.warning(
                f"Unknown index type: {index_type}, using exact flat search")
        return UnifiedIndexConfig(
            chunk_size=sec.get("chunk_size", 1024),
            checkpoint_every_chunks=sec.get("checkpoint_every_chunks", 5),
            store_thumbnails=sec.get("store_thumbnails", True),
            thumbnail_size=sec.get("thumbnail_size", 224),
            store_full_images=sec.get("store_full_images", False),
            dtype=sec.get("dtype", "bfloat16"),
            int8_rescore=bool(sec.get("int8_rescore", False)),
            int8_rescore_factor=int(sec.get("int8_rescore_factor", 4)),
            int8_rescore_cache=bool(sec.get("int8_rescore_cache", False)),
            # "exact" (the native spelling) also ignores a persisted ANN group
            ann_restore=index_type != "exact",
        )

    def _rebuild_metadata(self) -> None:
        if self.index is None or self.index.ntotal == 0:
            return
        # the similarity graph is an enrichment: skip it (and the bulk row
        # read it needs) above 200k rows
        build_similarity = self.index.ntotal <= 200_000
        feats = (self.index._container.read_embeddings(as_float32=True)
                 if build_similarity else None)
        self.metadata.build_metadata(list(self.index._metadata), feats,
                                     build_similarity=build_similarity)

    # -- search ---------------------------------------------------------------

    def search(self, query: str, options: SearchOptions | None = None) -> list[dict[str, Any]]:
        """Text search. Never raises on a search failure: logs it and
        returns [] (invalid options do raise)."""
        options = options or SearchOptions(
            limit=self.config.get("retrieval.default_top_k", 20))
        options.validate()
        try:
            with self.perf.timer("search_query", query_len=len(query)):
                return self._search_impl(query, options)
        except Exception:
            self.logger.exception("search failed", query=query[:100])
            self.perf.record_error("search_query")
            return []

    @staticmethod
    def _cache_mode_key(options: SearchOptions) -> str:
        """Covers every result-shaping option."""
        return (
            f"{options.mode}|f={options.folder_filter}|t={options.include_temporal}"
            f"|w={options.temporal_window}|e={options.include_explanations}"
            f"|m={options.min_similarity}|tr={options.translate}"
        )

    def _cache_index_key(self) -> str:
        """Index identity + mutation generation."""
        index = self.index
        if index is None:
            return "none"
        return f"{index.path}#{index.generation}#{index.ntotal}"

    def _search_impl(self, query: str, options: SearchOptions) -> list[dict[str, Any]]:
        query = query.strip()
        if not query or self.index is None:
            return []
        mode_key = f"{self._cache_mode_key(options)}::{self._cache_index_key()}"
        if options.use_cache:
            cached = self.cache.get_cached_results(query, mode_key, options.limit)
            if cached is not None:
                return cached
        clip_query, translation = self._clip_prompt(query, options)
        if options.mode == "clip_only":
            results = self._search_clip(clip_query, options)
        elif options.mode == "llm_enhanced":
            results = self._search_llm_enhanced(query, clip_query, options)
        else:  # hybrid: 0.7 clip + 0.3 enhanced
            results = self.dp.blend_results(
                self._search_clip(clip_query, options),
                self._search_llm_enhanced(query, clip_query, options),
                self.config.get("retrieval.hybrid_clip_weight", 0.7),
                self.config.get("retrieval.hybrid_llm_weight", 0.3),
                limit=options.limit,
            )
        results = self._post_process(results, options, translation)
        if options.use_cache:
            self.cache.cache_query_results(query, mode_key, options.limit, results)
        return results

    def _clip_prompt(self, query: str, options: SearchOptions) -> tuple[str, Any]:
        """The text the tower encodes: the translator's prompt when its
        confidence clears the bar, else the query itself."""
        if not options.translate:
            return query, None
        translation = self.translator.translate_query(query)
        if translation.confidence >= self.translator.min_confidence:
            return translation.clip_prompt, translation
        return query, translation

    def _encode_query(self, text: str) -> np.ndarray:
        return self.embedder.encode_text([text])[0]

    def _search_clip(self, clip_query: str, options: SearchOptions) -> list[dict]:
        return self._vector_search(self._encode_query(clip_query), options)

    def _search_llm_enhanced(self, query: str, clip_query: str,
                             options: SearchOptions) -> list[dict]:
        """Query expansion with the translator's keyword variants,
        max-merged (the LLM expansion is ported with chat later)."""
        variants = [clip_query]
        for kw in self.translator.translate_query(query).keywords[:2]:
            variants.append(f"a photo of {kw}")
        qvecs = self.embedder.encode_text(variants)
        merged = [self._vector_search(qvecs[i], options) for i in range(len(variants))]
        return self.dp.merge_results(merged, limit=options.limit)

    @staticmethod
    def _folder_filter(options: SearchOptions) -> Callable[[Any], bool] | None:
        if not options.folder_filter:
            return None
        target = options.folder_filter
        return lambda m: m.folder == target

    def _vector_search(self, qvec: np.ndarray, options: SearchOptions) -> list[dict]:
        hits = self.index.search(qvec, top_k=options.limit,
                                 filter_fn=self._folder_filter(options))
        return [h.to_dict("rich") for h in hits]

    def _post_process(self, results: list[dict], options: SearchOptions,
                      translation: Any) -> list[dict]:
        out = []
        for r in results:
            if r.get("similarity_score", 0.0) < options.min_similarity:
                continue
            r = dict(r)
            r["rank"] = len(out) + 1  # contiguous ranks AFTER filtering
            if options.include_temporal and self.index is not None:
                row = self.index.row_for(r.get("folder", ""), r.get("image", ""))
                if row is not None:
                    r["temporal_context"] = self.index.get_temporal_context(
                        row, options.temporal_window)
            if options.include_explanations:
                r["explanation"] = self._explain(r, translation)
            out.append(r)
            if len(out) >= options.limit:
                break
        return out

    @staticmethod
    def _explain(result: dict, translation: Any) -> str:
        score = result.get("similarity_score", 0.0)
        strength = "strong" if score > 0.3 else "moderate" if score > 0.25 else "weak"
        prompt = getattr(translation, "clip_prompt", None) if translation else None
        if prompt:
            return f"{strength} visual match (cosine {score:.3f}) for {prompt!r}"
        return f"{strength} visual match (cosine {score:.3f})"

    def search_batch(self, queries: Sequence[str],
                     options: SearchOptions | None = None) -> list[list[dict[str, Any]]]:
        """Batched text search: one text-tower forward and one top-k sweep
        for the whole batch. Per-query results equal :meth:`search` in
        ``clip_only`` mode; other modes run per query. Never raises on a
        search failure (``[]`` per query)."""
        options = options or SearchOptions(
            limit=self.config.get("retrieval.default_top_k", 20))
        options.validate()
        queries = [q.strip() for q in queries]
        if not queries:
            return []
        if options.mode != "clip_only":
            return [self.search(q, options) for q in queries]
        try:
            with self.perf.timer("search_batch", n_queries=len(queries)):
                return self._search_batch_impl(queries, options)
        except Exception:
            self.logger.exception("batch search failed")
            self.perf.record_error("search_batch")
            return [[] for _ in queries]

    def _search_batch_impl(self, queries: list[str],
                           options: SearchOptions) -> list[list[dict[str, Any]]]:
        mode_key = f"{self._cache_mode_key(options)}::{self._cache_index_key()}"
        out: list[list[dict[str, Any]] | None] = [None] * len(queries)
        todo: list[int] = []
        for i, q in enumerate(queries):
            if not q or self.index is None:
                out[i] = []
                continue
            if options.use_cache:
                cached = self.cache.get_cached_results(q, mode_key, options.limit)
                if cached is not None:
                    out[i] = cached
                    continue
            todo.append(i)
        if todo:
            prompts = [self._clip_prompt(queries[i], options) for i in todo]
            qvecs = self.embedder.encode_text([p for p, _ in prompts])
            hit_lists = self.index.search_vectors(
                qvecs, top_k=options.limit, filter_fn=self._folder_filter(options))
            for j, i in enumerate(todo):
                results = self._post_process(
                    [h.to_dict("rich") for h in hit_lists[j]], options, prompts[j][1])
                if options.use_cache:
                    self.cache.cache_query_results(queries[i], mode_key,
                                                   options.limit, results)
                out[i] = results
        return out  # type: ignore[return-value]

    def search_by_image(self, image: np.ndarray,
                        options: SearchOptions | None = None) -> list[dict[str, Any]]:
        """Image-to-image search over a (H, W, 3) or (1, H, W, 3) pixel
        array (normalize and the vision tower, so kernels B5 and B3 on a card). Image files are
        decoded with the ingest port in a later change. Never raises on a
        search failure (returns [])."""
        if isinstance(image, (str, Path)):
            raise NotImplementedError(
                "image files are decoded by the ingest port in a later change; "
                "pass the pixels as an array")
        options = options or SearchOptions()
        options.validate()
        try:
            with self.perf.timer("search_by_image"):
                qvec = self.embedder.encode_images(np.asarray(image))[0]
                return self._post_process(self._vector_search(qvec, options),
                                          options, None)
        except Exception:
            self.logger.exception("search_by_image failed")
            self.perf.record_error("search_by_image")
            return []

    # -- not ported yet -------------------------------------------------------

    def index_videos(self, *args: Any, **kwargs: Any) -> dict[str, Any]:
        raise NotImplementedError(_LATER_INGEST)

    def chat(self, *args: Any, **kwargs: Any) -> dict:
        raise NotImplementedError("chat is ported with the agents in a later change")

    def export_portable_index(self, *args: Any, **kwargs: Any) -> Path:
        raise NotImplementedError(
            "portable export is ported with the REST server in a later change")

    def load_portable_index(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(
            "portable import is ported with the REST server in a later change")

    def start_server(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "the REST/WebSocket server is ported in a later change; serve "
            "through serve.handlers.RequestHandler and serve.batching.QueryBatcher")

    # -- maintenance ------------------------------------------------------------

    def cleanup(self) -> None:
        with self._lock:
            if self.index is not None:
                self.index.close()
                self.index = None
            self.is_built = False

    def get_system_stats(self) -> dict[str, Any]:
        stats: dict[str, Any] = {
            "built": self.is_built,
            "device": str(self.device),
            "embedder": self.embedder.get_stats(),
            "cache": self.cache.get_stats(),
            "performance": self.perf.get_stats(),
            "metadata": self.metadata.stats(),
        }
        if self.index is not None:
            stats["index"] = self.index.get_stats()
        return stats


def create_system(config_file: str | Path | None = None,
                  torch_device: torch.device | str = "cuda", **overrides: Any):
    """Convenience factory: a system on ``torch_device`` (the default
    ``"cuda"`` raises where CUDA is missing; ``"cpu"`` runs the kernels'
    plain versions). ``overrides`` are config sections, as in the JAX
    package (e.g. ``device={"compute_dtype": "float32"}``)."""
    return EnhancedRetrievalSystem(
        Config(config_file=config_file, overrides=overrides or None),
        device=torch_device,
    )


def quick_search(index_path: str | Path, query: str, limit: int = 10,
                 torch_device: torch.device | str = "cuda"):
    """One-shot search helper: load ``index_path`` on ``torch_device``,
    answer one text query, clean up."""
    system = create_system(torch_device=torch_device)
    system.load_system(index_path)
    try:
        return system.search(query, SearchOptions(limit=limit))
    finally:
        system.cleanup()
