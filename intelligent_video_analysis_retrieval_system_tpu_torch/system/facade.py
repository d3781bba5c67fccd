"""EnhancedRetrievalSystem: the user-facing facade, build and serving paths.

Port of ``intelligent_video_analysis_retrieval_system_tpu/system/facade.py``:
``build_system`` (validate -> embed every keyframe through the vision tower
-> write the ``.rvdb`` container and its sidecar -> metadata -> consistency
check, with ``build_progress`` events), ``load_system`` -> ``search`` /
``search_batch`` (cache -> translate -> CLIP text encode -> exact top-k over
the device rows -> post processing -> cache), ``search_by_image`` over pixel
arrays and image files, ``export_portable_index`` / ``load_portable_index``,
``chat`` (the greeting, then ``chat_search``), ``export_data``,
``optimize``, ``get_system_stats``, ``cleanup`` and ``index_videos`` (videos
-> keyframes through ``ingest.FrameFilter`` -> ``build_system``). The index
types are the reference's names: ``flat``/``exact``/``IndexFlatIP``/
``IndexFlatL2`` serve the exact sweep, ``ivf``/``ann``/``IndexIVFFlat``/
``IndexHNSW``/``IndexLSH`` the IVF approximate mode, self-tuned to ``index.ann_target_recall`` after every
build and load. With ``device.compute_dtype = "int8_static"`` the calibrated
activation scales persist beside the index as ``<index>.act_scales.json``:
a build removes a stale file and writes the scales as they freeze; a load
(``load_system``, or ``attach_index`` of an index that has a path) imports
them, so the towers start static at once.

``model.name`` names the towers (``models.convert.MODEL_NAMES``):
``clip-vit-large-patch14`` (the default), ``clip-vit-base-patch32`` or
``siglip-so400m-patch14-384``. The facade builds that embedder and writes
its widths into ``model.embed_dim`` and ``model.image_size``; the index it
builds takes the embedder's width (1,152 for SigLIP).

Everything runs on the facade's explicit ``torch.device`` (default
``"cuda"``, which raises where CUDA is missing; pass ``"cpu"`` for the
kernels' plain versions); the embedder, the index and video ingest share
it; with a ``mesh`` (``parallel.create_mesh``) every index it builds or
loads shards its rows over the mesh's devices instead (the embedder stays on
``device``). ``start_server`` serves the system over REST, WebSocket and Socket.IO
(``serve/rest.py``, on the standard library), ``start_gui`` the web console
the same way, and ``cleanup`` stops the server. ``enable_llm`` attaches the
conversational agent (``agents.LLMProcessor``: ``chat`` and the query
expansion of ``llm_enhanced``); with no provider it answers offline. With
``llm.local.enabled`` the facade holds the local translation model
(``system/local_llm.py``, DeepSeek-V2-Lite; the other ``llm.local.*`` keys
go to ``LocalTranslator.from_config``, with the batcher's
``api.batching_max_batch`` as its rows a call) and the translator sends every
non-English query that misses its caches to it, a batch at a time. Peers'
indexes appended to ``remote_indexes`` (``serve.p2p.RemoteUnifiedIndex``)
are searched beside the local rows and merged by score.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..index.builder import RAGBuilder
from ..index.metadata import MetadataManager
from ..index.portable import PortableIndex
from ..index.unified import UnifiedIndex, UnifiedIndexConfig, resolve_device
from ..models.convert import model_config
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
        """``mesh``: an optional ``parallel.Mesh`` with an ``"index"`` axis:
        every index this system builds or loads shards its rows over the
        mesh's devices (bf16/f32 and the int8 capacity mode alike), the
        multi-device search that replaces the reference's fan-out to peers."""
        self.config = config or Config(config_file=None)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.llm_processor: Any | None = None  # agents.LLMProcessor, lazy
        self.remote_indexes: list[Any] = []    # serve.p2p.RemoteUnifiedIndex
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
        # the local translation model (``llm.local.*``, off by default)
        self.local_llm = None
        local = self.config.section("llm").get("local") or {}
        if local.get("enabled"):
            from .local_llm import LocalTranslator

            self.local_llm = LocalTranslator.from_config(
                local, self.device, int(self.config.get("api.batching_max_batch", 64)))
        self.translator = UniversalQueryTranslator(
            cache=self.cache,
            llm_batch_translate_fn=self.local_llm.translate if self.local_llm else None)
        if embedder is None:
            towers = model_config(self.config.get("model.name", "clip-vit-large-patch14"))
            self.config.set("model.embed_dim", towers.vision.projection_dim)
            self.config.set("model.image_size", towers.vision.image_size)
            embedder = CLIPEmbedder(
                model_path=self.config.get("model.path"),
                config=towers,
                compute_dtype=self.config.get("device.compute_dtype", "bfloat16"),
                parity_mode=bool(self.config.get("device.parity_mode", False)),
                image_batch_size=int(self.config.get("model.image_batch_size", 256)),
                logger=self.logger,
                vocab_dir=self.config.get("model.vocab_dir"),
                device=self.device,
            )
        self.embedder = embedder
        self.index: UnifiedIndex | None = None
        self.metadata = MetadataManager(device=self.device, file_manager=self.fm)
        self.health = SystemHealthMonitor(self)
        self._callbacks: dict[str, list[Callable[..., None]]] = {}
        self._lock = threading.RLock()
        self._server = None
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
            self._wire_act_scale_persistence(output_path, import_existing=False)
            self._maybe_tune_ann()
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
            center_crop=self.embedder.center_crop,
            config=index_cfg,
            file_manager=self.fm,
            progress_fn=lambda stage, done, total: self._emit(
                "build_progress", stage=stage, done=done, total=total
            ),
            mesh=self.mesh,
            device=self.device,
        )

    def load_system(self, index_path: str | Path, writable: bool = False) -> None:
        """Open an ``.rvdb`` index on the device and rebuild metadata."""
        with self.perf.timer("load_system"):
            index = UnifiedIndex(self._index_config(), device=self.device, mesh=self.mesh)
            index.load_unified_index(index_path, mode="a" if writable else "r")
            self._adopt_index(index)
            self._wire_act_scale_persistence(index_path, import_existing=True)
            self._maybe_tune_ann()

    def _maybe_tune_ann(self) -> None:
        """Self-tuning ANN: with ``index.ann_target_recall`` configured and
        the ANN mode active, pick the smallest nprobe reaching the target on
        this corpus (``UnifiedIndex.tune_nprobe``). A failure keeps the
        configured nprobe: tuning never blocks a load."""
        target = self.config.section("index").get("ann_target_recall")
        if not target or self.index is None or not self.index.ann_active:
            return
        try:
            rep = self.index.tune_nprobe(target_recall=float(target))
            self.logger.info("ANN self-tuned", nprobe=rep["nprobe"],
                             recall=round(rep["recall"], 4), target=float(target))
        except Exception:
            self.logger.exception("ANN self-tuning failed; keeping configured ann_nprobe")

    def attach_index(self, index: UnifiedIndex) -> None:
        """Serve an index the caller opened (e.g. over
        ``UnifiedIndex.attach_container``). An index with a path is a load:
        with int8_static its scales file beside it is read, as
        ``load_system`` reads it."""
        if self.mesh is not None or index.mesh is not None:
            if index.mesh is not self.mesh:
                raise ValueError("the index and the system are on different meshes")
        elif index.device != self.device:
            raise ValueError(f"index on {index.device}, system on {self.device}")
        self._adopt_index(index)
        if index.path is not None:
            self._wire_act_scale_persistence(index.path, import_existing=True)

    def _wire_act_scale_persistence(self, index_path: str | Path,
                                    import_existing: bool) -> None:
        """int8_static: persist the calibrated activation scales next to the
        index (``<index>.act_scales.json``) so that a restarted server starts
        static at once instead of observing calibration batches again.

        ``import_existing`` is True only on a load: a fresh build never
        imports the previous build's file (its scales were calibrated for
        another corpus or checkpoint and would override the ones just
        observed); the stale file is removed instead."""
        if getattr(self.embedder, "compute_dtype", None) != "int8_static":
            return
        scales_path = Path(f"{index_path}.act_scales.json")
        if import_existing:
            try:
                if self.embedder.import_act_scales(scales_path):
                    self.logger.info("int8_static scales loaded", path=str(scales_path))
            except Exception:
                self.logger.exception("act-scales import failed — recalibrating")
        else:
            scales_path.unlink(missing_ok=True)
        self.embedder.on_scales_frozen = (
            lambda: self.embedder.export_act_scales(scales_path))
        # towers may have frozen before the wiring (during the build's own
        # encode batches): export what exists now, or a build that exits
        # right after persists nothing
        if self.embedder.export_act_scales(scales_path):
            self.logger.info("int8_static scales saved", path=str(scales_path))

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
        return UnifiedIndexConfig(
            chunk_size=sec.get("chunk_size", 1024),
            checkpoint_every_chunks=sec.get("checkpoint_every_chunks", 5),
            store_thumbnails=sec.get("store_thumbnails", True),
            thumbnail_size=sec.get("thumbnail_size", 224),
            store_full_images=sec.get("store_full_images", False),
            dtype=sec.get("dtype", "bfloat16"),
            ann=self._resolve_index_type(index_type),
            ann_nlist=sec.get("ann_nlist"),
            ann_nprobe=int(sec.get("ann_nprobe", 32)),
            ann_max_batch=int(sec.get("ann_max_batch", 4)),
            # None in the section means the dataclass default (0.95, the
            # default-on recall guard); 0/false disables. The default is read
            # from __dataclass_fields__: on a slots=True dataclass the class
            # attribute is the member descriptor, not the value
            ann_target_recall=(
                UnifiedIndexConfig.__dataclass_fields__["ann_target_recall"].default
                if sec.get("ann_target_recall") is None
                else (float(sec["ann_target_recall"]) or None)
            ),
            int8_rescore=bool(sec.get("int8_rescore", False)),
            int8_rescore_factor=int(sec.get("int8_rescore_factor", 4)),
            int8_rescore_cache=bool(sec.get("int8_rescore_cache", False)),
            # "exact" (the native spelling) also ignores a persisted ANN group
            ann_restore=index_type != "exact",
        )

    def _resolve_index_type(self, index_type: str) -> bool:
        """The configured index type -> exact (False) or IVF ANN (True), by
        the reference's FAISS names; an unknown name serves exact search,
        with the reference's warning."""
        name = str(index_type or "flat")
        if name in ("flat", "exact", "IndexFlatIP", "IndexFlatL2"):
            return False
        if name in ("ivf", "ann", "IndexIVFFlat", "IndexHNSW", "IndexLSH"):
            if name in ("IndexHNSW", "IndexLSH"):
                self.logger.info("index_type served by the IVF ANN mode (same approximate-"
                                 "search capability)", index_type=name)
            return True
        self.logger.warning(f"Unknown index type: {name}, using exact flat search")
        return False

    def _rebuild_metadata(self) -> None:
        if self.index is None or self.index.ntotal == 0:
            return
        # the similarity graph is an enrichment: skip it (and the bulk row
        # read it needs) above 200k rows
        build_similarity = self.index.ntotal <= 200_000
        feats = (self.index._container.read_embeddings(as_float32=True)
                 if build_similarity else None)
        # the index's own sequence, walked once: a columnar sidecar makes its
        # records on the way and is never copied into a second list
        self.metadata.build_metadata(self.index._metadata, feats,
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
        """Query expansion, max-merged: an attached LLM processor's
        ``expand_query`` variants (at most 4), else the translator's keyword
        variants."""
        variants = [clip_query]
        if self.llm_processor is not None:
            try:
                variants = self.llm_processor.expand_query(query)[:4] or variants
            except Exception:
                pass
        else:
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
        if not self.remote_indexes:
            return [h.to_dict("rich") for h in hits]
        # remote fan-in: the local hits, then each peer's, merged by score; a
        # peer that fails is skipped
        merged: list[list[dict]] = [[h.to_dict("rich") for h in hits]]
        for remote in list(self.remote_indexes):
            try:
                merged.append(remote.search_vector(qvec, top_k=options.limit))
            except Exception:
                self.logger.warning("remote index failed; skipping")
        return self.dp.merge_results(merged, limit=options.limit)

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
        ``clip_only`` mode; other modes, and a system with remote indexes,
        run per query. Never raises on a search failure (``[]`` per query)."""
        options = options or SearchOptions(
            limit=self.config.get("retrieval.default_top_k", 20))
        options.validate()
        queries = [q.strip() for q in queries]
        if not queries:
            return []
        if options.mode != "clip_only" or self.remote_indexes:
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

    def search_by_image(self, image: np.ndarray | str | Path,
                        options: SearchOptions | None = None) -> list[dict[str, Any]]:
        """Image-to-image search over a (H, W, 3) or (1, H, W, 3) pixel
        array, or an image file decoded and resized as the index builder
        does (``encode_image_files``); then normalize and the vision tower,
        so kernels B5 and B3 on a card. Never raises on a search failure,
        and a file that cannot be decoded finds nothing: both return []."""
        options = options or SearchOptions()
        options.validate()
        try:
            with self.perf.timer("search_by_image"):
                if isinstance(image, (str, Path)):
                    emb, ok = self.embedder.encode_image_files([image])
                    if not ok:
                        return []
                    qvec = emb[0]
                else:
                    qvec = self.embedder.encode_images(np.asarray(image))[0]
                return self._post_process(self._vector_search(qvec, options),
                                          options, None)
        except Exception:
            self.logger.exception("search_by_image failed")
            self.perf.record_error("search_by_image")
            return []

    # -- portable packages ------------------------------------------------------

    def export_portable_index(self, package_dir: str | Path) -> Path:
        """Bundle the loaded index file (and the metadata export, when it
        can be written) into a portable package directory."""
        if self.index is None or self.index.path is None:
            raise RuntimeError("no index loaded")
        meta_path: Path | None = self.index.path.with_suffix(".metadata.json")
        try:
            self.metadata.save(meta_path)
        except (OSError, TypeError, ValueError):  # the export is optional
            meta_path = None
        return PortableIndex().create_package(
            self.index.path, package_dir, metadata_path=meta_path)

    def load_portable_index(self, package_dir: str | Path) -> None:
        """Validate a portable package and serve its index."""
        self._adopt_index(PortableIndex().load_package(
            package_dir, config=self._index_config(), device=self.device))

    def index_videos(
        self,
        videos: Sequence[str | Path],
        output_path: str | Path | None = None,
        filter_config: Any | None = None,
        resume: bool = True,
    ) -> dict[str, Any]:
        """One-shot pipeline: videos -> keyframes -> searchable index.

        Composes ``FrameFilter.extract_frames`` (batched decode + streaming
        dedup on this system's device) with :meth:`build_system`; keyframes
        and map CSVs land in the configured paths so later incremental runs
        resume."""
        from ..ingest import FrameFilter, FrameFilterConfig

        keyframes_dir = self.config.path("keyframes_dir")
        map_dir = self.config.path("map_dir")
        ingest_cfg = filter_config
        if ingest_cfg is None:
            sec = self.config.section("ingest")
            ingest_cfg = FrameFilterConfig(
                dedup_threshold=sec.get("dedup_threshold", 0.98),
                frame_batch=sec.get("frame_batch", 128),
            )
        ff = FrameFilter(ingest_cfg, device=self.device)
        extract_reports = []
        with self.perf.timer("index_videos_extract"):
            for video in videos:
                extract_reports.append(
                    ff.extract_frames(video, keyframes_dir, map_dir).as_dict()
                )
        build = self.build_system(
            keyframes_dir, map_dir=map_dir, output_path=output_path, resume=resume,
        )
        return {"extract": extract_reports, **build}

    # -- serving / gui ----------------------------------------------------------

    def start_server(self, host: str | None = None, port: int | None = None,
                     block: bool = True):
        """REST + WebSocket server over this system (``serve/rest.py``) on
        ``host:port`` (default ``api.host`` / ``api.port``); ``block`` serves
        in this thread until the server is stopped. Returns the server."""
        from ..serve.rest import RetrievalServer

        server = RetrievalServer(
            self,
            host=host or self.config.get("api.host", "0.0.0.0"),
            port=port or self.config.get("api.port", 5000),
        )
        self._server = server
        server.run(block=block)
        return server

    def start_gui(self) -> None:
        """The desktop GUI of the reference is replaced by the web console
        served at the server's root."""
        self.start_server(block=True)

    # -- chat (the greeting, the LLM processor, then chat_search) --------------

    def chat(self, message: str, context_frames: Sequence[dict] | None = None) -> dict:
        """Conversational entry: a greeting short-circuits; then the attached
        LLM processor answers (its own chain ends in :meth:`chat_search`);
        without one, or where it raises, :meth:`chat_search` does."""
        message = message.strip()
        if message.lower() in {"hi", "hello", "hey", "xin chào", "chào", "chào bạn"}:
            return {"response": ("Hello! Ask me to find scenes, e.g. 'a red car at night', "
                                 "or ask about selected frames."),
                    "search_results": [], "method": "greeting"}
        if self.llm_processor is not None:
            try:
                return self.llm_processor.chat_with_user(message, context_frames)
            except Exception:
                self.logger.exception("llm chat failed; falling back")
        return self.chat_search(message)

    def chat_search(self, message: str) -> dict:
        """Search + a templated answer."""
        results = self.search(message, SearchOptions(limit=5))
        if results:
            top = results[0]
            response = (f"I found {len(results)} matching keyframes. Best match: "
                        f"{top['folder']}/{top['image']} "
                        f"(similarity {top['similarity_score']:.3f}).")
        else:
            response = ("I couldn't find matching keyframes. Try different wording "
                        "or check that an index is loaded.")
        return {"response": response, "search_results": results, "method": "search"}

    def enable_llm(self, complete_fn: Any | None = None) -> Any:
        """Attach the conversational agent (chat and the ``llm_enhanced``
        expansion). ``complete_fn`` is the provider (the OpenAI
        chat-completions shape); without one the processor takes
        ``OPENAI_API_KEY`` or ``llm.api_key`` where set, else answers
        offline. The ``llm.*`` config keys set its limits."""
        from ..agents import LLMConfig, LLMProcessor

        sec = self.config.section("llm")
        self.llm_processor = LLMProcessor(
            self,
            complete_fn=complete_fn,
            config=LLMConfig(
                model=sec.get("model", "gpt-4o"),
                timeout_base_s=sec.get("timeout_base_s", 15.0),
                timeout_per_image_s=sec.get("timeout_per_image_s", 8.0),
                max_images=sec.get("max_images", 5),
                session_clear_every=sec.get("session_clear_every", 5),
            ),
        )
        return self.llm_processor

    # -- export -----------------------------------------------------------------

    def export_data(self, results: Sequence[dict], output_path: str | Path,
                    fmt: str | None = None) -> Path:
        """Results as JSON, CSV or XLSX (xlsx needs pandas), by ``fmt`` or
        the file's suffix."""
        output_path = Path(output_path)
        fmt = (fmt or output_path.suffix.lstrip(".") or "json").lower()
        output_path.parent.mkdir(parents=True, exist_ok=True)
        rows = [dict(r) for r in results]
        if fmt == "json":
            self.fm.safe_write(output_path, json.dumps(rows, ensure_ascii=False, indent=2))
        elif fmt == "csv":
            import csv
            import io

            buf = io.StringIO()
            if rows:
                keys = sorted({k for r in rows for k in r
                               if not isinstance(r[k], (list, dict))})
                writer = csv.DictWriter(buf, fieldnames=keys, extrasaction="ignore")
                writer.writeheader()
                writer.writerows(rows)
            self.fm.safe_write(output_path, buf.getvalue())
        elif fmt == "xlsx":
            import pandas as pd

            pd.DataFrame(rows).to_excel(output_path, index=False)
        else:
            raise ValueError(f"unsupported export format: {fmt}")
        return output_path

    # -- maintenance ------------------------------------------------------------

    def optimize(self) -> dict[str, Any]:
        """Temp cleanup + the cache's stats."""
        return {"temp_removed": self.fm.cleanup_temp(), "cache": self.cache.get_stats()}

    def cleanup(self) -> None:
        with self._lock:
            if self.index is not None:
                self.index.close()
                self.index = None
            if self._server is not None:
                self._server.stop()
            self.is_built = False

    def get_system_stats(self) -> dict[str, Any]:
        stats: dict[str, Any] = {
            "built": self.is_built,
            "device": str(self.device),
            "embedder": self.embedder.get_stats(),
            "cache": self.cache.get_stats(),
            "performance": self.perf.get_stats(),
            "metadata": self.metadata.stats(),
            "remote_indexes": len(self.remote_indexes),
        }
        if self.index is not None:
            stats["index"] = self.index.get_stats()
        return stats


def create_system(config_file: str | Path | None = None,
                  torch_device: torch.device | str = "cuda", mesh: Any | None = None,
                  **overrides: Any):
    """Convenience factory: a system on ``torch_device`` (the default
    ``"cuda"`` raises where CUDA is missing; ``"cpu"`` runs the kernels'
    plain versions). Pass ``mesh`` to shard every built or loaded index over
    a device mesh. ``overrides`` are config sections, as in the JAX
    package (e.g. ``device={"compute_dtype": "float32"}``)."""
    return EnhancedRetrievalSystem(
        Config(config_file=config_file, overrides=overrides or None),
        device=torch_device, mesh=mesh,
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
