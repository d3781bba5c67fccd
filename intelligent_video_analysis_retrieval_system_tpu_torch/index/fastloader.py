"""FastLoader: cache-backed and progressive index loading.

Port of ``intelligent_video_analysis_retrieval_system_tpu/index/fastloader.py``:

- ``load_with_cache``: metadata parsing (the slow, per-record JSON part of
  an index open) is cached in the two-tier CacheManager keyed by file
  identity (path, mtime, size): warm re-opens skip the parse entirely;
- ``progressive_load``: the container opens and searches are available at
  once over a growing prefix while embedding chunks stream to the device in
  a background thread. Each chunk is copied in place into the padded row
  buffer under the index lock (the JAX package donates the buffer to a
  jitted updater for the same reason: no copy of the whole buffer per
  chunk). The sweep kernel takes ``n_valid`` at launch, so the growing
  prefix costs nothing.

Both open on ``device`` (default ``"cuda"``, which raises where CUDA is
missing).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..ops.topk import TILE_N
from ..retrieval.results import KeyframeMetadata
from ..utils.cache import CacheManager
from .container import IndexContainer
from .unified import UnifiedIndex, UnifiedIndexConfig, resolve_device

__all__ = ["FastLoader"]


def _file_key(path: Path) -> str:
    st = path.stat()
    return f"fastload::{path.resolve()}::{st.st_mtime_ns}::{st.st_size}"


class FastLoader:
    def __init__(
        self,
        cache: CacheManager | None = None,
        config: UnifiedIndexConfig | None = None,
        device: torch.device | str = "cuda",
    ) -> None:
        self.cache = cache
        self.config = config
        self.device = resolve_device(device)

    # -- cached load ---------------------------------------------------------

    def load_with_cache(self, path: str | Path) -> UnifiedIndex:
        """Open an index; reuse cached parsed metadata when file unchanged."""
        path = Path(path)
        index = UnifiedIndex(self.config, device=self.device)
        cached_records = None
        key = None
        if self.cache is not None and path.is_file():
            key = _file_key(path)
            cached_records = self.cache.get(key)
        if cached_records is not None:
            index._container = IndexContainer(path, mode="r")
            index.path = path
            index._metadata = [KeyframeMetadata.from_dict(r) for r in cached_records]
            index._row_by_key = {m.key: m.row_id for m in index._metadata}
            index._upload_embeddings()
            index._maybe_build_fp_cache()
            index.load_time_s = 0.0
            return index
        index.load_unified_index(path, mode="r")
        if self.cache is not None and key is not None:
            records = [m.to_dict() for m in index._metadata]
            self.cache.set(key, records, ttl_s=7 * 24 * 3600)
        return index

    # -- progressive load ------------------------------------------------------

    def progressive_load(
        self,
        path: str | Path,
        chunk_rows: int = 100_000,
        on_progress: Callable[[int, int], None] | None = None,
    ) -> tuple[UnifiedIndex, threading.Thread]:
        """Open immediately; stream embeddings to device in the background.

        Returns (index, loader_thread). ``index.ntotal`` grows as chunks
        land; searches run over the loaded prefix at any time. Join the
        thread (or poll ``index.ntotal``) for completion. The rows are served
        dense, as in the JAX package: an int8 container streams dequantized.
        """
        path = Path(path)
        index = UnifiedIndex(self.config, device=self.device)
        container = IndexContainer(path, mode="r")
        index._container = container
        index.path = path
        index._load_metadata_cache()

        total = container.num_rows
        dim = container.dim
        cap = max(TILE_N, -(-total // TILE_N) * TILE_N)
        dtype = torch.bfloat16 if container.dtype == "bfloat16" else torch.float32
        index._dev_x = torch.zeros((cap, dim), dtype=dtype, device=self.device)
        index._capacity = cap
        index._n_valid = 0
        # tombstones apply from the start (the manual device-state path
        # bypasses _upload_embeddings, which normally loads the delete log)
        index._deleted = set(container.deleted_rows())
        if index._deleted:
            index._rebuild_deleted_mask()

        def loader() -> None:
            loaded = 0
            while loaded < total:
                end = min(loaded + chunk_rows, total)
                rows = container.read_embeddings(loaded, end, as_float32=True)
                if index.config.normalize:
                    rows = rows / np.maximum(
                        np.linalg.norm(rows, axis=-1, keepdims=True), 1e-12
                    )
                rows = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
                with index._lock:
                    # in place: no copy of the whole padded buffer per chunk
                    index._dev_x[loaded:end].copy_(rows)
                    index._n_valid = end
                loaded = end
                if on_progress is not None:
                    on_progress(loaded, total)

        thread = threading.Thread(target=loader, daemon=True)
        thread.start()
        return index, thread
