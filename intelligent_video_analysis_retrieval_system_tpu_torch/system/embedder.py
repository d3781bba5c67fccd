"""CLIPEmbedder: model + tokenizer + device, the embedding service.

Port of ``intelligent_video_analysis_retrieval_system_tpu/system/embedder.py``:
batched text encode with 77-token truncation and L2 normalization, batched
image encode (arrays or files), the ``as_embed_fn`` adapter the index
builder takes, and a load-time self-test that runs both towers once (so, on
a card, the normalize kernel B5 and the vision tower's fused attention
kernel B3).

- The model lives on an explicit ``torch.device``; asking for ``cuda``
  where CUDA is missing raises.
- Parameters stay f32; activations run in bf16 (``compute_dtype``) or f32;
  ``parity_mode`` forces f32 with the "highest" attention mode.
- Batches pad to the reference's buckets (8, 32, 128, 256), so the device
  sees the same shapes as the reference's compiled programs.
- ``fused_mlp=True`` runs the MLP half of every transformer block through
  the fused LN+MLP kernel B4 (``models.clip``). The JAX embedder has no
  such keyword (there only ``Transformer(fused_mlp=True)`` reaches the
  kernel); without one no entry point of the port would. It is off by
  default and is no ``Config`` key.

Not ported yet: the W8A8 modes ``int8`` / ``int8_static`` and their
activation-scale calibration (a later change).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..index.unified import resolve_device
from ..utils.logging import Logger

__all__ = ["CLIPEmbedder"]

_BATCH_BUCKETS = (8, 32, 128, 256)
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bucket(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    return -(-n // _BATCH_BUCKETS[-1]) * _BATCH_BUCKETS[-1]


def _normalized_f32(out: torch.Tensor) -> np.ndarray:
    out = out.float()
    out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)
    return out.cpu().numpy()


class CLIPEmbedder:
    def __init__(
        self,
        model_path: str | Path | None = None,
        config: Any | None = None,          # models.clip.CLIPConfig
        compute_dtype: str = "bfloat16",
        parity_mode: bool = False,
        image_batch_size: int = 256,
        logger: Logger | None = None,
        vocab_dir: str | Path | None = None,
        device: torch.device | str = "cuda",
        fused_mlp: bool = False,
    ) -> None:
        if compute_dtype in ("int8", "int8_static"):
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} (W8A8 towers) is ported in "
                "a later change")
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.model_path = model_path
        self._config_override = config
        self.compute_dtype = "float32" if parity_mode else compute_dtype
        self.parity_mode = parity_mode
        self.image_batch_size = image_batch_size
        self.logger = logger
        self.vocab_dir = vocab_dir
        self.device = resolve_device(device)
        self.fused_mlp = fused_mlp
        self._lock = threading.RLock()
        self._loaded = False
        self.model = None
        self.config = None
        self.tokenizer = None
        self.load_time_s: float | None = None
        self.using_pretrained = False

    # -- lifecycle -----------------------------------------------------------

    def _build_model(self, config: Any, state_dict: Mapping[str, torch.Tensor]):
        from ..models.convert import empty_model

        model = empty_model(
            config, "meta",
            dtype=_COMPUTE_DTYPES[self.compute_dtype],
            precision="highest" if self.parity_mode else "default",
            fused_mlp=self.fused_mlp,
        )
        sd = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
              for k, v in state_dict.items()}
        model.load_state_dict(sd, strict=True, assign=True)
        return model.eval()

    def ensure_loaded(self) -> None:
        with self._lock:
            if self._loaded:
                return
            t0 = time.perf_counter()
            from ..models.convert import load_clip
            from ..models.tokenizer import load_tokenizer

            cfg, sd = load_clip(self.model_path, config=self._config_override,
                                device=self.device)
            self.using_pretrained = (
                self.model_path is not None and Path(str(self.model_path)).exists()
            )
            self.config = cfg
            self.model = self._build_model(cfg, sd)
            vocab = self.vocab_dir or (
                self.model_path if self.using_pretrained else None)
            self.tokenizer = load_tokenizer(vocab, vocab_size=cfg.text.vocab_size)
            self._loaded = True
            self.load_time_s = time.perf_counter() - t0
            if self.logger:
                self.logger.log_performance(
                    "clip_model_load", self.load_time_s,
                    pretrained=self.using_pretrained,
                )
            self.self_test()

    def self_test(self) -> bool:
        """One text and one all-black image through the towers at load;
        raises on a wrong shape or a non-finite embedding."""
        txt = self.encode_text(["self test"])
        s = self.config.vision.image_size
        img = self.encode_images(np.zeros((1, s, s, 3), np.uint8))
        ok = (
            txt.shape == (1, self.config.text.projection_dim)
            and img.shape == (1, self.config.vision.projection_dim)
            and bool(np.isfinite(txt).all())
            and bool(np.isfinite(img).all())
        )
        if not ok:
            raise RuntimeError("CLIP self-test failed: non-finite embeddings")
        return ok

    def load_params(self, state_dict: Mapping[str, Any], config: Any | None = None) -> None:
        """Adopt externally produced weights: a state dict with HF-CLIP
        names (e.g. ``models.convert.from_jax_params`` of a JAX tree).
        ``config`` replaces the model config when the architecture differs."""
        with self._lock:
            if config is not None:
                self._config_override = config
            if not self._loaded:
                self.ensure_loaded()
            if config is not None:
                self.config = config
            self.model = self._build_model(self.config, state_dict)
            self.using_pretrained = True
        self.self_test()

    @property
    def embed_dim(self) -> int:
        self.ensure_loaded()
        return self.config.vision.projection_dim

    @property
    def input_size(self) -> int:
        self.ensure_loaded()
        return self.config.vision.image_size

    # -- text ---------------------------------------------------------------

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """(B,) strings -> (B, D) L2-normalized f32 embeddings."""
        self.ensure_loaded()
        if len(texts) == 0:
            return np.zeros((0, self.config.text.projection_dim), np.float32)
        t0 = time.perf_counter()
        tokens = self.tokenizer(list(texts), self.config.text.max_length)
        eot = self.tokenizer.eot_positions(tokens)
        b = len(texts)
        b_pad = _bucket(b)
        if b_pad != b:
            pad_tok = np.zeros((b_pad - b, tokens.shape[1]), tokens.dtype)
            pad_tok[:, 0] = self.tokenizer.sot_id
            pad_tok[:, 1] = self.tokenizer.eot_id
            tokens = np.concatenate([tokens, pad_tok])
            eot = np.concatenate([eot, np.ones(b_pad - b, eot.dtype)])
        with torch.inference_mode():
            out = self.model.encode_text(
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(eot).to(self.device),
            )
            result = _normalized_f32(out)[:b]
        if self.logger:
            self.logger.log_performance(
                "clip_text_encoding", time.perf_counter() - t0, batch=b)
        return result

    # -- images --------------------------------------------------------------

    def encode_images(self, images: np.ndarray, preprocessed: bool = False) -> np.ndarray:
        """(B, H, W, 3) uint8 (or preprocessed floats) -> (B, D) normalized.

        Chunks to ``image_batch_size`` and pads to buckets. Images already
        at the tower's input size are only normalized; others are resized
        (bicubic, antialiased) and center-cropped on the device."""
        from ..ops.preprocess import normalize_images, preprocess_images

        self.ensure_loaded()
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n = len(images)
        if n == 0:
            return np.zeros((0, self.config.vision.projection_dim), np.float32)
        t0 = time.perf_counter()
        s = self.config.vision.image_size
        dtype = _COMPUTE_DTYPES[self.compute_dtype]
        outs = []
        for start in range(0, n, self.image_batch_size):
            chunk = images[start:start + self.image_batch_size]
            b = len(chunk)
            b_pad = _bucket(b)
            if b_pad != b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b_pad - b, *chunk.shape[1:]), chunk.dtype)])
            with torch.inference_mode():
                px = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                if preprocessed:
                    px = px.to(dtype)
                elif px.shape[1] == s and px.shape[2] == s:
                    px = normalize_images(px, dtype=dtype)
                else:
                    px = preprocess_images(px, image_size=s, dtype=dtype)
                outs.append(_normalized_f32(self.model.encode_image(px))[:b])
        result = np.concatenate(outs)
        if self.logger:
            self.logger.log_performance(
                "clip_image_encoding", time.perf_counter() - t0, batch=n)
        return result

    def encode_image_files(
        self, paths: Sequence[str | Path]
    ) -> tuple[np.ndarray, list[int]]:
        """Decode + encode image files; tolerates failures.

        Returns (embeddings, ok_indices). The host-side resize is HF
        CLIPImageProcessor's (shortest side to the input size, bicubic,
        center crop), the same as the index builder's.
        """
        from PIL import Image

        self.ensure_loaded()
        s = self.config.vision.image_size
        pixels, ok = [], []
        for i, p in enumerate(paths):
            try:
                with Image.open(p) as img:
                    img = img.convert("RGB")
                    w, h = img.size
                    if w <= h:
                        nw, nh = s, max(s, round(h * s / w))
                    else:
                        nw, nh = max(s, round(w * s / h)), s
                    img = img.resize((nw, nh), Image.BICUBIC)
                    left, top = (nw - s) // 2, (nh - s) // 2
                    img = img.crop((left, top, left + s, top + s))
                    pixels.append(np.asarray(img, np.uint8))
                    ok.append(i)
            except Exception:
                continue
        if not pixels:
            return np.zeros((0, self.config.vision.projection_dim), np.float32), []
        return self.encode_images(np.stack(pixels)), ok

    # -- adapters ------------------------------------------------------------

    def as_embed_fn(self) -> Callable[[np.ndarray], np.ndarray]:
        """Adapter for RAGBuilder (uint8 batch -> embeddings)."""
        self.ensure_loaded()
        return lambda batch: self.encode_images(batch)

    def get_stats(self) -> dict[str, Any]:
        return {
            "loaded": self._loaded,
            "pretrained": self.using_pretrained,
            "load_time_s": self.load_time_s,
            "compute_dtype": self.compute_dtype,
            "parity_mode": self.parity_mode,
            "device": str(self.device),
            "fused_mlp": self.fused_mlp,
            "embed_dim": self.config.vision.projection_dim if self._loaded else None,
            # "clip_bpe" or "hash_fallback": degraded text semantics must
            # show in health checks
            "tokenizer": self.tokenizer.kind if self._loaded else None,
        }
