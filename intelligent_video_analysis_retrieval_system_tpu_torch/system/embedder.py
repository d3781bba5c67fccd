"""CLIPEmbedder: model + tokenizer + device, the embedding service.

Port of ``intelligent_video_analysis_retrieval_system_tpu/system/embedder.py``:
batched text encode with 77-token truncation and L2 normalization, batched
image encode (arrays or files), the ``as_embed_fn`` adapter the index
builder takes, and a load-time self-test that runs both towers once (so, on
a card, the normalize kernel B5 and the vision tower's fused attention
kernel B3).

- The model lives on an explicit ``torch.device``; asking for ``cuda``
  where CUDA is missing raises.
- The tower family is the config's type: ``models.clip.CLIPConfig`` (the
  default, ViT-L/14) or ``models.siglip.SiglipConfig``. The family brings its
  processor (``image_mean``, ``image_std``, ``center_crop``: CLIP crops the
  center, SigLIP resizes straight) and its embedding width (``embed_dim``:
  CLIP's projection, SigLIP's 1,152 hidden). SigLIP has no int8 mode.
- Parameters stay f32; activations run in bf16 (``compute_dtype``
  ``bfloat16``, and ``float16``, which the reference also runs as bf16) or
  f32; ``parity_mode`` forces f32 with the "highest" attention mode.
- ``compute_dtype="int8"``: W8A8 dense layers (``ops.quant.w8a8_dense``)
  with bf16 everything else, the same weights. ``"int8_static"`` swaps the
  per-token activation scales for calibrated constants: the first
  ``_CAL_BATCHES`` batches of each tower run a dynamic twin of the model
  (the same parameter tensors) while recording activation maxima, then the
  tower's scales freeze (``models.calibrate``, margin ``_CAL_MARGIN``) and
  the static path takes over. ``self_test`` never counts, ``calibrate()``
  freezes early, ``export_act_scales`` / ``import_act_scales`` carry the
  scales across restarts in the reference's JSON format, and
  ``on_scales_frozen`` tells the facade to persist them.
- Batches pad to the reference's buckets (8, 32, 128, 256), so the device
  sees the same shapes as the reference's compiled programs.
- ``fused_mlp=True`` runs the MLP half of every transformer block through
  the fused LN+MLP kernel B4 (``models.clip``). The JAX embedder has no
  such keyword (there only ``Transformer(fused_mlp=True)`` reaches the
  kernel); without one no entry point of the port would. It is off by
  default and is no ``Config`` key.
- Spans (:mod:`..trace`, recorded only while it is enabled): ``embed.load``
  around ``ensure_loaded`` and its self-test; ``embed.images`` and
  ``embed.text`` around a call, and under them ``embed.upload`` (a chunk's
  host-to-device copy and B5's launch), ``embed.dispatch`` (the tower's
  launches) and ``embed.readback`` (the host waiting for the embeddings).
  ``embed.images`` counts ``embed.tokens``, the tokens through the vision
  tower's blocks (padded images included).
"""

from __future__ import annotations

import functools
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .. import trace
from ..index.unified import resolve_device
from ..utils.logging import Logger

__all__ = ["CLIPEmbedder"]

_BATCH_BUCKETS = (8, 32, 128, 256)
# activation dtype per mode: the reference runs everything but float32 in bf16
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.bfloat16, "int8": torch.bfloat16,
                   "int8_static": torch.bfloat16}

# int8_static mode: batches observed through the dynamic path (accumulating
# activation maxima) before scales freeze and the static path takes over
_CAL_BATCHES = 4
# clipping headroom over the observed calibration maxima
_CAL_MARGIN = 1.1
_SCALES_FORMAT = "ivars-act-scales-v1"


def _bucket(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    return -(-n // _BATCH_BUCKETS[-1]) * _BATCH_BUCKETS[-1]


def _flatten_scale_tree(tree: Any, prefix: tuple = ()):
    """Yield (keypath, scalar) pairs from a nested act-scales dict."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten_scale_tree(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val).item()


def _normalized_f32(out: torch.Tensor) -> np.ndarray:
    out = out.float()
    out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)
    # the host waits here for the card to finish the tower
    with trace.span("embed.readback"):
        return out.cpu().numpy()


class CLIPEmbedder:
    def __init__(
        self,
        model_path: str | Path | None = None,
        config: Any | None = None,          # models.clip.CLIPConfig or .siglip.SiglipConfig
        compute_dtype: str = "bfloat16",
        parity_mode: bool = False,
        image_batch_size: int = 256,
        logger: Logger | None = None,
        vocab_dir: str | Path | None = None,
        device: torch.device | str = "cuda",
        fused_mlp: bool = False,
    ) -> None:
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
        # int8_static calibration state per tower: the accumulated maxima
        # (host trees), the batches seen, and the frozen scale trees
        self._cal_stats: dict[str, Any] = {"vision": None, "text": None}
        self._cal_seen: dict[str, int] = {"vision": 0, "text": 0}
        self._act_scales: dict[str, Any] = {}
        self._installed: dict[str, Any] = {}   # tower -> tree set on the model
        self._cal_paused = False  # self_test runs excluded from calibration
        # called whenever a tower's scales freeze (the facade persists them)
        self.on_scales_frozen: Callable[[], Any] | None = None

    # -- lifecycle -----------------------------------------------------------

    def _build_model(self, config: Any, state_dict: Mapping[str, torch.Tensor],
                     w8a8_static: bool | None = None):
        """The model of this mode over ``state_dict``'s tensors (moved to the
        device; tensors already there are taken as they are, so a twin
        built from another model's state dict shares its parameters)."""
        from ..models.convert import empty_model

        w8a8 = self.compute_dtype in ("int8", "int8_static")
        model = empty_model(
            config, "meta",
            dtype=_COMPUTE_DTYPES[self.compute_dtype],
            precision="highest" if self.parity_mode else "default",
            fused_mlp=self.fused_mlp, w8a8=w8a8,
            w8a8_static=(self.compute_dtype == "int8_static"
                         if w8a8_static is None else w8a8_static),
        )
        sd = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
              for k, v in state_dict.items()}
        model.load_state_dict(sd, strict=True, assign=True)
        return model.eval()

    def ensure_loaded(self) -> None:
        with self._lock:
            if self._loaded:
                return
            with trace.span("embed.load"):
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
        raises on a wrong shape or a non-finite embedding. The dummy inputs
        never count as int8_static calibration batches: their maxima are
        not representative."""
        self._cal_paused = True
        try:
            txt = self.encode_text(["self test"])
            s = self.config.vision.image_size
            img = self.encode_images(np.zeros((1, s, s, 3), np.uint8))
        finally:
            self._cal_paused = False
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
            self.__dict__.pop("_dynamic_model", None)
            # new weights invalidate calibrated activation ranges
            self._cal_stats = {"vision": None, "text": None}
            self._cal_seen = {"vision": 0, "text": 0}
            self._act_scales = {}
            self._installed = {}
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

    @property
    def center_crop(self) -> bool:
        """Whether the tower's processor crops the center (CLIP) or resizes
        straight to the square (SigLIP)."""
        self.ensure_loaded()
        return self.config.center_crop

    # -- int8_static calibration ---------------------------------------------

    @functools.cached_property
    def _dynamic_model(self):
        """Dynamic-scale twin for calibration passes, over the same
        parameter tensors as ``self.model``."""
        return self._build_model(self.config, self.model.state_dict(), w8a8_static=False)

    def _static_ready(self, tower: str) -> bool:
        return self.compute_dtype == "int8_static" and tower in self._act_scales

    def _tower_model(self, tower: str):
        """(the model to run a batch of ``tower`` on, whether it records
        calibration maxima)."""
        from ..models.calibrate import set_act_scales

        if self.compute_dtype != "int8_static":
            return self.model, False
        if not self._static_ready(tower):
            return self._dynamic_model, True
        tree = self._act_scales[tower]
        if self._installed.get(tower) is not tree:
            set_act_scales(self.model, {tower: tree})
            self._installed[tower] = tree
        return self.model, False

    def _encode(self, tower: str, fn: Callable[[Any], torch.Tensor]) -> np.ndarray:
        """``fn(model)`` on the model this tower's mode runs, recording and
        accumulating calibration maxima while the tower calibrates."""
        from ..models.calibrate import record_act_stats

        model, calibrating = self._tower_model(tower)
        if calibrating:
            # one calibration pass at a time: the twin's layers record into
            # state of their own, and another thread may freeze the tower
            with self._lock:
                model, calibrating = self._tower_model(tower)
                if calibrating:
                    with torch.inference_mode(), record_act_stats(model) as stats:
                        with trace.span("embed.dispatch"):
                            out = fn(model)
                        out = _normalized_f32(out)
                    self._accumulate_cal(tower, stats[tower])
                    return out
        with torch.inference_mode():
            with trace.span("embed.dispatch"):
                out = fn(model)
            return _normalized_f32(out)

    def _accumulate_cal(self, tower: str, stats_tree: Any) -> None:
        """Merge one calibration batch's maxima; freeze the tower's scales
        after _CAL_BATCHES batches."""
        from ..models.calibrate import merge_act_stats

        if self._cal_paused:
            return
        self._cal_stats[tower] = merge_act_stats(self._cal_stats[tower], stats_tree)
        self._cal_seen[tower] += 1
        if self._cal_seen[tower] >= _CAL_BATCHES:
            self._freeze_scales(tower)

    def _freeze_scales(self, tower: str) -> None:
        from ..models.calibrate import act_stats_to_scales

        if self._cal_stats[tower] is None:
            return
        self._act_scales[tower] = act_stats_to_scales(
            self._cal_stats[tower], margin=_CAL_MARGIN)["act_scales"]
        if self.logger:
            self.logger.info(
                f"int8_static: froze {tower} activation scales after "
                f"{self._cal_seen[tower]} calibration batches")
        if self.on_scales_frozen is not None:
            try:
                self.on_scales_frozen()
            except Exception:  # persistence must never break encoding
                if self.logger:
                    self.logger.exception("act-scales persistence failed")

    def calibrate(self) -> None:
        """Freeze int8_static scales now from whatever has been observed
        (otherwise they freeze after _CAL_BATCHES batches per tower)."""
        for tower in ("vision", "text"):
            if self._cal_seen[tower] > 0 and tower not in self._act_scales:
                self._freeze_scales(tower)

    def export_act_scales(self, path: str | Path) -> bool:
        """Persist the frozen int8_static scales as JSON (written to
        ``<path>.tmp``, then moved into place) so a restarted server starts
        static at once. Returns False if nothing is frozen yet."""
        if not self._act_scales:
            return False
        flat = {
            tower: {"/".join(str(k) for k in keypath): float(leaf)
                    for keypath, leaf in _flatten_scale_tree(tree)}
            for tower, tree in self._act_scales.items()
        }
        payload = {"format": _SCALES_FORMAT, "towers": flat}
        tmp = Path(str(path) + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
        tmp.replace(path)
        return True

    def import_act_scales(self, path: str | Path) -> bool:
        """Load scales written by :meth:`export_act_scales` (of this package
        or the JAX one); the towers it holds start static at once. Returns
        False when the file is missing (calibrate lazily as usual)."""
        path = Path(path)
        if not path.is_file():
            return False
        payload = json.loads(path.read_text())
        if payload.get("format") != _SCALES_FORMAT:
            raise ValueError(f"{path}: not an act-scales file")
        for tower, flat in payload["towers"].items():
            tree: dict[str, Any] = {}
            for joined, value in flat.items():
                node = tree
                parts = joined.split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = np.float32(value)
            self._act_scales[tower] = tree
        if self.logger:
            self.logger.info(
                f"int8_static: imported frozen activation scales for "
                f"{sorted(payload['towers'])} from {path}")
        return True

    # -- text ---------------------------------------------------------------

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """(B,) strings -> (B, D) L2-normalized f32 embeddings."""
        self.ensure_loaded()
        if len(texts) == 0:
            return np.zeros((0, self.config.text.projection_dim), np.float32)
        t0 = time.perf_counter()
        with trace.span("embed.text", texts=len(texts)):
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
            tok_d = torch.from_numpy(tokens).to(self.device)
            eot_d = torch.from_numpy(eot).to(self.device)
            result = self._encode("text", lambda m: m.encode_text(tok_d, eot_d))[:b]
        if self.logger:
            self.logger.log_performance(
                "clip_text_encoding", time.perf_counter() - t0, batch=b)
        return result

    # -- images --------------------------------------------------------------

    def encode_images(self, images: np.ndarray, preprocessed: bool = False) -> np.ndarray:
        """(B, H, W, 3) uint8 (or preprocessed floats) -> (B, D) normalized.

        Chunks to ``image_batch_size`` and pads to buckets. Images already
        at the tower's input size are only normalized; others are resized
        (bicubic, antialiased) and, for CLIP, center-cropped on the device,
        with the family's mean and std."""
        from ..ops.preprocess import normalize_images, preprocess_images

        self.ensure_loaded()
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n = len(images)
        if n == 0:
            return np.zeros((0, self.config.vision.projection_dim), np.float32)
        t0 = time.perf_counter()
        cfg = self.config
        s = cfg.vision.image_size
        dtype = _COMPUTE_DTYPES[self.compute_dtype]
        outs = []
        with trace.span("embed.images", images=n):
            for start in range(0, n, self.image_batch_size):
                chunk = images[start:start + self.image_batch_size]
                b = len(chunk)
                b_pad = _bucket(b)
                if b_pad != b:
                    chunk = np.concatenate(
                        [chunk, np.zeros((b_pad - b, *chunk.shape[1:]), chunk.dtype)])
                with trace.span("embed.upload", bytes=chunk.nbytes), torch.inference_mode():
                    px = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                    if preprocessed:
                        px = px.to(dtype)
                    elif px.shape[1] == s and px.shape[2] == s:
                        px = normalize_images(px, cfg.image_mean, cfg.image_std, dtype=dtype)
                    else:
                        px = preprocess_images(px, s, dtype, cfg.image_mean, cfg.image_std,
                                               cfg.center_crop)
                outs.append(self._encode("vision", lambda m: m.encode_image(px))[:b])
                trace.count("embed.tokens", b_pad * cfg.vision.seq_len)
            result = np.concatenate(outs)
        if self.logger:
            self.logger.log_performance(
                "clip_image_encoding", time.perf_counter() - t0, batch=n)
        return result

    def encode_image_files(
        self, paths: Sequence[str | Path]
    ) -> tuple[np.ndarray, list[int]]:
        """Decode + encode image files; tolerates failures.

        Returns (embeddings, ok_indices). The host-side resize is the
        tower's HF processor's (``ops.preprocess.fit_image``: CLIP's
        shortest side to the input size and center crop, SigLIP's straight
        resize; bicubic), the same as the index builder's.
        """
        from PIL import Image

        from ..ops.preprocess import fit_image

        self.ensure_loaded()
        s = self.config.vision.image_size
        pixels, ok = [], []
        for i, p in enumerate(paths):
            try:
                with Image.open(p) as img:
                    img = fit_image(img.convert("RGB"), s, self.config.center_crop)
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
            "act_scales_calibrated": sorted(self._act_scales.keys()),
            # "clip_bpe" or "hash_fallback": degraded text semantics must
            # show in health checks
            "tokenizer": self.tokenizer.kind if self._loaded else None,
        }
