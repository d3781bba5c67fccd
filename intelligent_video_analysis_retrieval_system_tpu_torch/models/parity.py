"""One-command real-weight parity gate against the HF torch reference.

Port of ``intelligent_video_analysis_retrieval_system_tpu/models/parity.py``.
Against a LOCAL copy of any ``openai/clip-vit-*`` checkpoint directory
(weights + vocab) it validates that:

1. the port's BPE tokenizer reproduces HF's input_ids exactly,
2. the port's text tower (the checkpoint converted by ``models.convert``,
   run in parity mode: f32, f32 attention logits) matches HF's
   ``get_text_features`` with cosine >= threshold (gate: 0.999),
3. its vision tower matches ``get_image_features`` likewise (identical
   preprocessed pixels on both sides, isolating the towers).

No network access is ever attempted; when the artifacts are missing the
report says exactly which file is absent. ``transformers`` is imported only
inside :func:`run_parity`: where it is not installed the report names it
unavailable. CLI: ``python -m intelligent_video_analysis_retrieval_system_tpu_torch
parity --weights DIR``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

__all__ = ["ParityReport", "run_parity"]

_TEXTS = [
    "a photo of a cat",
    "a man riding a bicycle down a busy street",
    "two dogs playing in the snow",
    "an aerial view of a city at night",
    "a close-up of a red flower with water droplets",
    "people walking across a pedestrian crossing",
    "a bowl of fresh fruit on a wooden table",
    "a soccer player kicking a ball into the goal",
]


@dataclass
class ParityReport:
    ok: bool
    threshold: float
    tokenizer_exact: bool | None = None
    text_cosine_min: float | None = None
    image_cosine_min: float | None = None
    errors: list[str] = field(default_factory=list)

    def summary(self) -> str:
        lines = []
        if self.errors:
            lines += [f"ERROR: {e}" for e in self.errors]
        if self.tokenizer_exact is not None:
            lines.append(
                f"tokenizer ids vs HF: "
                f"{'EXACT' if self.tokenizer_exact else 'MISMATCH'}"
            )
        if self.text_cosine_min is not None:
            lines.append(
                f"text embedding cosine (min over {len(_TEXTS)} prompts): "
                f"{self.text_cosine_min:.6f}"
            )
        if self.image_cosine_min is not None:
            lines.append(
                f"image embedding cosine (min): {self.image_cosine_min:.6f}"
            )
        lines.append(
            f"parity gate (cosine >= {self.threshold}): "
            f"{'PASS' if self.ok else 'FAIL'}"
        )
        return "\n".join(lines)


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return (a * b).sum(-1)


def run_parity(
    weights_dir: str | Path,
    threshold: float = 0.999,
    n_images: int = 4,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> ParityReport:
    """Run the full parity gate against a local HF CLIP checkpoint dir; the
    port's towers run on ``device``, HF's on the CPU."""
    root = Path(weights_dir)
    report = ParityReport(ok=False, threshold=threshold)
    if not root.is_dir():
        report.errors.append(f"{root} is not a directory")
        return report

    try:
        import transformers
    except ImportError as exc:
        report.errors.append(f"torch/transformers unavailable: {exc}")
        return report

    try:
        hf_model = transformers.CLIPModel.from_pretrained(
            str(root), local_files_only=True
        ).eval()
    except Exception as exc:
        report.errors.append(f"HF CLIPModel load failed from {root}: {exc}")
        return report

    # --- our side: f32 parity mode, strict vocab ---------------------------
    from ..system.embedder import CLIPEmbedder
    from .tokenizer import load_tokenizer

    try:
        load_tokenizer(root, allow_fallback=False)
    except FileNotFoundError as exc:
        report.errors.append(str(exc))
        return report
    embedder = CLIPEmbedder(model_path=root, parity_mode=True, vocab_dir=root, device=device)
    embedder.ensure_loaded()
    if not embedder.using_pretrained:
        report.errors.append(f"converter could not consume weights in {root}")
        return report
    if embedder.tokenizer.kind != "clip_bpe":
        report.errors.append("BPE tokenizer did not activate")
        return report
    hf_eos = getattr(hf_model.config.text_config, "eos_token_id", None)
    if hf_eos is not None and hf_eos != embedder.tokenizer.eot_id:
        # HF pools hidden states at eos_token_id; a vocab whose EOT id
        # differs means the checkpoint + vocab files are inconsistent and
        # every text cosine would silently compare different poolings
        report.errors.append(
            f"checkpoint eos_token_id={hf_eos} != vocab EOT id="
            f"{embedder.tokenizer.eot_id} — weights and vocab files are "
            "from different models"
        )
        return report

    # --- 1. tokenizer ids ---------------------------------------------------
    try:
        hf_tok = transformers.CLIPTokenizer.from_pretrained(
            str(root), local_files_only=True
        )
        report.tokenizer_exact = all(
            embedder.tokenizer.encode(t) == hf_tok(t)["input_ids"]
            for t in _TEXTS
        )
    except Exception as exc:
        report.errors.append(f"HF tokenizer load failed (ids unchecked): {exc}")
        report.tokenizer_exact = None

    # --- 2. text tower ------------------------------------------------------
    ours_txt = embedder.encode_text(_TEXTS)
    toks = embedder.tokenizer(_TEXTS, embedder.config.text.max_length)
    with torch.no_grad():
        hf_txt = hf_model.get_text_features(
            input_ids=torch.from_numpy(toks.astype(np.int64))
        ).numpy()
    report.text_cosine_min = float(_cosines(ours_txt, hf_txt).min())

    # --- 3. vision tower (identical preprocessed pixels both sides) --------
    rng = np.random.default_rng(seed)
    s = embedder.input_size
    px = rng.standard_normal((n_images, s, s, 3)).astype(np.float32)
    ours_img = embedder.encode_images(px, preprocessed=True)
    with torch.no_grad():
        hf_img = hf_model.get_image_features(
            pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2))
        ).numpy()
    report.image_cosine_min = float(_cosines(ours_img, hf_img).min())

    report.ok = (
        not report.errors
        and report.tokenizer_exact is not False
        and report.text_cosine_min >= threshold
        and report.image_cosine_min >= threshold
    )
    return report
