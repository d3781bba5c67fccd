"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/models/tokenizer.py``: the JAX
package's ``models/__init__.py`` imports flax, so the module cannot be
imported where JAX is not installed. Keep the two in step.

CLIP BPE tokenizer (self-contained) with an offline fallback.

The reference delegates tokenization to HF's CLIPProcessor
(``core.py:1524-1550``: 77-token truncation + padding). Here the byte-pair
encoding algorithm is implemented directly:

- :class:`CLIPTokenizer` consumes the standard CLIP vocab artifacts
  (``merges.txt`` + optional ``vocab.json``, as shipped with every
  ``openai/clip-vit-*`` checkpoint) and reproduces HF tokenization —
  required for text-embedding parity.
- :class:`SimpleTokenizer` is a deterministic hash-bucket fallback used
  when no vocab files exist (nothing is downloaded).
  Search still functions (identical text maps to identical ids); only
  cross-checkpoint parity needs the real files.

CLIP specifics honoured: lowercasing, whitespace collapse, byte-level
pre-encoding, end-of-word ``</w>`` markers, ``<|startoftext|>`` /
``<|endoftext|>`` wrapping, 77-token context with truncation (keeping EOT
at the end, as HF does).
"""

from __future__ import annotations

import gzip
import html
import json
import re
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["CLIPTokenizer", "SimpleTokenizer", "load_tokenizer"]


@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode map (printable, no whitespace)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


# Word-splitting pattern. CLIP's original uses \p{L}/\p{N} (via the
# third-party `regex` module, as HF's tokenizer does); when `regex` is
# available use the exact published pattern, else approximate with python
# `re` unicode \w classes. The approximation differs only on rare
# codepoints (non-decimal numerals No/Nl fold into letter runs instead of
# single-number tokens); underscores are handled identically (they join
# punctuation runs, `[^\s\p{L}\p{N}]+` semantics).
try:  # pragma: no cover - exercised via the HF oracle test
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE,
    )


def _basic_clean(text: str) -> str:
    # html-unescape twice + NFC, mirroring CLIP's ftfy.fix_text defaults
    # (ftfy unescapes entities and normalizes to NFC; double-unescape covers
    # double-encoded entities the same way fix_text's loop does)
    import unicodedata

    text = html.unescape(html.unescape(text))
    return unicodedata.normalize("NFC", text).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class _TokenizerBase:
    """Shared encode-to-fixed-length logic."""

    sot_id: int
    eot_id: int
    context_length: int = 77
    #: "clip_bpe" (real CLIP vocab) or "hash_fallback" (degraded semantics)
    kind: str = "unknown"

    def _encode_words(self, text: str) -> list[int]:
        raise NotImplementedError

    def encode(self, text: str) -> list[int]:
        return [self.sot_id] + self._encode_words(text) + [self.eot_id]

    def __call__(
        self, texts: str | list[str], context_length: int | None = None
    ) -> np.ndarray:
        """Tokenize to a fixed (B, context) int32 array, truncating long
        inputs while keeping EOT at the end (HF behaviour)."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > ctx:
                ids = ids[: ctx - 1] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out

    def eot_positions(self, token_ids: np.ndarray) -> np.ndarray:
        """Index of the EOT token per row (for the text tower pool)."""
        return np.argmax((token_ids == self.eot_id).astype(np.int32), axis=1)


class CLIPTokenizer(_TokenizerBase):
    """Exact CLIP BPE given the published merges (and optional vocab.json)."""

    kind = "clip_bpe"

    def __init__(self, merges_path: str | Path, vocab_path: str | Path | None = None):
        merges_path = Path(merges_path)
        if merges_path.suffix == ".gz":
            raw = gzip.open(merges_path, "rt", encoding="utf-8").read()
        else:
            raw = merges_path.read_text(encoding="utf-8")
        lines = raw.split("\n")
        # skip header/version lines; merges are "tok1 tok2"
        merges: list[tuple[str, str]] = []
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#version"):
                continue
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        # The original CLIP vocab uses the first 48894 merges.
        merges = merges[:48894]
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()

        if vocab_path is not None and Path(vocab_path).is_file():
            self.encoder: dict[str, int] = json.loads(
                Path(vocab_path).read_text(encoding="utf-8")
            )
        else:
            # reconstruct vocab the way CLIP does: bytes, bytes</w>, merges
            vocab = list(self.byte_encoder.values())
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.sot_id = self.encoder["<|startoftext|>"]
        self.eot_id = self.encoder["<|endoftext|>"]
        self._bpe_cache: dict[str, list[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> list[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = list(word)
        self._bpe_cache[token] = result
        return result

    def _encode_words(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for tok in _PAT.findall(text):
            # literal special-token strings map to their special ids, never
            # through BPE (HF/original-CLIP behaviour via their bpe cache)
            if tok == "<|startoftext|>":
                ids.append(self.sot_id)
                continue
            if tok == "<|endoftext|>":
                ids.append(self.eot_id)
                continue
            tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok_bytes):
                piece_id = self.encoder.get(piece)
                if piece_id is not None:
                    ids.append(piece_id)
        return ids


class SimpleTokenizer(_TokenizerBase):
    """Deterministic hash-bucket tokenizer (no vocab files needed).

    Words map to stable ids via blake2b; ids live in
    ``[reserved, vocab_size - 2)`` with the last two ids as SOT/EOT
    (mirroring CLIP where EOT is the largest id so that ``argmax(token_ids)``
    locates it — our text tower relies on that convention).
    """

    kind = "hash_fallback"

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1
        self._reserved = 1  # 0 = padding

    def _encode_words(self, text: str) -> list[int]:
        import hashlib

        text = _whitespace_clean(_basic_clean(text)).lower()
        span = self.sot_id - self._reserved
        ids = []
        for tok in _PAT.findall(text):
            h = int.from_bytes(
                hashlib.blake2b(tok.encode("utf-8"), digest_size=8).digest(), "little"
            )
            ids.append(self._reserved + (h % span))
        return ids


def load_tokenizer(
    vocab_dir: str | Path | None = None,
    vocab_size: int = 49408,
    allow_fallback: bool = True,
) -> _TokenizerBase:
    """CLIPTokenizer when vocab files are found, else SimpleTokenizer.

    Searches ``vocab_dir`` (or common HF layout names) for ``merges.txt`` /
    ``bpe_simple_vocab_16e6.txt.gz``.

    The SimpleTokenizer fallback degrades EVERY text embedding to non-CLIP
    semantics (hash buckets instead of BPE subwords), so falling back is
    **loud**: a logging warning fires, and callers that require real-vocab
    semantics can pass ``allow_fallback=False`` to get a FileNotFoundError
    instead. The active tokenizer's ``kind`` attribute ("clip_bpe" vs
    "hash_fallback") is surfaced by CLIPEmbedder.get_stats() and the system
    health check / ``/api/health``.
    """
    import logging

    if vocab_dir is not None:
        root = Path(vocab_dir)
        for name in ("merges.txt", "bpe_simple_vocab_16e6.txt.gz"):
            merges = root / name
            if merges.is_file():
                vocab = root / "vocab.json"
                return CLIPTokenizer(merges, vocab if vocab.is_file() else None)
    if not allow_fallback:
        raise FileNotFoundError(
            f"no CLIP vocab (merges.txt / bpe_simple_vocab_16e6.txt.gz) "
            f"under {vocab_dir!r} and allow_fallback=False"
        )
    logging.getLogger(__name__).warning(
        "CLIP vocab files not found%s — using the hash-bucket "
        "SimpleTokenizer fallback. Text embeddings will NOT match real CLIP "
        "semantics; search still works but cross-checkpoint parity does not. "
        "Point model.path / vocab_dir at a directory containing merges.txt "
        "(+ vocab.json) from any openai/clip-vit-* checkpoint.",
        f" under {vocab_dir!r}" if vocab_dir is not None else "",
    )
    return SimpleTokenizer(vocab_size=vocab_size)
