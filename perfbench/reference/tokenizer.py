"""A frozen copy of CLIP's hash-bucket tokenizer, the fallback that serves
every text cell while the CLIP BPE vocabulary (``merges.txt``) is not in the
repository.

Each word of the cleaned, lower-cased text maps to
``1 + blake2b_8(word) mod (vocab - 3)``; the sequence is
``[SOT] + ids + [EOT]`` with SOT = vocab - 2 and EOT = vocab - 1, truncated
to the context keeping EOT last, and zero-padded. The word pattern is
CLIP's published one (``\\p{L}`` / ``\\p{N}`` classes through the ``regex``
module, or the closest ``re`` classes where it is missing; the two agree on
ASCII text).
"""

from __future__ import annotations

import hashlib
import html
import re
import unicodedata

import numpy as np

try:
    import regex as _regex

    _WORDS = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:
    _WORDS = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE,
    )


def _clean(text: str) -> str:
    text = unicodedata.normalize("NFC", html.unescape(html.unescape(text))).strip()
    return re.sub(r"\s+", " ", text).strip().lower()


def tokenize(texts: list[str], vocab_size: int, context: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, context) int64 token ids and (B,) positions of EOT."""
    sot, eot = vocab_size - 2, vocab_size - 1
    span = sot - 1
    out = np.zeros((len(texts), context), np.int64)
    pos = np.zeros(len(texts), np.int64)
    for i, text in enumerate(texts):
        ids = [sot]
        for word in _WORDS.findall(_clean(text)):
            h = int.from_bytes(hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest(),
                               "little")
            ids.append(1 + h % span)
        ids.append(eot)
        if len(ids) > context:
            ids = ids[:context - 1] + [eot]
        out[i, :len(ids)] = ids
        pos[i] = len(ids) - 1
    return out, pos
