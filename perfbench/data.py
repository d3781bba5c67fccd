"""Inputs made from ``--seed``: index rows on the device, keyframes, text
queries, query vectors and schedules.

Rows are filled on the device in blocks from one ``torch.Generator``,
never uploaded (after the program's ``bench/data.py``, whose
``gen_db_bf16`` / ``gen_db_int8`` this copies and widens): bf16 rows are
standard normal, L2-normalized in float32 and rounded once; int8 rows are
normalized the same way and quantized per row as the int8 capacity mode
stores them (``scale = max|x| / 127``, values rounded half to even).

What sets the amount of work (how many requests, their word counts, the
gaps between arrivals) is drawn once from a fixed seed and only permuted by
``--seed``; the words, the rows and the pixels are drawn from ``--seed``.
Two seeds thus ask for the same work in another order.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 20
WORK_SEED = 20_231   # fixes the multiset of sizes and gaps every seed permutes


def seed64(seed: int) -> int:
    """Any whole number as a seed of 64 bits."""
    return int(seed) & ((1 << 64) - 1)


def rows_bf16(n: int, dim: int, seed: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    out = torch.empty((n, dim), dtype=torch.bfloat16, device=device)
    for s in range(0, n, BLOCK_ROWS):
        e = min(s + BLOCK_ROWS, n)
        c = torch.randn((e - s, dim), generator=gen, device=device)
        c /= torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-12)
        out[s:e].copy_(c)
    return out


def rows_int8(n: int, dim: int, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, dim) int8 rows and (n,) float32 scales of unit vectors."""
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    rows = torch.empty((n, dim), dtype=torch.int8, device=device)
    scales = torch.empty((n,), dtype=torch.float32, device=device)
    for s in range(0, n, BLOCK_ROWS):
        e = min(s + BLOCK_ROWS, n)
        c = torch.randn((e - s, dim), generator=gen, device=device)
        c /= torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-12)
        amax = torch.clamp(c.abs().amax(dim=-1, keepdim=True), min=1e-12)
        scale = amax / amax.new_full((), 127.0)
        rows[s:e].copy_(torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8))
        scales[s:e] = scale[:, 0]
    return rows, scales


def images(count: int, size: int, seed: int, device: torch.device) -> np.ndarray:
    """(count, size, size, 3) uint8 keyframes, made on the device and handed
    over as host arrays, as the builder hands decoded frames."""
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    px = torch.randint(0, 256, (count, size, size, 3), generator=gen, device=device,
                       dtype=torch.uint8)
    return px.cpu().numpy()


def noisy_queries(rows: torch.Tensor, scales: torch.Tensor, n_rows: int, count: int,
                  noise: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(count, dim) float32 host queries, each an indexed row (dequantized)
    plus Gaussian noise of norm about ``noise``, and the source row ids."""
    device = rows.device
    gen = torch.Generator(device=device).manual_seed(seed64(seed) ^ 0x5EED)
    src = torch.randint(0, n_rows, (count,), generator=gen, device=device)
    base = rows[src].float() * scales[src, None]
    q = base + torch.randn(base.shape, generator=gen, device=device) * (noise / base.shape[1] ** 0.5)
    return q.cpu().numpy(), src.cpu().numpy()


# -- text queries ------------------------------------------------------------

_VOCAB = """
man woman child boy girl people crowd person driver player singer dancer reporter police
soldier chef teacher doctor farmer worker student fisherman vendor tourist runner cyclist
dog cat horse cow bird duck chicken fish elephant buffalo monkey
car truck bus motorbike bicycle boat ship train plane helicopter tractor scooter taxi
street road bridge river lake sea beach mountain hill forest field garden park market
house building tower temple church school hospital stadium station airport shop kitchen
office classroom stage studio factory farm village city harbor
red blue green yellow white black orange purple pink brown gray golden silver
big small tall short old young long wide bright dark crowded empty wet dry sunny rainy
snowy foggy busy quiet colorful wooden modern traditional
riding walking running standing sitting holding carrying wearing driving crossing eating
drinking talking singing dancing playing cooking selling building painting reading
waving jumping swimming climbing pushing pulling opening watching fishing
jacket shirt dress hat helmet umbrella bag flag sign banner screen table chair lamp window
door fence wall roof tree flower grass rock sand water fire smoke light cloud sky
at night during the day in the morning in the evening near next to behind under above
in front of on top of inside outside along across around between with without and the a
two three four several many few some one logo text caption scoreboard microphone camera
""".split()


def _zipf_probs(n: int, a: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def word_counts(n: int) -> np.ndarray:
    """The fixed multiset of ``n`` query lengths, 5 to 40 words with a heavy
    tail (lognormal around 12). Five, not four: "a photo of" and one word
    allow only as many distinct queries as the vocabulary has words."""
    rng = np.random.default_rng(WORK_SEED)
    return np.clip(np.round(rng.lognormal(np.log(12.0), 0.5, n)), 5, 40).astype(int)


def text_queries(n: int, seed: int) -> list[str]:
    """``n`` distinct descriptive queries ("a photo of ..."), lengths from
    :func:`word_counts` in an order drawn from ``seed``; words by Zipf's
    law, or uniformly where Zipf keeps repeating a query already drawn."""
    rng = np.random.default_rng(seed64(seed))
    counts = rng.permutation(word_counts(n))
    zipf = _zipf_probs(len(_VOCAB))
    order = rng.permutation(len(_VOCAB))
    out, seen = [], set()
    for c in counts:
        for attempt in range(1000):
            probs = zipf if attempt < 20 else None
            words = [_VOCAB[order[j]] for j in rng.choice(len(_VOCAB), int(c) - 3, p=probs)]
            text = " ".join(["a", "photo", "of", *words])
            if text not in seen:
                break
        else:
            raise RuntimeError(f"no distinct query of {c} words left")
        seen.add(text)
        out.append(text)
    return out


def poisson_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds) of an open-loop Poisson schedule at
    ``rate``: the fixed multiset of gaps of ``round(rate * seconds)``
    arrivals, in an order drawn from ``seed``."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(WORK_SEED).exponential(1.0, n + 1)
    gaps = np.random.default_rng(seed64(seed)).permutation(gaps)
    t = np.cumsum(gaps)
    return (t[:n] / t[n] * seconds).astype(np.float64)
