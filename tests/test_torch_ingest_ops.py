"""Parity of the port's ingest ops with the JAX package's.

The same seeded numpy inputs go through ``ops/quality.py``, ``ops/phash.py``
and ``ops/dedup.py`` of both packages (the JAX ones jitted on the CPU, as
``tests/test_ingest.py`` runs them), the port's on CPU tensors.

- Quality scores: ``rtol`` 1e-5 (f32 sums in another order). Edge density
  counts pixels against two thresholds, so its inputs are held at least
  1e-3 from both in f64 (the f32 gray and Sobel sums of pixels up to 255
  carry ~1e-4 of rounding), asserted in the test.
- Masks are compared for equality on inputs whose margins from every
  threshold are at least 1e-5, computed in f64 and asserted in the test:
  the quality mask (both packages fed the same score arrays), the phash
  bits, the five dedup masks and the cluster representatives. An f64
  reference of each scan gives both the margins and the expected mask.
- The ``torch.median`` trap: two middle coefficients that are neighbouring
  floats, whose f32 mean rounds up to the upper one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.ops import dedup as jdedup
from intelligent_video_analysis_retrieval_system_tpu.ops import phash as jphash
from intelligent_video_analysis_retrieval_system_tpu.ops import quality as jquality
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import dedup as tdedup
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import phash as tphash
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quality as tquality
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.preprocess import (
    _interp_matrix,
)

torch.set_num_threads(2)

MARGIN = 1e-5
GRAY = np.array([0.299, 0.587, 0.114])


def _images(seed: int, n: int = 6, h: int = 36, w: int = 44) -> np.ndarray:
    """uint8 frames of rising contrast around mid grey (low-contrast ones put
    Sobel magnitudes in the weak band), one flat frame."""
    rng = np.random.default_rng(seed)
    amps = np.linspace(4.0, 127.0, n)[:, None, None, None]
    x = 128.0 + amps * rng.uniform(-1.0, 1.0, (n, h, w, 3))
    x[-1] = 90.0
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def _sobel_mag64(images: np.ndarray) -> np.ndarray:
    g = images.astype(np.float64) @ GRAY
    k = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    h, w = g.shape[1:]

    def conv(kernel):
        return sum(kernel[a, b] * g[:, a:a + h - 2, b:b + w - 2]
                   for a in range(3) for b in range(3))
    return np.sqrt(conv(k) ** 2 + conv(k.T) ** 2)


def test_rgb_to_gray_matches_jax():
    img = _images(0)
    want = np.asarray(jquality.rgb_to_gray(jnp.asarray(img.astype(np.float32))))
    got = tquality.rgb_to_gray(torch.from_numpy(img)).numpy()
    assert got.dtype == np.float32 and got.shape == img.shape[:3]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(6, 36, 44), (3, 17, 9)])
def test_quality_scores_match_jax(shape):
    img = _images(1, *shape)
    mag = _sobel_mag64(img)
    assert min(np.abs(mag - 50.0).min(), np.abs(mag - 150.0).min()) >= 1e-3
    metrics_j = jquality.quality_metrics(jnp.asarray(img.astype(np.float32)))
    metrics_t = tquality.quality_metrics(torch.from_numpy(img))
    for key in ("blur", "edges"):
        want, got = np.asarray(metrics_j[key]), metrics_t[key].numpy()
        assert got.shape == (shape[0],) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # the flat frame: no edge and no Laplacian energy; the weak band is used
    assert metrics_t["blur"][-1] == 0 and metrics_t["edges"][-1] == 0
    assert np.any((mag > 50.0) & (mag < 150.0)) and np.any(mag > 150.0)


def test_sobel_orientation_is_cross_correlation():
    """A horizontal ramp: the x filter sees it with the reference's sign."""
    ramp = np.tile(np.arange(10, dtype=np.float32) * 30.0, (1, 8, 1))[..., None]
    gray = torch.from_numpy(ramp[..., 0])
    gx = tquality._conv3x3(gray, tquality._SOBEL_X)
    gy = tquality._conv3x3(gray, tquality._SOBEL_Y)
    assert torch.all(gx == 240.0) and torch.all(gy == 0.0)


@pytest.mark.parametrize("percentiles", [(10.0, 10.0), (0.0, 0.0), (5.0, 25.0), (50.0, 2.0)])
def test_adaptive_quality_mask_matches_jax(percentiles):
    rng = np.random.default_rng(2)
    blur = rng.gamma(2.0, 300.0, 37).astype(np.float32)
    edges = rng.uniform(0.0, 0.6, 37).astype(np.float32)
    for scores, p in ((blur, percentiles[0]), (edges, percentiles[1])):
        thr = np.percentile(scores.astype(np.float64), p)
        gap = np.abs(scores - thr) / max(abs(thr), 1e-30)
        # a score either is the threshold (an order statistic hit exactly) or
        # lies well clear of it
        assert np.all((gap >= MARGIN) | (scores.astype(np.float64) == thr))
    want = np.asarray(jquality.adaptive_quality_mask(jnp.asarray(blur), jnp.asarray(edges),
                                                     *percentiles))
    got = tquality.adaptive_quality_mask(torch.from_numpy(blur), torch.from_numpy(edges),
                                         *percentiles).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any()


def _phash_low64(images: np.ndarray) -> np.ndarray:
    g = images.astype(np.float64) @ GRAY
    a_h = _interp_matrix(32, g.shape[1], "bilinear", True).astype(np.float64)
    a_w = _interp_matrix(32, g.shape[2], "bilinear", True).astype(np.float64)
    g32 = np.einsum("oh,bhw,pw->bop", a_h, g, a_w)
    c = tphash._dct_basis(32).astype(np.float64)
    coeffs = np.einsum("ij,bjk,lk->bil", c, g32, c)
    return coeffs[:, :8, :8].reshape(len(images), 64)


def test_perceptual_hash_matches_jax():
    img = _images(3, 7, 48, 40)[2:-1]      # no flat frame: its 63 AC coefficients tie
    low = _phash_low64(img)
    med = np.median(low, axis=1, keepdims=True)
    assert np.all(np.abs(low - med) >= MARGIN * np.abs(low).max(axis=1, keepdims=True))
    ordered = np.sort(low, axis=1)
    assert np.all(ordered[:, 31] < ordered[:, 32])   # two middle values that differ
    want = np.asarray(jphash.perceptual_hash(jnp.asarray(img.astype(np.float32))))
    got = tphash.perceptual_hash(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == (4, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (low > med).astype(np.uint8))


def test_median_is_the_mean_of_the_two_middle_values_not_torch_median():
    """The two middle coefficients 1 + 1 ulp and 1 + 2 ulps: their f32 mean
    rounds to the upper one, so its bit is 0 under jnp.median and would be 1
    under torch.median (the lower middle value)."""
    rng = np.random.default_rng(4)
    one = np.float32(1.0)
    middle = [one + np.float32(2.0 ** -23), one + np.float32(2.0 ** -22)]
    low = np.stack([rng.permutation(np.concatenate([
        np.linspace(-5.0, 0.5, 31), middle, np.linspace(2.0, 9.0, 31)]))
        for _ in range(3)]).astype(np.float32)
    want = np.asarray(low > jnp.median(jnp.asarray(low), axis=1, keepdims=True))
    got = tphash._bits_above_median(torch.from_numpy(low)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    assert got.sum(axis=1).tolist() == [31, 31, 31]
    lower = torch.median(torch.from_numpy(low), dim=1, keepdim=True).values
    assert not np.array_equal((torch.from_numpy(low) > lower).numpy(), want)


def test_hamming_distance_and_phash_dedup_mask_match_jax():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 2, (6, 64)).astype(np.uint8)
    hashes = np.repeat(base, 3, axis=0)
    flips = rng.integers(0, 64, (len(hashes), 7))
    for i, row in enumerate(flips):
        hashes[i, row[: i % 8]] ^= 1          # 0..7 flipped bits: both sides of 5
    want = np.asarray(jphash.hamming_distance(jnp.asarray(hashes), jnp.asarray(base)))
    got = tphash.hamming_distance(torch.from_numpy(hashes), torch.from_numpy(base))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for threshold in (0, 5, 64):
        want = jphash.phash_dedup_mask(jnp.asarray(hashes), threshold)
        np.testing.assert_array_equal(tphash.phash_dedup_mask(torch.from_numpy(hashes),
                                                              threshold), want)
        np.testing.assert_array_equal(tphash.phash_dedup_mask(hashes, threshold), want)


# ---------------------------------------------------------------------------
# dedup: f64 references of the reference's scans (mask and least margin)
# ---------------------------------------------------------------------------


def _unit64(x):
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _last_kept64(emb, carry, thr, active=None):
    emb, last = _unit64(emb), np.asarray(carry, np.float64)
    keep, margin = [], np.inf
    for i, e in enumerate(emb):
        live = active is None or bool(active[i])
        sim = float(last @ e)
        if live:
            margin = min(margin, abs(sim - thr))
        k = live and sim < thr
        if k:
            last = e
        keep.append(k)
    return np.array(keep), margin


def _windowed64(emb, thr, window):
    emb = _unit64(emb)
    buf, pos = np.zeros((window, emb.shape[1])), 0
    keep, margin = [], np.inf
    for e in emb:
        best = float((buf @ e).max())
        margin = min(margin, abs(best - thr))
        k = best < thr
        if k:
            buf[pos % window] = e
            pos += 1
        keep.append(k)
    return np.array(keep), margin


def _scenes(seed: int, n: int, d: int = 32, noise: float = 0.15,
            runs=(2, 3, 4, 5, 6, 7, 8)) -> np.ndarray:
    """Runs of noisy copies of a random direction (lengths drawn from
    ``runs``): within a run cosines straddle 0.98 at the default noise,
    across runs they are near 0."""
    rng = np.random.default_rng(seed)
    rows = []
    while len(rows) < n:
        base = rng.standard_normal(d)
        rows += [base + noise * rng.standard_normal(d) for _ in range(rng.choice(runs))]
    return np.asarray(rows[:n], np.float32)


def test_sequential_dedup_matches_jax():
    emb = _scenes(6, 70)
    want64, margin = _last_kept64(emb[1:], _unit64(emb[0]), 0.98)
    assert margin >= MARGIN and 0 < want64.sum() < len(want64)
    want = np.asarray(jdedup.sequential_dedup(jnp.asarray(emb), 0.98))
    got = tdedup.sequential_dedup(torch.from_numpy(emb), 0.98)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[1:], want64)
    for n in (0, 1):
        assert tdedup.sequential_dedup(torch.from_numpy(emb[:n])).tolist() == [True] * n


def test_sequential_dedup_carry_matches_jax_across_batches():
    emb = _scenes(7, 90)
    want64, margin = _last_kept64(emb, np.zeros(32), 0.98)
    assert margin >= MARGIN
    carry_j, carry_t, got, want = jnp.zeros(32), torch.zeros(32), [], []
    for s in range(0, 90, 32):
        kj, carry_j = jdedup.sequential_dedup_carry(jnp.asarray(emb[s:s + 32]), carry_j, 0.98)
        kt, carry_t = tdedup.sequential_dedup_carry(torch.from_numpy(emb[s:s + 32]), carry_t,
                                                    0.98)
        want.append(np.asarray(kj))
        got.append(kt.numpy())
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    np.testing.assert_array_equal(np.concatenate(got), want64)
    np.testing.assert_allclose(carry_t.numpy(), np.asarray(carry_j), atol=1e-6)
    empty, same = tdedup.sequential_dedup_carry(torch.zeros((0, 32)), carry_t)
    assert empty.shape == (0,) and same is carry_t


def test_sequential_dedup_carry_masked_matches_jax():
    emb = _scenes(8, 64)
    active = np.random.default_rng(8).uniform(size=64) < 0.7
    active[50:] = False                     # the padded tail of a batch
    want64, margin = _last_kept64(emb, np.zeros(32), 0.98, active)
    assert margin >= MARGIN
    kj, cj = jdedup.sequential_dedup_carry_masked(jnp.asarray(emb), jnp.zeros(32),
                                                  jnp.asarray(active), 0.98)
    kt, ct = tdedup.sequential_dedup_carry_masked(torch.from_numpy(emb), torch.zeros(32),
                                                  torch.from_numpy(active), 0.98)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(kt.numpy(), want64)
    assert not kt.numpy()[~active].any()
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)


@pytest.mark.parametrize("window", [1, 3, 5])
def test_windowed_dedup_mask_matches_jax(window):
    emb = _scenes(9, 60, noise=0.25)
    want64, margin = _windowed64(emb, 0.95, window)
    assert margin >= MARGIN and 0 < want64.sum() < len(want64)
    want = np.asarray(jdedup.windowed_dedup_mask(jnp.asarray(emb), 0.95, window))
    got = tdedup.windowed_dedup_mask(torch.from_numpy(emb), 0.95, window)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want64)
    assert tdedup.windowed_dedup_mask(torch.zeros((0, 8))).shape == (0,)


@pytest.mark.parametrize("eps", [0.02, 0.05])
def test_cluster_representatives_mask_matches_jax(eps):
    # a cluster of two is a tie for the representative (both members lie at
    # the same cosine from their centroid), so runs are 1 or 3-8 long
    emb = _scenes(10, 42, noise=0.04, runs=(1, 3, 4, 5, 6, 7, 8))
    unit = _unit64(emb)
    dist = 1.0 - unit @ unit.T
    iu = np.triu_indices(len(emb), 1)
    assert np.abs(dist[iu] - eps).min() >= MARGIN
    # each cluster's representative: its nearest member to the centroid by
    # at least the margin
    label = np.arange(len(emb))
    for _ in range(len(emb)):
        label = np.min(np.where(dist <= eps, label[None, :], len(emb)), axis=1)
    for c in np.unique(label):
        sub = unit[label == c]
        assert len(sub) != 2
        if len(sub) > 2:
            centroid = sub.mean(axis=0) / np.linalg.norm(sub.mean(axis=0))
            top2 = np.sort(sub @ centroid)[-2:]
            assert top2[1] - top2[0] >= MARGIN
    want = jdedup.cluster_representatives_mask(emb, eps=eps)
    for given in (emb, torch.from_numpy(emb)):
        got = tdedup.cluster_representatives_mask(given, eps=eps)
        assert isinstance(got, np.ndarray) and got.dtype == bool
        np.testing.assert_array_equal(got, want)
    assert 1 < want.sum() < len(emb)
    assert tdedup.cluster_representatives_mask(emb[:1]).tolist() == [True]
    assert tdedup.cluster_representatives_mask(emb[:0]).shape == (0,)
