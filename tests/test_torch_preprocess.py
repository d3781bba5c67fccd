"""The port's ``normalize_images`` (kernel B5's wrapper and plain version)
against the JAX package's two normalizes.

- ``interpret=True`` runs the JAX Pallas kernel, whose arithmetic the port
  repeats (multiply by the f32 reciprocals of 255 and of std, three
  roundings). The port is held bit for bit to that arithmetic written out
  in numpy. XLA's CPU backend, which runs interpret mode here, contracts
  ``x * (1/255) - mean`` into one fused multiply-add (shown below by a numpy
  emulation that equals it bit for bit), so against interpret mode itself
  the f32 outputs agree to two ulps at the outputs' magnitude (5e-7: one
  ulp of the intermediate times ``1/std``, and the last product's own
  rounding) and the bf16 outputs to one bf16 step on under 1% of elements.
- ``use_pallas=False`` is what the JAX callers take; it divides. The two
  differ by an f32 ulp or two: ``atol=1e-5`` in f32, at most one bf16 step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.ops import preprocess as jpre
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import preprocess as tpre

# HF ViT/DINO image processor constants (ImageNet)
DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)
CONSTANTS = {"clip": (jpre.CLIP_IMAGE_MEAN, jpre.CLIP_IMAGE_STD),
             "dino": (DINO_MEAN, DINO_STD)}


def _images(kind):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (3, 16, 24, 3))
    img[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [1, 127, 254], [128, 64, 32]]
    if kind == "uint8":
        return img.astype(np.uint8)
    # float pixels as the resize leaves them: not whole numbers
    return (img + rng.uniform(-0.4, 0.4, img.shape)).clip(0, 255).astype(np.float32)


def _kernel_arithmetic(img, mean, std, fused=False):
    """The TPU kernel's expression in numpy f32: three roundings, or two
    when ``fused`` takes ``x * (1/255) - mean`` as one multiply-add."""
    x = img.astype(np.float32)
    inv255 = np.float32(1.0 / 255.0)
    m = np.asarray(mean, np.float64).astype(np.float32)
    inv_s = (1.0 / np.asarray(std, np.float64)).astype(np.float32)
    if fused:
        centred = (x.astype(np.float64) * np.float64(inv255)
                   - m.astype(np.float64)).astype(np.float32)
    else:
        centred = x * inv255 - m
    return centred * inv_s


def _bf16_steps(a, b):
    """Distance in bf16 steps between two arrays of bf16 values held in f32."""
    ia = (a.view(np.uint32) >> 16).astype(np.int64)
    ib = (b.view(np.uint32) >> 16).astype(np.int64)
    # sign-magnitude to a monotonic integer line
    ia = np.where(ia & 0x8000, 0x8000 - ia, ia)
    ib = np.where(ib & 0x8000, 0x8000 - ib, ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("consts", ["clip", "dino"])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_f32_matches_both_jax_normalizes(kind, consts):
    mean, std = CONSTANTS[consts]
    img = _images(kind)
    got = tpre.normalize_images(torch.from_numpy(img), mean, std, torch.float32).numpy()
    kernel = np.asarray(jpre.normalize_images(jnp.asarray(img), mean, std, jnp.float32,
                                              interpret=True))
    np.testing.assert_array_equal(got, _kernel_arithmetic(img, mean, std))
    np.testing.assert_array_equal(kernel, _kernel_arithmetic(img, mean, std, fused=True))
    np.testing.assert_allclose(got, kernel, atol=5e-7, rtol=0)
    plain = np.asarray(jpre.normalize_images(jnp.asarray(img), mean, std, jnp.float32,
                                             use_pallas=False))
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("consts", ["clip", "dino"])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_bf16_matches_both_jax_normalizes(kind, consts):
    mean, std = CONSTANTS[consts]
    img = _images(kind)
    got = tpre.normalize_images(torch.from_numpy(img), mean, std, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == img.shape
    got = got.float().numpy()
    kernel = np.asarray(jpre.normalize_images(jnp.asarray(img), mean, std, jnp.bfloat16,
                                              interpret=True), np.float32)
    steps = _bf16_steps(got, kernel)
    assert steps.max() <= 1 and (steps > 0).mean() < 0.01
    plain = np.asarray(jpre.normalize_images(jnp.asarray(img), mean, std, jnp.bfloat16,
                                             use_pallas=False), np.float32)
    assert _bf16_steps(got, plain).max() <= 1


def test_wrapper_on_cpu_is_the_plain_version_and_defaults_are_clips():
    img = torch.from_numpy(_images("uint8"))
    before = tpre.normalize_images.launches
    a = tpre.normalize_images(img)
    b = tpre.normalize_images_reference(img, tpre.CLIP_IMAGE_MEAN, tpre.CLIP_IMAGE_STD)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert tpre.normalize_images.launches == before  # no kernel ran on the CPU
    assert tpre.CLIP_IMAGE_MEAN == jpre.CLIP_IMAGE_MEAN
    assert tpre.CLIP_IMAGE_STD == jpre.CLIP_IMAGE_STD


def test_preprocess_chain_still_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    want = jpre.preprocess_images(jnp.asarray(img), image_size=32, dtype=jnp.float32,
                                  use_pallas=False)
    got = tpre.preprocess_images(torch.from_numpy(img), image_size=32, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_constants_must_have_three_channels():
    with pytest.raises(ValueError):
        tpre.normalize_images(torch.zeros(1, 2, 2, 3), mean=(0.5,), std=(0.5,))
