"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here needs an NVIDIA card and ``nvcc`` (the hand-written kernels
have no CPU mode), carries the ``cuda`` marker and skips elsewhere. The file
imports no JAX, so it runs on a machine without it; there the repo's
``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: B1 chunk maxima 1e-3 (the kernel sums in another order than
the f32 matmul of the plain version); top-k tie-aware (5e-4); B3 f32 1e-5,
bf16 2e-2. B2 (int8) is exact: chunk maxima ``torch.equal`` to the plain
version, top-k tie-aware with atol 0 against the full-matrix reference.
B5 (normalize) has no sum and is ``torch.equal`` to its plain version. B4
(LN+MLP): f32 5e-5 (sums in another order, ``rsqrtf``), bf16 max abs
difference at most 0.01 of the output's max abs (the same rounding points;
a sum or an ``exp`` that lands on the other side of a bf16 boundary moves
an element by one step).
"""

import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention as tatt
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import block as tblock
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import preprocess as tpre
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant as tq
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import topk as ttopk
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 20, 33, 128, 160])
@pytest.mark.parametrize("d", [96, 40])
def test_chunk_max_kernel_matches_plain(cuda_device, dtype, b, d):
    gen = torch.Generator(device=cuda_device).manual_seed(b)
    x = torch.randn(8192, d, generator=gen, device=cuda_device).to(dtype)
    q = torch.randn(b, d, generator=gen, device=cuda_device).to(dtype)
    dead = (torch.rand(8192, generator=gen, device=cuda_device) < 0.01).to(torch.int8)
    before = ttopk.chunk_max_sweep.launches
    got = ttopk.chunk_max_sweep(x, q, 8000, dead)
    torch.cuda.synchronize()
    assert ttopk.chunk_max_sweep.launches == before + 1
    assert got.shape == (8192 // ttopk.CHUNK, b)
    want = ttopk.chunk_max_plain(x, q, 8000, dead)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_topk_search_on_card_matches_reference(cuda_device, dtype, k):
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.nn.functional.normalize(
        torch.randn(20000, 64, generator=gen, device=cuda_device), dim=-1).to(dtype)
    q = torch.nn.functional.normalize(
        torch.randn(5, 64, generator=gen, device=cuda_device), dim=-1).to(dtype)
    dead = (torch.rand(20000, generator=gen, device=cuda_device) < 0.01).to(torch.int8)
    res = ttopk.topk_search(x, q, k, n_valid=19000, deleted=dead)
    ref = ttopk.topk_masked_reference(x, q, k, 19000, deleted=dead)
    for i in range(5):
        tie_aware_equal(res.indices[i].cpu().numpy(), res.scores[i].cpu().numpy(),
                        ref.indices[i].cpu().numpy(), ref.scores[i].cpu().numpy())


def test_chunk_max_refuses_misaligned_rows(cuda_device):
    x = torch.zeros(ttopk.TILE_N * 16 + 1, dtype=torch.bfloat16, device=cuda_device)
    x = x[1:].view(ttopk.TILE_N, 16)  # 2-byte offset
    with pytest.raises(ValueError):
        ttopk.chunk_max_sweep(x, torch.zeros(2, 16, dtype=torch.bfloat16,
                                             device=cuda_device), 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 64, 4), (1, 257, 1024, 16), (2, 50, 768, 12),
                                   (1, 33, 120, 3), (2, 20, 36, 3)])
def test_mha_kernel_matches_plain(cuda_device, dtype, shape):
    b, t, d, h = shape
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    q, k, v = (torch.randn(b, t, d, generator=gen, device=cuda_device).to(dtype)
               for _ in range(3))
    before = tatt.fused_mha.launches
    got = tatt.fused_mha(q, k, v, h)
    torch.cuda.synchronize()
    assert tatt.fused_mha.launches == before + 1
    want = tatt._einsum_attention(q, k, v, h)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_mha_gradient_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ts = [torch.randn(2, 17, 32, generator=gen, device=cuda_device).requires_grad_(True)
          for _ in range(3)]
    g = torch.randn(2, 17, 32, generator=gen, device=cuda_device)
    tatt.fused_mha(*ts, 4).backward(g)
    refs = [t.detach().clone().requires_grad_(True) for t in ts]
    tatt._einsum_attention(*refs, 4).backward(g)
    for t, r in zip(ts, refs):
        torch.testing.assert_close(t.grad, r.grad, atol=1e-5, rtol=1e-5)


def _int8_rows(gen, n, d, device):
    """Quantized unit rows with exact duplicates (ties) across chunks."""
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device=device), dim=-1)
    x[[3, 700, 5000]] = x[1234].clone()
    x_i8, xs = tq.symmetric_int8(x, dim=-1)
    return x_i8, xs[:, 0].contiguous()


@pytest.mark.parametrize("b", [1, 8, 20, 33, 64, 128, 160])
@pytest.mark.parametrize("d", [768, 64])
def test_int8_chunk_max_kernel_matches_plain(cuda_device, b, d):
    gen = torch.Generator(device=cuda_device).manual_seed(b * d)
    x_i8, xs = _int8_rows(gen, 8192, d, cuda_device)
    q_i8, _ = tq.symmetric_int8(torch.randn(b, d, generator=gen, device=cuda_device), dim=-1)
    dead = (torch.rand(8192, generator=gen, device=cuda_device) < 0.01).to(torch.int8)
    before = tq.int8_chunk_max_sweep.launches
    got = tq.int8_chunk_max_sweep(x_i8, xs, q_i8, 8000, dead)
    torch.cuda.synchronize()
    # one launch per 64 queries of the padded batch
    assert tq.int8_chunk_max_sweep.launches == before + -(-ttopk.bucket_b(b) // 64)
    assert got.shape == (8192 // ttopk.CHUNK, b)
    want = tq.int8_chunk_max_plain(x_i8, xs, q_i8, 8000, dead)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_int8_topk_search_on_card_matches_reference(cuda_device, k):
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    x_i8, xs = _int8_rows(gen, 20480, 64, cuda_device)
    q = torch.randn(5, 64, generator=gen, device=cuda_device)
    q[0] = x_i8[1234].float()
    dead = (torch.rand(20480, generator=gen, device=cuda_device) < 0.01).to(torch.int8)
    dead[[3, 700, 5000, 1234]] = 0
    before = tq.int8_chunk_max_sweep.launches
    res = tq.topk_search_int8(x_i8, xs, q, k, n_valid=19000, deleted=dead)
    assert tq.int8_chunk_max_sweep.launches == before + 1   # phase 1 ran B2
    ref = tq.int8_reference(x_i8[:19000], xs[:19000], q, k, deleted=dead)
    for i in range(5):
        tie_aware_equal(res.indices[i].cpu().numpy(), res.scores[i].cpu().numpy(),
                        ref.indices[i].cpu().numpy(), ref.scores[i].cpu().numpy(), atol=0.0)
    if k >= 4:
        assert sorted(res.indices[0, :4].tolist()) == [3, 700, 1234, 5000]


def test_int8_chunk_max_refuses_bad_input(cuda_device):
    n = ttopk.TILE_N
    xs = torch.ones(n, device=cuda_device)
    q = torch.zeros(2, 32, dtype=torch.int8, device=cuda_device)
    raw = torch.zeros(n * 32 + 1, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):   # 1-byte offset
        tq.int8_chunk_max_sweep(raw[1:].view(n, 32), xs, q, 10)
    with pytest.raises(ValueError):   # rows not padded to TILE_N
        tq.int8_chunk_max_sweep(torch.zeros(n - 128, 32, dtype=torch.int8, device=cuda_device),
                                xs[:n - 128], q, 10)
    with pytest.raises(ValueError):   # a row of 24 bytes
        tq.int8_chunk_max_sweep(torch.zeros(n, 24, dtype=torch.int8, device=cuda_device), xs,
                                torch.zeros(2, 24, dtype=torch.int8, device=cuda_device), 10)
    with pytest.raises(ValueError):   # no plain search on the card
        tq.topk_search_int8(torch.zeros(n, 32, dtype=torch.int8, device=cuda_device), xs,
                            torch.zeros(2, 32, device=cuda_device), 3, use_pallas=False)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape", [(1, 3, 5, 3), (2, 32, 32, 3), (8, 224, 224, 3),
                                   (256, 224, 224, 3)])
def test_normalize_kernel_equals_plain(cuda_device, shape, in_dtype, out_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0])
    img = torch.randint(0, 256, shape, generator=gen, device=cuda_device, dtype=torch.uint8)
    if in_dtype == torch.float32:
        img = img.float() + torch.rand(shape, generator=gen, device=cuda_device) - 0.5
    before = tpre.normalize_images.launches
    got = tpre.normalize_images(img, dtype=out_dtype)
    torch.cuda.synchronize()
    assert tpre.normalize_images.launches == before + 1
    assert got.dtype == out_dtype and got.shape == img.shape
    want = tpre.normalize_images_reference(img, tpre.CLIP_IMAGE_MEAN, tpre.CLIP_IMAGE_STD,
                                           out_dtype)
    assert torch.equal(got, want)
    # and the same bits as the plain version computed on the host
    host = tpre.normalize_images(img.cpu(), dtype=out_dtype)
    assert torch.equal(got.cpu(), host)


def test_normalize_kernel_misaligned_view_and_other_constants(cuda_device):
    base = torch.randint(0, 256, (2 * 7 * 5 * 3 + 3,), device=cuda_device, dtype=torch.uint8)
    img = base[3:].view(2, 7, 5, 3)           # data pointer 3 bytes past an allocation
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = tpre.normalize_images(img, mean, std, torch.float32)
    assert torch.equal(got, tpre.normalize_images_reference(img, mean, std, torch.float32))
    crop = torch.rand(2, 9, 9, 3, device=cuda_device)[:, 1:8, 1:8]   # not contiguous
    got = tpre.normalize_images(crop, dtype=torch.bfloat16)
    assert torch.equal(got, tpre.normalize_images_reference(
        crop, tpre.CLIP_IMAGE_MEAN, tpre.CLIP_IMAGE_STD, torch.bfloat16))


def test_normalize_kernel_refuses_bad_input(cuda_device):
    with pytest.raises(TypeError):
        tpre.normalize_images(torch.zeros(1, 2, 2, 3, device=cuda_device, dtype=torch.int32))
    with pytest.raises(TypeError):
        tpre.normalize_images(torch.zeros(1, 2, 2, 3, device=cuda_device),
                              dtype=torch.float16)
    with pytest.raises(ValueError):
        tpre.normalize_images(torch.zeros(1, 2, 2, 4, device=cuda_device))


def _ln_mlp_args(device, tokens_shape, d, h, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = randn(*tokens_shape, d).to(dtype)
    return (x, 1.0 + 0.1 * randn(d), 0.1 * randn(d),
            (randn(h, d) / d ** 0.5).to(dtype), 0.1 * randn(h),
            (randn(d, h) / h ** 0.5).to(dtype), 0.1 * randn(d))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [((2, 9), 256, 512), ((37,), 128, 256), ((3, 50), 768, 3072),
                                   ((8, 77), 512, 2048), ((2, 257), 1024, 4096),
                                   ((1, 33), 384, 768)])
def test_ln_mlp_kernel_matches_plain(cuda_device, shape, dtype, act):
    tokens_shape, d, h = shape
    args = _ln_mlp_args(cuda_device, tokens_shape, d, h, dtype, seed=d + h)
    before = tblock.fused_ln_mlp.launches
    got = tblock.fused_ln_mlp(*args, act=act)
    torch.cuda.synchronize()
    assert tblock.fused_ln_mlp.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    want = tblock.fused_ln_mlp_reference(*args, act=act)
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
    else:
        diff = (got.float() - want.float()).abs().max().item()
        assert diff <= 0.01 * want.float().abs().max().item(), diff


def test_ln_mlp_kernel_full_batch_shape(cuda_device):
    # the build path's shape: 256 images x 257 tokens of ViT-L/14
    args = _ln_mlp_args(cuda_device, (256, 257), 1024, 4096, torch.bfloat16, seed=1)
    got = tblock.fused_ln_mlp(*args)
    want = tblock.fused_ln_mlp_reference(*args)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= 0.01 * want.float().abs().max().item(), diff


def test_ln_mlp_kernel_refuses_bad_input(cuda_device):
    args = _ln_mlp_args(cuda_device, (2, 3), 256, 512, torch.float32, seed=2)
    with pytest.raises(ValueError):
        tblock.fused_ln_mlp(*args, act="relu")
    with pytest.raises(TypeError):
        tblock.fused_ln_mlp(args[0].to(torch.float16), *args[1:])
    with pytest.raises(ValueError):      # d past the kernel's register tile
        tblock.fused_ln_mlp(*_ln_mlp_args(cuda_device, (2,), 1280, 5120,
                                          torch.bfloat16, seed=3))
    with pytest.raises(ValueError):      # weights on another device
        tblock.fused_ln_mlp(args[0], *(a.cpu() for a in args[1:]))
