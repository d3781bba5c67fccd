"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here needs an NVIDIA card and ``nvcc`` (the hand-written kernels
have no CPU mode), carries the ``cuda`` marker and skips elsewhere. The file
imports no JAX, so it runs on a machine without it; there the repo's
``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: B1 chunk maxima 1e-3 (the kernel sums in another order than
the f32 matmul of the plain version), and in bf16 the same bits over 50
launches beside B3 on another stream; top-k tie-aware (5e-4); B3 f32 1e-5,
bf16 2e-2. B2 (int8) is exact: chunk maxima ``torch.equal`` to the plain
version, top-k tie-aware with atol 0 against the full-matrix reference.
B5 (normalize) has no sum and is ``torch.equal`` to its plain version. B3 in
bf16 is swept over sequence lengths on both sides of its variants'
boundary and head dims on and off its padding, the ``wgmma`` variant past 272
keys over ragged last query and key tiles and rings wrapped more than once,
an unaligned view (copied) and head dim 36 (padded to 40) on the variant of
their length, the variant the library names and the calls it refuses
against :func:`mha_plan`; B4 in bf16 over every width
class and the token counts around its 64-token tile. B4
(LN+MLP): f32 5e-5 (sums in another order, ``rsqrtf``), bf16 max abs
difference at most 0.01 of the output's max abs (the same rounding points;
a sum or an ``exp`` that lands on the other side of a bf16 boundary moves
an element by one step). The bench probes: P1 (int8 tensor-core sweep) is
exact, ``torch.equal`` to its plain version and to B2 under an all-zero
tombstone mask; P2 (rows widened to bf16) within ``1e-5 x max |score|`` (f32
sums in another order); P3 (memory stream) ``torch.equal``.

The IVF mode (``ops.ann``, torch operations, no kernel of its own) on the
card against the same calls on CPU tensors over one state: int8 bit for bit,
float tie-aware; two card builds bit for bit; a card build against a CPU
build (centroids within 1e-5, the same bucket table but for rows that
near-tie in similarity); full-f32 scores (TF32 off); the batched union
searcher at B=16 over 1M rows, within its gather budget.

The REST server (``serve/rest.py``) over a facade on the card: a served
``/api/search`` launches B1 once, ``/api/image_search`` B5 once and B3 once
per vision layer, and 64 concurrent searches through the batcher answer
what the same searches answer one at a time (tie-aware, 5e-4 plus the
distance between the two query vectors the tower gave in the two batch
sizes), each against the exact reference.

Ingest (``ops/{quality,phash,dedup}.py``, torch operations around B3 and
B5) on the card against the same calls on the CPU: quality scores ``rtol``
1e-5, the quality mask, phash bits and every dedup mask equal; the DINO
tower launches B3 once per layer and B5 once per batch and keeps cosine >=
0.999 against the f32 tower on the CPU; ``FrameFilter.dedup_step`` keeps
the CPU's frames.

The W8A8 towers (``torch._int_mm`` products, torch operations around B3 and
B5): ``w8a8_dense`` on the card ``torch.equal`` to the CPU at the towers'
shapes and at shapes its CUDA route refuses (padded), dynamic and static;
int8 attention at (8, 257, 1024, 16 heads) against the CPU with TF32 asked
for: cosine >= 0.9999 on the same q, k, v (exact integer products, so only
the softmax's last bits differ), >= 0.999 for the layer (its bf16
projections round apart, and p8's fixed 1/127 step amplifies that); a W8A8-static tower calibrated on the card against the same on
the CPU (cosine >= 0.999, six products a layer, B3 once a layer unless
``int8_attn``); the ``int8_static`` embedder freezing after four batches.

Multi-device search (``parallel/``) over one card's logical shards
(``["cuda:0"] * n``, views of one buffer): ``sharded_topk`` (B1 per shard)
tie-aware equal to the single-device ``topk_search``, ``sharded_topk_int8``
(B2 per shard) and ``sharded_ivf_topk`` ``torch.equal`` to the
single-device searches, the launch counts growing by the shards a call; a
mesh-backed index on the card answering as the single-device one. Shards on
distinct cards need more than one card and are not tested here.

CLIP training (``parallel/train.py``) with the tiny config in f32: a step on
the card (``(1, 1)`` and ``(2, 2)`` logical shards) against the same step on
the CPU (loss within 1e-5, each gradient within 1e-4 x its tensor's max |g|;
``k_proj.bias``, whose exact gradient is zero, below 1e-6 x the largest),
B3 launched once per vision layer, data position and model shard and again
in the remat recompute; remat on and off the same loss; a checkpoint
restored bit for bit on its devices, the next loss equal.
"""

import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch import trace
from intelligent_video_analysis_retrieval_system_tpu_torch.bench import probes as tprobes
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann as tann
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


def _b1_inputs(device, n_pad, d, b, seed, dead_share=0.01):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n_pad, d, generator=gen, device=device).to(torch.bfloat16)
    # scores of about unit size at every width, as the index's unit rows give
    q = (torch.randn(b, d, generator=gen, device=device) / d ** 0.5).to(torch.bfloat16)
    dead = (torch.rand(n_pad, generator=gen, device=device) < dead_share).to(torch.int8)
    return x, q, dead


def _b1_check(got, x, q, n_valid, dead):
    want = ttopk.chunk_max_plain(x, q, n_valid, dead)
    assert got.shape == want.shape
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=1e-3, rtol=0)


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("d", [768, 40])
@pytest.mark.parametrize("n_valid", [8192 - 37, 4096 + 77, 130, 1, 0])
def test_chunk_max_bf16_masks_inside_a_stage(cuda_device, n_valid, d, b):
    # n_valid anywhere inside a 128-row stage of the ring, and every row of
    # chunk 5 tombstoned: that chunk is -inf for every query
    x, q, dead = _b1_inputs(cuda_device, 8192, d, b, seed=n_valid + d + b)
    dead[5 * ttopk.CHUNK:6 * ttopk.CHUNK] = 1
    got = ttopk.chunk_max_sweep(x, q, n_valid, dead)
    torch.cuda.synchronize()
    _b1_check(got, x, q, n_valid, dead)
    assert torch.isneginf(got[5]).all()
    assert torch.isneginf(got[-(-n_valid // ttopk.CHUNK):]).all()   # chunks past n_valid


@pytest.mark.parametrize("case", [(2048, 40, 8), (4096, 96, 33), (8192, 768, 64), (2048, 768, 128)])
def test_chunk_max_bf16_reads_nothing_past_its_inputs(cuda_device, case):
    # x, q and the tombstones each end where their allocation ends: the last
    # ring stage, the queries' tiles and the masks' bytes may not form an
    # address past them
    n_pad, d, b = case
    x, q, dead = (_at_the_end_of_a_segment(t)
                  for t in _b1_inputs(cuda_device, n_pad, d, ttopk.bucket_b(b), seed=d))
    for _ in range(3):
        got = ttopk.chunk_max_sweep(x, q, n_pad - 5, dead)
    torch.cuda.synchronize()   # an illegal address surfaces here
    _b1_check(got, x, q, n_pad - 5, dead)


def test_chunk_max_bf16_two_row_tensors_of_one_shape(cuda_device):
    # the tensor map names the rows' address: one encoded for the first x
    # must never serve the second
    x1, q, dead = _b1_inputs(cuda_device, 8192, 768, 8, seed=1)
    x2 = _b1_inputs(cuda_device, 8192, 768, 8, seed=2)[0]
    first = ttopk.chunk_max_sweep(x1, q, 8000, dead)
    second = ttopk.chunk_max_sweep(x2, q, 8000, dead)
    again = ttopk.chunk_max_sweep(x1, q, 8000, dead)
    torch.cuda.synchronize()
    _b1_check(first, x1, q, 8000, dead)
    _b1_check(second, x2, q, 8000, dead)
    assert torch.equal(again, first) and not torch.equal(second, first)


@pytest.mark.parametrize("b", [1, 64])
def test_chunk_max_bf16_at_the_smoke_row_count(cuda_device, b):
    # 1,000,000 rows padded to 1,001,472 (489 tiles of 2,048): the last
    # blocks' share of chunks, and n_valid 1,000 rows short of the rows
    n_pad = -(-1_000_000 // ttopk.TILE_N) * ttopk.TILE_N
    assert n_pad == 1_001_472
    x, q, dead = _b1_inputs(cuda_device, n_pad, 768, b, seed=b, dead_share=1e-3)
    got = ttopk.chunk_max_sweep(x, q, 999_000, dead)
    torch.cuda.synchronize()
    _b1_check(got, x, q, 999_000, dead)


@pytest.mark.parametrize("b", [8, 64])
def test_chunk_max_bf16_gives_the_same_bits_every_launch(cuda_device, b):
    # 50 launches on a second stream while B3 runs on the first: the ring's
    # hand-overs leave the output a function of the inputs to the bit
    x, q, dead = _b1_inputs(cuda_device, 65_536, 768, b, seed=b + 7)
    first = ttopk.chunk_max_sweep(x, q, 65_000, dead)
    torch.cuda.synchronize()
    _b1_check(first, x, q, 65_000, dead)
    qkv = torch.randn(64, 50, 768, device=cuda_device).to(torch.bfloat16)
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = []
    for _ in range(50):
        with torch.cuda.stream(side):
            outs.append(ttopk.chunk_max_sweep(x, q, 65_000, dead))
        tatt.fused_mha(qkv, qkv, qkv, 12)
    torch.cuda.synchronize()
    for i, again in enumerate(outs):
        assert torch.equal(again, first), f"launch {i + 1} differs from the first"


def test_chunk_max_plan_matches_the_library(cuda_device):
    import ctypes

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernels

    lib = kernels.load()
    group, stages, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    blocks, smem = ctypes.c_longlong(), ctypes.c_longlong()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n_pad in (2048, 1_001_472):
        for d in (8, 40, 96, 512, 768, 1024, 4096, 12352):
            for b_pad in (8, 16, 32, 64, 128, 160, 256):
                for count in (0, 64, sms):   # 0: the library asks the device
                    lib.ivars_chunk_max_plan(n_pad, d, b_pad, count, ctypes.byref(group),
                                             ctypes.byref(stages), ctypes.byref(per_sm),
                                             ctypes.byref(blocks), ctypes.byref(smem))
                    plan = ttopk.chunk_max_plan(n_pad, d, b_pad, sm_count=count or sms)
                    assert (group.value, stages.value, per_sm.value, blocks.value,
                            smem.value) == (plan["group"], plan["stages"],
                                            plan["blocks_per_sm"], plan["blocks"],
                                            plan["smem_bytes"]), (n_pad, d, b_pad, count)


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


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dh", [32, 64, 80, 128])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 50, 64, 65, 197, 257, 272, 273, 320])
def test_mha_bf16_kernel_over_sequence_lengths_and_head_dims(cuda_device, t, dh, b):
    # both variants and their boundary (272 | 273 padded keys), every register
    # tile (T_pad <= 64, 128, 272), the one-row last tile (T % 16 == 1), head
    # dims on and off the 32-column padding
    heads = 3
    gen = torch.Generator(device=cuda_device).manual_seed(1000 * t + dh + b)
    q, k, v = (torch.randn(b, t, heads * dh, generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    before = tatt.fused_mha.launches
    got = tatt.fused_mha(q, k, v, heads)
    torch.cuda.synchronize()
    assert tatt.fused_mha.launches == before + 1
    want = tatt._einsum_attention(q, k, v, heads)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    # past 272 keys the wgmma variant
    assert tatt.mha_plan(t, dh)["variant"] == ("registers" if t <= 272 else "wgmma")


def _b3_variants(call):
    """The ``variant`` of every ``attn.b3`` span that ``call`` records."""
    trace.take()   # nothing recorded before
    trace.enable()
    try:
        call()
    finally:
        trace.disable()
    return [s.attrs["variant"] for s in trace.take() if s.name == "attn.b3"]


@pytest.mark.parametrize("dh", [32, 64, 72, 80, 128])
@pytest.mark.parametrize("t", [273, 320, 729, 1100])
def test_mha_wgmma_variant_over_lengths_and_head_dims(cuda_device, t, dh):
    # 273: one real row in the last 192-row group's first warpgroup and none
    # in the others; 729 and 1100: last query tiles of 25 and 48 rows, key
    # counts no multiple of the 64-key tile, 12 and 18 tiles a pass through
    # rings of 4; head dims on and off the 64-column box and the 16-column
    # k-step (72: depth 80, the second box mostly zeros)
    heads = 3
    gen = torch.Generator(device=cuda_device).manual_seed(7 * t + dh)
    q, k, v = (torch.randn(2, t, heads * dh, generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    before = tatt.fused_mha.launches
    out = []
    assert _b3_variants(lambda: out.append(tatt.fused_mha(q, k, v, heads))) == ["wgmma"]
    torch.cuda.synchronize()
    assert tatt.fused_mha.launches == before + 1
    assert tatt.mha_plan(t, dh)["variant"] == "wgmma"
    want = tatt._einsum_attention(q, k, v, heads)
    torch.testing.assert_close(out[0].float(), want.float(), atol=2e-2, rtol=2e-2)


def test_mha_wgmma_variant_at_siglips_vision_shape(cuda_device):
    # SigLIP so400m/14 at 384 px: 729 tokens, 16 heads of 72
    gen = torch.Generator(device=cuda_device).manual_seed(729)
    q, k, v = (torch.randn(2, 729, 1152, generator=gen, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    before = tatt.fused_mha.launches
    out = []
    assert _b3_variants(lambda: out.append(tatt.fused_mha(q, k, v, 16))) == ["wgmma"]
    torch.cuda.synchronize()
    assert tatt.fused_mha.launches == before + 1
    want = tatt._einsum_attention(q, k, v, 16)
    torch.testing.assert_close(out[0].float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("t", [17, 257, 300])
def test_mha_bf16_kernel_on_an_unaligned_view(cuda_device, t):
    # data pointers 2 bytes past an allocation: the wrapper copies them to a
    # 16-byte boundary, and the variant is that of t
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    raw = torch.randn(3, 2 * t * 128 + 1, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = (raw[i, 1:].view(2, t, 128) for i in range(3))
    assert q.data_ptr() % 4 == 2
    out = []
    variants = _b3_variants(lambda: out.append(tatt.fused_mha(q, k, v, 2)))
    assert variants == ["registers" if t <= 272 else "wgmma"]
    assert tatt.mha_plan(t, 64)["variant"] == variants[0]
    want = tatt._einsum_attention(q, k, v, 2)
    torch.testing.assert_close(out[0].float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("t", [300, 729])
def test_mha_pads_a_head_dim_off_8(cuda_device, t):
    # head dim 36: the wrapper pads each head with zeros to 40 columns and
    # keeps 36's scale; past 272 keys the wgmma variant
    gen = torch.Generator(device=cuda_device).manual_seed(36 * t)
    q, k, v = (torch.randn(2, t, 4 * 36, generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    out = []
    assert _b3_variants(lambda: out.append(tatt.fused_mha(q, k, v, 4))) == ["wgmma"]
    plan = tatt.mha_plan(t, 36)
    assert (plan["variant"], plan["head_dim"]) == ("wgmma", 40)
    want = tatt._einsum_attention(q, k, v, 4)
    torch.testing.assert_close(out[0].float(), want.float(), atol=2e-2, rtol=2e-2)


def test_mha_plan_names_the_variant_the_library_takes(cuda_device):
    # ivars_mha_variant is the choice ivars_mha_fwd launches (and the one the
    # attn.b3 span names): by t alone, at the head dim the plan pads to
    import ctypes

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernels

    lib = kernels.load()
    heads = 3
    for t in (1, 64, 257, 272, 273, 300, 577, 729, 4097):
        for dh in (16, 20, 32, 36, 64, 72, 80, 96, 128):
            plan = tatt.mha_plan(t, dh)
            code = lib.ivars_mha_variant(2, t, heads * plan["head_dim"], heads, 0)
            assert tatt._VARIANTS[code] == plan["variant"], (t, dh)
            f32 = lib.ivars_mha_variant(2, t, heads * dh, heads, 1)
            assert tatt._VARIANTS[f32] == "f32"
            # bf16 heads off a multiple of 8 are refused as they come
            unpadded = lib.ivars_mha_variant(2, t, heads * dh, heads, 0)
            assert unpadded == (code if dh % 8 == 0 else -1), (t, dh)
    # what ivars_mha_fwd refuses: a head dim past 128, a dtype it lacks
    assert lib.ivars_mha_variant(2, 729, 3 * 136, 3, 0) == -1
    assert lib.ivars_mha_variant(2, 729, 3 * 64, 3, 2) == -1
    # and a bf16 call off the contract, before any launch: cudaErrorInvalidValue
    buf = torch.zeros(2 * 300 * 144 + 8, dtype=torch.bfloat16, device=cuda_device)
    for offset, d in ((2, 128), (0, 4 * 36)):
        ptr = ctypes.c_void_p(buf.data_ptr() + offset)
        assert lib.ivars_mha_fwd(ptr, ptr, ptr, ptr, 2, 300, d, 4, d // 4, 0, None) == 1


def test_mha_plan_matches_the_library(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernels

    lib = kernels.load()
    for t in (1, 50, 64, 65, 197, 257, 272, 273, 320, 577, 729, 4097):
        for dh in (16, 20, 32, 64, 72, 80, 96, 128):
            plan = tatt.mha_plan(t, dh)
            got = lib.ivars_mha_smem_bytes(t, plan["head_dim"], 0)
            assert got == plan["smem_bytes"], (t, dh)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for t in (1, 50, 64, 65, 128, 129, 257, 272, 273, 577):
        for dh in (64, 72, 36):
            for blocks in (1, 16, 2 * sms, 2 * sms + 1, 4096):
                for count in (0, 64, sms):   # 0: the library asks the device
                    want = tatt.mha_plan(t, dh, blocks=blocks, sm_count=count or sms)["warps"]
                    got = lib.ivars_mha_warps(t, blocks, count)
                    assert got == want, (t, dh, blocks, count)


def _at_the_end_of_a_segment(values):
    """``values`` copied to the last bytes of a device allocation of its own:
    a buffer of a whole number of the allocator's 2 MiB pages, large enough
    that the allocator asks the driver for exactly that many, with the
    tensor as its tail. A read past the tensor's last element then leaves
    the allocation."""
    page = 2 << 20
    n_bytes = values.numel() * values.element_size()
    total = max(20 << 20, -(-n_bytes // page) * page)
    raw = torch.empty(total, dtype=torch.uint8, device=values.device)
    tail = raw[total - n_bytes:].view(values.dtype).view(values.shape)
    tail.copy_(values)
    assert tail.data_ptr() + n_bytes == raw.data_ptr() + total and tail.data_ptr() % 16 == 0
    return tail


@pytest.mark.parametrize("shape", [(1, 273, 64, 1), (2, 300, 128, 2), (1, 577, 1024, 16),
                                   (1, 257, 1024, 16), (3, 17, 192, 3)])
def test_mha_bf16_kernel_reads_nothing_past_its_inputs(cuda_device, shape):
    # q, k and v each end where their allocation ends.  In the two-pass
    # variant (T > 272) the last 128-row group has warps whose whole query
    # tile lies past T, in both variants the last tile has rows past T: none
    # of them may form an address beyond row T - 1.
    b, t, d, h = shape
    gen = torch.Generator(device=cuda_device).manual_seed(t + d)
    q, k, v = (_at_the_end_of_a_segment(
        torch.randn(b, t, d, generator=gen, device=cuda_device).to(torch.bfloat16))
        for _ in range(3))
    for _ in range(3):
        got = tatt.fused_mha(q, k, v, h)
    torch.cuda.synchronize()   # an illegal address surfaces here
    want = tatt._einsum_attention(q, k, v, h)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


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


@pytest.mark.parametrize("b", [1, 8, 20, 33, 64, 128, 160, 256, 512, 520])
@pytest.mark.parametrize("d", [768, 512, 64])
def test_int8_chunk_max_kernel_matches_plain(cuda_device, b, d):
    gen = torch.Generator(device=cuda_device).manual_seed(b * d)
    x_i8, xs = _int8_rows(gen, 8192, d, cuda_device)
    q_i8, _ = tq.symmetric_int8(torch.randn(b, d, generator=gen, device=cuda_device), dim=-1)
    dead = (torch.rand(8192, generator=gen, device=cuda_device) < 0.01).to(torch.int8)
    before = tq.int8_chunk_max_sweep.launches
    got = tq.int8_chunk_max_sweep(x_i8, xs, q_i8, 8000, dead)
    torch.cuda.synchronize()
    # one launch per query group of the padded batch
    plan = tq.int8_sweep_plan(ttopk.bucket_b(b), d)
    assert tq.int8_chunk_max_sweep.launches == before + len(plan)
    assert tq.int8_chunk_max_sweep.group == plan[0]["group"]
    assert got.shape == (8192 // ttopk.CHUNK, b)
    want = tq.int8_chunk_max_plain(x_i8, xs, q_i8, 8000, dead)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got, want)


def test_int8_sweep_plan_matches_the_library(cuda_device):
    import ctypes

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernels

    lib = kernels.load()
    top, width, stages, per_sm = (ctypes.c_int() for _ in range(4))
    blocks, smem = ctypes.c_longlong(), ctypes.c_longlong()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n_pad in (2048, 100_663_296):
        for d in (16, 48, 64, 512, 768, 1024, 1280, 4096):
            for b_pad in (8, 16, 32, 64, 72, 128, 160, 256, 512, 544):
                for p in tq.int8_sweep_plan(b_pad, d):
                    for count in (0, 64, sms):   # 0: the library asks the device
                        lib.ivars_int8_chunk_max_plan(
                            n_pad, d, p["group"], count, ctypes.byref(top), ctypes.byref(width),
                            ctypes.byref(stages), ctypes.byref(per_sm), ctypes.byref(blocks),
                            ctypes.byref(smem))
                        want_blocks = min(n_pad // ttopk.CHUNK, (count or sms) * p["blocks_per_sm"])
                        assert (top.value, width.value, stages.value, per_sm.value, blocks.value,
                                smem.value) == (tq.int8_sweep_plan(256, d)[0]["group"],
                                                p["width"], p["stages"], p["blocks_per_sm"],
                                                want_blocks, p["smem_bytes"]), (n_pad, d, p)


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


@pytest.mark.parametrize("tokens", [1, 63, 64, 65, 129, 2056])
@pytest.mark.parametrize("d", [128, 256, 512, 768, 1024])
def test_ln_mlp_bf16_kernel_over_widths_and_token_counts(cuda_device, d, tokens):
    # every width class of the kernel's template, token counts around the
    # 64-token tile
    h = 4 * d if d > 128 else 256
    args = _ln_mlp_args(cuda_device, (tokens,), d, h, torch.bfloat16, seed=d + tokens)
    for act in (tblock.ACTIVATIONS if tokens == 65 else ("quick_gelu",)):
        got = tblock.fused_ln_mlp(*args, act=act)
        torch.cuda.synchronize()
        want = tblock.fused_ln_mlp_reference(*args, act=act)
        assert torch.isfinite(got).all()
        diff = (got.float() - want.float()).abs().max().item()
        assert diff <= 0.01 * want.float().abs().max().item(), (act, diff)


def test_ln_mlp_bf16_kernel_on_a_non_contiguous_input(cuda_device):
    args = _ln_mlp_args(cuda_device, (3, 70), 512, 2048, torch.bfloat16, seed=7)
    wide = torch.cat([args[0], args[0]], dim=-1)
    x = wide[..., :512]                       # rows 1,024 apart
    assert not x.is_contiguous()
    got = tblock.fused_ln_mlp(x, *args[1:])
    want = tblock.fused_ln_mlp_reference(args[0], *args[1:])
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= 0.01 * want.float().abs().max().item(), diff


def test_ln_mlp_plan_matches_the_library(cuda_device):
    import ctypes

    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernels

    lib = kernels.load()
    cluster, w1, w2 = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    blocks, smem = ctypes.c_longlong(), ctypes.c_longlong()
    for d in range(128, 1025, 128):
        for n_tok in (1, 64, 65, 2056, 4223, 4224, 65_792):
            lib.ivars_ln_mlp_plan(n_tok, d, ctypes.byref(cluster), ctypes.byref(blocks),
                                  ctypes.byref(w1), ctypes.byref(w2), ctypes.byref(smem))
            plan = tblock.ln_mlp_plan(n_tok, d)
            assert (cluster.value, blocks.value, w1.value, w2.value, smem.value) == (
                plan["cluster"], plan["blocks"], plan["w1_stages"], plan["w2_stages"],
                plan["smem_bytes"])


def test_ln_mlp_kernel_full_batch_shape(cuda_device):
    # the build path's shape: 256 images x 257 tokens of ViT-L/14
    args = _ln_mlp_args(cuda_device, (256, 257), 1024, 4096, torch.bfloat16, seed=1)
    got = tblock.fused_ln_mlp(*args)
    want = tblock.fused_ln_mlp_reference(*args)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= 0.01 * want.float().abs().max().item(), diff


@pytest.mark.parametrize("case", [((256, 257), 1024, 4096, 20), ((8, 257), 1024, 4096, 100),
                                  ((130,), 768, 3072, 100), ((4097,), 128, 256, 100)])
def test_ln_mlp_bf16_kernel_gives_the_same_bits_every_launch(cuda_device, case):
    # The blocks of a cluster hand activation tiles to one another through
    # barriers in shared memory.  Every sum has a fixed order, so the output
    # is a function of the inputs to the bit: one 16-byte group read before it
    # had landed, or overwritten before it was read, in any of the thousands
    # of hand-overs of a launch, shows as a difference between launches (the
    # comparison with the plain version, at 1e-2 of the output's range, would
    # let a single stale group pass).
    tokens_shape, d, h, repeats = case
    args = _ln_mlp_args(cuda_device, tokens_shape, d, h, torch.bfloat16, seed=d)
    first = tblock.fused_ln_mlp(*args)
    want = tblock.fused_ln_mlp_reference(*args)
    diff = (first.float() - want.float()).abs().max().item()
    assert diff <= 0.01 * want.float().abs().max().item(), diff
    # other work on the card at the same time: B3 on a second stream
    side = torch.cuda.Stream(device=cuda_device)
    qkv = torch.randn(64, 50, 768, device=cuda_device).to(torch.bfloat16)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    for i in range(repeats):
        if i % 2:
            with torch.cuda.stream(side):
                tatt.fused_mha(qkv, qkv, qkv, 12)
        again = tblock.fused_ln_mlp(*args)
        assert torch.equal(again, first), f"launch {i + 1} differs from the first"
    torch.cuda.synchronize()


def test_ln_mlp_kernel_refuses_bad_input(cuda_device):
    args = _ln_mlp_args(cuda_device, (2, 3), 256, 512, torch.float32, seed=2)
    with pytest.raises(ValueError):
        tblock.fused_ln_mlp(*args, act="relu")
    with pytest.raises(TypeError):
        tblock.fused_ln_mlp(args[0].to(torch.float16), *args[1:])
    with pytest.raises(ValueError):      # d past what one block's shared memory holds
        tblock.fused_ln_mlp(*_ln_mlp_args(cuda_device, (2,), 1280, 5120,
                                          torch.bfloat16, seed=3))
    with pytest.raises(ValueError):      # weights on another device
        tblock.fused_ln_mlp(args[0], *(a.cpu() for a in args[1:]))


# ---------------------------------------------------------------------------
# the bench probes (csrc/probes.cu)
# ---------------------------------------------------------------------------


def _probe_inputs(device, n_pad, d, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (n_pad, d), generator=gen, device=device, dtype=torch.int8)
    xs = (torch.rand(n_pad, generator=gen, device=device) * 0.2 + 0.9) / 127.0
    q = torch.randn(8, d, generator=gen, device=device)
    q_i8 = tq.symmetric_int8(q, dim=-1)[0]
    return x, xs, q.to(torch.bfloat16), q_i8


@pytest.mark.parametrize("rows_per_block", [128, 256, 512])
@pytest.mark.parametrize("n_valid", [8192, 8000, 4096 + 77, 1])
@pytest.mark.parametrize("d", [768, 96, 48])
def test_probe_int8_mma_kernel_is_exact(cuda_device, rows_per_block, n_valid, d):
    x, xs, _, q_i8 = _probe_inputs(cuda_device, 8192, d, seed=d + n_valid)
    before = tprobes.probe_int8_mma_sweep.launches
    got = tprobes.probe_int8_mma_sweep(x, xs.reshape(-1, 1), q_i8, n_valid, rows_per_block)
    torch.cuda.synchronize()
    assert tprobes.probe_int8_mma_sweep.launches == before + 1
    assert got.shape == (8192 // 128, 8)
    assert torch.equal(got, tprobes.probe_int8_mma_sweep_plain(x, xs, q_i8, n_valid))
    # B2 with an all-zero tombstone mask computes the same function
    dead = torch.zeros(8192, dtype=torch.int8, device=cuda_device)
    assert torch.equal(got, tq.int8_chunk_max_sweep(x, xs, q_i8, n_valid, dead))


@pytest.mark.parametrize("rows_per_block", [128, 256, 512])
@pytest.mark.parametrize("n_valid", [8192, 8000, 4096 + 77])
@pytest.mark.parametrize("d", [768, 96, 48])
def test_probe_int8_convert_kernel_matches_plain(cuda_device, rows_per_block, n_valid, d):
    x, xs, q_bf, _ = _probe_inputs(cuda_device, 8192, d, seed=d + n_valid + 1)
    before = tprobes.probe_int8_convert_sweep.launches
    got = tprobes.probe_int8_convert_sweep(x, xs, q_bf, n_valid, rows_per_block)
    torch.cuda.synchronize()
    assert tprobes.probe_int8_convert_sweep.launches == before + 1
    want = tprobes.probe_int8_convert_sweep_plain(x, xs, q_bf, n_valid)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    tol = 1e-5 * want[fin].abs().max().item()
    assert (got[fin] - want[fin]).abs().max().item() <= tol


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 4])
@pytest.mark.parametrize("case", [(torch.bfloat16, 768, 2048), (torch.int8, 768, 2048),
                                  (torch.int8, 768, 8192), (torch.int32, 192, 2048),
                                  (torch.int8, 128, 8)])
def test_probe_stream_kernel_returns_the_last_tiles_head(cuda_device, blocks_per_sm, case):
    dtype, d, tile_n = case
    n = 3 * tile_n + tile_n // 2          # a ragged tail the kernel never reads
    gen = torch.Generator(device=cuda_device).manual_seed(d + tile_n)
    if dtype == torch.bfloat16:
        x = torch.randn(n, d, generator=gen, device=cuda_device).to(dtype)
    else:
        x = torch.randint(-100, 100, (n, d), generator=gen, device=cuda_device, dtype=dtype)
    before = tprobes.probe_stream.launches
    got = tprobes.probe_stream(x, tile_n, blocks_per_sm)
    torch.cuda.synchronize()
    assert tprobes.probe_stream.launches == before + 1
    assert torch.equal(got, tprobes.probe_stream_plain(x, tile_n))
    assert torch.equal(got, x[2 * tile_n:2 * tile_n + 8, :128].float())


def test_probe_kernels_refuse_bad_input(cuda_device):
    x, xs, q_bf, q_i8 = _probe_inputs(cuda_device, 2048, 72, seed=0)   # 72 % 16 != 0
    with pytest.raises(ValueError):
        tprobes.probe_int8_mma_sweep(x, xs, q_i8, 2048)
    with pytest.raises(ValueError):
        tprobes.probe_int8_convert_sweep(x, xs, q_bf, 2048)
    x, xs, q_bf, q_i8 = _probe_inputs(cuda_device, 2048, 64, seed=0)
    with pytest.raises(ValueError):      # queries on another device
        tprobes.probe_int8_mma_sweep(x, xs, q_i8.cpu(), 2048)
    with pytest.raises(ValueError):      # a view at an odd byte offset
        flat = torch.zeros(2048 * 128 + 1, dtype=torch.int8, device=cuda_device)
        tprobes.probe_stream(flat[1:].view(2048, 128), 64)


# ---------------------------------------------------------------------------
# the IVF mode (ops.ann) on the card
# ---------------------------------------------------------------------------


def _clustered(n, d, seed, clusters=32):
    """Clustered unit rows, made on the CPU from a seed."""
    gen = torch.Generator().manual_seed(seed)
    centres = torch.nn.functional.normalize(torch.randn(clusters, d, generator=gen), dim=1)
    x = centres[torch.randint(0, clusters, (n,), generator=gen)]
    x = x + (0.35 / d**0.5) * torch.randn(n, d, generator=gen)
    return torch.nn.functional.normalize(x, dim=1)


def _to(state, device):
    return state._replace(centroids=state.centroids.to(device),
                          bucket_ids=state.bucket_ids.to(device),
                          tail_ids=state.tail_ids.to(device))


@pytest.fixture(scope="module")
def ivf_cpu():
    x = _clustered(4096, 64, seed=7)
    q = torch.nn.functional.normalize(x[:20] + 0.06 * torch.randn(20, 64,
                                      generator=torch.Generator().manual_seed(1)), dim=1)
    x_i8, xs = tq.symmetric_int8(x, dim=-1)
    state, _ = tann.build_ivf(x, nlist=64, kmeans_iters=6)
    return x, q, x_i8, xs[:, 0].contiguous(), state


@pytest.mark.parametrize("nprobe", [1, 8, 64])
@pytest.mark.parametrize("b", [1, 8, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_topk_on_card_matches_cpu(cuda_device, ivf_cpu, dtype, b, nprobe):
    x, q, x_i8, xs, state = ivf_cpu
    dead = torch.zeros(4096, 1, dtype=torch.int8)
    dead[::9] = 1
    q = q[:b] if b <= 20 else q
    kw = dict(k=10, nprobe=nprobe, n_valid=4000)
    if dtype == "int8":
        want = tann.ivf_topk(x_i8, state, q, x_scales=xs, deleted=dead, **kw)
        before = tann.ivf_topk.calls
        got = tann.ivf_topk(x_i8.to(cuda_device), _to(state, cuda_device), q.to(cuda_device),
                            x_scales=xs.to(cuda_device), deleted=dead.to(cuda_device), **kw)
        assert tann.ivf_topk.calls > before and got.scores.device.type == "cuda"
        assert torch.equal(got.scores.cpu(), want.scores)
        for i in range(b):
            tie_aware_equal(got.indices[i].cpu().numpy(), got.scores[i].cpu().numpy(),
                            want.indices[i].numpy(), want.scores[i].numpy(), atol=0.0)
        return
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = tann.ivf_topk(x.to(tdt), state, q, deleted=dead, **kw)
    got = tann.ivf_topk(x.to(tdt).to(cuda_device), _to(state, cuda_device), q.to(cuda_device),
                        deleted=dead.to(cuda_device), **kw)
    for i in range(b):
        tie_aware_equal(got.indices[i].cpu().numpy(), got.scores[i].cpu().numpy(),
                        want.indices[i].numpy(), want.scores[i].numpy())


def _assert_same_build(a, b, x, ties_allowed):
    torch.testing.assert_close(a.centroids.cpu(), b.centroids.cpu(), atol=1e-5, rtol=0)
    assert torch.equal(a.tail_ids.cpu(), b.tail_ids.cpu()) and a.tail_count == b.tail_count
    ba, bb = a.bucket_ids.cpu(), b.bucket_ids.cpu()
    if not ties_allowed:
        assert torch.equal(ba, bb)
        return
    cent = a.centroids.cpu().double()
    for c in torch.nonzero((ba != bb).any(dim=1)).reshape(-1).tolist():
        diff = ba[c] != bb[c]
        sa = torch.sort(x[ba[c][diff].long()].double() @ cent[c]).values
        sb = torch.sort(x[bb[c][diff].long()].double() @ cent[c]).values
        torch.testing.assert_close(sa, sb, atol=1e-6, rtol=0)
    assert int((ba != bb).sum()) <= 8


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_ivf_on_card_twice_is_bit_equal(cuda_device, dtype):
    x = _clustered(200_000, 96, seed=3, clusters=256).to(cuda_device)
    kw = {}
    if dtype == "int8":
        x, xs = tq.symmetric_int8(x, dim=-1)
        kw["x_scales"] = xs[:, 0].contiguous()
    a, ra = tann.build_ivf(x, nlist=512, kmeans_iters=4, seed=2, **kw)
    b, rb = tann.build_ivf(x, nlist=512, kmeans_iters=4, seed=2, **kw)
    assert ra == rb and a.tail_count == b.tail_count
    for t_a, t_b in zip((a.centroids, a.bucket_ids, a.tail_ids),
                        (b.centroids, b.bucket_ids, b.tail_ids)):
        assert torch.equal(t_a, t_b)


def test_build_ivf_on_card_matches_cpu(cuda_device):
    x = _clustered(4096, 64, seed=7)
    cpu, rc = tann.build_ivf(x, nlist=64, kmeans_iters=6)
    card, rg = tann.build_ivf(x.to(cuda_device), nlist=64, kmeans_iters=6)
    assert rc == rg
    _assert_same_build(card, cpu, x, ties_allowed=True)
    bucket = card.bucket_ids.cpu()
    ids = torch.cat([bucket[bucket >= 0], card.tail_ids.cpu()[:card.tail_count]])
    assert torch.equal(torch.sort(ids).values, torch.arange(4096, dtype=ids.dtype))


def test_ivf_scores_are_full_f32_on_card(cuda_device, ivf_cpu):
    """TF32 stays off (the port never turns it on), so the float rescore is
    full f32: within 1e-6 of a float64 product of the same rows."""
    x, q, _, _, state = ivf_cpu
    assert torch.backends.cuda.matmul.allow_tf32 is False
    got = tann.ivf_topk(x.to(cuda_device), _to(state, cuda_device), q.to(cuda_device), 10,
                        nprobe=8)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    ids = got.indices.cpu()
    want = torch.einsum("bd,bkd->bk", q.double(), x[ids].double())
    torch.testing.assert_close(got.scores.cpu().double(), want, atol=1e-6, rtol=0)


def test_ivf_union_searcher_b16_at_1m_rows(cuda_device):
    n, d = 1_000_000, 768
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    centres = torch.nn.functional.normalize(torch.randn(4096, d, generator=gen,
                                                        device=cuda_device), dim=1)
    x = torch.empty(n, d, dtype=torch.bfloat16, device=cuda_device)
    for s in range(0, n, 131_072):
        e = min(s + 131_072, n)
        blk = centres[torch.randint(0, 4096, (e - s,), generator=gen, device=cuda_device)]
        blk = blk + (0.35 / d**0.5) * torch.randn(e - s, d, generator=gen, device=cuda_device)
        x[s:e] = torch.nn.functional.normalize(blk, dim=1)
    state, report = tann.build_ivf(x, kmeans_iters=4)
    assert report.nlist == 4096 and report.bucket_cap == 384
    assert tann._max_program_b(4096, 384, d, 64, 2) == 16
    q = torch.nn.functional.normalize(torch.randn(16, d, generator=gen, device=cuda_device),
                                      dim=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tann.ivf_topk(x, state, q, 20, nprobe=64)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= tann._GATHER_BUDGET
    for i in range(16):
        one = tann.ivf_topk(x, state, q[i:i + 1], 20, nprobe=64)
        assert set(got.indices[i].tolist()) == set(one.indices[0].tolist())
        torch.testing.assert_close(torch.sort(got.scores[i]).values,
                                   torch.sort(one.scores[0]).values, atol=1e-5, rtol=0)


def test_symmetric_int8_on_card_is_the_cpu_bits(cuda_device):
    """The query scale is a true division on the card as on the CPU (CUDA
    turns a division by a Python scalar into a multiply by its reciprocal)."""
    x = torch.randn(20_000, 768, generator=torch.Generator().manual_seed(4))
    q_cpu, s_cpu = tq.symmetric_int8(x, dim=-1)
    q_card, s_card = tq.symmetric_int8(x.to(cuda_device), dim=-1)
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(q_card.cpu(), q_cpu)


# ---------------------------------------------------------------------------
# ingest (torch operations around B3 and B5): the card against the CPU
# ---------------------------------------------------------------------------


def _ingest_images(n=8, h=48, w=40, seed=11):
    gen = torch.Generator().manual_seed(seed)
    amps = torch.linspace(30.0, 127.0, n)[:, None, None, None]
    x = 128.0 + amps * (2 * torch.rand(n, h, w, 3, generator=gen) - 1)
    return x.round().clamp(0, 255).to(torch.uint8)


def test_quality_scores_on_card_match_cpu(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quality as tqual

    img = _ingest_images()
    cpu = tqual.quality_metrics(img)
    card = tqual.quality_metrics(img.to(cuda_device))
    for key in ("blur", "edges"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=1e-5, atol=0)
    mask = tqual.adaptive_quality_mask(cpu["blur"].to(cuda_device),
                                       cpu["edges"].to(cuda_device), 10.0, 25.0)
    assert torch.equal(mask.cpu(), tqual.adaptive_quality_mask(cpu["blur"], cpu["edges"],
                                                               10.0, 25.0))


def test_perceptual_hash_on_card_matches_cpu(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import phash as tph

    img = _ingest_images(seed=12)
    cpu = tph.perceptual_hash(img)
    card = tph.perceptual_hash(img.to(cuda_device))
    assert card.dtype == torch.uint8 and torch.equal(card.cpu(), cpu)
    assert torch.equal(tph.hamming_distance(card, card[:3]).cpu(),
                       tph.hamming_distance(cpu, cpu[:3]))


def _runs(n=96, d=32, noise=0.05, seed=13):
    gen = torch.Generator().manual_seed(seed)
    rows = []
    while len(rows) < n:
        base = torch.randn(d, generator=gen)
        for _ in range(int(torch.randint(3, 9, (1,), generator=gen))):
            rows.append(base + noise * torch.randn(d, generator=gen))
    return torch.stack(rows[:n])


def test_dedup_scans_on_card_match_cpu(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops import dedup as tdd

    emb = _runs()
    active = torch.rand(96, generator=torch.Generator().manual_seed(14)) < 0.8
    assert torch.equal(tdd.sequential_dedup(emb.to(cuda_device)).cpu(), tdd.sequential_dedup(emb))
    kc, cc = tdd.sequential_dedup_carry(emb, torch.zeros(32))
    kg, cg = tdd.sequential_dedup_carry(emb.to(cuda_device), torch.zeros(32, device=cuda_device))
    assert kg.device.type == "cuda" and torch.equal(kg.cpu(), kc)
    torch.testing.assert_close(cg.cpu(), cc, atol=1e-6, rtol=0)
    kc, _ = tdd.sequential_dedup_carry_masked(emb, torch.zeros(32), active)
    kg, _ = tdd.sequential_dedup_carry_masked(emb.to(cuda_device),
                                              torch.zeros(32, device=cuda_device),
                                              active.to(cuda_device))
    assert torch.equal(kg.cpu(), kc)
    assert torch.equal(tdd.windowed_dedup_mask(emb.to(cuda_device), 0.95, 5).cpu(),
                       tdd.windowed_dedup_mask(emb, 0.95, 5))
    assert (tdd.cluster_representatives_mask(emb.to(cuda_device), eps=0.05) ==
            tdd.cluster_representatives_mask(emb, eps=0.05)).all()


def test_dino_tower_on_card_launches_b3_per_layer_and_b5_per_batch(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ingest import frames as tfr
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.dino import DINOConfig

    frames = torch.randint(0, 256, (16, 64, 48, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(15))
    embed = tfr.dino_embedder(device=cuda_device)
    # the same weights in f32 on the CPU (a generator on the card draws other
    # numbers than one on the CPU, so each side's seeded tower differs)
    cpu = tfr.dino_embedder(dtype="float32", device="cpu")
    cpu.tower.load_state_dict({k: v.cpu() for k, v in embed.tower.state_dict().items()})
    want = cpu(frames.numpy())
    b3, b5 = tatt.fused_mha.launches, tpre.normalize_images.launches
    got = embed.device_fn(frames.to(cuda_device))
    torch.cuda.synchronize()
    assert tatt.fused_mha.launches - b3 == DINOConfig.vit_s_16().num_layers
    assert tpre.normalize_images.launches - b5 == 1
    cos = torch.nn.functional.cosine_similarity(got.cpu(), torch.from_numpy(want), dim=-1)
    assert float(cos.min()) >= 0.999
    # the host entry pads to batch_pad rows and slices
    assert embed(frames[:3].numpy()).shape == (3, 384)


def test_frame_filter_dedup_step_on_card_matches_cpu(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ingest import (
        FrameFilter,
        FrameFilterConfig,
    )

    gen = torch.Generator().manual_seed(16)
    scenes = torch.randint(0, 200, (4, 1, 64, 64, 3), generator=gen)
    batch = (scenes + torch.randint(0, 3, (4, 12, 64, 64, 3), generator=gen)).reshape(
        48, 64, 64, 3).to(torch.uint8).numpy()
    cfg = FrameFilterConfig(frame_batch=48)
    keep_cpu, _ = FrameFilter(cfg, device="cpu").dedup_step(batch, None)
    keep_card, carry = FrameFilter(cfg, device=cuda_device).dedup_step(batch, None)
    assert carry.device.type == "cuda"
    assert (keep_card == keep_cpu).all() and keep_card.sum() == 4


def _served_on_card(device, tmp_path, **api):
    """A port facade on the card (tiny towers, bf16) over 4,096 seeded rows,
    behind its REST server on a loopback port."""
    import socket

    import numpy as np

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench.data import (
        MemoryContainer,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        EnhancedRetrievalSystem,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

    rows = torch.from_numpy(np.random.default_rng(0).standard_normal((4096, 32),
                                                                     dtype=np.float32))
    bits = rows.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=tmp_path,
               overrides={"api": api, "logging": {"file": False}}),
        embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), device=device), device=device)
    index = UnifiedIndex(system._index_config(), device=device)
    index.attach_container(MemoryContainer(bits))
    system.attach_index(index)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    system.start_server(host="127.0.0.1", port=port, block=False)
    return system, port


def _post(port, path, payload):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _check_hits(system, hits, qvec, k):
    import numpy as np

    index = system.index
    q = torch.from_numpy(qvec / max(float(np.linalg.norm(qvec)), 1e-12)).to(
        index.device, index._dev_x.dtype)[None]
    ref = ttopk.topk_exact_reference(index._dev_x[:index.ntotal], q, k)
    rows = [index.row_for(h["folder"], h["image"]) for h in hits]
    assert len(hits) == k and None not in rows
    tie_aware_equal(rows, [h["similarity_score"] for h in hits], ref.indices[0].cpu().numpy(),
                    ref.scores[0].cpu().numpy())


def test_served_search_on_the_card_launches_b1(cuda_device, tmp_path):
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
    )

    system, port = _served_on_card(cuda_device, tmp_path)
    try:
        for i in range(3):
            text = f"a red car at night {i}"
            before = ttopk.chunk_max_sweep.launches
            status, body = _post(port, "/api/search", {"query": text, "limit": 10})
            assert status == 200 and body["count"] == 10
            assert ttopk.chunk_max_sweep.launches == before + 1
            prompt = system._clip_prompt(text, SearchOptions())[0]
            _check_hits(system, body["results"], system.embedder.encode_text([prompt])[0], 10)
    finally:
        system.cleanup()


def test_served_image_search_on_the_card_launches_b5_and_b3(cuda_device, tmp_path):
    import base64
    import io

    import numpy as np
    from PIL import Image

    system, port = _served_on_card(cuda_device, tmp_path)
    try:
        system.embedder.ensure_loaded()
        size = system.embedder.input_size
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(4).integers(0, 256, (size, size, 3),
                                                          dtype=np.uint8)).save(buf, "JPEG")
        before = (tpre.normalize_images.launches, tatt.fused_mha.launches,
                  ttopk.chunk_max_sweep.launches)
        status, body = _post(port, "/api/image_search", {
            "image_base64": base64.b64encode(buf.getvalue()).decode(), "limit": 10})
        assert status == 200 and body["count"] == 10
        layers = system.embedder.config.vision.num_layers
        assert (tpre.normalize_images.launches - before[0], tatt.fused_mha.launches - before[1],
                ttopk.chunk_max_sweep.launches - before[2]) == (1, layers, 1)
        pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        _check_hits(system, body["results"], system.embedder.encode_images(pixels[None])[0], 10)
    finally:
        system.cleanup()


def test_64_concurrent_served_searches_equal_their_serial_answers(cuda_device, tmp_path):
    import numpy as np

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench import served
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.testing import ATOL_TOPK

    system, port = _served_on_card(cuda_device, tmp_path, batching=True,
                                   batching_max_batch=64, batching_window_ms=20.0,
                                   rate_limit_per_minute=10**9)
    recorder = served.Recorder(system.embedder)
    try:
        texts = [f"concurrent {i}: people on a beach" for i in range(64)]
        _, _, together = served.fire(port, texts, concurrency=64)
        assert system._server.batcher.stats.max_batch_seen > 1
        _, _, alone = served.fire(port, texts, concurrency=1)
        for text, a, b in zip(texts, together, alone):
            first, second = recorder.vectors[system._clip_prompt(text, SearchOptions())[0]]
            _check_hits(system, a["results"], first, 10)
            _check_hits(system, b["results"], second, 10)
            key = {k: i for i, k in enumerate({(h["folder"], h["image"])
                                               for h in a["results"] + b["results"]})}
            tie_aware_equal([key[h["folder"], h["image"]] for h in a["results"]],
                            [h["similarity_score"] for h in a["results"]],
                            [key[h["folder"], h["image"]] for h in b["results"]],
                            [h["similarity_score"] for h in b["results"]],
                            atol=ATOL_TOPK + float(np.linalg.norm(first - second)))
    finally:
        recorder.close()
        system.cleanup()


# ---------------------------------------------------------------------------
# W8A8 towers: torch._int_mm products and torch operations around B3 and B5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2056, 1024, 1024), (2056, 1024, 4096), (2056, 4096, 1024),
                                   (616, 768, 3072), (77, 3072, 768), (16, 64, 64),
                                   (5, 45, 37), (1, 8, 8)])
def test_w8a8_dense_on_card_equals_cpu(cuda_device, shape, dtype, static):
    m, k, n = shape
    gen = torch.Generator().manual_seed(m * 7 + k + n)
    x = (torch.randn(m, k, generator=gen) * 2).to(dtype)
    w = torch.randn(n, k, generator=gen) * k ** -0.5
    b = torch.randn(n, generator=gen)
    a = torch.tensor(0.7 * float(x.float().abs().max()) / 127.0) if static else None
    want = tq.w8a8_dense(x, w, b, a_scale=a)
    calls = tq.w8a8_dense.calls
    got = tq.w8a8_dense(x.to(cuda_device), w.to(cuda_device), b.to(cuda_device), a_scale=a)
    torch.cuda.synchronize()
    assert tq.w8a8_dense.calls == calls + 1 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def test_int8_attention_on_card_matches_cpu(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip

    mha = tclip.MultiHeadAttention(1024, 16, int8_attn=True)
    gen = torch.Generator().manual_seed(3)
    for p in mha.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 1024 ** -0.5)
    x = torch.randn(8, 257, 1024, generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        qkv = [proj(x) for proj in (mha.q_proj, mha.k_proj, mha.v_proj)]
        want_core = mha._int8_attention(*qkv).float()
        want = mha(x).float()
    mha = mha.to(cuda_device)
    before = tatt.fused_mha.launches
    # TF32 asked for: the int8 products run in full f32 all the same and
    # leave the setting as they found it
    torch.set_float32_matmul_precision("high")
    try:
        with torch.inference_mode():
            core = mha._int8_attention(*(t.to(cuda_device) for t in qkv)).float().cpu()
            got = mha(x.to(cuda_device)).float().cpu()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert tatt.fused_mha.launches == before                 # not B3

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.reshape(-1, 1024),
                                                     b.reshape(-1, 1024)).min()

    # on the same q, k, v only the softmax's last bits differ
    assert cos(core, want_core) >= 0.9999
    # the bf16 projections round apart, and near-uniform weights over 257
    # keys sit at 0.49 of p8's 1/127 step: a last bit can move p8 by one
    assert cos(got, want) >= 0.999


@pytest.mark.parametrize("int8_attn", [False, True])
def test_w8a8_static_tower_on_card(cuda_device, int8_attn):
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import calibrate as tcal
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv

    cfg = tclip.CLIPConfig(
        vision=tclip.CLIPVisionConfig(image_size=64, patch_size=8, hidden_size=256,
                                      num_layers=3, num_heads=4, projection_dim=64),
        text=tclip.CLIPTextConfig(vocab_size=512, max_length=16, hidden_size=64,
                                  num_layers=1, num_heads=4, projection_dim=64))
    _, sd = tconv.load_clip(None, config=cfg)
    flags = dict(dtype=torch.bfloat16, w8a8=True, int8_attn=int8_attn)
    models = {}
    for dev in (torch.device("cpu"), cuda_device):
        dyn = tconv.empty_model(cfg, dev, **flags)
        dyn.load_state_dict(sd)
        static = tconv.empty_model(cfg, dev, w8a8_static=True, **flags)
        static.load_state_dict(sd)
        models[dev.type] = (dyn.eval(), static.eval())
    px = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(5)).bfloat16()
    scales = tcal.calibrate_act_scales(models["cuda"][0], [(px.to(cuda_device),)])["act_scales"]
    cpu_scales = tcal.calibrate_act_scales(models["cpu"][0], [(px,)])["act_scales"]
    for _, static in models.values():
        tcal.set_act_scales(static, scales)
    before = (tq.w8a8_dense.calls, tatt.fused_mha.launches)
    with torch.inference_mode():
        got = models["cuda"][1].encode_image(px.to(cuda_device)).float().cpu()
        want = models["cpu"][1].encode_image(px).float()
    assert (tq.w8a8_dense.calls - before[0], tatt.fused_mha.launches - before[1]) == \
        (2 * 6 * 3, 0 if int8_attn else 3)      # the CPU's 6 a layer too; B3 on the card only
    cos = torch.nn.functional.cosine_similarity(got, want)
    assert cos.min() >= 0.999
    for key in ("mlp_fc_ascale", "mlp_proj_ascale"):
        a = scales["vision"]["transformer"]["layer_2"][key]
        c = cpu_scales["vision"]["transformer"]["layer_2"][key]
        assert abs(float(a) / float(c) - 1) < 2e-2


def test_embedder_int8_static_on_card(cuda_device):
    import numpy as np

    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )

    emb = CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="int8_static",
                       device=cuda_device)
    emb.ensure_loaded()
    assert emb.get_stats()["act_scales_calibrated"] == []
    rng = np.random.default_rng(6)
    for i in range(4):
        before = tpre.normalize_images.launches
        emb.encode_images(rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8))
        assert tpre.normalize_images.launches == before + 1
        emb.encode_text([f"query {i}"])
    assert emb.get_stats()["act_scales_calibrated"] == ["text", "vision"]
    calls = tq.w8a8_dense.calls
    out = emb.encode_text(["a static query", "another"])
    assert tq.w8a8_dense.calls - calls == 6 * 2 and np.isfinite(out).all()
    assert emb.model.text_model.encoder.layers[0].self_attn.q_proj.act_scale.device.type == "cuda"


# ---------------------------------------------------------------------------
# multi-device search over logical shards of the card
# ---------------------------------------------------------------------------


def _card_mesh(n: int):
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
    )

    return create_mesh(MeshSpec(axis_names=("index",), shape=(n,)), devices=["cuda:0"] * n)


def test_create_mesh_on_the_card(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import create_mesh

    mesh = create_mesh()
    assert mesh.shape["index"] == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        create_mesh(devices=["cuda:0", "cpu"])


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("b", [1, 8, 33])
def test_sharded_b1_equals_single_device(cuda_device, n_shards, b):
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
        place_rows,
        sharded_topk,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(b)
    n_pad, d, n = 4 * 3 * ttopk.TILE_N, 768, 4 * 3 * ttopk.TILE_N - 777
    x = torch.randn(n_pad, d, generator=gen, device=cuda_device)
    x = (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn(b, d, generator=gen, device=cuda_device).to(torch.bfloat16)
    dead = (torch.rand(n_pad, generator=gen, device=cuda_device) < 1e-2).to(torch.int8)
    mesh = _card_mesh(n_shards)
    xs, ds = place_rows(mesh, x, n_pad), place_rows(mesh, dead, n_pad)
    assert xs.buffer is x
    before = ttopk.chunk_max_sweep.launches
    got = sharded_topk(mesh, xs, q, 20, n, deleted_sharded=ds)
    assert ttopk.chunk_max_sweep.launches - before == n_shards
    ref = ttopk.topk_search(x, q, 20, n_valid=n, deleted=dead)
    for i in range(b):
        tie_aware_equal(got.indices[i].cpu().numpy(), got.scores[i].cpu().numpy(),
                        ref.indices[i].cpu().numpy(), ref.scores[i].cpu().numpy())


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("b", [1, 8, 100])
def test_sharded_b2_equals_single_device(cuda_device, n_shards, b):
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
        place_rows,
        sharded_topk_int8,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(100 + b)
    n_pad, d, n = 4 * 3 * ttopk.TILE_N, 768, 4 * 3 * ttopk.TILE_N - 1500
    x8 = torch.randint(-127, 128, (n_pad, d), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    xs = (torch.rand(n_pad, generator=gen, device=cuda_device) * 0.2 + 0.9) / 127.0
    x8[[7, 5000, 9000, 20000]] = x8[3].clone()   # ties across shards
    xs[[7, 5000, 9000, 20000]] = xs[3].clone()
    q = torch.randn(b, d, generator=gen, device=cuda_device)
    q[0] = x8[3].float()
    mesh = _card_mesh(n_shards)
    before = tq.int8_chunk_max_sweep.launches
    got = sharded_topk_int8(mesh, place_rows(mesh, x8, n_pad), place_rows(mesh, xs, n_pad), q,
                            20, n)
    assert tq.int8_chunk_max_sweep.launches - before == \
        n_shards * len(tq.int8_sweep_plan(ttopk.bucket_b(b), d))
    ref = tq.topk_search_int8(x8, xs, q, 20, n_valid=n)
    assert torch.equal(got.indices, ref.indices) and torch.equal(got.scores, ref.scores)
    assert got.indices[0, :5].tolist() == [3, 7, 5000, 9000, 20000]


def test_sharded_ivf_on_the_card_equals_ivf_topk(cuda_device):
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_ann import (
        make_sharded_ivf,
        sharded_ivf_topk,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
        place_rows,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    n_pad, d, n = 4 * 8 * ttopk.TILE_N, 128, 4 * 8 * ttopk.TILE_N - 300
    x8 = torch.randint(-127, 128, (n_pad, d), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    xs = (torch.rand(n_pad, generator=gen, device=cuda_device) * 0.2 + 0.9) / 127.0
    state, _ = tann.build_ivf(x8, n_rows=n, x_scales=xs, nlist=64, kmeans_iters=4)
    mesh = _card_mesh(4)
    xsh, ssh = place_rows(mesh, x8, n_pad), place_rows(mesh, xs, n_pad)
    sivf = make_sharded_ivf(mesh, "index", state, xsh.shard_rows)
    for nprobe in (4, 64):
        for b in (1, 8):
            q = torch.randn(b, d, generator=gen, device=cuda_device)
            got = sharded_ivf_topk(mesh, xsh, sivf, q, 10, nprobe=nprobe, n_valid=n,
                                   scales_sharded=ssh)
            ref = tann.ivf_topk(x8, state, q, 10, nprobe=nprobe, n_valid=n, x_scales=xs)
            assert torch.equal(got.indices, ref.indices)
            assert torch.equal(got.scores, ref.scores)


def test_mesh_index_on_the_card_answers_as_single_device(cuda_device):
    import numpy as np

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench.data import (
        MemoryContainer,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.native import f32_to_bf16

    rng = np.random.default_rng(6)
    rows = rng.standard_normal((30_000, 256)).astype(np.float32)
    q = rng.standard_normal((5, 256)).astype(np.float32)
    indexes = []
    for mesh in (None, _card_mesh(4)):
        index = UnifiedIndex(device=cuda_device, mesh=mesh)
        index.attach_container(MemoryContainer(f32_to_bf16(rows)))
        indexes.append(index)
    single, meshed = indexes
    assert meshed._sharded is not None and meshed._sharded.capacity % (4 * ttopk.TILE_N) == 0
    before = ttopk.chunk_max_sweep.launches
    got = meshed.search_vectors(q, top_k=10)
    assert ttopk.chunk_max_sweep.launches - before == 4
    want = single.search_vectors(q, top_k=10)
    for g, w in zip(got, want):
        tie_aware_equal([h.metadata.row_id for h in g], [h.similarity_score for h in g],
                        [h.metadata.row_id for h in w], [h.similarity_score for h in w])


# ---------------------------------------------------------------------------
# CLIP training (parallel/train.py) on the card
# ---------------------------------------------------------------------------


def _tiny_trainers(device, shape=(1, 1), **tc):
    """The same tiny f32 trainer on the card and on the CPU, over one seeded
    state (made on the CPU: a card's generator draws other numbers)."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
        CLIPTrainer,
        MeshSpec,
        TrainConfig,
        create_mesh,
    )

    n = shape[0] * shape[1]
    out = []
    for dev in (device, torch.device("cpu")):
        mesh = create_mesh(MeshSpec(("data", "model"), shape), devices=[dev] * n)
        out.append(CLIPTrainer(CLIPConfig.tiny_test(), mesh, TrainConfig(**tc),
                               dtype=torch.float32))
    card, cpu = out
    return card, cpu, cpu.state_dict(cpu.init(0)[0])


def _tiny_batch(b=8):
    import numpy as np

    rng = np.random.default_rng(0)
    px = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 500, (b, 16)).astype(np.int32)
    tokens[:, -1] = 511
    return px, tokens


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_trainer_step_on_card_matches_cpu(cuda_device, shape):
    card, cpu, sd = _tiny_trainers(cuda_device, shape)
    before = tatt.fused_mha.launches
    loss, _, grads = card.value_and_grad(card.shard_params(sd), *_tiny_batch())
    # B3 once per vision layer, data position and model shard, and again in the recompute
    assert tatt.fused_mha.launches - before == 2 * shape[0] * shape[1] * 2
    ref_loss, _, ref_grads = cpu.value_and_grad(cpu.shard_params(sd), *_tiny_batch())
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    got, want = card.state_dict(grads), cpu.state_dict(ref_grads)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name].cpu()
        if name.endswith("self_attn.k_proj.bias"):   # exactly zero: rounding noise
            assert float(g.abs().max()) <= 1e-6 * largest
            continue
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    params, opt_state, metrics = card.train_step(card.shard_params(sd), card.init(0)[1],
                                                 *_tiny_batch())
    assert opt_state["count"] == 1 and torch.isfinite(metrics["loss"])
    assert all(s.device.type == cuda_device.type for shards in params.values() for s in shards)


def test_trainer_remat_on_card_recomputes_b3_and_keeps_the_loss(cuda_device):
    losses, launches = [], []
    for remat in (True, False):
        card, _, sd = _tiny_trainers(cuda_device, remat=remat)
        before = tatt.fused_mha.launches
        _, _, metrics = card.train_step(card.shard_params(sd), card.init(0)[1], *_tiny_batch())
        launches.append(tatt.fused_mha.launches - before)
        losses.append(float(metrics["loss"]))
    assert launches == [4, 2]             # 2 vision layers; twice each with remat
    assert losses[0] == losses[1]


def test_trainer_checkpoint_roundtrip_on_card(cuda_device, tmp_path):
    card, _, sd = _tiny_trainers(cuda_device, (1, 2))
    params, opt_state, _ = card.train_step(card.shard_params(sd), card.init(0)[1],
                                           *_tiny_batch())
    card.save_checkpoint(tmp_path, params, opt_state, step=1)
    params2, opt2, step = card.restore_checkpoint(tmp_path)
    assert step == 1 and opt2["count"] == 1
    for tree, tree2 in ((params, params2), (opt_state["mu"], opt2["mu"]),
                        (opt_state["nu"], opt2["nu"])):
        for name, shards in tree.items():
            assert len(shards) == len(tree2[name])
            for a, b in zip(shards, tree2[name]):
                assert a.device == b.device and torch.equal(a, b), name
    _, _, live = card.train_step(params, opt_state, *_tiny_batch())
    _, _, restored = card.train_step(params2, opt2, *_tiny_batch())
    assert float(live["loss"]) == float(restored["loss"])


def test_peer_remote_search_on_the_card_equals_the_exact_reference(cuda_device):
    """A port ``NetworkServer`` on the card shares a bf16 index of 4,096
    seeded rows (kept on the card); ``RemoteUnifiedIndex.search_vector``
    over loopback launches B1 once a query and answers the exact reference
    over the same device rows (tie-aware); a vector of the wrong length
    answers 400."""
    import socket
    import urllib.error

    import numpy as np

    from intelligent_video_analysis_retrieval_system_tpu_torch.bench.data import (
        MemoryContainer,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve.p2p import (
        NetworkClient,
        NetworkServer,
    )

    rows = torch.from_numpy(np.random.default_rng(1).standard_normal((4096, 32),
                                                                     dtype=np.float32))
    index = UnifiedIndex(device=cuda_device)
    index.attach_container(MemoryContainer(
        rows.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    peer = NetworkServer("127.0.0.1", port, enable_discovery=False, device=cuda_device)
    peer.register_index("card", index)
    peer.start_server()
    try:
        remote = NetworkClient().load_remote_index("127.0.0.1", port, "card")
        assert (remote.ntotal, remote.dim) == (4096, 32)
        for seed in range(3):
            qvec = np.random.default_rng(10 + seed).standard_normal(32).astype(np.float32)
            before = ttopk.chunk_max_sweep.launches
            hits = remote.search_vector(qvec, top_k=20)
            assert ttopk.chunk_max_sweep.launches == before + 1
            q = torch.from_numpy(qvec / np.linalg.norm(qvec)).to(cuda_device, torch.bfloat16)
            ref = ttopk.topk_exact_reference(index._dev_x[:index.ntotal], q[None], 20)
            tie_aware_equal([h["row_id"] for h in hits], [h["similarity_score"] for h in hits],
                            ref.indices[0].cpu().numpy(), ref.scores[0].cpu().numpy())
        with pytest.raises(urllib.error.HTTPError) as err:
            remote.search_vector(np.zeros(31, np.float32))
        assert err.value.code == 400
    finally:
        peer.stop_server()
