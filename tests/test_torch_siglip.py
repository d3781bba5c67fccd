"""The port's SigLIP towers (``models/siglip.py``) against the plain
reference the benchmark's ``correct`` uses (``perfbench/reference/siglip.py``).

On the CPU at ``SiglipConfig.tiny_test()`` size, over seeded weights in HF
names (``perfbench/weights_siglip.py``):

- the vision tower, the text tower and the MAP head alone, in f32, within
  1e-5 (the same operations; sums in another order, einsum against matmul);
- in bf16, every embedding's cosine with the f32 reference at least 0.999
  (bf16 keeps 8 bits: two layers of rounding at these widths read
  0.9995 and above);
- HF ``SiglipModel`` names through ``models.convert`` both ways, and the
  port and the reference equal to ``transformers.SiglipModel`` itself;
- SigLIP's processor: mean and std 0.5 and a straight bicubic resize, on
  the device and on the host;
- the facade building the embedder ``model.name`` names, and a build and
  search of a tiny index 48 wide;
- CLIP's blocks unchanged by the explicit MLP width; W8A8 and ``int8_attn``
  refused.

On a card (``cuda`` marker): B3 against its plain version at the two
SigLIP shapes, each launch inside an ``attn.b3`` span of its shape, and the
tiny towers in bf16 against the reference.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch import trace
from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv
from intelligent_video_analysis_retrieval_system_tpu_torch.models import siglip as tsig
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import preprocess as tpre
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
    SearchOptions,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config
from perfbench import weights_siglip
from perfbench.reference import siglip as ref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CFG = tsig.SiglipConfig.tiny_test()
ATOL_F32 = 1e-5
COS_BF16 = 0.999


def _json_config(cfg: tsig.SiglipConfig) -> dict:
    """The benchmark's configuration file at ``cfg``'s widths."""
    out = json.loads((REPO / "perfbench" / "configs" / "siglip-so400m-patch14-384.json").read_text())
    v, t = cfg.vision, cfg.text
    out["vision_config"].update(
        image_size=v.image_size, patch_size=v.patch_size, hidden_size=v.hidden_size,
        intermediate_size=v.intermediate_size, num_hidden_layers=v.num_layers,
        num_attention_heads=v.num_heads)
    out["text_config"].update(
        vocab_size=t.vocab_size, max_position_embeddings=t.max_length, hidden_size=t.hidden_size,
        intermediate_size=t.intermediate_size, num_hidden_layers=t.num_layers,
        num_attention_heads=t.num_heads)
    return out


JCFG = _json_config(CFG)


@pytest.fixture(scope="module")
def sd():
    return weights_siglip.make(JCFG, 2**31 + 7, torch.device("cpu"))


def _model(sd, dtype=torch.float32, precision="default", device="cpu"):
    m = tconv.empty_model(CFG, device, dtype=dtype, precision=precision)
    m.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
    return m.eval()


def _pixels(n=3, size=CFG.vision.image_size, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                                  dtype=np.uint8))


def _tokens(n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.text.vocab_size, (n, CFG.text.max_length), generator=g)


def _normalized(px, dtype=torch.float32):
    return tpre.normalize_images(px, tsig.SIGLIP_IMAGE_MEAN, tsig.SIGLIP_IMAGE_STD, dtype)


def _cos(a, b):
    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_vision_tower_matches_reference_f32(sd, precision):
    px = _pixels()
    with torch.no_grad():
        got = _model(sd, precision=precision).encode_image(_normalized(px))
    torch.testing.assert_close(got, ref.image_embed(sd, JCFG, px), atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_text_tower_matches_reference_f32(sd, precision):
    tok = _tokens()
    with torch.no_grad():
        got = _model(sd, precision=precision).encode_text(tok)
    torch.testing.assert_close(got, ref.text_embed(sd, JCFG, tok), atol=ATOL_F32, rtol=0)


def test_map_head_alone_matches_reference(sd):
    x = torch.randn(4, 16, CFG.vision.hidden_size, generator=torch.Generator().manual_seed(1))
    head = _model(sd).vision_model.head
    w = {k: v for k, v in sd.items() if k.startswith("vision_model.head.")}
    with torch.no_grad():
        got = head(x)
    want = ref._map_head(x, w, "vision_model.head", CFG.vision.num_heads, ref._dense)
    torch.testing.assert_close(got, want, atol=ATOL_F32, rtol=0)
    # one row an image, whatever the number of tokens attended over
    assert got.shape == (4, CFG.vision.hidden_size)


def test_bf16_towers_keep_cosine_with_the_reference(sd):
    px, tok = _pixels(8, seed=3), _tokens(8, seed=3)
    m = _model(sd, dtype=torch.bfloat16)
    with torch.no_grad():
        img, txt = m.encode_image(_normalized(px, torch.bfloat16)), m.encode_text(tok)
    assert img.dtype == txt.dtype == torch.bfloat16
    assert _cos(img, ref.image_embed(sd, JCFG, px)).min() >= COS_BF16
    assert _cos(txt, ref.text_embed(sd, JCFG, tok)).min() >= COS_BF16


def test_logits_are_the_sigmoid_loss_scores(sd):
    px, tok = _pixels(2), _tokens(3)
    with torch.no_grad():
        got = _model(sd)(_normalized(px), tok)
    want = ref.logits(sd, ref.image_embed(sd, JCFG, px), ref.text_embed(sd, JCFG, tok))
    torch.testing.assert_close(got, want, atol=ATOL_F32, rtol=0)
    assert math.isclose(float(sd["logit_bias"]), -10.0)


HF_TOP = {  # every SiglipModel name outside the blocks
    "logit_scale", "logit_bias",
    "text_model.embeddings.token_embedding.weight",
    "text_model.embeddings.position_embedding.weight",
    "text_model.final_layer_norm.weight", "text_model.final_layer_norm.bias",
    "text_model.head.weight", "text_model.head.bias",
    "vision_model.embeddings.patch_embedding.weight",
    "vision_model.embeddings.patch_embedding.bias",
    "vision_model.embeddings.position_embedding.weight",
    "vision_model.post_layernorm.weight", "vision_model.post_layernorm.bias",
    "vision_model.head.probe",
    "vision_model.head.attention.in_proj_weight", "vision_model.head.attention.in_proj_bias",
    "vision_model.head.attention.out_proj.weight", "vision_model.head.attention.out_proj.bias",
    "vision_model.head.layernorm.weight", "vision_model.head.layernorm.bias",
    "vision_model.head.mlp.fc1.weight", "vision_model.head.mlp.fc1.bias",
    "vision_model.head.mlp.fc2.weight", "vision_model.head.mlp.fc2.bias",
}
HF_LAYER = {f"{m}.{k}" for m in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                                 "self_attn.out_proj", "layer_norm1", "layer_norm2",
                                 "mlp.fc1", "mlp.fc2") for k in ("weight", "bias")}


def test_hf_names_round_trip(sd):
    names = set(HF_TOP)
    for tower in ("vision_model", "text_model"):
        names |= {f"{tower}.encoder.layers.{i}.{k}" for i in range(2) for k in HF_LAYER}
    model = _model(sd)
    assert set(model.state_dict()) == names == set(sd)
    # an HF state dict with its buffers loads through convert and comes back
    hf = dict(sd, **{"vision_model.embeddings.position_ids": torch.arange(16)[None],
                     "logit_scale": sd["logit_scale"].reshape(1)})
    back = _model(tconv.from_hf_state_dict(hf, CFG)).state_dict()
    assert set(back) == names
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="lacks"):
        tconv.from_hf_state_dict({k: v for k, v in sd.items() if "head.probe" not in k}, CFG)


def test_port_and_reference_equal_hf_siglip(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=512, hidden_size=48, intermediate_size=136,
                         num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=16),
        vision_config=dict(image_size=38, patch_size=8, hidden_size=48, intermediate_size=136,
                           num_hidden_layers=2, num_attention_heads=4))
    hf = transformers.SiglipModel(hf_cfg).eval()
    with torch.no_grad():   # off HF's init, so every bias and LayerNorm counts
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    hf.save_pretrained(tmp_path)
    cfg, loaded = tconv.load_clip(tmp_path)
    assert cfg == CFG
    px, tok = _pixels(), _tokens()
    with torch.no_grad():
        pv = ((px.float() / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
        want_img = hf.get_image_features(pixel_values=pv)
        want_txt = hf.get_text_features(input_ids=tok)
        m = _model(loaded)
        got_img, got_txt = m.encode_image(_normalized(px)), m.encode_text(tok)
    sd_hf = hf.state_dict()
    for got, want in ((got_img, want_img), (got_txt, want_txt),
                      (ref.image_embed(sd_hf, JCFG, px), want_img),
                      (ref.text_embed(sd_hf, JCFG, tok), want_txt)):
        torch.testing.assert_close(got, want, atol=ATOL_F32, rtol=0)


def test_preprocess_takes_siglips_constants_and_straight_resize():
    px = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 40, 56, 3),
                                                            dtype=np.uint8))
    got = tpre.preprocess_images(px, 32, torch.float32, tsig.SIGLIP_IMAGE_MEAN,
                                 tsig.SIGLIP_IMAGE_STD, crop=False)
    resized = tpre.resize_bilinear(px, 32, 32, method="bicubic", antialias=True)
    torch.testing.assert_close(got, (resized / 255.0 - 0.5) / 0.5, atol=1e-5, rtol=0)
    # CLIP's path is unchanged: shortest side to 32, then the center
    clip = tpre.preprocess_images(px, 32, torch.float32)
    want = tpre.normalize_images(tpre.center_crop(tpre.resize_bilinear(
        px, 32, 45, method="bicubic"), 32), dtype=torch.float32)
    torch.testing.assert_close(clip, want, atol=0, rtol=0)
    from PIL import Image

    img = Image.fromarray(px[0].numpy())
    assert tpre.fit_image(img, 32, crop=False).size == (32, 32)
    np.testing.assert_array_equal(np.asarray(tpre.fit_image(img, 32, crop=False)),
                                  np.asarray(img.resize((32, 32), Image.BICUBIC)))


def _embedder(sd, **kwargs):
    emb = CLIPEmbedder(config=CFG, compute_dtype="float32", device="cpu", **kwargs)
    emb.load_params({k: v.clone() for k, v in sd.items()})
    return emb


def test_embedder_runs_the_siglip_family(sd):
    emb = _embedder(sd)
    assert isinstance(emb.model, tsig.SiglipModel)
    assert emb.embed_dim == CFG.vision.hidden_size and not emb.center_crop
    px = _pixels(3)
    got = emb.encode_images(px.numpy())                    # native size: normalize only
    want = ref.normalize(ref.image_embed(sd, JCFG, px)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_F32)
    big = np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    s = CFG.vision.image_size
    resized = tpre.resize_bilinear(torch.from_numpy(big), s, s, method="bicubic")
    want = ref.normalize(ref.image_embed(sd, JCFG, resized.round().clamp(0, 255))).numpy()
    got = emb.encode_images(big)                           # straight resize on the device
    assert float(np.min(np.sum(got * want, axis=-1))) > 0.999
    txt = emb.encode_text(["a red car", "a boat at night"])
    assert txt.shape == (2, CFG.text.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(txt, axis=-1), 1.0, atol=1e-5)


def test_embedder_counts_tokens_through_the_tower(sd):
    emb = _embedder(sd)
    trace.enable()
    try:
        emb.encode_images(_pixels(3).numpy())
    finally:
        trace.disable()
    spans = trace.take()
    images = [s for s in spans if s.name == "embed.images"]
    pool = [s for s in spans if s.name == "embed.pool"]
    assert len(images) == 1 and images[0].counts == {"embed.tokens": 8 * CFG.vision.seq_len}
    assert len(pool) == 1 and pool[0].attrs == {"images": 8, "tokens": CFG.vision.num_patches}
    assert pool[0].parent is not None


def test_facade_builds_the_named_towers(tmp_path):
    over = {"model": {"name": "siglip-so400m-patch14-384"}}
    system = EnhancedRetrievalSystem(Config(config_file=None, base_dir=tmp_path, overrides=over),
                                     device="cpu")
    assert system.embedder._config_override == tsig.SiglipConfig.so400m_patch14_384()
    assert system.config.get("model.embed_dim") == 1152
    assert system.config.get("model.image_size") == 384
    assert not system.embedder._loaded        # nothing built at the published size
    default = EnhancedRetrievalSystem(Config(config_file=None, base_dir=tmp_path / "d"),
                                      device="cpu")
    assert default.embedder._config_override == tclip.CLIPConfig.vit_l_14()
    assert default.config.get("model.embed_dim") == 768
    with pytest.raises(ValueError, match="unknown model.name"):
        EnhancedRetrievalSystem(Config(config_file=None, base_dir=tmp_path / "x",
                                       overrides={"model": {"name": "clip-vit-h"}}), device="cpu")


def test_facade_builds_and_searches_a_siglip_index(sd, tmp_path):
    from PIL import Image

    root = tmp_path / "keyframes"
    rng = np.random.default_rng(6)
    for v in range(2):
        (root / f"v{v}").mkdir(parents=True)
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
                root / f"v{v}" / f"{i}.jpg")
    over = {"model": {"name": "siglip-so400m-patch14-384"}, "index": {"chunk_size": 8}}
    system = EnhancedRetrievalSystem(Config(config_file=None, base_dir=tmp_path, overrides=over),
                                     embedder=_embedder(sd), device="cpu")
    out = system.build_system(root, output_path=tmp_path / "i.rvdb")
    assert out["report"]["processed"] == 12
    assert system.index._dev_x.shape[1] == CFG.vision.hidden_size
    hits = system.search("a red car", SearchOptions(limit=5, use_cache=False))
    assert len(hits) == 5
    # an indexed keyframe finds itself: the builder resized it as the embedder does
    img = np.asarray(Image.open(root / "v1" / "3.jpg").convert("RGB"))
    best = system.search_by_image(img, SearchOptions(limit=1, use_cache=False))[0]
    assert (best["folder"], best["image"]) == ("v1", "3.jpg")
    assert best["similarity_score"] > 0.999
    system.cleanup()


def test_clip_blocks_unchanged_by_the_explicit_mlp_width():
    m = tconv.empty_model(tclip.CLIPConfig.vit_l_14(), "meta")
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes["vision_model.encoder.layers.0.mlp.fc1.weight"] == (4096, 1024)
    assert shapes["text_model.encoder.layers.11.mlp.fc2.weight"] == (768, 3072)
    assert len(shapes) == len(tconv.empty_model(tclip.CLIPConfig.vit_l_14(), "meta").state_dict())
    blk = tclip.TransformerBlock(256, 4, 512, fused_mlp=True)
    assert blk.mlp.fc1.out_features == 512 and blk.fused_mlp
    # SigLIP's 4,304 is no multiple of 1,152, and too wide for B4: never fused
    sig = tclip.TransformerBlock(1152, 16, 4304, act="gelu_tanh", fused_mlp=True)
    assert sig.mlp.fc1.out_features == 4304 and not sig.fused_mlp


@pytest.mark.parametrize("flag", ["w8a8", "w8a8_static", "int8_attn"])
def test_int8_modes_raise_for_siglip(flag):
    with pytest.raises(ValueError, match="no int8 mode"):
        tsig.SiglipModel(CFG, **{flag: True})


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_embedder_raises_for_siglip(mode):
    with pytest.raises(ValueError, match="no int8 mode"):
        CLIPEmbedder(config=CFG, compute_dtype=mode, device="cpu").ensure_loaded()


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B3 has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,variant", [(2, 729, "wgmma"), (8, 64, "registers")])
def test_b3_at_siglips_shapes(card, b, t, variant):
    gen = torch.Generator(device=card).manual_seed(t)
    q, k, v = (torch.randn(b, t, 1152, generator=gen, device=card).to(torch.bfloat16)
               for _ in range(3))
    assert attention.mha_plan(t, 72)["variant"] == variant
    trace.enable()
    try:
        got = attention.fused_mha(q, k, v, 16)
    finally:
        trace.disable()
    spans = [s for s in trace.take() if s.name == "attn.b3"]
    assert [s.attrs for s in spans] == [dict(batch=b, tokens=t, dim=1152, heads=16,
                                             variant=variant)]
    want = attention._einsum_attention(q, k, v, 16)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_towers_on_the_card_match_the_reference(card, sd):
    m = _model(sd, dtype=torch.bfloat16, device=card)
    px, tok = _pixels(8, seed=7), _tokens(8, seed=7)
    launches = attention.fused_mha.launches
    with torch.no_grad():
        img = m.encode_image(_normalized(px.to(card), torch.bfloat16))
        txt = m.encode_text(tok.to(card))
    assert attention.fused_mha.launches - launches == 2 * CFG.vision.num_layers
    assert _cos(img.cpu(), ref.image_embed(sd, JCFG, px)).min() >= COS_BF16
    assert _cos(txt.cpu(), ref.text_embed(sd, JCFG, tok)).min() >= COS_BF16
