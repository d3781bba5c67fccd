"""The PyTorch port's weight loading and model inputs against the JAX package.

Seeded random init and local HF checkpoints (``models.convert.load_clip``),
the tokenizer copy (same ids as the JAX tokenizer on 20 strings) and the
image preprocessing (plain torch, NHWC, as the JAX package runs it with
``use_pallas=False``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.models import tokenizer as jtok
from intelligent_video_analysis_retrieval_system_tpu.ops import preprocess as jpre
from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv
from intelligent_video_analysis_retrieval_system_tpu_torch.models import tokenizer as ttok
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(2)

CFG_T = tclip.CLIPConfig.tiny_test()


_STRINGS = [
    "a red car at night", "A RED CAR AT NIGHT", "", "  spaces   everywhere  ",
    "người đàn ông đi xe đạp", "emoji 🚗🔥 test", "tab\tand\nnewline", "x" * 300,
    "numbers 12345 and 3.14", "punctuation!?!... (yes)", "it's the dog's bone",
    "café naïve résumé", "中文 查询", "hello world hello world", "a",
    "<|startoftext|> injected", "UPPER lower MiXeD", "hyphen-ated words",
    "a photo of a cat on a mat", "the quick brown fox jumps over the lazy dog",
]


def test_tokenizer_copy_matches_jax(tmp_path):
    a, b = ttok.SimpleTokenizer(vocab_size=512), jtok.SimpleTokenizer(vocab_size=512)
    np.testing.assert_array_equal(a(_STRINGS, 16), b(_STRINGS, 16))
    np.testing.assert_array_equal(a.eot_positions(a(_STRINGS)), b.eot_positions(b(_STRINGS)))
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\nh e\nl l\nhe ll\nhell o</w>\nr e\nc a\nca r</w>\n")
    ta, tb = ttok.CLIPTokenizer(merges), jtok.CLIPTokenizer(merges)
    for s in _STRINGS:
        assert ta.encode(s) == tb.encode(s)
    np.testing.assert_array_equal(ta(_STRINGS), tb(_STRINGS))


def test_load_clip_seeded_init():
    cfg, sd0 = tconv.load_clip(None, config=CFG_T, seed=0)
    _, sd0b = tconv.load_clip(None, config=CFG_T, seed=0)
    _, sd1 = tconv.load_clip(None, config=CFG_T, seed=1)
    assert cfg == CFG_T
    for k, v in sd0.items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all()
        assert torch.equal(v, sd0b[k])
    assert not torch.equal(sd0["text_projection.weight"], sd1["text_projection.weight"])
    assert torch.equal(sd0["vision_model.pre_layrnorm.weight"],
                       torch.ones(CFG_T.vision.hidden_size))


def test_load_clip_from_local_hf_checkpoint(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.CLIPConfig(
        projection_dim=32,
        text_config={"vocab_size": 512, "hidden_size": 48, "intermediate_size": 192,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "max_position_embeddings": 16, "hidden_act": "quick_gelu"},
        vision_config={"image_size": 32, "patch_size": 8, "hidden_size": 64,
                       "intermediate_size": 256, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "hidden_act": "quick_gelu"},
    )
    hf = transformers.CLIPModel(hf_cfg).eval()
    hf.save_pretrained(tmp_path)
    cfg, sd = tconv.load_clip(tmp_path)
    assert cfg == CFG_T
    ref = hf.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, ref[k].float())


def test_preprocess_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    for method in ("bilinear", "bicubic"):
        want = jpre.resize_bilinear(jnp.asarray(img), 20, 30, method=method)
        got = tpre.resize_bilinear(torch.from_numpy(img), 20, 30, method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        tpre.center_crop(torch.from_numpy(img), 32).numpy(),
        np.asarray(jpre.center_crop(jnp.asarray(img), 32)))
    want = jpre.normalize_images(jnp.asarray(img), dtype=jnp.float32, use_pallas=False)
    got = tpre.normalize_images(torch.from_numpy(img), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want = jpre.preprocess_images(jnp.asarray(img), image_size=32,
                                  dtype=jnp.float32, use_pallas=False)
    got = tpre.preprocess_images(torch.from_numpy(img), image_size=32, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
