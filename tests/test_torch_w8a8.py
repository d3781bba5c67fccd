"""The W8A8 tower modes of the PyTorch port against the JAX package.

Every test gives both packages the same numpy-seeded inputs and the same
weights (a JAX init of ``CLIPConfig.tiny_test()`` carried across by
``models.convert.from_jax_params``).

- ``ops.quant.w8a8_dense`` equals the JAX ``w8a8_dense`` run eagerly, bit
  for bit: dynamic and static scales, f32 and bf16, 2-D and 3-D inputs, with
  and without bias, at widths that are multiples of 8 and at odd ones (the
  port pads for ``torch._int_mm``). Against the jitted JAX op it is held to
  2.5e-7 relative in f32 and one bf16 step: under ``jit`` XLA turns the
  divisions by 127 and by the closed-over static scale into multiplications
  by reciprocals.
- Int8 attention (``int8_attn``, unmasked only) and the towers with ``w8a8``
  / ``w8a8_static`` against Flax: cosine >= 0.9999 in f32 and >= 0.999 in
  bf16 (the towers' bf16 gate), the static towers given the scale tree JAX
  calibrated.
- ``calibrate_act_scales``: the JAX key set, values within rtol 1e-5 in
  f32 (the maxima of activations that differ by f32 rounding);
  ``act_stats_to_scales``: bit for bit.
- The embedder's ``int8_static`` mode: frozen after ``_CAL_BATCHES`` batches
  per tower, ``self_test`` never counted, ``calibrate()``, ``load_params``
  resetting calibration; its scales against the JAX embedder's on the same
  batches (rtol 2e-2: maxima of bf16 activations that the two frameworks
  round at different places); the act-scales file across packages both
  ways; the facade's ``<index>.act_scales.json`` on build, load and attach,
  one written by JAX among them; the health warning; CLI ``build`` and
  ``search`` with ``--compute-dtype int8_static``.
- ``compute_dtype="float16"`` runs bf16 as the JAX embedder does (it was
  refused before): cosine >= 0.999 against the JAX embedder.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.models import calibrate as jcal
from intelligent_video_analysis_retrieval_system_tpu.models import clip as jclip
from intelligent_video_analysis_retrieval_system_tpu.ops.quant import w8a8_dense as jax_w8a8
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
from intelligent_video_analysis_retrieval_system_tpu_torch.models import calibrate as tcal
from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant as tquant
from intelligent_video_analysis_retrieval_system_tpu_torch.system import embedder as temb_mod
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
    SearchOptions,
)

torch.set_num_threads(2)

CFG_J = jclip.CLIPConfig.tiny_test()
CFG_T = tclip.CLIPConfig.tiny_test()
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
COS = {"float32": 0.9999, "bfloat16": 0.999}


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(0)
    px = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 500, (1, 16)).astype(np.int32)
    params = jclip.CLIPModel(CFG_J).init(jax.random.PRNGKey(0), px, toks)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 500, (3, 16)).astype(np.int32)
    toks[:, 0] = 500
    eot = np.array([5, 9, 15])
    toks[np.arange(3), eot] = 511          # EOT = largest id
    return px, toks, eot


def _port_model(params, dtype, **flags):
    m = tconv.empty_model(CFG_T, "cpu", dtype=dtype, **flags)
    m.load_state_dict(tconv.from_jax_params(params, CFG_T))
    return m.eval()


def _cos(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.float32(np.asarray(v))
    return out


def _run(model, tower, px, toks, eot):
    with torch.inference_mode():
        if tower == "vision":
            return model.encode_image(torch.from_numpy(px).to(model.dtype)).float().numpy()
        return model.encode_text(torch.from_numpy(toks), torch.from_numpy(eot)).float().numpy()


def _run_jax(model, variables, tower, px, toks, eot, dtype):
    if tower == "vision":
        out = model.apply(variables, jnp.asarray(px, dtype), method=jclip.CLIPModel.encode_image)
    else:
        out = model.apply(variables, jnp.asarray(toks), jnp.asarray(eot),
                          method=jclip.CLIPModel.encode_text)
    return np.asarray(out.astype(jnp.float32))


def _jax_scales(params, px, toks, eot, dtype=jnp.float32):
    """The JAX calibration of both towers: ``{"vision": ..., "text": ...}``."""
    dyn = jclip.CLIPModel(CFG_J, dtype=dtype, w8a8=True)
    v = jcal.calibrate_act_scales(dyn, {"params": params}, [(jnp.asarray(px, dtype),)],
                                  method=jclip.CLIPModel.encode_image)["act_scales"]
    t = jcal.calibrate_act_scales(dyn, {"params": params},
                                  [(jnp.asarray(toks), jnp.asarray(eot))],
                                  method=jclip.CLIPModel.encode_text)["act_scales"]
    return {**v, **t}


# ---------------------------------------------------------------------------
# ops.quant.w8a8_dense
# ---------------------------------------------------------------------------

SHAPES = {"even": (19, 48, 40), "odd": (5, 45, 37)}


def _dense_case(shape, ndim, bias, seed=0):
    m, k, n = SHAPES[shape]
    rng = np.random.default_rng(seed)
    lead = (m,) if ndim == 2 else (2, m)
    x = (rng.standard_normal((*lead, k)) * 2).astype(np.float32)
    x[..., 0, 3] = 9.0                      # one outlier per row block
    kernel = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    # static: a scale that saturates the outliers
    a_scale = np.float32(0.6 * np.abs(x).max() / 127.0)
    return x, kernel, b, a_scale


@pytest.mark.parametrize("shape", ["even", "odd"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dense_equals_jax_eager_bit_for_bit(dtype, static, ndim, bias, shape):
    x, kernel, b, a_scale = _dense_case(shape, ndim, bias)
    jdt, tdt = DT[dtype]
    want = jax_w8a8(jnp.asarray(x, jdt), jnp.asarray(kernel),
                    None if b is None else jnp.asarray(b),
                    a_scale=jnp.float32(a_scale) if static else None)
    calls = tquant.w8a8_dense.calls
    got = tquant.w8a8_dense(torch.from_numpy(x).to(tdt), torch.from_numpy(kernel.T.copy()),
                            None if b is None else torch.from_numpy(b),
                            a_scale=torch.tensor(a_scale) if static else None)
    assert tquant.w8a8_dense.calls == calls + 1
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dense_near_jax_jit(dtype, static):
    x, kernel, b, a_scale = _dense_case("even", 3, True, seed=3)
    jdt, tdt = DT[dtype]
    a = jnp.float32(a_scale) if static else None
    fn = jax.jit(lambda x, w, b: jax_w8a8(x, w, b, a_scale=a))
    want = np.asarray(fn(jnp.asarray(x, jdt), jnp.asarray(kernel), jnp.asarray(b))
                      .astype(jnp.float32))
    got = tquant.w8a8_dense(torch.from_numpy(x).to(tdt), torch.from_numpy(kernel.T.copy()),
                            torch.from_numpy(b),
                            a_scale=torch.tensor(a_scale) if static else None).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=2.5e-7)
    else:   # one bf16 step of the larger magnitude
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= step)


def test_int_mm_pads_shapes_its_cuda_route_refuses():
    rng = np.random.default_rng(4)
    for m, k, n in ((1, 8, 8), (16, 64, 64), (5, 45, 37), (33, 7, 3)):
        x8 = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        w8 = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        got = tquant._int_mm(x8, w8)
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        assert torch.equal(got, (x8.long() @ w8.long().T).int())


def test_weight_quant_is_taken_from_the_f32_parameter_and_cached():
    d = tclip.Dense(48, 40, w8a8=True)
    torch.nn.init.normal_(d.weight)
    x = torch.randn(2, 7, 48, dtype=torch.bfloat16)
    with torch.no_grad():
        d(x)
        w8, ws = d._q[1]
        want8, want_s = tquant.quantize_weight_int8(d.weight)
        assert torch.equal(w8, want8) and torch.equal(ws, want_s)
        d(x)
        assert d._q[1][0] is w8                       # cached
        d.weight.mul_(2.0)                            # a new version: quantized again
        d(x)
        assert d._q[1][0] is not w8 and torch.equal(d._q[1][1], ws * 2)
    # never from the bf16 copy: the f32 maxima give other scales than bf16's
    wb = d.weight.detach().bfloat16().float()
    assert not torch.equal(tquant.quantize_weight_int8(wb)[1], d._q[1][1])


# ---------------------------------------------------------------------------
# int8 attention and the W8A8 towers against Flax
# ---------------------------------------------------------------------------


def _port_mha(jparams, d, heads, **flags):
    mha = tclip.MultiHeadAttention(d, heads, **flags)
    sd = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(jparams[name]["kernel"]).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.array(jparams[name]["bias"]))
    mha.load_state_dict(sd)
    return mha.eval()


@pytest.mark.parametrize("w8a8", [False, True])
def test_mha_int8_attn_matches_flax(w8a8):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    jm = jclip.MultiHeadAttention(num_heads=4, dtype=jnp.float32, w8a8=w8a8, int8_attn=True)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    mha = _port_mha(params, 64, 4, w8a8=w8a8, int8_attn=True)
    with torch.inference_mode():
        got = mha(torch.from_numpy(x)).numpy()
    cos = _cos(got.reshape(-1, 64), want.reshape(-1, 64))
    assert cos.min() >= 0.9999, cos.min()
    # the int8 route really ran: it is not the float attention
    plain_mha = _port_mha(params, 64, 4, w8a8=w8a8)
    with torch.inference_mode():
        plain = plain_mha(torch.from_numpy(x)).numpy()
    assert not np.array_equal(got, plain)


def test_int8_attn_leaves_masked_attention_on_the_standard_path():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 9, 48)).astype(np.float32))
    mask = torch.triu(torch.full((9, 9), float("-inf")), diagonal=1)[None, None]
    a = tclip.MultiHeadAttention(48, 4, int8_attn=True)
    b = tclip.MultiHeadAttention(48, 4)
    b.load_state_dict(a.state_dict())
    with torch.inference_mode():
        assert torch.equal(a(x, mask), b(x, mask))
        assert not torch.equal(a(x), b(x))


def test_vision_tower_w8a8_static_int8_attn_matches_flax(jax_params, inputs):
    px, toks, eot = inputs
    scales = _jax_scales(jax_params, px, toks, eot)
    jm = jclip.CLIPModel(CFG_J, dtype=jnp.float32, w8a8=True, w8a8_static=True,
                         int8_attn=True)
    want = _run_jax(jm, {"params": jax_params, "act_scales": scales}, "vision", px, toks,
                    eot, jnp.float32)
    m = _port_model(jax_params, torch.float32, w8a8=True, w8a8_static=True, int8_attn=True)
    tcal.set_act_scales(m, scales)
    got = _run(m, "vision", px, toks, eot)
    assert _cos(got, want).min() >= 0.9999, _cos(got, want)


@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_model_w8a8_matches_flax(jax_params, inputs, dtype, tower):
    px, toks, eot = inputs
    jdt, tdt = DT[dtype]
    want = _run_jax(jclip.CLIPModel(CFG_J, dtype=jdt, w8a8=True), {"params": jax_params},
                    tower, px, toks, eot, jdt)
    calls = tquant.w8a8_dense.calls
    got = _run(_port_model(jax_params, tdt, w8a8=True), tower, px, toks, eot)
    # six int8 products a layer
    assert tquant.w8a8_dense.calls - calls == 6 * 2
    assert _cos(got, want).min() >= COS[dtype], _cos(got, want)


@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_model_w8a8_static_matches_flax(jax_params, inputs, dtype, tower):
    px, toks, eot = inputs
    jdt, tdt = DT[dtype]
    scales = _jax_scales(jax_params, px, toks, eot)
    want = _run_jax(jclip.CLIPModel(CFG_J, dtype=jdt, w8a8=True, w8a8_static=True),
                    {"params": jax_params, "act_scales": scales}, tower, px, toks, eot, jdt)
    m = _port_model(jax_params, tdt, w8a8=True, w8a8_static=True)
    tcal.set_act_scales(m, scales)
    got = _run(m, tower, px, toks, eot)
    assert _cos(got, want).min() >= COS[dtype], _cos(got, want)
    # the scales are in use: a static model without them gives another answer
    bare = _run(_port_model(jax_params, tdt, w8a8=True, w8a8_static=True), tower, px, toks, eot)
    assert not np.array_equal(got, bare)


# ---------------------------------------------------------------------------
# models.calibrate
# ---------------------------------------------------------------------------


def test_calibrate_act_scales_matches_jax(jax_params, inputs):
    px, toks, eot = inputs
    rng = np.random.default_rng(9)
    px2 = rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 1.5
    dyn = jclip.CLIPModel(CFG_J, dtype=jnp.float32, w8a8=True)
    want = jcal.calibrate_act_scales(
        dyn, {"params": jax_params}, [(jnp.asarray(px),), (jnp.asarray(px2),)],
        method=jclip.CLIPModel.encode_image, margin=1.1)["act_scales"]
    want.update(jcal.calibrate_act_scales(
        dyn, {"params": jax_params}, [(jnp.asarray(toks), jnp.asarray(eot))],
        method=jclip.CLIPModel.encode_text, margin=1.1)["act_scales"])
    m = _port_model(jax_params, torch.float32, w8a8=True)
    got = tcal.calibrate_act_scales(m, [(torch.from_numpy(px),), (torch.from_numpy(px2),)],
                                    method="encode_image", margin=1.1)["act_scales"]
    got.update(tcal.calibrate_act_scales(
        m, [(torch.from_numpy(toks), torch.from_numpy(eot))], method="encode_text",
        margin=1.1)["act_scales"])
    fw, fg = _flat(want), _flat(got)
    assert set(fg) == set(fw)
    assert len(fg) == 2 * 6 * 2          # towers x sites x layers
    assert ("vision", "transformer", "layer_1", "attn", "q_proj_ascale") in fg
    assert ("text", "transformer", "layer_0", "mlp_proj_ascale") in fg
    for key in fw:
        np.testing.assert_allclose(fg[key], fw[key], rtol=1e-5, err_msg=str(key))
    # a tower that did not run records nothing
    with torch.inference_mode(), tcal.record_act_stats(m) as stats:
        m.encode_text(torch.from_numpy(toks), torch.from_numpy(eot))
    assert list(stats) == ["text"]
    with pytest.raises(ValueError):
        tcal.calibrate_act_scales(m, [])


@pytest.mark.parametrize("margin", [1.0, 1.1])
def test_act_stats_to_scales_bit_for_bit(margin):
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.lognormal(0, 3, 40), [0.0, 1e-7, 1e-6, 127.0]]).astype(np.float32)
    stats = {"vision": {"transformer": {f"layer_{i}": {"attn": {"q_proj_amax": vals[2 * i]},
                                                       "mlp_fc_amax": vals[2 * i + 1]}
                                        for i in range(len(vals) // 2)}}}
    want = jcal.act_stats_to_scales(jax.tree_util.tree_map(jnp.float32, stats), margin)
    got = tcal.act_stats_to_scales(
        jax.tree_util.tree_map(lambda v: torch.tensor(v), stats), margin)
    fw, fg = _flat(want), _flat(got)
    assert set(fw) == set(fg)
    for key in fw:
        assert fg[key].tobytes() == fw[key].tobytes(), key
    with pytest.raises(ValueError):
        tcal.act_stats_to_scales({"x_max": 1.0})


# ---------------------------------------------------------------------------
# the embedder's int8 / int8_static / float16 modes
# ---------------------------------------------------------------------------


def _embedders(jax_params, mode):
    jemb = JaxEmbedder(config=CFG_J, compute_dtype=mode)
    jemb.load_params(jax.tree_util.tree_map(jnp.asarray, jax_params))
    temb = CLIPEmbedder(config=CFG_T, compute_dtype=mode, device="cpu")
    temb.load_params(tconv.from_jax_params(jax_params, CFG_T))
    return jemb, temb


def _batches(seed=12):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8) for _ in range(4)]
    texts = [[f"a photo of scene {i}", f"people at dusk {i}"] for i in range(4)]
    return images, texts


def test_embedder_int8_static_calibrates_like_jax(jax_params):
    jemb, temb = _embedders(jax_params, "int8_static")
    for emb in (jemb, temb):
        assert emb.get_stats()["act_scales_calibrated"] == []
        assert emb._cal_seen == {"vision": 0, "text": 0}   # self_test never counts
    images, texts = _batches()
    cal = temb_mod._CAL_BATCHES
    assert (cal, temb_mod._CAL_MARGIN) == (4, 1.1)
    for i in range(cal):
        for emb in (jemb, temb):
            emb.encode_images(images[i])
            emb.encode_text(texts[i])
            emb.self_test()
        want = ["text", "vision"] if i == cal - 1 else []
        assert temb.get_stats()["act_scales_calibrated"] == want
        assert jemb.get_stats()["act_scales_calibrated"] == want
    fj, ft = (_flat(e._act_scales) for e in (jemb, temb))
    assert set(ft) == set(fj) and len(ft) == 24
    for key in fj:
        np.testing.assert_allclose(ft[key], fj[key], rtol=2e-2, err_msg=str(key))
    # static now: no more calibration, the encodes agree with JAX's
    calls = tquant.w8a8_dense.calls
    got = temb.encode_images(images[0])
    assert tquant.w8a8_dense.calls - calls == 12 and temb._cal_seen["vision"] == cal
    assert _cos(got, jemb.encode_images(images[0])).min() >= 0.99
    assert np.isfinite(temb.encode_text(["after"])).all()
    # load_params resets calibration
    temb.load_params(tconv.from_jax_params(jax_params, CFG_T))
    assert temb.get_stats()["act_scales_calibrated"] == [] and \
        temb._cal_seen == {"vision": 0, "text": 0}
    # calibrate() freezes what has been observed
    temb.encode_text(texts[0])
    temb.calibrate()
    assert temb.get_stats()["act_scales_calibrated"] == ["text"]


def test_calibration_maxima_count_the_pad_rows(jax_params):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.preprocess import (
        normalize_images,
    )

    temb = CLIPEmbedder(config=CFG_T, compute_dtype="int8_static", device="cpu")
    temb.load_params(tconv.from_jax_params(jax_params, CFG_T))
    grey = np.full((3, 32, 32, 3), 128, np.uint8)          # padded with black to 8
    temb.encode_images(grey)
    got = _flat(temb._cal_stats["vision"])

    def maxima(images):
        px = normalize_images(torch.from_numpy(images), dtype=torch.bfloat16)
        with torch.inference_mode(), tcal.record_act_stats(temb._dynamic_model) as stats:
            temb._dynamic_model.encode_image(px)
        return _flat(tcal.merge_act_stats(None, stats["vision"]))

    padded = maxima(np.concatenate([grey, np.zeros((5, 32, 32, 3), np.uint8)]))
    assert all(got[k].tobytes() == padded[k].tobytes() for k in padded)
    unpadded = maxima(grey)
    assert any(got[k] != unpadded[k] for k in unpadded)


def test_embedder_int8_matches_jax_and_counts_its_products(jax_params):
    jemb, temb = _embedders(jax_params, "int8")
    images, texts = _batches(13)
    calls = tquant.w8a8_dense.calls
    got = temb.encode_images(images[0])
    assert tquant.w8a8_dense.calls - calls == 6 * CFG_T.vision.num_layers
    assert _cos(got, jemb.encode_images(images[0])).min() >= 0.999
    assert _cos(temb.encode_text(texts[0]), jemb.encode_text(texts[0])).min() >= 0.999
    assert temb.get_stats()["act_scales_calibrated"] == []
    assert temb.model.vision_model.encoder.layers[0].mlp.fc1.w8a8


def test_float16_runs_bf16_like_the_jax_embedder(jax_params):
    jemb, temb = _embedders(jax_params, "float16")
    assert temb.get_stats()["compute_dtype"] == "float16" == jemb.get_stats()["compute_dtype"]
    assert temb.model.dtype == torch.bfloat16
    images, texts = _batches(14)
    assert _cos(temb.encode_images(images[1]), jemb.encode_images(images[1])).min() >= 0.999
    assert _cos(temb.encode_text(texts[1]), jemb.encode_text(texts[1])).min() >= 0.999
    with pytest.raises(ValueError):
        CLIPEmbedder(compute_dtype="float8", device="cpu")


def test_act_scales_files_load_across_packages(jax_params, tmp_path):
    jemb, temb = _embedders(jax_params, "int8_static")
    assert not temb.export_act_scales(tmp_path / "none.json")      # nothing frozen yet
    assert not temb.import_act_scales(tmp_path / "missing.json")
    images, texts = _batches(15)
    for emb in (jemb, temb):
        emb.encode_images(images[0])
        emb.encode_text(texts[0])
        emb.calibrate()
    assert jemb.export_act_scales(tmp_path / "jax.json")
    assert temb.export_act_scales(tmp_path / "port.json")
    assert not Path(str(tmp_path / "port.json") + ".tmp").exists()
    pj, pt = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json"))
    assert pt["format"] == pj["format"] == "ivars-act-scales-v1"
    assert set(pt["towers"]) == set(pj["towers"]) == {"text", "vision"}
    for tower in pj["towers"]:
        assert set(pt["towers"][tower]) == set(pj["towers"][tower])
    # the JAX file in a fresh port embedder, the port's in a fresh JAX one
    t2 = CLIPEmbedder(config=CFG_T, compute_dtype="int8_static", device="cpu")
    assert t2.import_act_scales(tmp_path / "jax.json")
    j2 = JaxEmbedder(config=CFG_J, compute_dtype="int8_static")
    assert j2.import_act_scales(tmp_path / "port.json")
    assert t2.get_stats()["act_scales_calibrated"] == ["text", "vision"]
    for a, b in ((t2, jemb), (j2, temb)):
        fa, fb = _flat(a._act_scales), _flat(b._act_scales)
        assert set(fa) == set(fb)
        for key in fb:
            assert fa[key].tobytes() == fb[key].tobytes(), key
    # imported scales are used at once (loading does not reset them): the
    # port encodes static from the first batch
    t2.ensure_loaded()
    t2.encode_text(texts[1])
    assert t2._cal_seen["text"] == 0
    (tmp_path / "bad.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError):
        t2.import_act_scales(tmp_path / "bad.json")


# ---------------------------------------------------------------------------
# the facade's sidecar, health and the CLI
# ---------------------------------------------------------------------------


def _write_keyframes(root: Path, n: int = 13):
    from PIL import Image

    rng = np.random.default_rng(16)
    (root / "map").mkdir(parents=True)
    (root / "keyframes" / "video_1").mkdir(parents=True)
    lines = ["n,pts_time,fps,frame_idx"]
    for i in range(1, n + 1):
        cells = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
        Image.fromarray(np.kron(cells, np.ones((8, 8, 1), np.uint8))).save(
            root / "keyframes" / "video_1" / f"{i}.jpg", quality=92)
        lines.append(f"{i},{i * 0.4},25.0,{i * 10}")
    (root / "map" / "video_1.csv").write_text("\n".join(lines) + "\n")
    return root / "keyframes", root / "map"


def _static_system(root: Path, jax_params):
    emb = CLIPEmbedder(config=CFG_T, compute_dtype="int8_static", device="cpu")
    emb.load_params(tconv.from_jax_params(jax_params, CFG_T))
    cfg = Config(config_file=None, base_dir=root,
                 overrides={"device": {"compute_dtype": "int8_static"},
                            "index": {"chunk_size": 3}})
    return EnhancedRetrievalSystem(cfg, embedder=emb, device="cpu")


def test_facade_persists_scales_beside_the_index(jax_params, tmp_path):
    keyframes, map_dir = _write_keyframes(tmp_path / "data")
    out_path = tmp_path / "idx" / "i.rvdb"
    out_path.parent.mkdir()
    sidecar = Path(f"{out_path}.act_scales.json")
    sidecar.write_text('{"format": "ivars-act-scales-v1", "towers": '
                       '{"vision": {"bogus_ascale": 99.0}}}')
    sys1 = _static_system(tmp_path / "s1", jax_params)
    try:
        out = sys1.build_system(keyframes, map_dir=map_dir, output_path=out_path)
        # 13 frames in chunks of 3: five encode batches, the vision tower froze
        assert out["report"]["processed"] == 13
        payload = json.loads(sidecar.read_text())
        assert list(payload["towers"]) == ["vision"] and "bogus" not in sidecar.read_text()
        assert "calibrating" in str(sys1.health.comprehensive_health_check()
                                    ["components"]["embedder"]["detail"])
        for i in range(temb_mod._CAL_BATCHES):
            sys1.search(f"query {i}", SearchOptions(use_cache=False))
        assert set(json.loads(sidecar.read_text())["towers"]) == {"text", "vision"}
        probe = [h["image"] for h in sys1.search("a probe", SearchOptions(use_cache=False))]
        assert probe
    finally:
        sys1.cleanup()

    # a restarted system loads them: static from the first query, same answer
    sys2 = _static_system(tmp_path / "s2", jax_params)
    try:
        sys2.load_system(out_path)
        assert sys2.embedder.get_stats()["act_scales_calibrated"] == ["text", "vision"]
        assert [h["image"] for h in sys2.search("a probe", SearchOptions(use_cache=False))] \
            == probe
        assert sys2.embedder._cal_seen == {"vision": 0, "text": 0}
    finally:
        sys2.cleanup()

    # a sidecar written by the JAX facade over the same index
    jemb = JaxEmbedder(config=CFG_J, compute_dtype="int8_static")
    jemb.load_params(jax.tree_util.tree_map(jnp.asarray, jax_params))
    jsys = JaxSystem(Config(config_file=None, base_dir=tmp_path / "j",
                            overrides={"device": {"compute_dtype": "int8_static"}}),
                     embedder=jemb)
    shutil.copy(out_path, tmp_path / "idx" / "copy.rvdb")
    jsys.load_system(tmp_path / "idx" / "copy.rvdb")
    for i in range(temb_mod._CAL_BATCHES):
        jemb.encode_text([f"jax query {i}"])
        jemb.encode_images(np.zeros((2, 32, 32, 3), np.uint8) + i * 40)
    jsys.cleanup()
    jfile = tmp_path / "idx" / "copy.rvdb.act_scales.json"
    assert set(json.loads(jfile.read_text())["towers"]) == {"text", "vision"}
    # ... loads in the port, through load_system and through attach_index
    sys3 = _static_system(tmp_path / "s3", jax_params)
    sys4 = _static_system(tmp_path / "s4", jax_params)
    try:
        sys3.load_system(tmp_path / "idx" / "copy.rvdb")
        index = UnifiedIndex(sys4._index_config(), device="cpu")
        index.load_unified_index(tmp_path / "idx" / "copy.rvdb")
        sys4.attach_index(index)
        fj = _flat(jemb._act_scales)
        for system in (sys3, sys4):
            got = _flat(system.embedder._act_scales)
            assert set(got) == set(fj)
            assert all(got[k].tobytes() == fj[k].tobytes() for k in fj)
    finally:
        sys3.cleanup()
        sys4.cleanup()


def test_health_warning_equals_jax(jax_params, tmp_path):
    jemb, temb = _embedders(jax_params, "int8_static")
    jsys = JaxSystem(Config(config_file=None, base_dir=tmp_path / "j"), embedder=jemb)
    tsys = EnhancedRetrievalSystem(Config(config_file=None, base_dir=tmp_path / "t"),
                                   embedder=temb, device="cpu")
    images, texts = _batches(17)
    want = jsys.health._check_embedder()
    assert "still calibrating (frozen: [])" in want["detail"]
    assert tsys.health._check_embedder() == want
    for i in range(temb_mod._CAL_BATCHES):
        for emb in (jemb, temb):
            emb.encode_text(texts[i])
    want = jsys.health._check_embedder()
    assert "(frozen: ['text'])" in want["detail"]
    assert tsys.health._check_embedder() == want
    for i in range(temb_mod._CAL_BATCHES):
        for emb in (jemb, temb):
            emb.encode_images(images[i])
    want = jsys.health._check_embedder()
    assert "calibrating" not in str(want["detail"])
    assert tsys.health._check_embedder() == want
    jsys.cleanup()
    tsys.cleanup()


def test_cli_build_and_search_int8_static(tmp_path, monkeypatch, capsys):
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    keyframes, map_dir = _write_keyframes(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tconv.CLIPConfig, "vit_l_14", classmethod(lambda cls: CFG_T))
    out = tmp_path / "out" / "s.rvdb"
    assert cli.main(["build", str(keyframes), "--output", str(out), "--map-dir", str(map_dir),
                     "--chunk-size", "3", "--compute-dtype", "int8_static",
                     "--device", "cpu"]) == 0
    assert "indexed 13 images" in capsys.readouterr().out
    payload = json.loads(Path(f"{out}.act_scales.json").read_text())
    assert list(payload["towers"]) == ["vision"]
    assert cli.main(["search", str(out), "a red car", "--device", "cpu", "--limit", "3",
                     "--compute-dtype", "int8_static", "--json"]) == 0
    hits = json.loads(capsys.readouterr().out)
    assert len(hits) == 3 and hits[0]["folder"] == "video_1"
    args = cli._build_parser().parse_args(["build", "k", "--compute-dtype", "float16"])
    assert args.compute_dtype == "float16"
