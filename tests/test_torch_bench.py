"""The port's bench entry point on the CPU, at a small size.

- ``bench`` with ``--device cpu --rows 20000 --skip-10m`` and narrow towers
  prints one JSON line with the JAX bench's key names (the W8A8-static
  image tower's ``image_tower_fps_int8_static`` among them) and
  ``extra.not_ported``.
- The W8A8-static image tower's scales equal JAX ``calibrate_act_scales``
  on the same weights and batch within rtol 2e-2 (maxima of bf16
  activations, which the two frameworks round at different places), and
  its ``verify_static`` hook gets the timed model with those scales.
- The headline section's answers equal the JAX ``topk_search`` on the same
  rows and the same query vectors (tie-aware, atol 5e-4: bf16 rows, sums in
  another order).
- The int8 section at 4,096 rows returns the ids of the JAX
  ``topk_search_int8`` and, bit for bit, the scores of that function run
  eagerly (``jax.disable_jit``) and of its arithmetic ``(int_dot * s_row) *
  s_q`` written out with its quantizer run eagerly. The jitted JAX search
  itself is held to 2 ulps: under ``jit`` on this CPU, XLA
  computes the query scale ``max|q| / 127.0`` as a multiplication by the
  reciprocal, one ulp off in about one query in twenty (ROADMAP, queue C).
- Without a card and without ``--device cpu`` the bench raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.ops import quant as jq
from intelligent_video_analysis_retrieval_system_tpu.ops import topk as jtopk
from intelligent_video_analysis_retrieval_system_tpu_torch import bench, cli
from intelligent_video_analysis_retrieval_system_tpu_torch.bench import (
    data,
    headline,
    served,
    timing,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
    ivf_candidate_reference,
    tie_aware_equal,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def narrow_towers(monkeypatch):
    """ViT-L/14 and ViT-B/32 stand for the tiny test config."""
    tiny = CLIPConfig.tiny_test()
    monkeypatch.setattr(CLIPConfig, "vit_l_14", classmethod(lambda cls: tiny))
    monkeypatch.setattr(CLIPConfig, "vit_b_32", classmethod(lambda cls: tiny))
    return tiny


def test_bench_prints_one_json_line_with_the_jax_key_names(narrow_towers, capsys):
    assert cli.main(["bench", "--device", "cpu", "--rows", "20000", "--skip-10m"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    result = json.loads(out[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "p95", "queries", "extra"}
    assert result["metric"] == "e2e_text_query_latency_20k_index" and result["unit"] == "ms"
    assert result["queries"] == 100 and 0 < result["value"] <= result["p95"]
    assert result["vs_baseline"] == pytest.approx(39.0 / result["value"], abs=0.02)
    extra = result["extra"]
    assert list(extra)[0] == "gpu" and extra["gpu"] is None and extra["device"] == "cpu"
    assert list(extra)[-1] == "not_ported"
    assert extra["not_ported"] == []
    assert extra["tokenizer_kind"] == "hash_fallback"
    assert extra["image_tower"] == "ViT-B/32" and extra["image_tower_fps"] > 0
    assert extra["image_tower_batch"] == 8
    assert extra["image_tower_fps_int8_static"] > 0
    assert extra["image_tower_int8_static_ms_per_batch"] > 0
    for key in ("facade_search_p50_ms", "facade_search_p95_ms", "search_batch_b32_ms"):
        assert extra[key] > 0
    assert extra["headline_device_p50_ms"] is None        # no device time on the CPU
    for key in ("served_qps_1M", "served_p50_ms", "served_p95_ms", "served_avg_batch"):
        assert extra[key] > 0                             # served_qps runs with --skip-10m
    # the sharded sections: the headline query on a one-device mesh, and the
    # anchor (one card's shard of ten times --rows over 8 cards, bf16 and int8)
    anchor = ("latency_10M_8chip_anchor_ms", "latency_10M_8chip_anchor_p95_ms",
              "latency_10M_8chip_anchor_int8_ms")
    for key in ("latency_1M_sharded_1dev_p50_ms",) + anchor:
        assert extra[key] > 0
    assert extra["anchor_rows"] == 25_000
    assert not any("10M" in key for key in extra if key not in anchor)   # --skip-10m


def test_bench_needs_a_card_unless_the_cpu_is_asked_for():
    with pytest.raises(RuntimeError):
        bench.main(["--skip-10m"])
    with pytest.raises(RuntimeError):
        bench.run_bench()


def test_headline_answers_equal_jax_topk_search(narrow_towers):
    seen = []
    embedder = CLIPEmbedder(device=CPU)
    out = headline.headline_1M(CPU, embedder, 20_000, verify=lambda *args: seen.append(args))
    assert out["metric"] == "e2e_text_query_latency_20k_index" and out["queries"] == 100
    (section, x, scales, n_valid, q, result), sharded = seen
    assert section == "headline_1M" and scales is None and n_valid == 20_000
    # the sharded section: the same rows and queries through sharded_topk on a
    # one-device mesh answer as topk_search does (one shard: the same sweep)
    assert sharded[0] == "sharded_1M" and sharded[1] is x and torch.equal(sharded[4], q)
    assert torch.equal(sharded[5].indices, result.indices)
    assert torch.equal(sharded[5].scores, result.scores)
    assert out["extra"]["latency_1M_sharded_1dev_p50_ms"] > 0
    assert x.dtype == torch.bfloat16 and x.shape == (20_480, 32)
    assert q.shape == (100, 32) and result.indices.shape == (100, headline.K)
    # every query differs (token 1 is salted) and is a unit vector
    assert len({tuple(row) for row in q.float().numpy().round(4).tolist()}) == 100
    np.testing.assert_allclose(q.float().norm(dim=-1).numpy(), 1.0, atol=1e-2)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jres = jtopk.topk_search(jx, jnp.asarray(q.float().numpy(), jnp.bfloat16), headline.K,
                             n_valid=n_valid, use_pallas=False)
    jids, jscores = np.asarray(jres.indices), np.asarray(jres.scores)
    for i in range(100):
        tie_aware_equal(result.indices[i].numpy(), result.scores[i].numpy(), jids[i],
                        jscores[i])


def test_image_tower_int8_static_matches_jax_calibration(narrow_towers):
    from intelligent_video_analysis_retrieval_system_tpu.models import calibrate as jcal
    from intelligent_video_analysis_retrieval_system_tpu.models import clip as jclip
    from intelligent_video_analysis_retrieval_system_tpu.models.convert import (
        convert_hf_clip_params,
    )

    seen = []
    out = headline.image_tower(CPU, False, verify_static=lambda *a: seen.append(a))
    assert out["image_tower_fps_int8_static"] > 0 and out["image_tower_int8_static_ms_per_batch"] > 0
    ((model, scales, pixels, emb),) = seen
    assert model.w8a8_static and pixels.shape == (8, 32, 32, 3) and emb.shape == (8, 32)
    assert list(scales) == ["vision"]
    # the scales are installed on the timed model, and they are JAX's
    # calibration of the same weights on the same batch (bf16 activations,
    # rounded at other places by the two frameworks)
    fc = model.vision_model.encoder.layers[1].mlp.fc1
    assert fc.act_scale.item() == float(scales["vision"]["transformer"]["layer_1"]["mlp_fc_ascale"])
    cfg = jclip.CLIPConfig.tiny_test()
    params = convert_hf_clip_params({k: v.numpy() for k, v in model.state_dict().items()}, cfg)
    want = jcal.calibrate_act_scales(
        jclip.CLIPModel(cfg, dtype=jnp.bfloat16, w8a8=True), {"params": params},
        [(jnp.asarray(pixels.float().numpy(), jnp.bfloat16),)],
        method=jclip.CLIPModel.encode_image)["act_scales"]["vision"]
    got = scales["vision"]
    for i in range(cfg.vision.num_layers):
        lw, lg = want["transformer"][f"layer_{i}"], got["transformer"][f"layer_{i}"]
        pairs = [(lw["attn"][k], lg["attn"][k]) for k in lw["attn"]]
        pairs += [(lw[k], lg[k]) for k in ("mlp_fc_ascale", "mlp_proj_ascale")]
        for w, g in pairs:
            np.testing.assert_allclose(float(g), float(w), rtol=2e-2)


def test_int8_section_equals_jax_topk_search_int8_bit_for_bit(narrow_towers):
    seen = []
    embedder = CLIPEmbedder(device=CPU)
    out = headline.int8_10M(CPU, embedder, 4096, verify=lambda *args: seen.append(args))
    assert out["int8_rows"] == 4096 and out["queries_10M"] == 100
    for key in ("latency_10M_int8_1chip_p50_ms", "latency_10M_int8_1chip_p95_ms",
                "qps_10M_int8_1chip_b128", "qps_10M_int8_1chip_b32",
                "latency_2M5_int8_1chip_p50_ms", "latency_5M_int8_1chip_p50_ms"):
        assert out[key] > 0
    # all single queries, the first batch of 128 and of 32, then the two prefixes
    assert [(s[3], s[4].shape[0]) for s in seen] == [(4096, 100), (4096, 128), (4096, 32),
                                                     (1024, 100), (2048, 100)]
    for section, x, scales, n_valid, q, result in seen:
        assert section == "int8_10M" and x.dtype == torch.int8
        jres = jq.topk_search_int8(jnp.asarray(x.numpy()), jnp.asarray(scales.numpy()),
                                   jnp.asarray(q.numpy()), headline.K, n_valid=n_valid)
        np.testing.assert_array_equal(result.indices.numpy(), np.asarray(jres.indices))
        np.testing.assert_array_max_ulp(result.scores.numpy(), np.asarray(jres.scores), maxulp=2)
        # bit for bit: the JAX package's own search, run eagerly
        with jax.disable_jit():
            eager = jq.topk_search_int8(jnp.asarray(x.numpy()), jnp.asarray(scales.numpy()),
                                        jnp.asarray(q.numpy()), headline.K, n_valid=n_valid)
        np.testing.assert_array_equal(result.indices.numpy(), np.asarray(eager.indices))
        np.testing.assert_array_equal(result.scores.numpy(), np.asarray(eager.scores))
        # and the same arithmetic written out, its quantizer run eagerly
        q8, qs = jq._quantize_q(jnp.asarray(q.numpy()))
        int_dot = np.asarray(q8).astype(np.float32) @ x[:n_valid].numpy().astype(np.float32).T
        spec = (int_dot * scales[:n_valid].numpy()[None, :]) * np.asarray(qs)[:, None]
        order = np.argsort(-spec, axis=1, kind="stable")[:, :headline.K]
        np.testing.assert_array_equal(result.indices.numpy(), order)
        np.testing.assert_array_equal(result.scores.numpy(),
                                      np.take_along_axis(spec, order, axis=1))


def test_anchor_section_equals_the_jax_sharded_searchers(narrow_towers):
    """The anchor at 4,096 rows (5,120 in the shard): bf16 answers tie-aware
    equal to JAX ``sharded_topk`` on a one-device mesh, int8 ids equal to
    JAX ``sharded_topk_int8`` and scores within 2 ulps (jitted), and bit for
    bit the port's single-device ``topk_search_int8``."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from intelligent_video_analysis_retrieval_system_tpu.parallel import sharded_search as jss
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.quant import (
        topk_search_int8,
    )

    seen = []
    embedder = CLIPEmbedder(device=CPU)
    out = headline.anchor_1M25(CPU, embedder, 4096, verify=lambda *args: seen.append(args))
    assert out["anchor_rows"] == 5120
    for key in ("latency_10M_8chip_anchor_ms", "latency_10M_8chip_anchor_p95_ms",
                "latency_10M_8chip_anchor_int8_ms"):
        assert out[key] > 0
    assert [s[0] for s in seen] == ["anchor_1M25", "anchor_1M25_int8"]
    mesh = Mesh(np.array(jax.devices()[:1]), ("index",))
    rows = NamedSharding(mesh, P("index", None))
    (_, x, _, n, q, res), (_, x8, s8, n8, q8, res8) = seen
    jx = jax.device_put(jnp.asarray(x.float().numpy(), jnp.bfloat16), rows)
    jres = jss.sharded_topk(mesh, jx, jnp.asarray(q.float().numpy(), jnp.bfloat16),
                            headline.K, n, use_pallas=False)
    for i in range(len(q)):
        tie_aware_equal(res.indices[i].numpy(), res.scores[i].numpy(),
                        np.asarray(jres.indices)[i], np.asarray(jres.scores)[i])
    jres8 = jss.sharded_topk_int8(
        mesh, jax.device_put(jnp.asarray(x8.numpy()), rows),
        jax.device_put(jnp.asarray(s8.numpy()[:, None]), rows), jnp.asarray(q8.numpy()),
        headline.K, n8, use_pallas=False)
    np.testing.assert_array_equal(res8.indices.numpy(), np.asarray(jres8.indices))
    np.testing.assert_array_max_ulp(res8.scores.numpy(), np.asarray(jres8.scores), maxulp=2)
    single = topk_search_int8(x8, s8, q8, headline.K, n_valid=n8)
    assert torch.equal(res8.indices, single.indices) and torch.equal(res8.scores, single.scores)


def test_served_qps_answers_equal_jax_topk_search(narrow_towers):
    """The REST server with the batcher over 4,096 bf16 rows: the JAX key
    names, and every timed answer (handed to ``verify`` with the vector the
    server searched) equal to the JAX ``topk_search`` (tie-aware)."""
    seen = []
    out = served.served_qps(CPU, CLIPEmbedder(device=CPU), 4096,
                            verify=lambda *args, **kw: seen.append((args, kw)))
    assert set(out) == {"served_qps_1M", "served_p50_ms", "served_p95_ms", "served_avg_batch"}
    assert out["served_qps_1M"] > 0 and 0 < out["served_p50_ms"] <= out["served_p95_ms"]
    assert 1.0 <= out["served_avg_batch"] <= served.CONCURRENCY
    ((section, x, scales, n_valid, q, result), kw), = seen
    assert section == "served_1M" and scales is None and n_valid == 4096
    assert kw == {"decimals": served.SCORE_DECIMALS}
    assert q.shape == (served.TIMED, 32) and q.dtype == torch.bfloat16
    assert result.indices.shape == (served.TIMED, headline.K)
    jres = jtopk.topk_search(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.asarray(q.float().numpy(), jnp.bfloat16), headline.K,
                             n_valid=n_valid, use_pallas=False)
    jids, jscores = np.asarray(jres.indices), np.asarray(jres.scores)
    for i in range(served.TIMED):
        tie_aware_equal(result.indices[i].numpy(), result.scores[i].numpy(), jids[i],
                        jscores[i])


def test_served_10M_answers_equal_jax_int8_and_the_ivf_reference(narrow_towers):
    """The IVF section's int8 rows served with its structure attached, then
    dense: batches of at most ``ann_max_batch`` probe (the candidate-set
    reference), larger ones sweep (the JAX ``topk_search_int8`` run eagerly):
    the same ids, and the scores bit for bit as the server rounds them."""
    embedder = CLIPEmbedder(device=CPU)
    kept: dict = {}
    headline.ivf_10M(CPU, embedder, 4096, keep=kept)
    assert set(kept) == {"x", "scales", "state"}
    seen = []
    out = served.served_10M(CPU, embedder, 4096, kept,
                            verify=lambda *args, **kw: seen.append((args, kw)))
    for suffix in ("10M_int8_ann", "10M_int8_dense"):
        assert out[f"served_qps_{suffix}"] > 0 and out[f"served_avg_batch_{suffix}"] >= 1
        assert 0 < out[f"served_p50_{suffix}_ms"] <= out[f"served_p95_{suffix}_ms"]
    def rounded(ref):       # the scores as a served answer carries them
        return np.array([[round(float(v), served.SCORE_DECIMALS) for v in row]
                         for row in np.asarray(ref)], np.float32)

    answered = {"served_10M_int8_ann": 0, "served_10M_int8_dense": 0}
    for (section, x, scales, n_valid, q, result), kw in seen:
        assert x is kept["x"] and scales is kept["scales"] and n_valid == 4096
        assert kw.pop("decimals") == served.SCORE_DECIMALS
        answered[section] += len(q)
        ids, scores = result.indices.numpy(), result.scores.numpy()
        if kw:                                 # probed: the candidate-set reference
            assert section == "served_10M_int8_ann" and kw["ivf"][0] is kept["state"]
            ref_s, ref_i = ivf_candidate_reference(x, kw["ivf"][0], q, headline.K,
                                                   kw["ivf"][1], n_valid, x_scales=scales)
            np.testing.assert_array_equal(scores, rounded(ref_s))
            for i in range(len(q)):
                tie_aware_equal(ids[i], scores[i], ref_i[i], rounded(ref_s)[i], atol=0.0)
            continue
        with jax.disable_jit():
            eager = jq.topk_search_int8(jnp.asarray(x.numpy()), jnp.asarray(scales.numpy()),
                                        jnp.asarray(q.numpy()), headline.K, n_valid=n_valid)
        np.testing.assert_array_equal(ids, np.asarray(eager.indices))
        np.testing.assert_array_equal(scores, rounded(eager.scores))
    assert answered == {"served_10M_int8_ann": served.TIMED,
                        "served_10M_int8_dense": served.TIMED}


def test_generated_rows():
    x = data.gen_db_bf16(600_000, 8, 7, CPU)              # two generator chunks
    assert x.shape == (600_000, 8) and x.dtype == torch.bfloat16
    np.testing.assert_allclose(x[::997].float().norm(dim=-1).numpy(), 1.0, atol=2e-2)
    assert torch.equal(x[:1000], data.gen_db_bf16(600_000, 8, 7, CPU)[:1000])
    assert not torch.equal(x[:1000], data.gen_db_bf16(600_000, 8, 8, CPU)[:1000])
    xi, s = data.gen_db_int8(4096, 16, 0, CPU)
    assert xi.dtype == torch.int8 and xi.shape == (4096, 16) and s.shape == (4096,)
    assert int(xi.min()) == -127 and int(xi.max()) == 127
    assert float(s.min()) >= 0.9 / 127 and float(s.max()) <= 1.1 / 127 + 1e-9
    container = data.MemoryContainer(x[:5].view(torch.int16).numpy().view(np.uint16))
    assert container.num_rows == container.num_metadata == 5 and container.path is None
    assert container.get_metadata(3) == list(container.iter_metadata())[3]
    np.testing.assert_array_equal(container.read_embeddings(1, 3, as_float32=True),
                                  x[1:3].float().numpy())


def test_percentile_wall_counts_calls_and_refuses_too_few():
    calls = []
    out = timing.percentile_wall(calls.append, 100, CPU)
    assert calls == [-1, -2, -3, *range(100)]
    assert out["calls"] == 100 and out["device_p50_ms"] is None
    assert 0 <= out["p50_ms"] <= out["p95_ms"]
    with pytest.raises(ValueError):
        timing.percentile_wall(calls.append, 99, CPU)
    assert timing.median_ms(lambda: None, CPU) >= 0
