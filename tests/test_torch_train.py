"""Parity of the port's CLIP trainer (``parallel/train.py``) with the JAX one.

The JAX trainer runs on its ``(2, 4)`` mesh over the 8 virtual CPU devices
of ``tests/conftest.py``, in f32 (both packages compute the same math there;
in bf16 the JAX CPU route keeps bf16 logits and the port f32 scores); its
params carry across with ``models.convert.from_jax_params``, its optimizer
state with ``from_optax_state``. The port runs on ``(1, 1)`` and ``(2, 4)``
meshes of logical CPU shards. Inputs come from ``numpy.random.default_rng``.

Tolerances: loss within 1e-5 and each gradient within 1e-4 x its tensor's
max |g|, but ``k_proj.bias``, whose exact gradient is zero (a bias on the
keys shifts every logit of a row alike, and the softmax ignores that): both
sides' values there are rounding noise, held below 1e-6 x the largest
gradient of the model. The optimizer update within 1e-6 relative of optax's
chain; three steps' losses within 1e-4 relative of the JAX trainer's; remat
on and off, and a checkpoint restore, bit for bit; the train -> deploy
embeddings within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.models.clip import (
    CLIPConfig as JCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.parallel import mesh as jmesh
from intelligent_video_analysis_retrieval_system_tpu.parallel import train as jtrain
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.preprocess import (
    normalize_images,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import mesh as tmesh
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import train as ttrain
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder

torch.set_num_threads(2)

CFG = CLIPConfig.tiny_test()
JCFG = JCLIPConfig.tiny_test()
MESHES = [(1, 1), (2, 4)]


def _batch(seed=0, b=8):
    """The JAX tests' batch: raw pixels, tokens ending in the EOT id (511)."""
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 500, (b, 16)).astype(np.int32)
    tokens[:, -1] = 511
    return px, tokens


def _copy(tree):
    """numpy copies of a JAX tree (the JAX step donates its buffers)."""
    return jax.tree_util.tree_map(np.array, tree)


def _mesh(shape):
    return tmesh.create_mesh(tmesh.MeshSpec(("data", "model"), shape),
                             devices=["cpu"] * (shape[0] * shape[1]))


def _trainer(shape, **tc):
    return ttrain.CLIPTrainer(CFG, _mesh(shape), ttrain.TrainConfig(**tc), dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer on its (2, 4) mesh in f32: the params at init, the
    loss and gradients there, and three train steps (the loss each step
    reports, and the params and optimizer state after it)."""
    mesh = jmesh.create_mesh(jmesh.MeshSpec(axis_names=("data", "model"), shape=(2, 4)))
    trainer = jtrain.CLIPTrainer(JCFG, mesh, dtype=jnp.float32)
    params, opt_state = trainer.init(0)
    px, tokens = _batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(trainer.loss_fn, has_aux=True))(
        params, px, tokens)
    run = {"params": _copy(params), "loss": float(loss), "grads": _copy(grads), "steps": []}
    for _ in range(3):
        params, opt_state, metrics = trainer.train_step(params, opt_state, px, tokens)
        run["steps"].append({"loss": float(metrics["loss"]), "params": _copy(params),
                             "opt_state": _copy(opt_state)})
    return run


def _state(run_params):
    return tconv.from_jax_params(run_params, CFG)


# ---------------------------------------------------------------------------
# (a) TrainConfig and its schedule
# ---------------------------------------------------------------------------


def test_train_config_fields_and_schedules_are_the_jax_ones():
    ours = [(f.name, f.default) for f in dataclasses.fields(ttrain.TrainConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jtrain.TrainConfig)]
    assert ours == theirs
    assert ttrain.TrainConfig().make_schedule() == jtrain.TrainConfig().make_schedule() == 1e-5
    kw = dict(schedule="warmup_cosine", warmup_steps=2, total_steps=10, learning_rate=1e-3)
    sched, jsched = ttrain.TrainConfig(**kw).make_schedule(), jtrain.TrainConfig(**kw).make_schedule()
    lrs = [sched(s) for s in range(11)]
    for s, lr in enumerate(lrs):
        assert abs(lr - float(jsched(s))) < 1e-9, s
    # the JAX test's own numbers
    assert lrs[0] == 0.0 and abs(lrs[2] - 1e-3) < 1e-9 and lrs[10] < lrs[2]
    assert abs(lrs[10] - 1e-4) < 1e-8
    # past total_steps the schedule stays at its end value, as optax's does
    assert abs(sched(25) - float(jsched(25))) < 1e-9
    with pytest.raises(ValueError, match="unknown schedule"):
        ttrain.TrainConfig(schedule="linear").make_schedule()


# ---------------------------------------------------------------------------
# (b) the layout rules, (h) shards held as the rules say
# ---------------------------------------------------------------------------


def test_param_spec_is_the_jax_layout_under_the_name_and_transpose_map(jax_run):
    # mark every JAX leaf along the axis its _param_pspec splits (zeros when
    # replicated), carry the markers across, read the split axis back
    def marker(path, leaf):
        spec = jtrain._param_pspec(path, leaf, "model")
        out = np.zeros(leaf.shape, np.float32)
        if "model" in spec:
            axis = list(spec).index("model")
            shape = [1] * leaf.ndim
            shape[axis] = leaf.shape[axis]
            out += np.arange(1, leaf.shape[axis] + 1, dtype=np.float32).reshape(shape)
        return out

    marked = tconv.from_jax_params(
        jax.tree_util.tree_map_with_path(marker, jax_run["params"]), CFG)
    n_split = 0
    for name, t in marked.items():
        varying = [d for d in range(t.ndim) if t.ndim and not torch.equal(
            t, t.narrow(d, 0, 1).expand_as(t))]
        want = () if not varying else tuple(
            "model" if d == varying[0] else None for d in range(t.ndim))
        assert ttrain.param_spec(name, t) == want, name
        n_split += bool(varying)
    # q, k, v, out, fc1, fc2 weights and q, k, v, fc1 biases of 4 layers
    assert n_split == 4 * 10
    assert ttrain.param_spec("text_model.encoder.layers.0.mlp.fc1.weight",
                             marked["text_model.encoder.layers.0.mlp.fc1.weight"], "mp") == \
        ("mp", None)


def test_params_actually_sharded():
    trainer = _trainer((2, 4))
    params, opt_state = trainer.init(0)
    layer = "vision_model.encoder.layers.0."
    want = {"mlp.fc1.weight": (64, 64), "mlp.fc1.bias": (64,), "self_attn.q_proj.weight": (16, 64),
            "self_attn.out_proj.weight": (64, 16), "mlp.fc2.weight": (64, 64),
            "self_attn.out_proj.bias": None, "layer_norm1.weight": None}
    for name, shape in want.items():
        shards = params[layer + name]
        if shape is None:           # replicated: once, on the mesh's first device
            assert len(shards) == 1 and shards[0].device == trainer.mesh.devices[0, 0]
            continue
        assert len(shards) == 4, name
        assert [tuple(s.shape) for s in shards] == [shape] * 4, name
        assert [s.device for s in shards] == list(trainer.mesh.devices[0]), name
        assert len({s.data_ptr() for s in shards}) == 4     # own storage each
    # the optimizer state keeps the params' layout
    for key in ("mu", "nu"):
        assert [s.shape for s in opt_state[key][layer + "mlp.fc2.weight"]] == \
            [s.shape for s in params[layer + "mlp.fc2.weight"]]
    assert opt_state["count"] == 0
    # and gathers back to the full state dict
    full = trainer.state_dict(params)
    assert full[layer + "mlp.fc2.weight"].shape == (64, 256)
    again = trainer.shard_params(full)
    for name, shards in params.items():
        assert all(torch.equal(a, b) for a, b in zip(shards, again[name])), name


# ---------------------------------------------------------------------------
# (c) loss and gradients against JAX's trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_loss_and_gradients_equal_the_jax_trainers(jax_run, shape):
    trainer = _trainer(shape)
    params = trainer.shard_params(_state(jax_run["params"]))
    loss, metrics, grads = trainer.value_and_grad(params, *_batch())
    assert abs(float(loss) - jax_run["loss"]) <= 1e-5
    assert float(metrics["loss"]) == float(loss)
    got = trainer.state_dict(grads)
    want = tconv.from_jax_params(jax_run["grads"], CFG)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        if name.endswith("self_attn.k_proj.bias"):     # exactly zero: noise on both sides
            assert float(g.abs().max()) <= 1e-6 * largest and float(w.abs().max()) <= 1e-6 * largest
            continue
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


# ---------------------------------------------------------------------------
# (d) the optimizer against optax's chain, (f) the warmup's first step
# ---------------------------------------------------------------------------


def _optax_chain(tc):
    return optax.chain(optax.clip_by_global_norm(tc.max_grad_norm),
                       optax.adamw(tc.make_schedule(), b1=tc.b1, b2=tc.b2, eps=tc.eps,
                                   weight_decay=tc.weight_decay))


@pytest.mark.parametrize("case", ["below", "above", "tiny_max_norm"])
def test_optimizer_update_equals_optax_chain(jax_run, case):
    rng = np.random.default_rng(3)
    jparams = jax_run["params"]
    size = sum(np.size(x) for x in jax.tree_util.tree_leaves(jparams))

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(rng.standard_normal(x.shape) * scale, np.float32), jparams)

    # a warm state (count 3, nonzero moments), so the update depends on the
    # gradient's scale; the gradients' global norm is about sqrt(size) x scale
    max_norm, norm = {"below": (1.0, 0.5), "above": (1.0, 30.0),
                      "tiny_max_norm": (1e-4, 2e-4)}[case]
    scale = norm / np.sqrt(size)
    jtc = jtrain.TrainConfig(learning_rate=1e-2, max_grad_norm=max_norm)
    tx = _optax_chain(jtc)
    state = tx.init(jparams)
    for _ in range(3):
        _, state = tx.update(draw(scale), state, jparams)
    grads = draw(scale)
    norm = float(optax.global_norm(grads))
    assert (norm < max_norm) == (case == "below")
    updates, new_state = tx.update(grads, state, jparams)
    want_params = tconv.from_jax_params(_copy(optax.apply_updates(jparams, updates)), CFG)
    want_opt = tconv.from_optax_state(_copy(new_state), CFG)

    trainer = _trainer((2, 4), **{f.name: getattr(jtc, f.name)
                                 for f in dataclasses.fields(jtc)})
    params = trainer.shard_params(_state(jparams))
    new_params, new_opt = trainer.apply_gradients(
        params, trainer.shard_params(_state(grads)),
        trainer.shard_opt_state(tconv.from_optax_state(_copy(state), CFG)))
    assert new_opt["count"] == want_opt["count"] == 4
    for got, want in ((trainer.state_dict(new_params), want_params),
                      (trainer.state_dict(new_opt["mu"]), want_opt["mu"]),
                      (trainer.state_dict(new_opt["nu"]), want_opt["nu"])):
        for name, w in want.items():
            torch.testing.assert_close(got[name], w, rtol=1e-6,
                                       atol=1e-6 * float(w.abs().max()), msg=name)
    if case == "tiny_max_norm":
        # clip_grad_norm_ (max_norm / (norm + 1e-6), clamped) scales these
        # gradients ~0.5% apart from optax: the port must not be it
        sd = _state(grads)
        ours = trainer.state_dict(ttrain.clip_by_global_norm(
            trainer.shard_params(sd), max_norm, torch.device("cpu")))
        theirs = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        for t in theirs.values():
            t.grad = t.detach().clone()
        torch.nn.utils.clip_grad_norm_(list(theirs.values()), max_norm)
        name = "vision_model.encoder.layers.0.mlp.fc1.weight"
        rel = float(((theirs[name].grad - ours[name]).abs() / ours[name].abs()).max())
        assert rel > 1e-3


def test_warmup_cosine_first_step_leaves_params_unchanged(jax_run):
    kw = dict(schedule="warmup_cosine", warmup_steps=2, total_steps=10, learning_rate=1e-3)
    trainer = _trainer((2, 4), **kw)
    params = trainer.shard_params(_state(jax_run["params"]))
    new_params, opt_state, metrics = trainer.train_step(params, trainer.init(0)[1], *_batch())
    assert opt_state["count"] == 1 and np.isfinite(float(metrics["loss"]))
    for name, shards in params.items():
        assert all(torch.equal(a, b) for a, b in zip(shards, new_params[name])), name
    # optax: lr = schedule(0) = 0, so its updates are zeros as well
    tx = _optax_chain(jtrain.TrainConfig(**kw))
    jparams = jax_run["params"]
    updates, _ = tx.update(jax.tree_util.tree_map(np.ones_like, jparams), tx.init(jparams),
                           jparams)
    assert all(not np.asarray(u).any() for u in jax.tree_util.tree_leaves(updates))
    # the second step moves them
    moved, _, _ = trainer.train_step(new_params, opt_state, *_batch())
    assert not torch.equal(moved["logit_scale"][0], params["logit_scale"][0])


# ---------------------------------------------------------------------------
# (e) three steps against JAX's, (j) a JAX run continued in the port
# ---------------------------------------------------------------------------


def test_three_steps_on_2x4_track_the_jax_trainer(jax_run):
    trainer = _trainer((2, 4))
    params = trainer.shard_params(_state(jax_run["params"]))
    opt_state = trainer.init(0)[1]
    losses = []
    for _ in range(3):
        params, opt_state, metrics = trainer.train_step(params, opt_state, *_batch())
        losses.append(float(metrics["loss"]))
        assert 0.0 <= float(metrics["accuracy"]) <= 1.0
        assert abs(float(metrics["scale"]) - np.exp(CFG.logit_scale_init)) < 1e-3
    assert losses[-1] < losses[0]
    for got, step in zip(losses, jax_run["steps"]):
        assert abs(got - step["loss"]) <= 1e-4 * abs(step["loss"])


def test_from_optax_state_continues_a_jax_run(jax_run):
    first, second, third = jax_run["steps"]
    trainer = _trainer((2, 4))
    params = trainer.shard_params(_state(first["params"]))
    opt_state = trainer.shard_opt_state(tconv.from_optax_state(first["opt_state"], CFG))
    assert opt_state["count"] == 1
    params, opt_state, metrics = trainer.train_step(params, opt_state, *_batch())
    assert abs(float(metrics["loss"]) - second["loss"]) <= 1e-4 * second["loss"]
    loss, _ = trainer.loss_fn(params, *_batch())
    assert abs(float(loss) - third["loss"]) <= 1e-4 * third["loss"]
    want = tconv.from_optax_state(second["opt_state"], CFG)
    assert opt_state["count"] == want["count"] == 2
    got_mu = trainer.state_dict(opt_state["mu"])
    for name, w in want["mu"].items():
        if not name.endswith("self_attn.k_proj.bias"):
            assert float((got_mu[name] - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    with pytest.raises(ValueError, match="no Adam state"):
        tconv.from_optax_state((optax.EmptyState(),), CFG)


# ---------------------------------------------------------------------------
# (g) remat, (i) checkpoints, (k) train -> deploy, (l) refusals
# ---------------------------------------------------------------------------


def test_remat_on_and_off_give_the_same_gradients(jax_run):
    sd = _state(jax_run["params"])
    out = []
    for remat in (True, False):
        trainer = _trainer((2, 4), remat=remat)
        out.append(trainer.value_and_grad(trainer.shard_params(sd), *_batch()))
    (loss_on, _, g_on), (loss_off, _, g_off) = out
    assert torch.equal(loss_on, loss_off)
    for name, shards in g_on.items():
        assert all(torch.equal(a, b) for a, b in zip(shards, g_off[name])), name


def test_checkpoint_roundtrip_keeps_values_and_layout(tmp_path, jax_run):
    trainer = _trainer((2, 4))
    params = trainer.shard_params(_state(jax_run["params"]))
    params, opt_state, _ = trainer.train_step(params, trainer.init(0)[1], *_batch())
    path = trainer.save_checkpoint(tmp_path / "ckpt", params, opt_state, step=1)
    assert path == str((tmp_path / "ckpt" / "1").resolve())
    assert [p.name for p in (tmp_path / "ckpt" / "1").iterdir()] == ["state.pt"]
    params2, opt2, step = trainer.restore_checkpoint(tmp_path / "ckpt")
    assert step == 1 and opt2["count"] == opt_state["count"] == 1
    for tree, tree2 in ((params, params2), (opt_state["mu"], opt2["mu"]),
                        (opt_state["nu"], opt2["nu"])):
        for name, shards in tree.items():
            assert len(shards) == len(tree2[name]), name    # the TP layout survives
            for a, b in zip(shards, tree2[name]):
                assert torch.equal(a, b) and a.device == b.device, name
    # the restored state trains on, and its next loss is the live state's
    _, _, live = trainer.train_step(params, opt_state, *_batch())
    _, _, restored = trainer.train_step(params2, opt2, *_batch())
    assert np.isfinite(float(restored["loss"])) and float(restored["loss"]) == float(live["loss"])
    # keep prunes the oldest; a named step restores that step
    for step in (2, 3, 4):
        trainer.save_checkpoint(tmp_path / "ckpt", params, opt_state, step=step, keep=3)
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [2, 3, 4]
    assert trainer.restore_checkpoint(tmp_path / "ckpt")[2] == 4
    assert trainer.restore_checkpoint(tmp_path / "ckpt", step=3)[2] == 3
    with pytest.raises(FileNotFoundError):
        trainer.restore_checkpoint(tmp_path / "ckpt", step=1)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        trainer.restore_checkpoint(tmp_path / "empty")


def test_state_dict_deploys_into_the_embedder(jax_run):
    trainer = _trainer((2, 4))
    params = trainer.shard_params(_state(jax_run["params"]))
    params, _, _ = trainer.train_step(params, trainer.init(0)[1], *_batch())
    embedder = CLIPEmbedder(config=CFG, compute_dtype="float32", device="cpu")
    embedder.load_params(trainer.state_dict(params))
    images = np.random.default_rng(5).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    got = embedder.encode_images(images)
    with torch.no_grad():
        want = trainer.encode_image(params, normalize_images(torch.from_numpy(images),
                                                             dtype=torch.float32))
    want = torch.nn.functional.normalize(want, dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_trainer_refuses_what_it_cannot_lay_out():
    trainer = _trainer((2, 4))
    params = trainer.init(0)[0]
    px, tokens = _batch(b=7)
    with pytest.raises(ValueError, match="does not split evenly"):
        trainer.loss_fn(params, px, tokens)
    with pytest.raises(ValueError, match="vision_model.encoder.layers.*self_attn"):
        _trainer((1, 3))          # 4 heads over 3 model shards
    with pytest.raises(ValueError, match="axes"):
        ttrain.CLIPTrainer(CFG, tmesh.create_mesh(devices=["cpu"] * 2))
    two_ranks = tmesh.Mesh(np.array([[torch.device("cpu")] * 2], dtype=object),
                           ("data", "model"), process_ids=np.array([[0, 1]]))
    # a mesh that spans ranks trains across processes (tests/test_torch_train_multiproc.py),
    # but only inside a process group that covers them
    with pytest.raises(RuntimeError, match="needs an initialized process group"):
        ttrain.CLIPTrainer(CFG, two_ranks)
