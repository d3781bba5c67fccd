"""The port's CLIP trainer over a mesh that spans processes, on the CPU.

Ranks are processes of one gloo group, spawned as
``tests/test_torch_distributed.py``'s ``_run_procs`` spawns them (each with a
timeout of its own; the children import no JAX). Every rank calls the
trainer with the same global batch, the batch of ``tests/test_torch_train.py``,
from the same start: the JAX trainer's init params, carried across with
``models.convert.from_jax_params``. Each rank writes what it saw to a file
(its loss, the gathered gradients and params, its own shards) and the tests
read those files.

- Two ranks of four CPU devices on a ``(2, 4)`` mesh (data across the
  processes, the model within each), held to the JAX trainer's ``(2, 4)``
  run with ``tests/test_torch_train.py``'s tolerances: loss within 1e-5,
  each gradient within 1e-4 x its tensor's max |g| (``k_proj.bias``, whose
  exact gradient is zero, as noise below 1e-6 x the model's largest
  gradient on both sides), three steps' losses within 1e-4 relative. A
  checkpoint saved by the two ranks restores bit for bit in one process,
  and one saved by one process in the two ranks; the gathered
  ``state_dict`` deploys into ``CLIPEmbedder`` on every rank.
- Four ranks of one CPU device on a ``(2, 2)`` mesh (data and model both
  across the processes), held to the one-process ``(2, 2)`` trainer in
  f32: loss within 1e-6 relative, each gradient within 1e-5 x its
  tensor's max |g| (``k_proj.bias`` as noise, as above), three steps'
  losses within 1e-5 relative.
- On every rank alike: the metrics, the gradients and the params after
  each step (every shard a rank holds ``torch.equal`` to the same slice of
  the gathered params, and the gathered params equal across ranks).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_distributed import _run_procs
from test_torch_train import _batch, _state, jax_run  # noqa: F401  (a fixture)

from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import mesh as tmesh
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import train as ttrain

pytestmark = pytest.mark.skipif(not torch.distributed.is_available()
                                or not torch.distributed.is_gloo_available(),
                                reason="needs torch.distributed with gloo")

torch.set_num_threads(2)

CFG = CLIPConfig.tiny_test()
STEPS = 3

_CHILD = r'''
import json
import sys
from pathlib import Path

pid, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, repo)
import numpy as np
import torch

torch.set_num_threads(1)
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.preprocess import normalize_images
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
    CLIPTrainer, MeshSpec, create_mesh,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder

work = Path(__file__).parent
job = json.loads((work / "job.json").read_text())
initialize_distributed(f"127.0.0.1:{port}", job["world"], pid)
mesh = create_mesh(MeshSpec(("data", "model"), tuple(job["shape"])),
                   devices=["cpu"] * job["per_rank"])
cfg = CLIPConfig.tiny_test()
trainer = CLIPTrainer(cfg, mesh, dtype=torch.float32)
init = torch.load(work / "init.pt", weights_only=True)
zeros = {k: torch.zeros_like(v) for k, v in init.items()}
params = trainer.shard_params(init)
opt_state = trainer.shard_opt_state({"count": 0, "mu": zeros, "nu": zeros})
rng = np.random.default_rng(0)
px = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
tokens = rng.integers(1, 500, (8, 16)).astype(np.int32)
tokens[:, -1] = 511

loss, metrics, grads = trainer.value_and_grad(params, px, tokens)
out = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
       "grads": trainer.state_dict(grads), "held_grads": grads, "cols": trainer._cols,
       "rows": trainer._rows, "steps": []}
for _ in range(job["steps"]):
    params, opt_state, metrics = trainer.train_step(params, opt_state, px, tokens)
    out["steps"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                         "params": trainer.state_dict(params), "held": params})
out["count"] = opt_state["count"]
trainer.save_checkpoint(work / "ckpt_multi", params, opt_state, step=job["steps"])
if (work / "ckpt_single").is_dir():
    r_params, r_opt, r_step = trainer.restore_checkpoint(work / "ckpt_single")
    out["restored"] = {"params": r_params, "mu": r_opt["mu"], "nu": r_opt["nu"],
                       "count": r_opt["count"], "step": r_step}
# train -> deploy: the gathered state dict in an embedder, against the
# trainer's own encode_image (a collective across the ranks)
embedder = CLIPEmbedder(config=cfg, compute_dtype="float32", device="cpu")
embedder.load_params(trainer.state_dict(params))
images = np.random.default_rng(5).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
got = embedder.encode_images(images)
with torch.no_grad():
    want = trainer.encode_image(params, normalize_images(torch.from_numpy(images),
                                                         dtype=torch.float32))
want = torch.nn.functional.normalize(want, dim=-1).numpy()
out["deploy_err"] = float(np.abs(got - want).max())
torch.save(out, work / f"out_{pid}.pt")
torch.distributed.destroy_process_group()
print(f"TRAIN OK pid={pid}", flush=True)
'''


def _run(tmp_path: Path, init: dict, world: int, per_rank: int, shape: tuple[int, int],
         timeout: float = 240) -> list[dict]:
    """The child on ``world`` ranks from ``init``; every rank's output."""
    torch.save(init, tmp_path / "init.pt")
    (tmp_path / "job.json").write_text(json.dumps(
        {"world": world, "per_rank": per_rank, "shape": list(shape), "steps": STEPS}))
    _run_procs(tmp_path, _CHILD, world, "TRAIN OK", timeout=timeout)
    return [torch.load(tmp_path / f"out_{r}.pt", weights_only=True) for r in range(world)]


def _mesh(shape):
    return tmesh.create_mesh(tmesh.MeshSpec(("data", "model"), shape),
                             devices=["cpu"] * (shape[0] * shape[1]))


def _trainer(shape):
    return ttrain.CLIPTrainer(CFG, _mesh(shape), dtype=torch.float32)


def _zeros(state):
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in state.items()},
            "nu": {k: torch.zeros_like(v) for k, v in state.items()}}


def _close_grads(got: dict, want: dict, rel: float) -> None:
    """Each gradient within ``rel`` x its tensor's max |g|; ``k_proj.bias``
    (exactly zero) as noise below 1e-6 x the largest gradient, both sides."""
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        if name.endswith("self_attn.k_proj.bias"):
            assert float(g.abs().max()) <= 1e-6 * largest, name
            assert float(w.abs().max()) <= 1e-6 * largest, name
            continue
        assert float((g - w).abs().max()) <= rel * float(w.abs().max()), name


def _same_on_every_rank(outs: list[dict], split: dict) -> None:
    """Metrics, gathered gradients and params equal across ranks; every
    shard a rank holds equal to its slice of the gathered tensor."""
    first = outs[0]
    for out in outs[1:]:
        assert out["loss"] == first["loss"] and out["metrics"] == first["metrics"]
        for name, g in first["grads"].items():
            assert torch.equal(out["grads"][name], g), name
        for s, s0 in zip(out["steps"], first["steps"]):
            assert s["metrics"] == s0["metrics"]
            for name, p in s0["params"].items():
                assert torch.equal(s["params"][name], p), name
    n_model = max(max(out["cols"]) for out in outs) + 1
    for out in outs:
        for held, full in ([(out["held_grads"], first["grads"])]
                           + [(s["held"], s0["params"])
                              for s, s0 in zip(out["steps"], first["steps"])]):
            for name, shards in held.items():
                dim = split[name]
                if dim is None:
                    assert len(shards) == 1 and torch.equal(shards[0], full[name]), name
                    continue
                chunks = full[name].chunk(n_model, dim)
                assert len(shards) == len(out["cols"]), name
                for j, s in zip(out["cols"], shards):
                    assert torch.equal(s, chunks[j]), (name, j)


# ---------------------------------------------------------------------------
# two ranks x four devices on (2, 4), against the JAX trainer's (2, 4) run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(jax_run, tmp_path_factory):  # noqa: F811
    """The two ranks' outputs, with the one-process (2, 4) trainer that
    wrote the checkpoint the ranks restore (one step from the same init)."""
    work = tmp_path_factory.mktemp("two_ranks")
    init = _state(jax_run["params"])
    single = _trainer((2, 4))
    params, opt_state, _ = single.train_step(single.shard_params(init),
                                             single.shard_opt_state(_zeros(init)), *_batch())
    single.save_checkpoint(work / "ckpt_single", params, opt_state, step=1)
    outs = _run(work, init, world=2, per_rank=4, shape=(2, 4))
    return {"outs": outs, "work": work, "single": single,
            "single_state": {"params": single.state_dict(params),
                             "mu": single.state_dict(opt_state["mu"]),
                             "nu": single.state_dict(opt_state["nu"])}}


def test_two_ranks_lay_the_data_axis_across_the_processes(two_ranks):
    outs = two_ranks["outs"]
    assert [out["cols"] for out in outs] == [[0, 1, 2, 3]] * 2
    assert [out["rows"] for out in outs] == [[0], [1]]


def test_two_ranks_loss_and_gradients_equal_the_jax_trainers(jax_run, two_ranks):  # noqa: F811
    for out in two_ranks["outs"]:
        assert abs(out["loss"] - jax_run["loss"]) <= 1e-5
        _close_grads(out["grads"], _state(jax_run["grads"]), 1e-4)


def test_two_ranks_three_steps_track_the_jax_trainer(jax_run, two_ranks):  # noqa: F811
    for out in two_ranks["outs"]:
        losses = [s["metrics"]["loss"] for s in out["steps"]]
        assert losses[-1] < losses[0]
        for got, step in zip(losses, jax_run["steps"]):
            assert abs(got - step["loss"]) <= 1e-4 * abs(step["loss"])


def test_two_ranks_agree_on_every_rank(two_ranks):
    _same_on_every_rank(two_ranks["outs"], two_ranks["single"]._split)


def test_checkpoint_of_two_ranks_restores_bit_for_bit_in_one_process(two_ranks):
    single, out = two_ranks["single"], two_ranks["outs"][0]
    params, opt_state, step = single.restore_checkpoint(two_ranks["work"] / "ckpt_multi")
    assert step == STEPS and opt_state["count"] == out["count"] == STEPS
    got = single.state_dict(params)
    for name, p in out["steps"][-1]["params"].items():
        assert torch.equal(got[name], p), name
    # and it trains on in one process
    _, _, metrics = single.train_step(params, opt_state, *_batch())
    assert np.isfinite(metrics["loss"].item())


def test_checkpoint_of_one_process_restores_bit_for_bit_in_two_ranks(two_ranks):
    want, split = two_ranks["single_state"], two_ranks["single"]._split
    for out in two_ranks["outs"]:
        restored = out["restored"]
        assert restored["step"] == 1 and restored["count"] == 1
        for key in ("params", "mu", "nu"):
            for name, shards in restored[key].items():
                dim = split[name]
                chunks = [want[key][name]] if dim is None else want[key][name].chunk(4, dim)
                cols = [0] if dim is None else out["cols"]
                assert len(shards) == len(cols), (key, name)
                for j, s in zip(cols, shards):
                    assert torch.equal(s, chunks[j]), (key, name, j)


def test_state_dict_across_ranks_deploys_into_the_embedder(two_ranks):
    for out in two_ranks["outs"]:
        assert out["deploy_err"] <= 1e-5


# ---------------------------------------------------------------------------
# four ranks x one device on (2, 2), against the one-process (2, 2) trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' outputs and the one-process (2, 2) run from the same
    seeded init: the first loss and gradients, and three steps."""
    work = tmp_path_factory.mktemp("four_ranks")
    single = _trainer((2, 2))
    init = single.state_dict(single.init(0)[0])
    params = single.shard_params(init)
    loss, _, grads = single.value_and_grad(params, *_batch())
    ref = {"loss": float(loss), "grads": single.state_dict(grads), "losses": []}
    opt_state = single.shard_opt_state(_zeros(init))
    for _ in range(STEPS):
        params, opt_state, metrics = single.train_step(params, opt_state, *_batch())
        ref["losses"].append(float(metrics["loss"]))
    outs = _run(work, init, world=4, per_rank=1, shape=(2, 2))
    return {"outs": outs, "ref": ref, "single": single}


def test_four_ranks_cross_both_axes(four_ranks):
    outs = four_ranks["outs"]
    assert [out["cols"] for out in outs] == [[0], [1], [0], [1]]
    assert [out["rows"] for out in outs] == [[0], [0], [1], [1]]


def test_four_ranks_loss_and_gradients_equal_one_process(four_ranks):
    ref = four_ranks["ref"]
    for out in four_ranks["outs"]:
        assert abs(out["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
        _close_grads(out["grads"], ref["grads"], 1e-5)


def test_four_ranks_three_steps_track_one_process(four_ranks):
    ref = four_ranks["ref"]
    for out in four_ranks["outs"]:
        for s, want in zip(out["steps"], ref["losses"]):
            assert abs(s["metrics"]["loss"] - want) <= 1e-5 * abs(want)


def test_four_ranks_agree_on_every_rank(four_ranks):
    _same_on_every_rank(four_ranks["outs"], four_ranks["single"]._split)
    for out in four_ranks["outs"]:
        assert out["deploy_err"] <= 1e-5
