"""Distributed CLIP contrastive training (fine-tuning) over a device mesh.

Port of ``intelligent_video_analysis_retrieval_system_tpu/parallel/train.py``.
There the layout is ``NamedSharding`` annotation and XLA inserts the
collectives; here it is held and computed explicitly over the port's
:class:`parallel.mesh.Mesh` with axes ``("data", "model")``:

- **TP**: :func:`param_spec` is the reference's ``_param_pspec`` over HF
  state-dict names, in the torch layout. Column-parallel tensors (``q_proj``,
  ``k_proj``, ``v_proj``, ``fc1``: weight and bias) split their output
  features, row-parallel weights (``out_proj``, ``fc2``) their input
  features; everything else is replicated. A split tensor is held as
  ``mesh.shape["model"]`` shards, shard j on the j-th device along the model
  axis; a replicated one once, on the mesh's first device. Each shard
  computes its own heads (kernel B3 over ``num_heads / model`` heads on a
  card) and its own slice of the MLP's hidden features; the row-parallel
  partial sums are added in shard order on the data position's first
  device, so the result does not depend on timing. Heads split in whole
  blocks: ``num_heads`` and the MLP width must divide by the model axis
  (stricter than the reference, which needs only the split dimension to
  divide and leaves the head layout to XLA).
- **DP**: the batch splits evenly over the ``data`` positions. Position i
  runs its slice on its own devices, reading every master shard through a
  differentiable ``.to(device)`` (a no-op on the same device), so autograd
  sums the positions' gradients into each master: the DP all-reduce. The
  embeddings are gathered onto the first device for the symmetric InfoNCE
  loss over the global batch.
- The optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
  adamw(schedule, b1, b2, eps, weight_decay))`` written out with optax's
  arithmetic (:func:`clip_by_global_norm`, :meth:`CLIPTrainer.apply_gradients`);
  weight decay reaches every parameter, as optax's ``mask=None`` does.
- With ``remat`` the blocks run under activation checkpointing
  (:func:`models.clip.run_blocks`), so B3 runs twice per vision layer, shard
  and step.
- Checkpoints are one ``torch.save`` file per step (no orbax on the card's
  machine): the gathered parameters and optimizer state in HF names.

**Across processes.** A mesh whose devices belong to several ranks of a
``torch.distributed`` process group (``mesh.process_ids``) trains as the
reference's multi-process trainer does: every rank calls :meth:`train_step`
with the same global batch and runs the data positions and model shards
whose devices it owns; the metrics and the updated params come out the same
on every rank. A rank holds the shards of the model columns it owns (on its
first device in the column) and every replicated tensor. The four moves of
the one-process code become collectives (``collectives.py``): the input of
each column-parallel region (Megatron's "f") and the row-parallel partial
sums (its "g", added in shard order) over the ranks of a data position; the
embeddings gathered for the global loss, each rank's gradient its own rows;
the data-parallel sum of each gradient over the ranks that hold it, in rank
order. A replicated tensor's gradient counts once per data position (the
position's rank of model shard 0 keeps it, the others drop theirs) and
``logit_scale``'s once (rank 0); the global norm counts each
shard once. :meth:`state_dict` and :meth:`save_checkpoint` gather the
shards (rank 0 writes, then every rank meets at a barrier), so a checkpoint
moves between one process and several either way. Every rank of the world
must own part of the mesh: the process groups are built collectively.

Params and their gradients are ``{name: [shard, ...]}`` (one entry for a
replicated tensor; a rank's own model columns, in order, for a split one),
f32; the optimizer state is ``{"count": int, "mu": ..., "nu": ...}`` in the
params' layout.
"""

from __future__ import annotations

import functools
import math
import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..models.clip import CLIPConfig, attention, patch_embed, quick_gelu, run_blocks
from ..models.convert import empty_model, load_clip
from . import collectives
from .mesh import Mesh, _rank_world

__all__ = ["TrainConfig", "CLIPTrainer", "param_spec", "clip_by_global_norm"]

_COLUMN = ("q_proj", "k_proj", "v_proj", "fc1")   # split output features
_ROW = ("out_proj", "fc2")                        # split input features (weights)
_CKPT_FILE = "state.pt"

Params = dict[str, list[torch.Tensor]]


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.2
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    data_axis: str = "data"
    model_axis: str = "model"
    remat: bool = True  # recompute the blocks' activations in the backward pass
    # the vision tower's attention through kernel B3 on a card (its backward
    # is the einsum recompute); False takes the plain einsum path end to end
    fused_attn: bool = True
    # LR schedule: "constant" (default) or "warmup_cosine" (linear warmup
    # over ``warmup_steps`` then cosine decay to ``end_lr_factor * lr``
    # at ``total_steps``)
    schedule: str = "constant"
    warmup_steps: int = 500
    total_steps: int = 10_000
    end_lr_factor: float = 0.1

    def make_schedule(self) -> float | Callable[[int], float]:
        """The learning rate: a constant, or ``step -> lr`` with the values
        of ``optax.warmup_cosine_decay_schedule``."""
        if self.schedule == "constant":
            return self.learning_rate
        if self.schedule == "warmup_cosine":
            return _warmup_cosine(self.learning_rate, self.warmup_steps, self.total_steps,
                                  self.learning_rate * self.end_lr_factor)
        raise ValueError(f"unknown schedule {self.schedule!r}")


def _warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                   end: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps, end)``: linear from 0 to ``peak`` over ``warmup_steps``,
    then a cosine from ``peak`` to ``end`` at ``total_steps``, then flat."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"warmup_cosine needs total_steps > warmup_steps, got "
                         f"{total_steps} and {warmup_steps}")
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return -peak * frac + peak
        count = min(step - warmup_steps, decay_steps)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
                       + alpha)

    return schedule


def param_spec(name: str, tensor: torch.Tensor, model_axis: str = "model") -> tuple:
    """The reference's ``_param_pspec`` for an HF-named tensor, in the torch
    layout: one entry per dimension, ``model_axis`` on the dimension split
    over the model shards and ``None`` elsewhere; ``()`` when replicated. A
    Flax kernel is ``(in, out)`` and a torch weight ``(out, in)``, so the
    reference's ``P(None, "model")`` on ``mlp_fc/kernel`` is ``("model",
    None)`` on ``mlp.fc1.weight`` and ``P("model", None)`` on
    ``mlp_proj/kernel`` is ``(None, "model")`` on ``mlp.fc2.weight``."""
    module, _, leaf = name.rpartition(".")
    layer = module.rpartition(".")[2]
    if layer in _COLUMN and (leaf, tensor.ndim) in (("weight", 2), ("bias", 1)):
        return (model_axis,) + (None,) * (tensor.ndim - 1)
    if layer in _ROW and (leaf, tensor.ndim) == ("weight", 2):
        return (None, model_axis)
    return ()


def clip_by_global_norm(grads: Params, max_norm: float, device: torch.device,
                        norm: torch.Tensor | None = None) -> Params:
    """``optax.clip_by_global_norm``: the L2 norm over every gradient shard
    in f32 (summed on ``device``; or ``norm``, where the caller counted the
    shards of other ranks too); where it is at least ``max_norm`` each
    gradient becomes ``(g / norm) * max_norm``. Not
    ``torch.nn.utils.clip_grad_norm_``, which scales by ``max_norm / (norm
    + 1e-6)`` clamped to 1."""
    if norm is None:
        flat = [g for shards in grads.values() for g in shards]
        norm = torch.sqrt(torch.stack([torch.sum(g * g).to(device) for g in flat]).sum())
    if bool(norm < max_norm):
        return grads
    return {name: [(g / norm.to(g.device)) * max_norm for g in shards]
            for name, shards in grads.items()}


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An own contiguous f32 copy of ``t`` on ``device``."""
    return t.to(device=device, dtype=torch.float32, memory_format=torch.contiguous_format,
                copy=True)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``models.clip.Dense``: the f32 parameters cast to the input's dtype."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``models.clip.LayerNorm``: f32 statistics, output in the input's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), 1e-5).to(x.dtype)


def _in_order(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The row-parallel partial sums added in shard order on ``device``."""
    return collectives.sum_in_order([part.to(device) for part in parts])


def _steps(root: Path) -> list[int]:
    """The steps with a complete checkpoint under ``root``, oldest first."""
    if not root.is_dir():
        return []
    return sorted(int(d.name) for d in root.iterdir()
                  if d.name.isdigit() and (d / _CKPT_FILE).is_file())


class CLIPTrainer:
    """Contrastive trainer over a ``("data", "model")`` mesh (DP x TP)."""

    def __init__(self, config: CLIPConfig, mesh: Mesh, train_config: TrainConfig | None = None,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        tc = train_config or TrainConfig()
        if sorted(mesh.axis_names) != sorted((tc.data_axis, tc.model_axis)):
            raise ValueError(f"the trainer needs a mesh with axes ({tc.data_axis!r}, "
                             f"{tc.model_axis!r}), got {mesh.axis_names}")
        data_first = mesh.axis_names[0] == tc.data_axis
        grid = mesh.devices if data_first else mesh.devices.T
        owners = mesh.process_ids if data_first else mesh.process_ids.T
        self._grid = [[torch.device(d) for d in row] for row in grid]   # [data][model]
        self._owners = [[int(r) for r in row] for row in owners]
        self.n_data, self.n_model = len(self._grid), len(self._grid[0])
        ranks = sorted({r for row in self._owners for r in row})
        self._multi = len(ranks) > 1
        if self._multi:
            dist = torch.distributed
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"the mesh's devices belong to ranks {ranks}: training across processes "
                    "needs an initialized process group (parallel.distributed."
                    "initialize_distributed) on every one of them")
            if ranks != list(range(dist.get_world_size())):
                raise ValueError(
                    f"the mesh's devices belong to ranks {ranks}, but the process group has "
                    f"{dist.get_world_size()}: every rank must own part of the mesh")
        self._ranks = ranks
        self._rank = _rank_world()[0] if self._multi else ranks[0]
        for tower, cfg in (("vision_model", config.vision), ("text_model", config.text)):
            if cfg.num_heads % self.n_model:
                raise ValueError(f"{tower}.encoder.layers.*.self_attn: {cfg.num_heads} heads do "
                                 f"not split into {self.n_model} model shards")
            if cfg.hidden_size * cfg.mlp_ratio % self.n_model:
                raise ValueError(f"{tower}.encoder.layers.*.mlp.fc1: "
                                 f"{cfg.hidden_size * cfg.mlp_ratio} hidden features do not "
                                 f"split into {self.n_model} model shards")
        self.config = config
        self.mesh = mesh
        self.tc = tc
        self.dtype = dtype
        # what this rank computes: its data positions, and in each its model
        # columns; a position's activations live on its first such device
        me = self._rank
        self._rows = [i for i in range(self.n_data) if me in self._owners[i]]
        self._row_cols = {i: [j for j in range(self.n_model) if self._owners[i][j] == me]
                          for i in self._rows}
        self._home = {i: self._grid[i][cols[0]] for i, cols in self._row_cols.items()}
        # what it holds: its columns' shards, each on its first device in the column
        self._cols = sorted({j for cols in self._row_cols.values() for j in cols})
        self._col_home = {j: self._grid[min(i for i in self._rows if j in self._row_cols[i])][j]
                          for j in self._cols}
        self.device = self._home[self._rows[0]]   # replicated tensors and the loss
        self._row_groups: dict[int, collectives.Group] = {}
        self._col_groups: dict[int, collectives.Group] = {}
        self._world: collectives.Group | None = None
        if self._multi:   # built in one order on every rank: new_group is collective
            for i in range(self.n_data):
                if len(set(self._owners[i])) > 1:
                    self._row_groups[i] = collectives.new_group(set(self._owners[i]))
            for j in range(self.n_model):
                holders = {row[j] for row in self._owners}
                if len(holders) > 1:
                    self._col_groups[j] = collectives.new_group(holders)
            self._world = collectives.new_group(ranks)
        self._shapes: dict[str, tuple[int, ...]] = {}
        self._split: dict[str, int | None] = {}   # the dimension split over the model axis
        for name, p in empty_model(config, "meta").named_parameters():
            spec = param_spec(name, p, tc.model_axis)
            self._shapes[name] = tuple(p.shape)
            self._split[name] = spec.index(tc.model_axis) if spec else None
        self._schedule = tc.make_schedule()

    # -- layout ---------------------------------------------------------------

    def shard_params(self, params: Mapping[str, Any]) -> Params:
        """A full HF-named state dict (tensors or numpy arrays; e.g.
        ``models.convert.from_jax_params``) -> this trainer's layout, f32,
        every tensor an own copy."""
        missing = sorted(set(self._shapes) - set(params))
        if missing:
            raise KeyError(f"shard_params: missing {missing[:3]} ({len(missing)} in all)")
        out: Params = {}
        for name, shape in self._shapes.items():
            t = torch.as_tensor(params[name])
            if tuple(t.shape) != shape:
                raise ValueError(f"shard_params: {name} has shape {tuple(t.shape)}, not {shape}")
            dim = self._split[name]
            if dim is None:
                out[name] = [_place(t, self.device)]
            else:
                chunks = t.chunk(self.n_model, dim)
                out[name] = [_place(chunks[j], self._col_home[j]) for j in self._cols]
        return out

    def _keeper(self, name: str, j: int) -> int:
        """The rank whose copy of shard ``j`` of ``name`` is read where one
        copy is needed (a gather, the global norm): the lowest holder."""
        if self._split[name] is None:
            return self._ranks[0]
        return min(row[j] for row in self._owners)

    def _held(self, name: str) -> list[int]:
        """The shards of ``name`` this rank holds (its params' list), by column."""
        return [0] if self._split[name] is None else self._cols

    def state_dict(self, params: Params) -> dict[str, torch.Tensor]:
        """The shards gathered into one HF-named state dict on the first
        device (for ``CLIPEmbedder.load_params``: train -> deploy). Across
        processes every rank calls it and gets the whole state dict: the
        ranks of a data position hold every model column between them, so
        each column's shards come from its rank there (one ``all_gather``
        of a column's shards, flat, per position the rank computes), and a
        replicated tensor is the rank's own copy."""
        if not self._multi:
            return {name: shards[0] if len(shards) == 1
                    else torch.cat([s.to(self.device) for s in shards], self._split[name])
                    for name, shards in params.items()}
        split = {name: k for k, name in enumerate(n for n in params if self._split[n] is not None)}
        sizes = [params[name][0].numel() for name in split]
        columns = None
        for i in self._rows:   # every group this rank is in takes part, in order
            mine = [torch.cat([params[name][self._cols.index(j)].reshape(-1) for name in split])
                    for j in self._row_cols[i]]
            group = self._row_groups.get(i)
            flats = mine if group is None else collectives.gather_items(
                mine, self._owners[i], group, mine[0], self.device)
            columns = columns or [f.to(self.device).split(sizes) for f in flats]
        out = {}
        for name, shards in params.items():
            if self._split[name] is None:
                out[name] = shards[0]
            else:
                out[name] = torch.cat([col[split[name]].view_as(shards[0]) for col in columns],
                                      self._split[name])
        return out

    def shard_opt_state(self, opt_state: Mapping[str, Any]) -> dict[str, Any]:
        """``{"count", "mu", "nu"}`` with full state dicts (a checkpoint's,
        or ``models.convert.from_optax_state``'s) -> this trainer's layout."""
        return {"count": int(opt_state["count"]), "mu": self.shard_params(opt_state["mu"]),
                "nu": self.shard_params(opt_state["nu"])}

    # -- init -----------------------------------------------------------------

    def init(self, seed: int = 0) -> tuple[Params, dict[str, Any]]:
        """Seeded f32 params (``torch.Generator(first device).manual_seed``,
        the reference's initializers) in this trainer's layout, and a fresh
        optimizer state."""
        _, sd = load_clip(config=self.config, seed=seed, device=self.device)
        params = self.shard_params(sd)

        def zeros():
            return {name: [torch.zeros_like(s) for s in shards] for name, shards in params.items()}

        return params, {"count": 0, "mu": zeros(), "nu": zeros()}

    # -- forward ----------------------------------------------------------------

    def _view(self, params: Params, i: int) -> Params:
        """Every shard as data position ``i`` reads it: shard j on the
        position's j-th device (``None`` for a column of another rank), a
        replicated tensor on the position's first device of this rank, its
        gradient dropped where another rank keeps the position's gradient of
        it (``collectives.counted_elsewhere``)."""
        row, home = self._grid[i], self._home[i]
        keep = self._owners[i][0] == self._rank
        view: Params = {}
        for name, shards in params.items():
            if self._split[name] is None:
                t = shards[0] if keep else collectives.counted_elsewhere(shards[0])
                view[name] = [t.to(home)]
            else:
                full = [None] * self.n_model
                for j in self._row_cols[i]:
                    full[j] = shards[self._cols.index(j)].to(row[j])
                view[name] = full
        return view

    def _enter(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """The input of data position ``i``'s column-parallel shards."""
        group = self._row_groups.get(i)
        return h if group is None else collectives.enter_parallel(h, group)

    def _reduce(self, parts: list[torch.Tensor], i: int, device: torch.device) -> torch.Tensor:
        """Data position ``i``'s row-parallel partial sums (this rank's
        shards' in ``parts``) added in shard order on ``device``."""
        group = self._row_groups.get(i)
        if group is None:
            return _in_order(parts, device)
        return collectives.reduce_in_order(parts, self._owners[i], group, device)

    def _block(self, view: Params, prefix: str, heads: int, i: int, x: torch.Tensor,
               mask: torch.Tensor | None) -> torch.Tensor:
        """``models.clip.TransformerBlock`` over the model shards of data
        position ``i``: each shard's heads and MLP slice on its device, the
        row-parallel bias added once, by shard 0 (with one shard this is the
        block's own arithmetic)."""
        def p(name):
            return view[f"{prefix}.{name}"]

        attn, mlp = [], []
        h = self._enter(_layer_norm(x, p("layer_norm1.weight")[0], p("layer_norm1.bias")[0]), i)
        for j in self._row_cols[i]:
            dev = self._grid[i][j]
            hj, mj = h.to(dev), None if mask is None else mask.to(dev)
            q, k, v = (_linear(hj, p(f"self_attn.{n}.weight")[j], p(f"self_attn.{n}.bias")[j])
                       for n in ("q_proj", "k_proj", "v_proj"))
            a = attention(q, k, v, heads, mj, fused_attn=self.tc.fused_attn)
            attn.append(_linear(a, p("self_attn.out_proj.weight")[j],
                                p("self_attn.out_proj.bias")[0] if j == 0 else None))
        x = x + self._reduce(attn, i, x.device)
        h = self._enter(_layer_norm(x, p("layer_norm2.weight")[0], p("layer_norm2.bias")[0]), i)
        for j in self._row_cols[i]:
            dev = self._grid[i][j]
            a = quick_gelu(_linear(h.to(dev), p("mlp.fc1.weight")[j], p("mlp.fc1.bias")[j]))
            mlp.append(_linear(a, p("mlp.fc2.weight")[j],
                               p("mlp.fc2.bias")[0] if j == 0 else None))
        return x + self._reduce(mlp, i, x.device)

    def _encoder(self, view: Params, tower: str, x: torch.Tensor, mask: torch.Tensor | None,
                 i: int) -> torch.Tensor:
        cfg = self.config.vision if tower == "vision_model" else self.config.text
        blocks = [functools.partial(self._block, view, f"{tower}.encoder.layers.{n}",
                                    cfg.num_heads // self.n_model, i)
                  for n in range(cfg.num_layers)]
        return run_blocks(blocks, x, mask, self.tc.remat)

    def _encode_image(self, view: Params, pixels: torch.Tensor, i: int) -> torch.Tensor:
        """``models.clip.CLIPVisionTower`` + ``visual_projection``."""
        dt = self.dtype

        def p(name):
            return view[f"vision_model.{name}"][0]

        x = patch_embed(pixels.to(self._home[i], dt),
                        p("embeddings.patch_embedding.weight").to(dt))
        cls = p("embeddings.class_embedding").to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + p("embeddings.position_embedding.weight").to(dt)[None]
        x = _layer_norm(x, p("pre_layrnorm.weight"), p("pre_layrnorm.bias"))
        x = self._encoder(view, "vision_model", x, None, i)
        x = _layer_norm(x[:, 0], p("post_layernorm.weight"), p("post_layernorm.bias"))
        return _linear(x, view["visual_projection.weight"][0])

    def _encode_text(self, view: Params, tokens: torch.Tensor, i: int) -> torch.Tensor:
        """``models.clip.CLIPTextTower`` (EOT = the largest id) +
        ``text_projection``."""
        dev, dt = self._home[i], self.dtype

        def p(name):
            return view[f"text_model.{name}"][0]

        tokens = tokens.to(dev)
        t = tokens.shape[1]
        x = p("embeddings.token_embedding.weight")[tokens.long()].to(dt)
        x = x + p("embeddings.position_embedding.weight")[:t].to(dt)[None]
        mask = torch.triu(torch.full((t, t), float("-inf"), device=dev), diagonal=1)[None, None]
        x = self._encoder(view, "text_model", x, mask, i)
        x = _layer_norm(x, p("final_layer_norm.weight"), p("final_layer_norm.bias"))
        x = x[torch.arange(x.shape[0], device=dev), tokens.argmax(dim=-1)]
        return _linear(x, view["text_projection.weight"][0])

    def encode_image(self, params: Params, pixels: Any) -> torch.Tensor:
        """(B, H, W, 3) pixels -> (B, projection_dim) unnormalized, in
        ``dtype``, on the first data position (the reference's
        ``model.apply(..., method=CLIPModel.encode_image)``). Across
        processes every rank calls it and computes on its own first data
        position."""
        i = self._rows[0]
        return self._encode_image(self._view(params, i), torch.as_tensor(pixels), i)

    # -- loss / step ------------------------------------------------------------

    def loss_fn(self, params: Params, pixels: Any, tokens: Any
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Symmetric InfoNCE over the global batch: ``(loss, {"loss",
        "accuracy", "scale"})``. ``pixels`` are raw ``(B, H, W, 3)`` f32 (not
        normalized here), ``tokens`` ``(B, T)`` ids; B splits evenly over the
        data positions."""
        pixels, tokens = torch.as_tensor(pixels, dtype=torch.float32), torch.as_tensor(tokens)
        b = pixels.shape[0]
        if b % self.n_data or tokens.shape[0] != b:
            raise ValueError(f"a batch of {b} images and {tokens.shape[0]} texts does not split "
                             f"evenly over {self.n_data} data positions")
        per = b // self.n_data
        imgs, txts = [], []
        for i in self._rows:
            view, rows = self._view(params, i), slice(i * per, (i + 1) * per)
            imgs.append(self._encode_image(view, pixels[rows], i).float().to(self.device))
            txts.append(self._encode_text(view, tokens[rows], i).float().to(self.device))
        if self._multi:   # every position's embeddings, from its rank of shard 0
            both = collectives.gather_rows(
                [torch.cat(pair, -1) for pair in zip(imgs, txts)], self._rows,
                [row[0] for row in self._owners], self._world, self.device)
            img, txt = both.split([imgs[0].shape[-1], txts[0].shape[-1]], -1)
        else:
            img, txt = torch.cat(imgs), torch.cat(txts)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        # every rank computes this loss alike: one keeps logit_scale's gradient
        logit_scale = params["logit_scale"][0]
        if self._rank != self._keeper("logit_scale", 0):
            logit_scale = collectives.counted_elsewhere(logit_scale)
        scale = torch.exp(torch.clamp(logit_scale, 0.0, math.log(100.0)))
        logits = scale * img @ txt.T
        labels = torch.arange(b, device=self.device)
        loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
        accuracy = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, {"loss": loss, "accuracy": accuracy, "scale": scale}

    def value_and_grad(self, params: Params, pixels: Any, tokens: Any
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor], Params]:
        """``(loss, metrics, grads)``, the gradients of :meth:`loss_fn` in the
        params' layout (``jax.value_and_grad(loss_fn, has_aux=True)``).
        Across processes each gradient is summed over the ranks that hold its
        tensor, so every rank returns the same ones."""
        leaves = {name: [s.detach().requires_grad_(True) for s in shards]
                  for name, shards in params.items()}
        flat_leaves = [s for shards in leaves.values() for s in shards]
        with torch.enable_grad():
            loss, metrics = self.loss_fn(leaves, pixels, tokens)
            # across processes a rank may drop a tensor's every gradient
            flat = torch.autograd.grad(loss, flat_leaves, allow_unused=self._multi)
        it = (torch.zeros_like(s) if g is None else g for s, g in zip(flat_leaves, flat))
        grads = {name: [next(it) for _ in shards] for name, shards in leaves.items()}
        if self._multi:
            grads = self._sum_data_parallel(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def _sum_data_parallel(self, grads: Params) -> Params:
        """Each gradient summed over the ranks that hold its tensor (a
        column's holders, or every rank for a replicated tensor), in rank
        order: one flat ``all_gather`` per group."""
        members: dict[int | None, list[tuple[str, int]]] = {}
        for name in grads:
            for k, j in enumerate(self._held(name)):
                key = None if self._split[name] is None else j
                members.setdefault(key, []).append((name, k))
        out = {name: list(shards) for name, shards in grads.items()}
        for key, items in members.items():
            group = self._world if key is None else self._col_groups.get(key)
            if group is None:
                continue
            parts = [grads[name][k] for name, k in items]
            total = collectives.sum_over(torch.cat([g.reshape(-1) for g in parts]), group)
            for (name, k), g in zip(items, total.split([g.numel() for g in parts])):
                out[name][k] = g.view_as(grads[name][k])
        return out

    def _global_norm(self, grads: Params) -> torch.Tensor:
        """The L2 norm of the gradients over every shard of every rank, each
        counted once (its keeper's copy), summed in the one-process order."""
        keepers, mine = [], []
        for name, shards in grads.items():
            held = dict(zip(self._held(name), shards))
            for j in ([0] if self._split[name] is None else range(self.n_model)):
                keepers.append(self._keeper(name, j))
                if keepers[-1] == self._rank:
                    mine.append(torch.sum(held[j] * held[j]).to(self.device))
        sums = collectives.gather_items(mine, keepers, self._world,
                                        torch.zeros((), device=self.device), self.device)
        return torch.sqrt(torch.stack(sums).sum())

    def apply_gradients(self, params: Params, grads: Params, opt_state: dict[str, Any]
                        ) -> tuple[Params, dict[str, Any]]:
        """One update of ``optax.chain(clip_by_global_norm(max_grad_norm),
        adamw(schedule, b1, b2, eps, weight_decay))``, shard by shard on the
        shard's device: the bias correction uses the incremented count, the
        learning rate ``schedule(count)`` the count before it (so a warmup
        from 0 leaves the first step's params unchanged); ``eps`` outside the
        square root, ``eps_root`` 0; decoupled weight decay on every tensor."""
        tc = self.tc
        grads = clip_by_global_norm(grads, tc.max_grad_norm, self.device,
                                    self._global_norm(grads) if self._multi else None)
        count = int(opt_state["count"])
        lr = self._schedule(count) if callable(self._schedule) else self._schedule
        # 1 - b**t in f32, as optax computes it; tensors, so that a division
        # on a card is a division (not a multiply by the reciprocal)
        bc1 = torch.tensor(1 - np.float32(tc.b1) ** np.float32(count + 1))
        bc2 = torch.tensor(1 - np.float32(tc.b2) ** np.float32(count + 1))
        new_p, new_mu, new_nu = {}, {}, {}
        for name, shards in params.items():
            new_p[name], new_mu[name], new_nu[name] = [], [], []
            for p, g, mu, nu in zip(shards, grads[name], opt_state["mu"][name],
                                    opt_state["nu"][name]):
                mu = (1 - tc.b1) * g + tc.b1 * mu
                nu = (1 - tc.b2) * (g * g) + tc.b2 * nu
                u = (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device)) + tc.eps)
                u = u + tc.weight_decay * p
                new_p[name].append(p + -lr * u)
                new_mu[name].append(mu)
                new_nu[name].append(nu)
        return new_p, {"count": count + 1, "mu": new_mu, "nu": new_nu}

    def train_step(self, params: Params, opt_state: dict[str, Any], pixels: np.ndarray,
                   tokens: np.ndarray) -> tuple[Params, dict[str, Any], dict[str, torch.Tensor]]:
        """One optimizer step; returns ``(params, opt_state, metrics)`` (new
        tensors: the arguments stay as they were)."""
        _, metrics, grads = self.value_and_grad(params, pixels, tokens)
        params, opt_state = self.apply_gradients(params, grads, opt_state)
        return params, opt_state, metrics

    # -- checkpoints --------------------------------------------------------------

    def save_checkpoint(self, ckpt_dir: str | Path, params: Params, opt_state: dict[str, Any],
                        step: int, keep: int = 3) -> str:
        """``<ckpt_dir>/<step>/state.pt``: the gathered params and optimizer
        state in HF names, written to a temporary name, flushed to disk and
        moved into place; then only the newest ``keep`` steps stay. Across
        processes every rank calls it: rank 0 writes (``ckpt_dir`` must be
        one directory for all), then all meet at a barrier."""
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        root = Path(ckpt_dir).resolve()
        folder = root / str(int(step))
        state = {"step": int(step), "params": self.state_dict(params),
                 "opt_state": {"count": int(opt_state["count"]),
                               "mu": self.state_dict(opt_state["mu"]),
                               "nu": self.state_dict(opt_state["nu"])}}
        if self._rank == self._ranks[0]:
            folder.mkdir(parents=True, exist_ok=True)
            tmp = folder / f"{_CKPT_FILE}.tmp"
            with open(tmp, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, folder / _CKPT_FILE)
            for old in _steps(root)[:-keep]:
                shutil.rmtree(root / str(old))
        if self._multi:
            torch.distributed.barrier(group=self._world.pg)
        return str(folder)

    def restore_checkpoint(self, ckpt_dir: str | Path, step: int | None = None
                           ) -> tuple[Params, dict[str, Any], int]:
        """``(params, opt_state, step)`` of ``step`` (default: the latest),
        every shard back on this trainer's devices (across processes: each
        rank reads the file and takes its own shards)."""
        root = Path(ckpt_dir).resolve()
        if step is None:
            steps = _steps(root)
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {root}")
            step = steps[-1]
        path = root / str(int(step)) / _CKPT_FILE
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint of step {step} under {root}")
        state = torch.load(path, map_location="cpu", weights_only=True)
        return (self.shard_params(state["params"]), self.shard_opt_state(state["opt_state"]),
                int(state["step"]))
