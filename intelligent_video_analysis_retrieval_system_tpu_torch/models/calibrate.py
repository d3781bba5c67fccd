"""Static activation-scale calibration for the W8A8 towers.

Port of ``intelligent_video_analysis_retrieval_system_tpu/models/calibrate.py``.
The dynamic W8A8 mode (``w8a8=True``) takes a per-token max before every
int8 product; static mode (``w8a8_static=True``) replaces it with one
calibrated scalar per dense-layer input. Calibration runs representative
batches through the *dynamic* model while every W8A8 layer records the
``max|x|`` of its input (:func:`record_act_stats`, the reference's
``act_stats`` collection), then turns each maximum into a symmetric int8
scale ``max(amax, 1e-6) * margin / 127`` (:func:`act_stats_to_scales`).

The scale tree carries the Flax key paths of the reference, so a scales
file written by either package loads in the other. The port's modules use
HF names; :func:`act_sites` maps them explicitly::

    {"vision" | "text": {"transformer": {"layer_{i}": {
        "attn": {"q_proj_ascale", "k_proj_ascale", "v_proj_ascale",
                 "out_proj_ascale"},
        "mlp_fc_ascale", "mlp_proj_ascale"}}}}

(``*_amax`` in the stats tree). ``q_proj``, ``k_proj`` and ``v_proj`` each
keep their own site although all three see the same input, as in the
reference.

Usage::

    dyn = CLIPModel(cfg, torch.bfloat16, w8a8=True)
    scales = calibrate_act_scales(dyn, [(px1,), (px2,)], method="encode_image")
    fast = CLIPModel(cfg, torch.bfloat16, w8a8=True, w8a8_static=True)
    fast.load_state_dict(dyn.state_dict())
    set_act_scales(fast, scales["act_scales"])
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch

from .clip import CLIPModel, Dense

__all__ = ["TOWERS", "act_sites", "record_act_stats", "act_stats_to_scales",
           "merge_act_stats", "calibrate_act_scales", "set_act_scales"]

# the reference's submodule names of the two towers, and the port's
TOWERS = {"vision": "vision_model", "text": "text_model"}


def act_sites(model: CLIPModel) -> dict[str, dict[tuple[str, ...], Dense]]:
    """Per tower, the Flax key path of every W8A8 input site (without the
    ``_amax`` / ``_ascale`` suffix) -> the port's dense layer."""
    out: dict[str, dict[tuple[str, ...], Dense]] = {}
    for tower, attr in TOWERS.items():
        sites: dict[tuple[str, ...], Dense] = {}
        for i, layer in enumerate(getattr(model, attr).encoder.layers):
            pre = ("transformer", f"layer_{i}")
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sites[pre + ("attn", proj)] = getattr(layer.self_attn, proj)
            sites[pre + ("mlp_fc",)] = layer.mlp.fc1
            sites[pre + ("mlp_proj",)] = layer.mlp.fc2
        out[tower] = sites
    return out


def _nest(flat: dict[tuple[str, ...], Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


@contextlib.contextmanager
def record_act_stats(model: CLIPModel) -> Iterator[dict]:
    """Record ``max|x|`` at every W8A8 input site of ``model`` while the
    block runs. The yielded dict is filled on exit with the stats tree
    ``{tower: {..., "<site>_amax": f32 0-d tensor on the device}}`` of the
    towers that ran, as Flax's ``mutable=["act_stats"]`` returns it; the
    maxima stay on the device (no sync per site)."""
    sites = act_sites(model)
    if not model.w8a8:
        raise ValueError("record_act_stats needs a model built with w8a8=True")
    for per_tower in sites.values():
        for dense in per_tower.values():
            dense.recording, dense.amax = True, None
    stats: dict = {}
    try:
        yield stats
        for tower, per_tower in sites.items():
            # Flax's collection holds only the towers that ran
            if all(dense.amax is not None for dense in per_tower.values()):
                stats[tower] = _nest({path[:-1] + (f"{path[-1]}_amax",): dense.amax
                                      for path, dense in per_tower.items()})
    finally:
        for per_tower in sites.values():
            for dense in per_tower.values():
                dense.recording, dense.amax = False, None


def _map_leaves(tree: Any, fn) -> Any:
    if not isinstance(tree, dict):
        raise TypeError(f"expected dict tree, got {type(tree)}")
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _map_leaves(val, fn)
        else:
            new_key, new_val = fn(key, val)
            out[new_key] = new_val
    return out


def _host_f32(leaf: Any) -> np.float32:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.float32(np.asarray(leaf, np.float32).reshape(()))


def act_stats_to_scales(act_stats: dict, margin: float = 1.0) -> dict:
    """Stats tree (``*_amax`` maxima) -> ``{"act_scales": ...}`` with
    ``*_ascale`` scalars, ``max(amax, 1e-6) * margin / 127`` in f32 on the
    host: the reference's expression, operation for operation, so the same
    maxima give the same bits."""

    def convert(key: str, leaf: Any):
        if not key.endswith("_amax"):
            raise ValueError(f"unexpected act_stats leaf {key!r}")
        amax = np.maximum(_host_f32(leaf), np.float32(1e-6))
        return key[: -len("_amax")] + "_ascale", \
            amax * np.float32(margin) / np.float32(127.0)

    return {"act_scales": _map_leaves(act_stats, convert)}


def merge_act_stats(a: dict | None, b: dict) -> dict:
    """Elementwise maximum of a host stats tree ``a`` (numpy f32 scalars;
    None for the first batch) and a tree ``b`` of 0-d device tensors as
    :func:`record_act_stats` yields it, brought to the host in one copy."""
    leaves: list[torch.Tensor] = []
    _map_leaves(b, lambda k, v: (k, leaves.append(v)))
    flat = iter(torch.stack(leaves).cpu().numpy()) if leaves else iter(())
    host = _map_leaves(b, lambda k, v: (k, np.float32(next(flat))))
    if a is None:
        return host

    def walk(x: dict, y: dict) -> dict:
        return {k: walk(x[k], y[k]) if isinstance(y[k], dict) else np.maximum(x[k], y[k])
                for k in y}

    return walk(a, host)


def calibrate_act_scales(
    model: CLIPModel,
    batches: Iterable[Sequence[Any]],
    method: str = "encode_image",
    margin: float = 1.0,
) -> dict:
    """Collect activation maxima over ``batches`` (tuples of positional
    arguments of ``model.<method>``) and return the ``{"act_scales": ...}``
    tree for a ``w8a8_static=True`` model. ``model`` must be built with
    ``w8a8=True`` (dynamic or static: the sites record either way).
    ``margin`` > 1 adds clipping headroom for data drift."""
    fn = getattr(model, method)
    stats = None
    for batch in batches:
        with torch.inference_mode(), record_act_stats(model) as batch_stats:
            fn(*batch)
        stats = merge_act_stats(stats, batch_stats)
    if stats is None:
        raise ValueError("calibrate_act_scales needs at least one batch")
    return act_stats_to_scales(stats, margin=margin)


def set_act_scales(model: CLIPModel, act_scales: dict) -> None:
    """Install the ``{tower: {... "<site>_ascale": scalar}}`` tree of the
    towers it names on ``model``'s W8A8 layers, each scale an f32 0-d
    tensor on the layer's device; a tower it does not name keeps its scales."""
    sites = act_sites(model)
    for tower, tree in act_scales.items():
        for path, dense in sites[tower].items():
            node = tree
            for part in path[:-1]:
                node = node[part]
            value = _host_f32(node[f"{path[-1]}_ascale"])
            dense.act_scale = torch.tensor(value, dtype=torch.float32,
                                           device=dense.weight.device)
