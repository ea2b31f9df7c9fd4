"""GSPMD-style sharding rules (port of ``repro/runtime/sharding.py``,
DESIGN.md §5), as the dry-run's yardstick of bytes per chip.

Axes: (pod?, data, model).  Batch shards over every data-parallel axis
("pod" + "data"); weights shard FSDP (ZeRO-3) over "data" and tensor-
parallel over "model" for training, over "model" only for serving; MoE
experts shard over "model" when it divides their count (expert
parallelism), else intra-expert TP; KV caches shard batch over dp and
sequence over "model".  Every rule goes through ``_fit``, which drops an
axis that does not divide its dimension, so rules degrade to replication.

A spec is a tuple with one entry per dimension: None, an axis name, or a
tuple of axis names, as a ``PartitionSpec``'s entries are.  ``mesh`` is
anything with ``axis_names`` and a ``shape`` mapping
(``launch/mesh.make_production_mesh``).

The reference's layer leaves are stacked (L_j, ...) for its scan, one
stack per scan position j; the port's ``layers`` is a list of per-layer
dicts.  So each rule runs on the stacked shape (n_j, *shape) that the
leaf would have in the reference, and its first entry is dropped: the
decisions that read the whole stack (the expert-parallel residue of
``_param_rule``) come out as the reference's.  Caches are per layer too
and are ruled the same way.  The port's serving runtime (``runtime/
tp.py``) shards by output column and replicates ``wo``; these rules are
what the reference's GSPMD program would hold per chip, and the dry-run
records both.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _entry(ax):
    """A spec entry as a ``PartitionSpec`` keeps it: one axis by its name,
    several as a tuple, none as None."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def _fit(spec: tuple, shape, mesh) -> tuple:
    """Drop spec entries that don't divide the corresponding dim."""
    out = []
    for i, dim in enumerate(shape):
        ax = _entry(spec[i]) if i < len(spec) else None
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return tuple(out)


# weight keys whose 2-D layout is (d_in, d_out) -> FSDP d_in, TP d_out
_COL_KEYS = {"wq", "wk", "wv", "wi", "swi", "wg", "wr", "ck", "cr",
             "wq_a", "wq_b", "wkv_a", "wkv_b", "embed"}
# (d_hidden, d_model) down-projections -> TP d_in, FSDP d_out
_ROW_KEYS = {"wo", "swo", "cv", "lm_head"}

# serve-mode EP weights also shard their inner dim over "data" when the
# per-chip residue after model-axis EP exceeds this (the reference's)
SERVE_EP_INNER_SHARD_LIMIT = 8 * 2 ** 30

_QUANT_REPLICATED = ("signs1", "signs2", "mean_col", "w_out", "out_idx",
                     "keep_idx")


def _param_rule(key: str, shape, mesh, names, serve: bool) -> tuple:
    fsdp = None if serve else "data"
    nd = len(shape)
    if "moe" in names and key in ("wi", "wo") and nd in (3, 4):
        # stacked (L, E, a, b) expert weights
        lead = (None,) * (nd - 3)
        e = shape[nd - 3]
        if e % mesh.shape["model"] == 0:
            per_chip = 2 * np.prod(shape) / mesh.shape["model"]
            inner = ("data" if not serve
                     or per_chip > SERVE_EP_INNER_SHARD_LIMIT else None)
            return _fit((*lead, "model", None, inner), shape, mesh)
        return _fit((*lead, None, "data" if not serve else None, "model"),
                    shape, mesh)
    if key == "router":
        return (None,) * nd
    if key in _COL_KEYS and nd >= 2:
        return _fit(((None,) * (nd - 2)) + (fsdp, "model"), shape, mesh)
    if key in _ROW_KEYS and nd >= 2:
        return _fit(((None,) * (nd - 2)) + ("model", fsdp), shape, mesh)
    return (None,) * nd  # norms, biases, LoRAs, convs: replicated


def _leaf_rule(names: list, shape, mesh, serve: bool) -> tuple:
    """The reference's ``param_specs`` rule for a leaf at path ``names``
    of (stacked) shape ``shape``."""
    key = names[-1] if names else ""
    nd = len(shape)
    if "packed" in names or "rescale" in names:
        if nd >= 2:
            if names[-1] == "rescale":
                return _fit(((None,) * (nd - 1)) + ("model",), shape, mesh)
            return _fit(((None,) * (nd - 2)) + (None, "model"), shape, mesh)
        return (None,) * nd
    if any(n in _QUANT_REPLICATED for n in names):
        return (None,) * nd
    return _param_rule(key, shape, mesh, names, serve)


def _walk(node, names: list, fn):
    """``node``'s tree with each tensor replaced by ``fn(names, tensor)``:
    dicts and lists keep their layout, a dataclass (a quantized weight, a
    cache) becomes a dict of its tensor fields, anything else None.  List
    positions add "" to the path, as the reference's sequence keys name
    nothing."""
    if isinstance(node, torch.Tensor):
        return fn(names, node)
    if isinstance(node, dict):
        return {k: _walk(v, names + [str(k)], fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, names + [""], fn) for v in node]
    if dataclasses.is_dataclass(node):
        return {f.name: _walk(getattr(node, f.name), names + [f.name], fn)
                for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name), torch.Tensor)}
    return None


_LAYER_KEYS = ("layers", "enc_layers")


def _stack_size(n_layers: int, i: int, period: int) -> int:
    """Layers at layer i's scan position: the reference's stack length."""
    return len(range(i % period, n_layers, period))


def param_specs(params: dict, mesh, serve: bool = False, *,
                period: int = 1) -> dict:
    """Spec tree for a (possibly quantized) port param tree.  ``period``
    is the config's ``scan_period`` (the reference stacks ``layers`` by
    scan position; Whisper's ``enc_layers`` is one stack)."""
    def rule(names, t):
        return _leaf_rule(names, tuple(t.shape), mesh, serve)

    out = {}
    for key, node in params.items():
        if key in _LAYER_KEYS and isinstance(node, list):
            p = period if key == "layers" else 1
            layers = []
            for i, lp in enumerate(node):
                n_j = _stack_size(len(node), i, p)
                layers.append(_walk(lp, [key, ""], lambda names, t, n_j=n_j:
                                    _leaf_rule(names, (n_j, *t.shape), mesh,
                                               serve)[1:]))
            out[key] = layers
        else:
            out[key] = _walk(node, [key], rule)
    return out


def batch_specs(batch: dict, mesh) -> dict:
    dp = dp_axes(mesh)

    def rule(names, t):
        key = names[-1]
        shape = tuple(t.shape)
        if key == "positions" and len(shape) == 3:      # (3, B, S)
            return _fit((None, dp, None), shape, mesh)
        if key == "pos" or len(shape) == 0:
            return ()
        return _fit((dp,) + (None,) * (len(shape) - 1), shape, mesh)
    return {k: _walk(v, [k], rule) for k, v in batch.items()}


def _cache_rule(shape, mesh) -> tuple:
    """The reference's rule on a stacked (n_j, B, S?, ...) cache leaf."""
    nd = len(shape)
    if nd <= 1:
        return (None,) * nd
    spec = [None, dp_axes(mesh)] + [None] * (nd - 2)
    if nd >= 4:
        spec[2] = "model"                 # sequence / capacity axis
    return _fit(tuple(spec), shape, mesh)


def cache_specs(caches: list, mesh) -> list:
    """Per-layer cache specs: batch over dp, the sequence (or capacity)
    axis over model, ruled on the reference's stacked shape."""
    return _walk(caches, [], lambda names, t: _cache_rule(
        (1, *t.shape), mesh)[1:])


def replicate_specs(tree: Any):
    return _walk(tree, [], lambda names, t: (None,) * t.ndim)


def shard_factor(spec: tuple, mesh) -> int:
    """How many ways a leaf with ``spec`` is split across the mesh."""
    return int(np.prod([_axis_size(mesh, ax) for ax in spec]))


def bytes_per_chip(tree, specs, mesh) -> int:
    """Bytes of ``tree``'s tensors one chip holds under ``specs`` (a spec
    tree from the rules above, the same layout)."""
    total = 0

    def add(node, spec):
        nonlocal total
        if isinstance(node, torch.Tensor):
            total += (node.numel() * node.element_size()
                      // shard_factor(spec, mesh))
        elif isinstance(node, dict):
            for k, v in node.items():
                add(v, spec[k])
        elif isinstance(node, (list, tuple)):
            for v, s in zip(node, spec):
                add(v, s)
        elif dataclasses.is_dataclass(node):
            for k, s in spec.items():
                add(getattr(node, k), s)
    add(tree, specs)
    return total
