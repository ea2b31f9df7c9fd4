"""Carry the reference's parameters into the port.

Input contract: plain containers of numpy arrays (dicts, lists, ``None``),
so this module needs nothing of the JAX package.  Two tree shapes are
accepted under ``params["layers"]`` (one entry per scan position; the
attention decoders ported so far have a scan period of 1):

  * the stacked fp tree of ``repro/models/decode.py:80-91`` — one dict whose
    arrays carry a leading layer axis;
  * the unrolled per-layer list that ``repro/core/pipeline.py:quantize_model``
    builds, where each quantized weight is a dict with the keys
    ``packed, rescale, signs1, signs2, mean_col, w_out, out_idx, keep_idx``
    (arrays or None) and ``bits, d, d_keep, c`` (ints) — the leaves and
    static fields of ``repro.core.qlinear.QuantizedLinear`` — and each
    quantized MoE expert stack a dict with ``packed, rescale, signs1,
    signs2`` and ``bits, d, c``, those of ``QuantizedGrouped``.

A MoE layer's fp ``moe`` subtree (router (d, E), wi (E, d, 2f), wo (E, f,
d), each with the leading layer axis in the stacked tree) carries across
like any other subtree.

The caller flattens a JAX tree into that form (``numpy.asarray`` on every
array, a dict per ``QuantizedLinear``); the result is the port's param
dict with ``layers`` as a list of per-layer dicts on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qlinear import QuantizedGrouped, QuantizedLinear

QL_TENSORS = ("packed", "rescale", "signs1", "signs2", "mean_col", "w_out",
              "out_idx", "keep_idx")
QL_STATIC = ("bits", "d", "d_keep", "c")
QG_TENSORS = ("packed", "rescale", "signs1", "signs2")
QG_STATIC = ("bits", "d", "c")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _quantized(node: dict, device) -> QuantizedLinear:
    fields = {}
    for k in QL_TENSORS:
        v = node[k]
        if v is None:
            fields[k] = None
        elif k in ("out_idx", "keep_idx"):
            fields[k] = _tensor(np.asarray(v, np.int64), device)
        else:
            fields[k] = _tensor(v, device)
    for k in QL_STATIC:
        fields[k] = int(node[k])
    return QuantizedLinear(**fields)


def _grouped(node: dict, device) -> QuantizedGrouped:
    fields = {k: None if node[k] is None else _tensor(node[k], device)
              for k in QG_TENSORS}
    fields.update({k: int(node[k]) for k in QG_STATIC})
    return QuantizedGrouped(**fields)


def _convert(node, device):
    if node is None:
        return None
    if isinstance(node, dict):
        if "packed" in node and "bits" in node:
            if "d_keep" in node:
                return _quantized(node, device)
            return _grouped(node, device)
        return {k: _convert(v, device) for k, v in node.items()}
    return _tensor(node, device)


def _take(node, i: int):
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _n_stacked(node) -> int:
    if isinstance(node, dict):
        return _n_stacked(next(iter(node.values())))
    return int(np.asarray(node).shape[0])


def params_from_reference(tree: dict, device=None) -> dict:
    """The port's params from a reference param tree of numpy containers,
    on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    if len(tree["layers"]) != 1:
        raise NotImplementedError("scan periods > 1 (mixed mixer patterns) "
                                  "are not ported yet")
    stack = tree["layers"][0]
    per_layer = (list(stack) if isinstance(stack, list)
                 else [_take(stack, i) for i in range(_n_stacked(stack))])
    return {"embed": _convert(tree["embed"], dev),
            "layers": [_convert(lp, dev) for lp in per_layer],
            "final_norm": _convert(tree["final_norm"], dev),
            "lm_head": _convert(tree["lm_head"], dev)}
