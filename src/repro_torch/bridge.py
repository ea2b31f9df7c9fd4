"""Carry the reference's parameters into the port.

Input contract: plain containers of numpy arrays (dicts, lists, ``None``),
so this module needs nothing of the JAX package.  ``params["layers"]``
holds one entry per scan position j < p (p = ``cfg.scan_period``: 1 for a
homogeneous stack, 3 for recurrentgemma's (rglru, rglru, attn)), in one of
two shapes:

  * the stacked fp tree of ``repro/models/transformer.py:init_params`` —
    a dict whose arrays carry a leading axis over the layers i with
    i % p == j;
  * the unrolled per-position lists that ``repro/core/pipeline.py:
    quantize_model`` builds, where each quantized weight is a dict with
    the keys
    ``packed, rescale, signs1, signs2, mean_col, w_out, out_idx, keep_idx``
    (arrays or None) and ``bits, d, d_keep, c`` (ints) — the leaves and
    static fields of ``repro.core.qlinear.QuantizedLinear`` — and each
    quantized MoE expert stack a dict with ``packed, rescale, signs1,
    signs2`` and ``bits, d, c``, those of ``QuantizedGrouped``.

A stacked tree may hold quantized weights too, as the reference's
``quantize_params_uniform`` makes them: such a dict's arrays carry the
leading layer axis and its static fields (``bits, d, d_keep, c``) do not.

Layer i is element i // p of position i % p, so the port's list is in
execution order, as the reference's ``get_layer`` and ``_apply_layers``
walk it (full periods, then the remainder).  Whisper's ``enc_layers``
holds one such entry (a stack of the encoder's layers, or the list that
``quantize_model`` unrolls it into) and ``enc_norm`` a norm's dict.
Every other subtree (a MoE layer's router and shared experts, MLA's
norms and ``wkv_b``, RWKV's ``tm`` / ``cm`` vectors and LoRAs, RG-LRU's
block-diagonal ``wa`` / ``wx`` and conv filter, a Whisper decoder layer's
``ln_x`` / ``xattn``) carries across leaf by leaf.

The caller flattens a JAX tree into that form (``numpy.asarray`` on every
array, a dict per ``QuantizedLinear``); the result is the port's param
dict with ``layers`` as a list of per-layer dicts on ``device``.

``draft_from_reference`` carries the draft of the reference's
``quantize_model_dual`` pair across beside its converted target, with the
sharing the dual quantization promises: the draft's sign tensors are the
target's (``pipeline._alias_rotation``) and its full-precision leaves are
the target's tensors.  ``reference_signs`` reads every quantized weight's
Rademacher signs out of a reference tree, under the port's names
(``L{i}.attn.wq``, ``enc{i}.mlp.wi``), for the port's quantizers'
``signs``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import SCOPES, _alias_rotation
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


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and "packed" in node and "bits" in node


def _convert(node, device):
    if node is None:
        return None
    if isinstance(node, dict):
        if _is_quantized(node):
            if "d_keep" in node:
                return _quantized(node, device)
            return _grouped(node, device)
        return {k: _convert(v, device) for k, v in node.items()}
    return _tensor(node, device)


def _take(node, i: int):
    if _is_quantized(node):         # static fields carry no layer axis
        return {k: v if v is None or k in QL_STATIC else np.asarray(v)[i]
                for k, v in node.items()}
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _n_stacked(node) -> int:
    if _is_quantized(node):
        return _n_stacked(node["packed"])
    if isinstance(node, dict):
        return _n_stacked(next(iter(node.values())))
    return int(np.asarray(node).shape[0])


def _layer_trees(positions: list) -> list:
    """Per-layer trees of numpy containers in execution order from the
    reference's per-scan-position stacks (or lists)."""
    stacks = [list(st) if isinstance(st, list)
              else [_take(st, i) for i in range(_n_stacked(st))]
              for st in positions]
    period = len(stacks)
    n_layers = sum(len(st) for st in stacks)
    return [stacks[i % period][i // period] for i in range(n_layers)]


def _unrolled(positions: list, device) -> list:
    """Per-layer dicts of the port in execution order."""
    return [_convert(lp, device) for lp in _layer_trees(positions)]


def params_from_reference(tree: dict, device=None) -> dict:
    """The port's params from a reference param tree of numpy containers,
    on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = {"embed": _convert(tree["embed"], dev),
           "layers": _unrolled(tree["layers"], dev),
           "final_norm": _convert(tree["final_norm"], dev),
           "lm_head": _convert(tree["lm_head"], dev)}
    if "enc_layers" in tree:
        out["enc_layers"] = _unrolled(tree["enc_layers"], dev)
        out["enc_norm"] = _convert(tree["enc_norm"], dev)
    return out


def _quantized_nodes(node, prefix=()):
    """(path, dict) of every quantized weight in one layer's tree."""
    if _is_quantized(node):
        yield prefix, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _quantized_nodes(v, prefix + (k,))


def reference_signs(tree: dict) -> dict:
    """name -> (signs1, signs2 or None), CPU f32 tensors, of every quantized
    weight in a reference tree (unrolled lists or stacks), under the port's
    names: the ``signs`` that give the port's quantizers the reference's
    rotations."""
    out = {}
    for scope, key in SCOPES:
        for i, lp in enumerate(_layer_trees(tree.get(key, []))):
            for path, node in _quantized_nodes(lp):
                s2 = node["signs2"]
                out[f"{scope}{i}." + ".".join(path)] = (
                    _tensor(node["signs1"], "cpu"),
                    None if s2 is None else _tensor(s2, "cpu"))
    return out


def _share_leaves(t, d):
    """``d`` with each full-precision tensor replaced by ``t``'s, which must
    hold the same values; quantized weights are kept."""
    if isinstance(d, dict):
        return {k: _share_leaves(t[k], v) for k, v in d.items()}
    if isinstance(d, list):
        return [_share_leaves(a, b) for a, b in zip(t, d)]
    if isinstance(d, torch.Tensor):
        if not torch.equal(t, d):
            raise ValueError("the draft's full-precision leaves differ from "
                             "the target's: not a dual quantization pair")
        return t
    return d


def draft_from_reference(target: dict, draft_tree: dict, device=None) -> dict:
    """The port's draft params from the draft half of a reference
    ``quantize_model_dual`` pair, beside ``target`` (the port's conversion
    of the target half): full-precision leaves shared with ``target``, and
    every quantized weight's signs aliased to the target's tensors."""
    draft = _share_leaves(target, params_from_reference(draft_tree, device))
    for tq, dq in _quantized_pairs(target, draft):
        if not (torch.equal(tq.signs1, dq.signs1)
                and (tq.signs2 is None) == (dq.signs2 is None)
                and (tq.signs2 is None
                     or torch.equal(tq.signs2, dq.signs2))):
            raise ValueError("the draft's rotation differs from the "
                             "target's: not a dual quantization pair")
    return _alias_rotation(target, draft)


def _quantized_pairs(t, d):
    if isinstance(d, (QuantizedLinear, QuantizedGrouped)):
        yield t, d
    elif isinstance(d, dict):
        for k, v in d.items():
            yield from _quantized_pairs(t[k], v)
    elif isinstance(d, list):
        for a, b in zip(t, d):
            yield from _quantized_pairs(a, b)
