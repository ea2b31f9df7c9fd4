"""Gradient compression (port of ``repro/runtime/compression.py``).

  * ``compress_decompress_grads`` -- int8 symmetric quantization of the
    gradients inside the train step, one scale per tensor: ``max(|g|max,
    1e-12) / 127``, round half to even (``torch.round``, as ``jnp.round``),
    clip at +-127; leaves that are not floating point pass through.  It
    models the quality impact of an int8 all-reduce, which is what
    convergence tests need;
  * ``ErrorFeedback`` -- residual accumulation, so each step's quantization
    error is re-injected into the next (EF-SGD style);
  * ``int8_psum`` -- an all-reduce of int8-quantized payloads over a
    ``torch.distributed`` group, the wire format the first item models.

"One scale per tensor" means per tensor of the reference's layout, which
stacks the decoder layers: its ``layers[0]["attn"]["wq"]`` is one (L, d, c)
tensor, so a weight's copies in all L layers share one scale, and so does
Whisper's encoder stack (``enc_layers[0]``).  The port's layers are lists
of per-layer trees, so under a ``"layers"`` or ``"enc_layers"`` list a
leaf is quantized with the scale of it and its counterparts in the list's
other layers (the max over all of them): the same codes as the
reference's.  Every other leaf has its own scale.

Under model-parallel training the gradients are a rank's ZeRO shards of
its tensor-parallel slices; ``compress_decompress_grads(amax_total=)``
takes each group's largest |g| over every rank that holds a part of it (an
all-reduce MAX, ``runtime/sharding.TrainLayout.amax_total``), so every
element's code is one device's.

``int8_psum`` is the reference's (``repro/runtime/compression.py:61``),
with a process group in place of a mesh axis name: each rank quantizes its
tensor, the ranks agree on the largest scale (an all-reduce MAX), every
rank re-quantizes against that shared scale so the integer sum is
coherent, the codes are summed in int32 (an all-reduce SUM) and rescaled.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import flatten, tree_map, unflatten

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _is_float(g) -> bool:
    return isinstance(g, torch.Tensor) and g.dtype in _FLOATS


def _scale(gs: list[torch.Tensor]) -> torch.Tensor:
    """The int8 scale shared by the f32 tensors ``gs``."""
    a = torch.stack([torch.max(torch.abs(g)) for g in gs]).max()
    return torch.clamp(a, min=1e-12) / 127.0


def _roundtrip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g quantized to int8 codes with ``scale`` and dequantized (f32)."""
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


STACKED = ("layers", "enc_layers")   # the reference's stacked layer lists


def _map_layers(fn: Callable[[list], list], layers: list) -> list:
    """``fn`` over each leaf's copies in all ``layers`` together."""
    flats = [flatten(lp) for lp in layers]
    if any(td != flats[0][1] for _, td in flats):
        raise ValueError("layers of different structure")
    cols = [fn([leaf[j] for leaf, _ in flats])
            for j in range(len(flats[0][0]))]
    return [unflatten(td, [col[i] for col in cols])
            for i, (_, td) in enumerate(flats)]


def _map_groups(fn: Callable[[list], list], tree_):
    """``fn`` over the groups of leaves that share a scale (a list in, a
    list of the same length out) -> a tree of ``tree_``'s structure."""
    if not isinstance(tree_, dict):
        return tree_map(lambda g: fn([g])[0], tree_)
    return {k: (_map_layers(fn, v) if k in STACKED and isinstance(v, list)
                and v else _map_groups(fn, v)) for k, v in tree_.items()}


def _int8_group(gs: list, amax: torch.Tensor | None = None) -> list:
    """A group of leaves through int8 with one shared scale (f32 out); a
    group that is not floating point passes through.  ``amax``: the
    group's largest |g| (default: over ``gs``)."""
    if not all(_is_float(g) for g in gs):
        return gs
    gf = [g.to(torch.float32) for g in gs]
    scale = (_scale(gf) if amax is None
             else torch.clamp(amax, min=1e-12) / 127.0)
    return [_roundtrip(x, scale) for x in gf]


def compress_decompress_grads(grads, amax_total: Callable | None = None):
    """``grads`` through int8, one scale per group.  ``amax_total(amax)``
    takes the groups' local largest |g| (1-D, in the groups' order) to
    their global ones (a mesh's shards); without it each group's scale is
    its own."""
    if amax_total is None:
        deq = _map_groups(_int8_group, grads)
    else:
        local = []

        def collect(gs):
            if all(_is_float(g) for g in gs):
                local.append(torch.stack([torch.max(torch.abs(
                    g.to(torch.float32))) for g in gs]).max())
            return gs
        _map_groups(collect, grads)
        amax = iter(amax_total(torch.stack(local)) if local else [])
        deq = _map_groups(lambda gs: _int8_group(
            gs, next(amax) if all(_is_float(g) for g in gs) else None),
            grads)
    return tree_map(lambda d, g: d.to(g.dtype) if _is_float(g) else g,
                    deq, grads)


def int8_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks (a ``torch.distributed`` process
    group; None: the default group) of every rank's ``x``, each sent as
    int8 codes against the ranks' largest scale; f32 out.  Unbiased up to
    the shared-scale rounding, as the reference's."""
    import torch.distributed as dist
    xf = x.to(torch.float32)
    scale = _scale([xf])
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(torch.float32) * scale


class ErrorFeedback:
    """Stateful error feedback: a tree of f32 residuals beside the
    gradients, on their devices."""

    def __init__(self, params_like):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_like)

    def apply(self, grads):
        gf = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                      self.residual)
        deq = _map_groups(_int8_group, gf)
        self.residual = tree_map(lambda x, d: x - d, gf, deq)
        return tree_map(lambda d, g: d.to(g.dtype), deq, grads)
