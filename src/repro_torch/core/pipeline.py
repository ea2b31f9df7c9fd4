"""End-to-end RaanA pipeline (paper Alg. 1): calibrate -> AllocateBits ->
RaBitQ-H quantize -> deployable quantized params.

Port of ``repro/core/pipeline.py:quantize_model`` for dense attention
decoders: per-layer heterogeneous bit widths from the DP allocator, the
outlier and centralization tricks, and the port's own param layout
(``params["layers"]`` a list of per-layer dicts, as ``bridge.py`` and the
engine use).  Embeddings, norms and lm_head stay in full precision.

The reference splits one ``jax.random`` key per quantized weight; the port
draws each weight's Rademacher signs with ``draw_signs(d_keep, generator)``
in the same entry order, or takes them from ``signs`` (name -> (signs1,
signs2)) — how the parity tests pass the reference's signs in.

Not ported yet: ``quantize_model_dual`` (speculation, ROADMAP Queue 1 item
10), ``quantize_params_uniform`` (dry-run tooling, item 15) and grouped MoE
weights (item 9).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig

from . import allocate as alloc
from .calibrate import LayerStat
from .qlinear import draw_signs, quantize_linear

QUANTIZABLE_2D = {"wq", "wk", "wv", "wo", "wi", "swi", "swo", "ck", "cv",
                  "cr", "wr", "wg", "wq_a", "wq_b", "wkv_a"}
GROUPED_KEYS = {"wi", "wo"}


def _walk_layer(lp: dict, prefix: tuple = ()):
    """Yield (path, kind) for quantizable leaves of ONE layer's param dict.

    Keys are walked in sorted order: the reference's layer dicts come out of
    ``jax.tree.map`` with sorted keys, and the entry order decides the DP's
    tie-breaks and the order the signs are drawn in."""
    for k in sorted(lp):
        v = lp[k]
        path = prefix + (k,)
        if isinstance(v, dict):
            yield from _walk_layer(v, path)
        elif isinstance(v, torch.Tensor):
            if (len(path) >= 2 and path[-2] == "moe" and k in GROUPED_KEYS
                    and v.ndim == 3):
                yield path, "grouped"
            elif k in QUANTIZABLE_2D and v.ndim == 2 and min(v.shape) >= 8:
                yield path, "linear"


def _get(d: dict, path):
    for k in path:
        d = d[k]
    return d


def _set(d: dict, path, val):
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = val


def _copy_dicts(node):
    """The nested dicts of one layer copied, their tensors shared."""
    if isinstance(node, dict):
        return {k: _copy_dicts(v) for k, v in node.items()}
    return node


@dataclass
class QuantReport:
    per_layer_bits: dict[str, int]
    avg_bits: float
    requested_avg_bits: float
    total_param_bits: int
    overhead_bits: int
    objective: float
    wall_time_s: float
    n_layers: int
    allocate_s: float = 0.0   # AllocateBits DP (host numpy)
    quantize_s: float = 0.0   # RHT + code search + packing, all weights


def _overhead_bits_estimate(kind: str, shape, outlier_frac: float,
                            centralize: bool) -> int:
    """Side-info bits: rescale + signs + mean col + outlier rows/indices."""
    if kind == "grouped":
        e, d, c = shape
        return 16 * e * c + 2 * d
    d, c = shape
    k = int(np.ceil(outlier_frac * d)) if outlier_frac > 0 else 0
    bits = 16 * c + 2 * d                    # rescale + signs (both blocks)
    if centralize:
        bits += 16 * d
    bits += k * (16 * c + 32)
    return bits


def quantize_model(cfg: ModelConfig, params: dict,
                   stats: dict[str, LayerStat], avg_bits: float, *,
                   generator: torch.Generator | None = None,
                   signs: dict | None = None,
                   bit_choices=(1, 2, 3, 4, 5, 6, 7, 8),
                   outlier_frac: float = 0.003, centralize: bool = True,
                   n_candidates: int = 12, device=None):
    """Full RaanA on ``device`` (CUDA unless ``"cpu"``): returns (quantized
    params, QuantReport).  ``params`` is not modified; the result shares its
    full-precision leaves."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    entries = []  # (name, layer index, path, shape)
    for i, lp in enumerate(params["layers"]):
        for path, kind in _walk_layer(lp):
            if kind == "grouped":
                raise NotImplementedError(
                    "grouped (MoE) weights are not ported yet (ROADMAP "
                    "Queue 1 item 9)")
            name = f"L{i}." + ".".join(path)
            entries.append((name, i, path, tuple(_get(lp, path).shape)))

    ms, alphas, overheads = [], [], []
    for name, _, _, shape in entries:
        m = int(np.prod(shape))
        st = stats.get(name)
        alphas.append(float(np.sqrt(m)) if st is None         # weight-only
                      else max(st.alpha, 1e-12))
        ms.append(m)
        overheads.append(_overhead_bits_estimate("linear", shape,
                                                 outlier_frac, centralize))
    total_m = int(sum(ms))
    budget = int(np.floor(avg_bits * total_m)) - int(sum(overheads))
    t_alloc = time.monotonic()
    allocation = alloc.allocate_bits(alphas, ms, budget, bit_choices)
    allocate_s = time.monotonic() - t_alloc

    qparams = dict(params)
    qparams["layers"] = [_copy_dicts(lp) for lp in params["layers"]]
    per_layer_bits: dict[str, int] = {}
    used_bits = 0
    overhead_used = 0
    t_quant = time.monotonic()
    for (name, i, path, shape), bits in zip(entries, allocation.bits):
        target = qparams["layers"][i]
        w = _get(target, path)
        st = stats.get(name)
        x_col = (np.sqrt(np.maximum(st.x_col_sq, 0.0))
                 if st is not None else None)
        frac = outlier_frac if x_col is not None else 0.0
        if signs is not None and name in signs:
            s1, s2 = signs[name]
        else:
            d = shape[0]
            k = int(np.ceil(frac * d)) if frac > 0 else 0
            s1, s2 = draw_signs(d - k, generator)
        q = quantize_linear(w, bits, s1, s2, x_col_norms=x_col,
                            outlier_frac=frac, centralize=centralize,
                            n_candidates=n_candidates, device=dev)
        _set(target, path, q)             # the copy no longer holds w
        del w
        overhead_used += q.overhead_bits()
        per_layer_bits[name] = bits
        used_bits += bits * int(np.prod(shape))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    quantize_s = time.monotonic() - t_quant

    report = QuantReport(
        per_layer_bits=per_layer_bits,
        avg_bits=(used_bits + overhead_used) / total_m,
        requested_avg_bits=avg_bits,
        total_param_bits=used_bits,
        overhead_bits=overhead_used,
        objective=allocation.objective,
        wall_time_s=time.monotonic() - t0,
        n_layers=len(entries),
        allocate_s=allocate_s,
        quantize_s=quantize_s)
    return qparams, report
