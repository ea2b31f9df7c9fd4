"""End-to-end RaanA pipeline (paper Alg. 1): calibrate -> AllocateBits ->
RaBitQ-H quantize -> deployable quantized params.

Port of ``repro/core/pipeline.py:quantize_model`` for attention decoders
and every other family of the registry: per-layer heterogeneous bit widths
from the DP allocator, the outlier and centralization tricks for 2-D
projections, ``quantize_grouped`` for the stacked MoE experts (wi, wo),
and the port's own param layout (``params["layers"]`` a list of per-layer
dicts, as ``bridge.py`` and the engine use).  Whisper's encoder is the
``enc`` scope (``params["enc_layers"]``): its weights come after every
decoder weight, named ``enc{i}.attn.wq``, ..., as the reference collects
them, and the decoder's cross-attention weights are ``L{i}.xattn.*``.
Embeddings, norms, the MoE router and lm_head stay in full precision.

The reference splits one ``jax.random`` key per quantized weight; the port
draws each weight's Rademacher signs with ``draw_signs(d_keep, generator)``
in the same entry order (a grouped weight: ``draw_signs(d)``, shared by its
experts), or takes them from ``signs`` (name -> (signs1, signs2)) — how
the parity tests pass the reference's signs in.

``quantize_model_dual`` quantizes the same weights twice from one
calibration, a target and a low-bit draft for self-speculative decoding.
The reference passes one PRNG key to both runs so the signs come out
equal; torch cannot replay a ``jax.random`` stream, so the port draws the
signs once (``draw_model_signs``) and passes the same dict to both.

``quantize_params_uniform`` gives every quantizable weight the same bit
width (no calibration, no outlier split; the paper's uniform RaanA rows
of Table 1).  The reference keeps its stacked scan layout for the
dry-run; the port has none and returns its per-layer lists.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig

from . import allocate as alloc
from .calibrate import LayerStat
from .qlinear import (QuantizedGrouped, QuantizedLinear, draw_signs,
                      quantize_grouped, quantize_linear)

# the uniform quantizer's grid-step candidates (the reference's
# ``_quantize_stacked_linear`` / ``_quantize_stacked_grouped``)
UNIFORM_N_CANDIDATES = 8
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


SCOPES = (("L", "layers"), ("enc", "enc_layers"))   # name prefix, params key


def _entries(params: dict) -> list:
    """(name, params key, layer index, path, kind, shape) of every
    quantizable weight, in the order the allocation and the signs take
    them: the decoder's layers, then the encoder's."""
    entries = []
    for scope, key in SCOPES:
        for i, lp in enumerate(params.get(key, ())):
            for path, kind in _walk_layer(lp):
                entries.append((f"{scope}{i}." + ".".join(path), key, i,
                                path, kind, tuple(_get(lp, path).shape)))
    return entries


def draw_model_signs(params: dict, stats: dict[str, LayerStat], *,
                     generator: torch.Generator,
                     outlier_frac: float = 0.003,
                     signs: dict | None = None) -> dict:
    """name -> (signs1, signs2) for every quantizable weight: taken from
    ``signs`` where it names the weight, else drawn from ``generator`` in
    entry order for the width the weight keeps after its outlier split."""
    out = {}
    for name, _, _, _, kind, shape in _entries(params):
        if signs is not None and name in signs:
            out[name] = signs[name]
            continue
        frac = (outlier_frac if kind == "linear" and stats.get(name)
                is not None else 0.0)
        d = shape[-2]
        k = int(np.ceil(frac * d)) if frac > 0 else 0
        out[name] = draw_signs(d - k, generator)
    return out


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

    entries = _entries(params)
    signs = draw_model_signs(params, stats, generator=generator,
                             outlier_frac=outlier_frac, signs=signs)

    ms, alphas, overheads = [], [], []
    for name, _, _, _, kind, shape in entries:
        m = int(np.prod(shape))
        st = stats.get(name)
        alphas.append(float(np.sqrt(m)) if st is None         # weight-only
                      else max(st.alpha, 1e-12))
        ms.append(m)
        overheads.append(_overhead_bits_estimate(kind, shape, outlier_frac,
                                                 centralize))
    total_m = int(sum(ms))
    budget = int(np.floor(avg_bits * total_m)) - int(sum(overheads))
    t_alloc = time.monotonic()
    allocation = alloc.allocate_bits(alphas, ms, budget, bit_choices)
    allocate_s = time.monotonic() - t_alloc

    qparams = dict(params)
    for _, key in SCOPES:
        if key in params:
            qparams[key] = [_copy_dicts(lp) for lp in params[key]]
    per_layer_bits: dict[str, int] = {}
    used_bits = 0
    overhead_used = 0
    t_quant = time.monotonic()
    for (name, key, i, path, kind, shape), bits in zip(entries,
                                                       allocation.bits):
        target = qparams[key][i]
        w = _get(target, path)
        st = stats.get(name)
        x_col = (np.sqrt(np.maximum(st.x_col_sq, 0.0))
                 if st is not None and kind == "linear" else None)
        frac = outlier_frac if x_col is not None else 0.0
        s1, s2 = signs[name]
        if kind == "grouped":
            q = quantize_grouped(w, bits, s1, s2, n_candidates=n_candidates,
                                 device=dev)
        else:
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


def _alias_rotation(tq: dict, dq: dict) -> dict:
    """``dq`` with every quantized weight's sign vectors replaced by the
    same tensors of ``tq`` (equal in value already): the rotation is held
    once, and the sharing can be checked by identity."""
    def share(t, d):
        if isinstance(d, (QuantizedLinear, QuantizedGrouped)):
            return dataclasses.replace(d, signs1=t.signs1, signs2=t.signs2)
        if isinstance(d, dict):
            return {k: share(t[k], v) for k, v in d.items()}
        return d
    out = dict(dq)
    for _, key in SCOPES:
        if key in dq:
            out[key] = [share(t, d) for t, d in zip(tq[key], dq[key])]
    return out


def quantize_model_dual(cfg: ModelConfig, params: dict,
                        stats: dict[str, LayerStat], avg_bits: float,
                        draft_avg_bits: float, *,
                        generator: torch.Generator | None = None,
                        signs: dict | None = None,
                        outlier_frac: float = 0.003, device=None, **kwargs):
    """Self-speculative pair from one calibration: the same weights
    quantized at ``avg_bits`` (the target) and at ``draft_avg_bits`` (the
    draft).  Both runs take ``stats`` and one set of signs, drawn once, so
    every layer's rotation is the same and the draft's sign tensors are the
    target's; full-precision leaves (embedding, norms, routers, lm_head)
    are shared by reference, so the draft costs only its codes and side
    information.  AllocateBits runs once per budget.  Returns
    ``(target_params, target_report, draft_params, draft_report)`` for
    ``PagedServer(..., draft_params=, speculate=k)``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    signs = draw_model_signs(params, stats, generator=generator,
                             outlier_frac=outlier_frac, signs=signs)
    tparams, treport = quantize_model(cfg, params, stats, avg_bits,
                                      signs=signs, outlier_frac=outlier_frac,
                                      device=dev, **kwargs)
    dparams, dreport = quantize_model(cfg, params, stats, draft_avg_bits,
                                      signs=signs, outlier_frac=outlier_frac,
                                      device=dev, **kwargs)
    return tparams, treport, _alias_rotation(tparams, dparams), dreport


def quantize_params_uniform(cfg: ModelConfig, params: dict, bits: int, *,
                            signs: dict | None = None,
                            generator: torch.Generator | None = None,
                            device=None) -> dict:
    """Uniform-bit RaBitQ-H on ``device`` (CUDA unless ``"cpu"``): every 2-D
    projection of ``layers`` (and Whisper's ``enc_layers``) through
    ``quantize_linear`` with centralization and no outliers, every MoE
    ``wi`` / ``wo`` stack through ``quantize_grouped``, all at ``bits`` and
    UNIFORM_N_CANDIDATES grid steps.  Signs come from ``signs`` (name ->
    (signs1, signs2)) or are drawn from ``generator`` in entry order, as
    ``quantize_model`` draws them.  Port of the reference's function of the
    same name, which keeps the stacked scan layout for the dry-run; the
    port returns its per-layer lists.  ``params`` is not modified; the
    result shares its full-precision leaves."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    signs = draw_model_signs(params, {}, generator=generator,
                             outlier_frac=0.0, signs=signs)
    qparams = dict(params)
    for _, key in SCOPES:
        if key in params:
            qparams[key] = [_copy_dicts(lp) for lp in params[key]]
    for name, key, i, path, kind, _ in _entries(params):
        target = qparams[key][i]
        w = _get(target, path)
        s1, s2 = signs[name]
        if kind == "grouped":
            q = quantize_grouped(w, bits, s1, s2,
                                 n_candidates=UNIFORM_N_CANDIDATES, device=dev)
        else:
            q = quantize_linear(w, bits, s1, s2, x_col_norms=None,
                                outlier_frac=0.0, centralize=True,
                                n_candidates=UNIFORM_N_CANDIDATES, device=dev)
        _set(target, path, q)
    return qparams
