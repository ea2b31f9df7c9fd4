"""Apply a baseline PTQ method to a whole model (drop-in reconstructed
weights), mirroring ``core.pipeline.quantize_model``'s layer selection so
that average-bits accounting is comparable.

Port of ``repro/baselines/apply.py`` on the port's param layout
(``params["layers"]`` a list of per-layer dicts, layer i named ``L{i}.``,
which is the reference's ``idx * scan_period + jpos``).  Only the decoder
layers' 2-D projections are replaced, as in the reference: MoE expert
stacks, Whisper's ``enc_layers``, embeddings, norms and lm_head stay as
they are.
"""
from __future__ import annotations

import time

import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import _copy_dicts, _get, _set, _walk_layer
from repro_torch.models import transformer as tf
from repro_torch.models.common import LinearCtx
from repro_torch.models.config import ModelConfig

from .quant_baselines import awq_quantize, gptq_quantize, rtn_quantize

METHODS = ("rtn", "gptq", "awq")


def collect_hessians(cfg: ModelConfig, params: dict, batches,
                     device=None) -> tuple[dict, dict]:
    """(name -> layer Hessian X^T X summed over ``batches``, name -> input
    column norms sqrt(x_col_sq) of the last batch) for every named linear,
    from ``loss_fn`` forwards on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    ctx = LinearCtx(collect_hessian=True, collect=True)
    with torch.no_grad():
        for b in batches:
            tf.loss_fn(cfg, params, {k: torch.as_tensor(v).to(dev)
                                     for k, v in b.items()}, ctx=ctx)
    return (dict(ctx.hessians),
            {k: torch.sqrt(t["x_col_sq"]) for k, t in ctx.taps.items()})


def apply_baseline(cfg: ModelConfig, params: dict, method: str, bits: int,
                   hessians: dict | None = None,
                   x_col_norms: dict | None = None, group: int = 128,
                   device=None):
    """Returns (params with reconstructed weights, achieved avg bits,
    seconds).  GPTQ falls back to the identity Hessian and AWQ to unit
    norms for a weight missing from ``hessians`` / ``x_col_norms``.
    ``params`` is not modified; the result shares every leaf it does not
    replace."""
    if method not in METHODS:
        raise ValueError(method)
    dev = resolve_device(device)
    t0 = time.monotonic()
    out = dict(params)
    out["layers"] = [_copy_dicts(lp) for lp in params["layers"]]
    total_bits = 0
    total_m = 0
    for i, lp in enumerate(out["layers"]):
        for path, kind in _walk_layer(lp):
            if kind != "linear":
                continue          # baselines cover 2-D weights only
            name = f"L{i}." + ".".join(path)
            w = _get(lp, path)
            if method == "rtn":
                wq, ovh = rtn_quantize(w, bits, group, device=dev)
            elif method == "gptq":
                h = None if hessians is None else hessians.get(name)
                if h is None:
                    h = torch.eye(w.shape[0], dtype=torch.float64, device=dev)
                wq, ovh = gptq_quantize(w, h, bits, group, device=dev)
            else:
                n = None if x_col_norms is None else x_col_norms.get(name)
                if n is None:
                    n = torch.ones(w.shape[0], dtype=torch.float64)
                wq, ovh, _ = awq_quantize(w, n, bits, group, device=dev)
            _set(lp, path, wq)
            total_bits += bits * w.numel() + ovh
            total_m += w.numel()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, total_bits / max(total_m, 1), time.monotonic() - t0
