"""Few-shot / zero-shot calibration (paper §4.2, eq. 23), port of
``repro/core/calibrate.py``.

Per linear layer k we need three Frobenius norms:

    alpha_k = (1/sqrt(d_k)) * ||df/dH^(k)||_F * ||X^(k)||_F * ||W^(k)||_F

``df/dH`` is the gradient of the loss with respect to a zero perturbation
added to each linear's output (``models.common.LinearCtx``), taken with
``torch.autograd.grad``; ||X|| and the per-input-dim column energies (for
the outlier trick) come from the same pass's taps.  One forward and one
backward per batch: the reference's two passes are an artifact of tracing.
The parameters must not require grad — at full width their gradients
would be another copy of the model — so only the perturbations do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.models.common import LinearCtx

# The paper's zero-shot sentence (§4.2), repeated 100x.
ZERO_SHOT_SENTENCE = ("The curious fox leaped over the quiet stream, its "
                      "reflection rippling in the golden afternoon light. ")


@dataclasses.dataclass
class LayerStat:
    name: str
    d: int
    c: int
    m: int                    # parameter count (grouped: E*d*c)
    alpha: float              # eq. 23 sensitivity
    x_col_sq: np.ndarray      # (d,) accumulated input column energy
    grouped: bool = False
    n_groups: int = 1


def zero_shot_tokens(vocab: int, seq_len: int, repeats: int = 100) -> np.ndarray:
    """Byte-tokenized synthetic sentence (valid for any vocab >= 256)."""
    raw = (ZERO_SHOT_SENTENCE * repeats).encode("utf-8")
    toks = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
    if vocab < 256:
        toks = toks % vocab
    reps = -(-(seq_len + 1) // len(toks))
    return np.tile(toks, reps)[: seq_len + 1][None, :]


def calibrate(loss_with_ctx: Callable[[dict, dict, LinearCtx], torch.Tensor],
              params: dict, batches: list[dict]) -> dict[str, LayerStat]:
    """Estimate LayerStats over calibration batches.

    ``loss_with_ctx(params, batch, ctx)`` must route every linear through
    the ctx (``models.transformer.loss_fn`` does).  Batches hold tensors on
    the params' device, and reach the loss whole: mrope's ``positions``
    and Whisper's ``enc_embeds`` too, whose encoder taps are named
    ``enc{i}.*`` and whose cross-attention taps ``L{i}.xattn.*``."""
    stats: dict[str, dict] = {}
    for batch in batches:
        ctx = LinearCtx(perturb={}, collect=True)
        loss = loss_with_ctx(params, batch, ctx)
        names = list(ctx.perturb)
        grads = torch.autograd.grad(loss, [ctx.perturb[n] for n in names])
        for name, grad in zip(names, grads):
            tap = ctx.taps[name]
            g_fro = float(torch.linalg.norm(grad.to(torch.float32)))
            x_fro = math.sqrt(float(tap["x_fro_sq"]))
            w_fro = float(tap["w_fro"])
            d = int(tap["d"])
            alpha = g_fro * x_fro * w_fro / np.sqrt(d)
            s = stats.setdefault(name, dict(
                alpha_sum=0.0, n=0, x_col_sq=np.zeros((d,), np.float64),
                d=d, c=int(tap["c"]), grouped=bool(tap.get("grouped", False)),
                n_groups=int(tap.get("n_groups", 1))))
            s["alpha_sum"] += alpha
            s["n"] += 1
            s["x_col_sq"] += tap["x_col_sq"].cpu().numpy().astype(np.float64)
        del ctx, loss, grads
    out = {}
    for name, s in stats.items():
        out[name] = LayerStat(name=name, d=s["d"], c=s["c"],
                              m=s["d"] * s["c"] * s["n_groups"],
                              alpha=s["alpha_sum"] / max(s["n"], 1),
                              x_col_sq=s["x_col_sq"], grouped=s["grouped"],
                              n_groups=s["n_groups"])
    return out
