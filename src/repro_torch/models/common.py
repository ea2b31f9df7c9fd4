"""Shared building blocks: the linear chokepoint, norms, RoPE, loss, init.

Port of the parts of ``repro/models/common.py`` the attention-decoder path
uses.  Every weight multiplication goes through ``linear``, which dispatches
on ``QuantizedLinear`` (the fused RHT + dequant GEMM) or multiplies a plain
(d, c) tensor, so that RaanA calibration can tap per-layer statistics and
inject output perturbations through a ``LinearCtx``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qlinear import QuantizedLinear


class LinearCtx:
    """Calibration collector (port of ``repro/models/common.py:LinearCtx``,
    without the GPTQ baseline's ``collect_hessian``).

    ``collect`` records per-linear taps in ``taps``.  ``perturb`` maps a
    linear's name to an additive perturbation of its output; when
    ``collect`` is on as well, a linear missing from ``perturb`` gets a zero
    perturbation that requires grad, so one forward and backward yields the
    taps and d loss / d output (``core/calibrate.py``)."""

    def __init__(self, perturb: dict | None = None, collect: bool = False):
        self.perturb = perturb
        self.collect = collect
        self.taps: dict[str, dict] = {}


def linear(w, x: torch.Tensor, ctx: Optional[LinearCtx] = None,
           name: str | None = None) -> torch.Tensor:
    """y = x @ w for w either a raw (d, c) tensor or a QuantizedLinear."""
    if isinstance(w, QuantizedLinear):
        return w.apply(x)
    y = x @ w.to(x.dtype)
    if ctx is not None and name is not None:
        if ctx.collect:
            with torch.no_grad():
                xf = x.detach().to(torch.float32)
                sq = xf * xf
                ctx.taps[name] = dict(
                    x_fro_sq=torch.sum(sq),
                    x_col_sq=torch.sum(sq.reshape(-1, x.shape[-1]), dim=0),
                    w_fro=torch.linalg.norm(w.to(torch.float32)),
                    n_rows=float(x.numel() // x.shape[-1]),
                    d=int(w.shape[0]), c=int(w.shape[1]),
                    h_shape=tuple(y.shape))
            if ctx.perturb is not None and name not in ctx.perturb:
                ctx.perturb[name] = torch.zeros(
                    y.shape, dtype=torch.float32, device=y.device,
                    requires_grad=True)
        if ctx.perturb is not None and name in ctx.perturb:
            y = y + ctx.perturb[name].to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_params(kind: str, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) -> rotated x (half-split convention)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                           # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv              # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, device,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL; logits (..., V) computed in f32 for stability."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
