"""Extended (multi-bit) RaBitQ quantization, sans rotation (paper §5, App. A.2).

Port of ``repro/core/rabitq.py``.  Columns of an already-rotated matrix are
quantized to b-bit unsigned codes with a per-column rescale so that

    <x, w>  ~=  r * <x, (codes - c_b * 1)>,      c_b = (2^b - 1) / 2.

The grid step is chosen per column from a fixed geometric sweep of
``n_candidates`` steps (argmin of the LS-rescaled residual), then the
closed-form rescale r = <w,v>/<v,v> is applied.

The candidate scales are ``numpy.geomspace`` in float64 rounded to f32; the
reference computes them in f32 and lands within one ulp, so codes agree
except at round-half ties (the same off-by-one the reference's own kernel
test tolerates).

Every division here divides by a tensor: PyTorch on CUDA multiplies by the
reciprocal when the divisor is a Python scalar, which moves delta0 by an
ulp against the CPU and against the CUDA kernel
(``csrc/rabitq_quant.cu``), which divides as IEEE does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["RabitqCodes", "quantize", "dequantize", "estimate_matmul",
           "candidate_scales", "C_ERROR"]

# Empirical constant of the RaBitQ error bound (paper eq. 11), P >= 99.9%
C_ERROR = 5.75


class RabitqCodes(NamedTuple):
    """Quantized representation of a (d, c) matrix of column vectors."""
    codes: torch.Tensor    # (d, c) uint8 codes in [0, 2^b - 1]
    rescale: torch.Tensor  # (c,) f32 per-column least-squares rescale
    bits: int


def _codes_v(w: torch.Tensor, delta: torch.Tensor, c_b: float,
             levels: int) -> torch.Tensor:
    return torch.clamp(torch.round(w / delta + c_b), 0.0, float(levels)) - c_b


def candidate_scales(n_candidates: int, lo: float = 0.3,
                     hi: float = 1.05) -> np.ndarray:
    """The f32 grid-step multipliers of the per-column search."""
    return np.geomspace(lo, hi, n_candidates).astype(np.float32)


def quantize(w: torch.Tensor, bits: int, n_candidates: int = 12,
             lo: float = 0.3, hi: float = 1.05) -> RabitqCodes:
    """Quantize columns of ``w`` (d, c) to ``bits``-bit codes + rescale."""
    if not (1 <= bits <= 8):
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    w = w.to(torch.float32)
    levels = (1 << bits) - 1
    c_b = levels / 2.0
    absmax = torch.amax(torch.abs(w), dim=0)                    # (c,)
    delta0 = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, c_b)
    scales = torch.from_numpy(
        candidate_scales(n_candidates, lo, hi)).to(w.device)
    errs = []
    for s in scales:
        v = _codes_v(w, delta0 * s, c_b, levels)
        wv = torch.sum(w * v, dim=0)
        vv = torch.sum(v * v, dim=0)
        errs.append(-(wv * wv) / torch.clamp(vv, min=1e-30))
    best = torch.argmin(torch.stack(errs), dim=0)               # (c,)
    delta = delta0 * scales[best]
    v = _codes_v(w, delta, c_b, levels)
    wv = torch.sum(w * v, dim=0)
    vv = torch.sum(v * v, dim=0)
    rescale = torch.where(vv > 0, wv / torch.clamp(vv, min=1e-30),
                          torch.zeros_like(vv))
    codes = (v + c_b).to(torch.uint8)
    return RabitqCodes(codes=codes, rescale=rescale, bits=bits)


def dequantize(q: RabitqCodes) -> torch.Tensor:
    """Reconstruct w_hat = r * (codes - c_b) per column, shape (d, c)."""
    c_b = ((1 << q.bits) - 1) / 2.0
    return (q.codes.to(torch.float32) - c_b) * q.rescale[None, :]


def estimate_matmul(x: torch.Tensor, q: RabitqCodes) -> torch.Tensor:
    """Estimate X @ W from codes (paper Alg. 3, sans the external RHT)."""
    c_b = ((1 << q.bits) - 1) / 2.0
    xf = x.to(torch.float32)
    xw = xf @ q.codes.to(torch.float32)
    z = c_b * torch.sum(xf, dim=-1, keepdim=True)
    return (xw - z) * q.rescale[None, :]
