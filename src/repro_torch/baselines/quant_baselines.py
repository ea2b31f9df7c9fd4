"""Baseline PTQ methods the paper compares against (Table 1): RTN (grouped
round-to-nearest), GPTQ (layer-Hessian OBQ, arXiv:2210.17323), and an
AWQ-style activation-aware scaling (arXiv:2306.00978).

Port of ``repro/baselines/quant_baselines.py``, which is host numpy.  Each
takes W (d_in, d_out) as a tensor and returns a reconstructed f32 weight of
the same shape on ``device`` (CUDA unless ``"cpu"``), drop-in like
``core.qlinear.reconstruct_weight``, plus the side information's bits so
that average-bits accounting matches RaanA's.

The arithmetic follows the reference's numpy 2 dtypes step for step, so a
CPU run gives its numbers bit for bit: the grid is f32 for RTN and GPTQ and
f64 for AWQ (whose scales are f64); GPTQ's residual is taken in f32 and
only then divided by the f64 pivot, and its f64 row update is rounded into
the f32 weight (numpy's in-place ``same_kind`` cast).  Every division
divides by a tensor: CUDA PyTorch multiplies by the reciprocal of a host
scalar, one ulp off IEEE division.  The reductions that feed a scale
(AWQ's mean norm and ``n ** alpha``, GPTQ's damping and factor) stay
numpy on the host, whose summation order, ``pow`` and LAPACK the reference
uses; GPTQ's row loop then runs on ``device`` and equals the host's bit
for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["rtn_quantize", "gptq_quantize", "awq_quantize"]


def _levels(bits: int, like: torch.Tensor) -> torch.Tensor:
    """2^bits - 1 as a 0-d tensor of ``like``'s dtype and device (a divisor
    that CUDA divides by exactly)."""
    return torch.tensor((1 << bits) - 1, dtype=like.dtype, device=like.device)


def _uniform_grid(w: torch.Tensor, bits: int, axis: int = 0,
                  group: int = 0) -> torch.Tensor:
    """Asymmetric min/max uniform quantization along ``axis`` (optionally in
    groups of ``group`` input dims), in ``w``'s dtype.  Returns the
    reconstruction.  A last group short of ``group`` rows is padded with
    zeros, which enter its min and max, as in the reference."""
    levels = (1 << bits) - 1
    if group and w.shape[0] > group:
        d = w.shape[0]
        pad = (-d) % group
        wp = torch.cat([w, w.new_zeros((pad, *w.shape[1:]))], 0)
        wg = wp.reshape(-1, group, *w.shape[1:])
        lo = wg.amin(dim=1, keepdim=True)
        hi = wg.amax(dim=1, keepdim=True)
        scale = torch.clamp(hi - lo, min=1e-12) / _levels(bits, w)
        q = torch.clamp(torch.round((wg - lo) / scale), 0, levels)
        return (q * scale + lo).reshape(-1, *w.shape[1:])[:d]
    lo = w.amin(dim=axis, keepdim=True)
    hi = w.amax(dim=axis, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-12) / _levels(bits, w)
    q = torch.clamp(torch.round((w - lo) / scale), 0, levels)
    return q * scale + lo


def _group_overhead(d: int, c: int, group: int) -> int:
    """(scale + zero) in fp16 per group and output column."""
    return int(2 * 16 * math.ceil(d / group) * c)


def rtn_quantize(w: torch.Tensor, bits: int, group: int = 128, device=None):
    """Grouped round-to-nearest.  Side info: (scale+zero) fp16 per group ->
    2*16/group extra bits per weight."""
    dev = resolve_device(device)
    w = w.to(device=dev, dtype=torch.float32)
    out = _uniform_grid(w, bits, axis=0, group=group)
    return out, _group_overhead(w.shape[0], w.shape[1], group)


def _gptq_factor_host(hessian: torch.Tensor, percdamp: float):
    """(u, dead) by the reference's numpy (LAPACK) verbatim, as CPU
    tensors: the upper Cholesky factor U of the damped inverse Hessian (H^-1
    = U^T U, f64) and the inputs whose diagonal is zero (set to 1 before
    damping)."""
    h = np.array(hessian.detach().cpu().numpy(), np.float64, copy=True)
    d = h.shape[0]
    dead = np.diag(h) == 0
    h[dead, dead] = 1.0
    h[np.arange(d), np.arange(d)] += percdamp * np.mean(np.diag(h))
    u = np.linalg.cholesky(np.linalg.inv(h)).T
    return torch.from_numpy(np.ascontiguousarray(u)), torch.from_numpy(dead)


def _gptq_rows(w: torch.Tensor, u: torch.Tensor, bits: int, group: int,
               codes: torch.Tensor | None = None) -> torch.Tensor:
    """GPTQ's row loop, as the reference writes it: quantize input dim i of
    ``w`` (f32 (d, c), updated in place) on its group's grid, taken when i
    opens the group from the rows as propagated so far, then spread the
    residual over the rows below through row i of ``u`` (f64 (d, d)).
    Returns the f32 reconstruction; ``codes`` (uint8 (d, c)), when given,
    receives the grid codes."""
    d = w.shape[0]
    levels = (1 << bits) - 1
    out = torch.zeros_like(w)
    pivots = torch.diagonal(u)
    for i in range(d):
        if group and i % group == 0:
            blk = w[i: i + group]
            lo = blk.amin(dim=0)
            hi = blk.amax(dim=0)
            scale = torch.clamp(hi - lo, min=1e-12) / _levels(bits, w)
            zero = lo
        q = torch.clamp(torch.round((w[i] - zero) / scale), 0, levels)
        torch.add(q * scale, zero, out=out[i])
        if codes is not None:
            codes[i] = q
        # f32 residual over a 1-element f64 pivot: the quotient is f64,
        # as numpy's f32 array over an np.float64 scalar
        err = (w[i] - out[i]) / pivots[i: i + 1]
        if i + 1 < d:
            w[i + 1:].sub_(torch.outer(u[i, i + 1:], err))  # f64, into f32
    return out


def gptq_quantize(w: torch.Tensor, hessian: torch.Tensor, bits: int,
                  group: int = 128, percdamp: float = 0.01, device=None):
    """GPTQ: quantize input dims in order, propagating error through the
    Cholesky factor of the damped inverse Hessian H = X^T X (d_in, d_in)."""
    dev = resolve_device(device)
    w = w.to(device=dev, dtype=torch.float32, copy=True)
    d, c = w.shape
    u, dead = _gptq_factor_host(hessian, percdamp)
    w[dead.to(dev)] = 0.0
    out = _gptq_rows(w, u.to(dev), bits, group)
    return out, _group_overhead(d, c, group)


def awq_quantize(w: torch.Tensor, x_col_norms, bits: int, group: int = 128,
                 alphas=(0.0, 0.25, 0.5, 0.75, 1.0), device=None):
    """AWQ-style: scale salient input dims up before RTN, fold the inverse
    scale back exactly.  Grid-search alpha minimizing ||diag(n)(W - W_hat)||_F
    (column-norm proxy for the activation-weighted error); the first alpha
    wins a tie.  Returns (reconstruction, overhead bits, alpha)."""
    dev = resolve_device(device)
    w = w.to(device=dev, dtype=torch.float32)
    n = np.asarray(torch.as_tensor(x_col_norms).detach().cpu(), np.float64)
    n = n / max(n.mean(), 1e-12)
    w64 = w.to(torch.float64)
    n_col = torch.from_numpy(n).to(dev)[:, None]
    best, best_err, best_alpha = None, np.inf, 0.0
    for a in alphas:
        s = torch.from_numpy(np.maximum(n ** a, 1e-6)).to(dev)[:, None]
        wq = _uniform_grid(w64 * s, bits, axis=0, group=group) / s
        err = float(torch.linalg.vector_norm((w64 - wq) * n_col))
        if err < best_err:
            best, best_err, best_alpha = wq, err, a
    overhead = _group_overhead(w.shape[0], w.shape[1], group) + 16 * w.shape[0]
    return best.to(torch.float32), overhead, best_alpha
