"""QuantizedLinear — the deployable artifact of RaanA for one linear layer.

Port of ``repro/core/qlinear.py``: the same eight tensor leaves and the same
static ``bits/d/d_keep/c``.  ``apply`` runs Alg. 3 with the App. C.3 trick
corrections; the practical RHT and the dequant GEMM are one dispatch through
``kernels/qmatmul/ops.rht_quantized_matmul`` (the CUDA kernel on the card,
its plain twin for CPU tensors).  The mean-column term and the exact outlier
product stay plain torch outside the kernel, as in the reference.

``quantize_linear`` takes the Rademacher signs as arguments because torch
cannot reproduce ``jax.random`` streams: parity tests pass the reference's
signs, and ``draw_signs`` draws fresh ones from a ``torch.Generator``.  Its
code search goes through ``kernels/rabitq_quant/ops.quantize`` (the CUDA
kernel on the card, ``core/rabitq.quantize`` for CPU tensors).

``QuantizedGrouped`` is the stacked per-expert form for MoE weights (E, d,
c): signs shared across the experts of a layer, a rescale per (expert,
column), no outliers and no centralization (as in the reference); its
``apply`` is one grouped dispatch, ``kernels/qmatmul/ops.
grouped_rht_quantized_matmul``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.rabitq_quant import ops as rq_ops

from . import hadamard, packing, tricks

__all__ = ["QuantizedLinear", "quantize_linear", "reconstruct_weight",
           "draw_signs", "QuantizedGrouped", "quantize_grouped"]


@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    packed: torch.Tensor                 # (packed_rows(d_keep), c) uint8
    rescale: torch.Tensor                # (c,) f16
    signs1: torch.Tensor                 # (d_hat,) f32 (+/-1)
    signs2: Optional[torch.Tensor]       # (d_hat,) f32 or None (d_keep pow2)
    mean_col: Optional[torch.Tensor]     # (d_keep,) f16 or None
    w_out: Optional[torch.Tensor]        # (k, c) f16 outlier rows or None
    out_idx: Optional[torch.Tensor]      # (k,) int64 or None
    keep_idx: Optional[torch.Tensor]     # (d_keep,) int64 or None (k == 0)
    bits: int = 4
    d: int = 0
    d_keep: int = 0
    c: int = 0

    def overhead_bits(self) -> int:
        """Side-information cost in bits, at actual storage width (counted
        against the AllocateBits budget; signs are 1 bit each)."""
        n = self.rescale.numel() * self.rescale.element_size() * 8
        n += self.signs1.numel()
        if self.signs2 is not None:
            n += self.signs2.numel()
        if self.mean_col is not None:
            n += self.mean_col.numel() * self.mean_col.element_size() * 8
        if self.w_out is not None:
            n += (self.w_out.numel() * self.w_out.element_size() * 8
                  + self.out_idx.numel() * 32)
        return int(n)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Estimate x @ W for x of shape (..., d) — Alg. 3 + corrections."""
        from repro_torch.kernels.qmatmul import ops as qops  # late: no cycle
        lead = x.shape[:-1]
        c = self.rescale.shape[-1]
        x2 = x.reshape(-1, self.d).to(torch.float32)
        if self.out_idx is not None and self.out_idx.numel():
            x_out = x2.index_select(1, self.out_idx)
            x_rest = x2.index_select(1, self.keep_idx)
        else:
            x_out, x_rest = None, x2
        y = qops.rht_quantized_matmul(x_rest, self.packed, self.rescale,
                                      self.signs1, self.signs2,
                                      bits=self.bits, d=self.d_keep)
        if self.mean_col is not None:
            y = (x_rest @ self.mean_col.to(torch.float32))[:, None] + y
        if x_out is not None:
            y = y + x_out @ self.w_out.to(torch.float32)
        return y.reshape(*lead, c)


def draw_signs(d_keep: int, generator: torch.Generator | None = None):
    """(signs1, signs2) for a layer whose quantized input width is d_keep;
    signs2 is None when d_keep is a power of 2 (Alg. 5 needs one block)."""
    d_hat = hadamard.largest_pow2_leq(d_keep)
    s1 = hadamard.rademacher(d_hat, generator)
    s2 = hadamard.rademacher(d_hat, generator) if d_hat != d_keep else None
    return s1, s2


def quantize_linear(w: torch.Tensor, bits: int, signs1: torch.Tensor,
                    signs2: torch.Tensor | None,
                    x_col_norms: np.ndarray | None = None,
                    outlier_frac: float = 0.003,
                    centralize: bool = True,
                    n_candidates: int = 12,
                    device=None) -> QuantizedLinear:
    """Alg. 2 (+ App. C.3 tricks) for one weight matrix (d, c).

    ``signs1``/``signs2`` are the practical-RHT signs for the kept width
    (see ``draw_signs``).  Runs on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    d, c = w.shape
    w = w.to(device=dev, dtype=torch.float32)
    if x_col_norms is not None and outlier_frac > 0:
        out_np, keep_np = tricks.outlier_indices(np.asarray(x_col_norms),
                                                 outlier_frac)
    else:
        out_np = np.zeros((0,), np.int32)
        keep_np = np.arange(d, dtype=np.int32)
    has_out = out_np.size > 0
    out_idx = torch.from_numpy(out_np.astype(np.int64)).to(dev)
    keep_idx = torch.from_numpy(keep_np.astype(np.int64)).to(dev)
    w_out, w_rest = (tricks.split_outlier_dims(w, out_idx, keep_idx)
                     if has_out else (None, w))
    d_keep = int(keep_np.size)
    d_hat = hadamard.largest_pow2_leq(d_keep)
    if signs1.shape != (d_hat,) or (signs2 is None) != (d_hat == d_keep):
        raise ValueError(f"signs do not fit d_keep={d_keep} (d_hat={d_hat})")
    mean_col = None
    if centralize:
        w_rest, mean_col = tricks.centralize(w_rest)
    s1 = signs1.to(device=dev, dtype=torch.float32)
    s2 = (signs2.to(device=dev, dtype=torch.float32)
          if signs2 is not None else None)
    w_rot = hadamard.practical_rht(w_rest, s1, s2, axis=0)
    q = rq_ops.quantize(w_rot, bits, n_candidates=n_candidates)
    packed = packing.pack_codes(q.codes, bits)
    return QuantizedLinear(
        packed=packed, rescale=q.rescale.to(torch.float16),
        signs1=s1, signs2=s2,
        mean_col=mean_col.to(torch.float16) if mean_col is not None else None,
        w_out=w_out.to(torch.float16) if w_out is not None else None,
        out_idx=out_idx if has_out else None,
        keep_idx=keep_idx if has_out else None,
        bits=bits, d=d, d_keep=d_keep, c=c)


@dataclasses.dataclass(frozen=True)
class QuantizedGrouped:
    """Stacked per-expert quantization of MoE weights (E, d, c)."""
    packed: torch.Tensor                 # (E, packed_rows(d), c) uint8
    rescale: torch.Tensor                # (E, c) f16
    signs1: torch.Tensor                 # (d_hat,) f32, shared by the experts
    signs2: Optional[torch.Tensor]       # (d_hat,) f32 or None (d pow2)
    bits: int = 4
    d: int = 0
    c: int = 0

    @property
    def shape(self):
        return (self.packed.shape[0], self.d, self.c)

    def overhead_bits(self) -> int:
        """Side-information cost in bits, at actual storage width."""
        n = self.rescale.numel() * self.rescale.element_size() * 8
        n += self.signs1.numel()
        if self.signs2 is not None:
            n += self.signs2.numel()
        return int(n)

    def apply(self, xbuf: torch.Tensor) -> torch.Tensor:
        """xbuf (E, C, d) -> (E, C, c): each expert's Alg. 3 estimate, codes
        kept packed (no dense (E, d, c) weight is ever built)."""
        from repro_torch.kernels.qmatmul import ops as qops  # late: no cycle
        return qops.grouped_rht_quantized_matmul(
            xbuf, self.packed, self.rescale, self.signs1, self.signs2,
            bits=self.bits, d=self.d)


def quantize_grouped(w: torch.Tensor, bits: int, signs1: torch.Tensor,
                     signs2: torch.Tensor | None, n_candidates: int = 12,
                     device=None) -> QuantizedGrouped:
    """Quantize stacked expert weights (E, d, c) with shared RHT signs (see
    ``draw_signs(d)``) on ``device`` (CUDA unless ``"cpu"``).  Each expert
    is rotated and code-searched on its own, one kernel launch per expert,
    so only one expert's f32 rotation is held at a time."""
    dev = resolve_device(device)
    e, d, c = w.shape
    d_hat = hadamard.largest_pow2_leq(d)
    if signs1.shape != (d_hat,) or (signs2 is None) != (d_hat == d):
        raise ValueError(f"signs do not fit d={d} (d_hat={d_hat})")
    s1 = signs1.to(device=dev, dtype=torch.float32)
    s2 = (signs2.to(device=dev, dtype=torch.float32)
          if signs2 is not None else None)
    packed = torch.empty((e, packing.packed_rows(d, bits), c),
                         dtype=torch.uint8, device=dev)
    rescale = torch.empty((e, c), dtype=torch.float16, device=dev)
    for i in range(e):
        w_rot = hadamard.practical_rht(
            w[i].to(device=dev, dtype=torch.float32), s1, s2, axis=0)
        q = rq_ops.quantize(w_rot, bits, n_candidates=n_candidates)
        packed[i] = packing.pack_codes(q.codes, bits)
        rescale[i] = q.rescale.to(torch.float16)
        del w_rot, q
    return QuantizedGrouped(packed=packed, rescale=rescale, signs1=s1,
                            signs2=s2, bits=bits, d=d, c=c)


def reconstruct_weight(q: QuantizedLinear) -> torch.Tensor:
    """Effective W_hat (d, c) implementing exactly the Alg. 3 estimator."""
    codes = packing.unpack_codes(q.packed, q.bits, q.d_keep)
    c_b = ((1 << q.bits) - 1) / 2.0
    w_rot = (codes.to(torch.float32) - c_b) * q.rescale[None, :].to(torch.float32)
    w_rest = hadamard.practical_rht_inverse(w_rot, q.signs1, q.signs2, axis=0)
    if q.mean_col is not None:
        w_rest = w_rest + q.mean_col[:, None].to(torch.float32)
    if q.out_idx is None or not q.out_idx.numel():
        return w_rest
    w_hat = torch.zeros((q.d, q.c), dtype=torch.float32, device=w_rest.device)
    w_hat[q.keep_idx] = w_rest
    w_hat[q.out_idx] = q.w_out.to(torch.float32)
    return w_hat
