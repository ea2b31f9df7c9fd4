"""Plain PyTorch versions of the (RHT-)fused dequant GEMM (paper Alg. 3 /
Alg. 5), mirroring ``repro/kernels/qmatmul/ref.py``: the unfused
composition the CUDA kernel must match."""
from __future__ import annotations

import torch

from repro_torch.core import hadamard, packing


def quantized_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                         rescale: torch.Tensor, *, bits: int,
                         d: int) -> torch.Tensor:
    """Y = (X @ (codes - c_b)) * r  for X (n, d), packed codes, r (c,)."""
    codes = packing.unpack_codes(packed, bits, d).to(torch.float32)
    c_b = ((1 << bits) - 1) / 2.0
    x = x.to(torch.float32)
    y = x @ codes - c_b * torch.sum(x, dim=-1, keepdim=True)
    return y * rescale[None, :].to(torch.float32)


def rht_quantized_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                             rescale: torch.Tensor, signs1: torch.Tensor,
                             signs2: torch.Tensor | None, *, bits: int,
                             d: int) -> torch.Tensor:
    """Alg. 5 (practical RHT) then Alg. 3."""
    xr = hadamard.practical_rht(x.to(torch.float32), signs1, signs2, axis=-1)
    return quantized_matmul_ref(xr, packed, rescale, bits=bits, d=d)


def grouped_rht_quantized_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                                     rescale: torch.Tensor,
                                     signs1: torch.Tensor,
                                     signs2: torch.Tensor | None, *,
                                     bits: int, d: int) -> torch.Tensor:
    """The reference's vmap over experts written out: x (E, C, d), packed
    (E, pr, c), rescale (E, c) -> (E, C, c); the signs are shared."""
    return torch.stack([
        rht_quantized_matmul_ref(x[e], packed[e], rescale[e], signs1, signs2,
                                 bits=bits, d=d) for e in range(x.shape[0])])


def grouped_quantized_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                                 rescale: torch.Tensor, *, bits: int,
                                 d: int) -> torch.Tensor:
    """The unfused GEMM per expert on an already-rotated x (E, C, d)."""
    return torch.stack([
        quantized_matmul_ref(x[e], packed[e], rescale[e], bits=bits, d=d)
        for e in range(x.shape[0])])
