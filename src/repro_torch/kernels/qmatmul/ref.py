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


def split_planes(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensor-core route's split of f32 x into bf16 planes (hi, mid, lo)
    with (hi + mid) + lo == x bit for bit for normal f32 values, as
    ``csrc/fwht.cuh:split3`` cuts it: hi keeps x's top 8 significant bits
    (truncation), mid the next 8 of the remainder, lo the rest."""
    def top16(v):
        return (v.contiguous().view(torch.int32)
                & -65536).view(torch.float32)
    x = x.to(torch.float32)
    hi = top16(x)
    r = x - hi
    mid = top16(r)
    lo = r - mid
    return tuple(p.to(torch.bfloat16) for p in (hi, mid, lo))


def quantized_matmul_planes_ref(x: torch.Tensor, packed: torch.Tensor,
                                rescale: torch.Tensor, *, bits: int,
                                d: int) -> torch.Tensor:
    """``quantized_matmul_ref`` built as the tensor-core route builds it:
    the three planes' products with the codes (each exact in f32) summed in
    f32, the c_b correction from the f32 row sum."""
    codes = packing.unpack_codes(packed, bits, d).to(torch.float32)
    c_b = ((1 << bits) - 1) / 2.0
    acc = sum(p.to(torch.float32) @ codes for p in split_planes(x))
    y = acc - c_b * torch.sum(x.to(torch.float32), dim=-1, keepdim=True)
    return y * rescale[None, :].to(torch.float32)
