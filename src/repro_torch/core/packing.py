"""Bit-packing of RaBitQ codes (port of ``repro/core/packing.py``).

Codes are stored packed along the d (input/contraction) axis:
  * bits in {1, 2, 4, 8}: dense — 8 // bits codes per uint8, low bits first,
  * bits in {3, 5, 6, 7}: one code per byte (counted at b logical bits for
    budget purposes).

The packed layout is what the fused CUDA GEMM consumes: codes cross device
memory packed and are unpacked in registers.
"""
from __future__ import annotations

import torch

__all__ = ["pack_codes", "unpack_codes", "packed_rows", "codes_per_byte",
           "DENSE_BITS"]

DENSE_BITS = (1, 2, 4, 8)


def codes_per_byte(bits: int) -> int:
    return 8 // bits if bits in DENSE_BITS else 1


def packed_rows(d: int, bits: int) -> int:
    per = codes_per_byte(bits)
    return (d + per - 1) // per


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (d, c) uint8 codes -> (packed_rows(d, bits), c) uint8."""
    per = codes_per_byte(bits)
    if per == 1:
        return codes.to(torch.uint8)
    d, c = codes.shape
    pad = (-d) % per
    codes = codes.to(torch.uint8)
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad, c))], dim=0)
    grp = codes.reshape(-1, per, c).to(torch.int32)
    shifts = (torch.arange(per, device=codes.device, dtype=torch.int32)
              * bits)[None, :, None]
    return torch.sum(grp << shifts, dim=1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Inverse of ``pack_codes`` -> (d, c) uint8."""
    per = codes_per_byte(bits)
    if per == 1:
        return packed
    mask = (1 << bits) - 1
    shifts = (torch.arange(per, device=packed.device, dtype=torch.int32)
              * bits)[None, :, None]
    grp = (packed.to(torch.int32)[:, None, :] >> shifts) & mask
    return grp.reshape(-1, packed.shape[-1])[:d].to(torch.uint8)
