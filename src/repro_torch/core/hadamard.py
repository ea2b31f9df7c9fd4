"""Fast Walsh-Hadamard transform + the paper's practical RHT (App. A.1 / C.2).

Port of ``repro/core/hadamard.py``.  The plain path keeps the reference's
Kronecker factorization H_{d1*d2} = H_{d1} (x) H_{d2}: a length-d FWHT is a
reshape to (d1, d2) plus two small dense matmuls.  The CUDA kernel
(``csrc/rht_qmatmul.cu``) computes the same Sylvester H_d with an in-shared-
memory butterfly instead; the two agree up to f32 rounding.

Rademacher signs come from a ``torch.Generator``.  torch cannot reproduce
``jax.random`` streams, so parity tests pass the reference's signs in.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "hadamard_matrix",
    "fwht",
    "rht",
    "rht_inverse",
    "practical_rht",
    "practical_rht_inverse",
    "rademacher",
    "largest_pow2_leq",
]


def largest_pow2_leq(d: int) -> int:
    """2 ** floor(log2(d))  (paper App. C.2: d_hat)."""
    if d < 1:
        raise ValueError(f"dimension must be >= 1, got {d}")
    return 1 << (d.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def _hadamard_np(d: int) -> np.ndarray:
    """Unnormalized Sylvester Hadamard matrix H_d (d a power of 2)."""
    if d & (d - 1):
        raise ValueError(f"Hadamard matrix only defined for powers of 2, got {d}")
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < d:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized (orthonormal, involutory) Hadamard matrix H_d / sqrt(d)."""
    h = (_hadamard_np(d) / math.sqrt(d)).astype(np.float32)
    return torch.from_numpy(h).to(device=device, dtype=dtype)


def _split_dim(d: int) -> tuple[int, int]:
    """Balanced factorization d = d1 * d2 with both powers of 2, d1 >= d2."""
    lg = d.bit_length() - 1
    d1 = 1 << ((lg + 1) // 2)
    d2 = d // d1
    return d1, d2


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Normalized fast Walsh-Hadamard transform along ``axis``.

    Length along ``axis`` must be a power of 2.  Orthonormal and involutory:
    ``fwht(fwht(x)) == x``.
    """
    axis = axis % x.ndim
    d = x.shape[axis]
    if d & (d - 1):
        raise ValueError(f"fwht requires a power-of-2 length, got {d}")
    if d == 1:
        return x
    x = torch.movedim(x, axis, -1)
    lead = x.shape[:-1]
    d1, d2 = _split_dim(d)
    # row-major pairing: index i in [0,d) <-> (i1, i2), i1 slow => H_d = H_d1 (x) H_d2
    xr = x.reshape(*lead, d1, d2)
    h1 = hadamard_matrix(d1, x.dtype, x.device)
    h2 = hadamard_matrix(d2, x.dtype, x.device)
    xr = xr @ h2
    xr = h1 @ xr                   # H symmetric: sum_i h1[i, a] xr[i, j]
    x = xr.reshape(*lead, d)
    return torch.movedim(x, -1, axis)


def rademacher(d: int, generator: torch.Generator | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """i.i.d. +/-1 vector of length d, drawn on the generator's device."""
    dev = generator.device if generator is not None else None
    bits = torch.randint(0, 2, (d,), generator=generator, device=dev)
    return bits.to(dtype) * 2.0 - 1.0


def _signs_shape(x: torch.Tensor, axis: int) -> list[int]:
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return shape


def rht(x: torch.Tensor, signs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Randomized Hadamard transform: x -> Hadamard(D x) (paper eq. 8)."""
    axis = axis % x.ndim
    return fwht(x * signs.reshape(_signs_shape(x, axis)).to(x.dtype), axis=axis)


def rht_inverse(y: torch.Tensor, signs: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Inverse of ``rht``: x = D Hadamard(y)  (H orthonormal involution)."""
    axis = axis % y.ndim
    return fwht(y, axis=axis) * signs.reshape(_signs_shape(y, axis)).to(y.dtype)


def _apply_block(x: torch.Tensor, signs: torch.Tensor, axis: int, start: int,
                 d_hat: int, inverse: bool) -> torch.Tensor:
    """Apply (inverse) RHT to the slice [start, start+d_hat) along ``axis``."""
    blk = x.narrow(axis, start, d_hat)
    blk = rht_inverse(blk, signs, axis) if inverse else rht(blk, signs, axis)
    out = x.clone()
    out.narrow(axis, start, d_hat).copy_(blk)
    return out


def practical_rht(x: torch.Tensor, signs1: torch.Tensor,
                  signs2: torch.Tensor | None, axis: int = -1) -> torch.Tensor:
    """Practical RHT for arbitrary dimension d (paper Alg. 5).

    d_hat = 2^floor(log2 d); RHT the first d_hat coords with D1, then the last
    d_hat coords with D2 (the overlap is transformed twice).  When d is a
    power of 2 a single application suffices (signs2 may be None).
    """
    axis = axis % x.ndim
    d = x.shape[axis]
    d_hat = largest_pow2_leq(d)
    x = _apply_block(x, signs1, axis, 0, d_hat, inverse=False)
    if d_hat != d:
        if signs2 is None:
            raise ValueError("signs2 required when d is not a power of 2")
        x = _apply_block(x, signs2, axis, d - d_hat, d_hat, inverse=False)
    return x


def practical_rht_inverse(y: torch.Tensor, signs1: torch.Tensor,
                          signs2: torch.Tensor | None,
                          axis: int = -1) -> torch.Tensor:
    """Exact inverse of ``practical_rht`` (reverse order, inverse blocks)."""
    axis = axis % y.ndim
    d = y.shape[axis]
    d_hat = largest_pow2_leq(d)
    if d_hat != d:
        if signs2 is None:
            raise ValueError("signs2 required when d is not a power of 2")
        y = _apply_block(y, signs2, axis, d - d_hat, d_hat, inverse=True)
    return _apply_block(y, signs1, axis, 0, d_hat, inverse=True)
