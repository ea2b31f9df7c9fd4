"""Dispatch for the randomized Hadamard transform (practical RHT, Alg. 5,
over the last axis), mirroring ``repro/kernels/hadamard/ops.py``.  It is the
first half of the unfused A/B path (``qmatmul.ops.fusion(False)``).

Paths:
  * a CUDA tensor -> the hand-written kernel (``csrc/hadamard.cu``),
  * a CPU tensor  -> the plain PyTorch version (``ref.py``).

``set_forced_path("ref")`` runs the plain version on the card too, so a
smoke run can hold the kernel against it.  A CUDA tensor never falls back:
the kernel launches or the call raises.

Kernel source note — replaces ``repro/kernels/hadamard/hadamard.py:
rht_pallas`` (``_kernel``), H(D x) for a power-of-2 d as two Kronecker
matmuls per row tile on the MXU, which the reference's ``practical_rht``
calls once per block.  On the H100 one launch does both blocks of Alg. 5:
one CTA per row holds the row in shared memory and runs the butterfly
FWHT of ``csrc/fwht.cuh`` (shared with the fused GEMM), the second block
after the first, so the reference's overlap semantics hold and the row
crosses device memory once each way.  Bytes bound it (8 bytes per element
against d*log2(d) shared-memory adds); at the decode path's n <= 64 rows
one CTA per row leaves SMs idle, so it is latency-bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hadamard as hcore

from .ref import practical_rht_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
launches = 0                    # kernel launches (one per wrapper call)
MAX_SMEM_BYTES = 232448         # dynamic shared memory one H100 block may use
_LIB = None


def set_forced_path(path: str | None) -> None:
    global _FORCE_PATH
    if path not in (None, "kernel", "ref"):
        raise ValueError(f"unknown path {path!r}")
    _FORCE_PATH = path


def _use_kernel(x: torch.Tensor) -> bool:
    if _FORCE_PATH == "ref":
        return False
    if x.is_cuda:
        return True
    if _FORCE_PATH == "kernel":
        raise RuntimeError("the CUDA kernel path needs tensors on the card")
    return False


def practical_rht(x: torch.Tensor, signs1: torch.Tensor,
                  signs2: torch.Tensor | None) -> torch.Tensor:
    """Paper Alg. 5 over the last axis of x (..., d), any d, kernel-backed."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if _use_kernel(x2):
        y = rht_cuda(x2.contiguous(), signs1, signs2)
    else:
        y = practical_rht_ref(x2, signs1, signs2)
    return y.reshape(*lead, d)


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("hadamard")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rht.argtypes = [p, p, p, p, i, i, i, p]
        lib.rht.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != shape):
        raise ValueError(f"{name}: expected float32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rht_cuda(x: torch.Tensor, signs1: torch.Tensor,
             signs2: torch.Tensor | None) -> torch.Tensor:
    """The kernel on the card: x (n, d) f32, signs (d_hat,) f32 (signs2
    exactly when d is not a power of 2) -> practical_rht(x) (n, d) f32."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("rht_cuda needs CUDA tensors")
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    d_hat = hcore.largest_pow2_leq(d)
    _check(x, "x", (n, d), dev)
    _check(signs1, "signs1", (d_hat,), dev)
    if (signs2 is None) != (d_hat == d):
        raise ValueError("signs2 is required exactly when d is not a power of 2")
    if signs2 is not None:
        _check(signs2, "signs2", (d_hat,), dev)
    if (d + (1 if d_hat == d else 2) * d_hat) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"d={d}: the kernel keeps a row and its signs in "
                         f"shared memory, {MAX_SMEM_BYTES} bytes")
    out = torch.empty_like(x)
    if n == 0:
        return out
    s2 = signs2 if signs2 is not None else signs1
    with torch.cuda.device(dev):
        err = _lib().rht(x.data_ptr(), signs1.data_ptr(), s2.data_ptr(),
                         out.data_ptr(), n, d, d_hat,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rht launch failed with CUDA error {err}")
    launches += 1
    return out
