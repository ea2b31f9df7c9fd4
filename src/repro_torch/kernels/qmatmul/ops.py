"""Dispatch for the dequant GEMMs — the chokepoint every quantized
projection (``QuantizedLinear.apply``) routes through.  Mirrors
``repro/kernels/qmatmul/ops.py``.

Paths:
  * a CUDA tensor -> the hand-written kernels (``csrc/rht_qmatmul.cu``),
  * a CPU tensor  -> the plain PyTorch versions (``ref.py``).

Fusion: by default the practical RHT (Alg. 5) runs inside
``rht_quantized_matmul``'s kernel.  The scoped ``fusion(enabled)`` context
manager selects the reference's unfused A/B pair instead: the RHT kernel
(``kernels/hadamard``) writes the rotated activations, then
``quantized_matmul``'s kernel reads them.  It is backed by a
``contextvars.ContextVar``, so two engines in one process can hold
opposite settings.

``set_forced_path("ref")`` runs the plain versions on the card too, so a
smoke run can hold the kernels against them; it is never the default.  A
CUDA tensor never falls back: the kernel launches or the call raises.

Kernel source note — ``rht_quantized_matmul_cuda`` replaces
``repro/kernels/qmatmul/qmatmul.py:rht_quantized_matmul_pallas``
(``_fused_kernel``), ``quantized_matmul_cuda`` replaces
``quantized_matmul_pallas`` (``_kernel``).  The Pallas fused kernel
rotates once at grid step (j=0, k=0) and keeps the rotated (bn, d_pad) tile
in VMEM across every column tile, which relies on TPU grid steps running in
order.  On the H100 CTAs run concurrently and a rotated f32 tile at n=8,
d=10974 (351 KB) exceeds a block's 227 KB of shared memory, so the fused
wrapper launches a rotation (one CTA per row, sign flip + butterfly FWHT in
shared memory, rowsum) that writes x_rot (n, d) f32 to scratch, and a
split-K dequant GEMM whose partial sums a third small pass reduces in a
fixed order (deterministic, so greedy tokens do not vary run to run) and
finishes with the Alg. 3 epilogue.  The unfused wrapper launches a row-sum
pass and the same GEMM and epilogue on a given x_rot.  The x_rot round trip
costs n*d*8 bytes (about 0.7 MB at n=8, d=10974) against 22.5 MB of 4-bit
codes for that layer (about 3%).  What bounds it on this card: at decode
(n <= 8) the packed-code bytes and f32 FMAs are of one order (4-bit, n=8:
2.5 us of bytes vs 4 us of f32 FMA at 67 TFLOP/s), at prefill (n=64) the
f32 FMAs.  The design splits d so that n <= 8 still fills the 132 SMs with
column x split tiles.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

from repro_torch.core import hadamard, packing

from .ref import quantized_matmul_ref, rht_quantized_matmul_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
_FUSE_RHT: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_qmatmul_fuse_rht", default=True)
launches = 0                    # fused kernel launches (one per call)
unfused_launches = 0            # quantized_matmul kernel launches

# Tiling of the dequant GEMM; must match csrc/rht_qmatmul.cu.
COLS_PER_CTA = 128              # 32 lanes x 4 columns (8 warps share them)
MIN_ROWS_PER_SPLIT = 64         # packed rows a split covers at least
CTAS_PER_SM = 3                 # resident 256-thread CTAs the plan aims at
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


@contextlib.contextmanager
def fusion(enabled: bool):
    """Scoped RHT + GEMM fusion toggle (True: the fused kernel, the default;
    False: the unfused pair, where rotated activations round-trip through
    device memory, kept for A/B measurement).  Nests and unwinds."""
    token = _FUSE_RHT.set(bool(enabled))
    try:
        yield
    finally:
        _FUSE_RHT.reset(token)


def fused_enabled() -> bool:
    """The innermost enclosing ``fusion`` setting (fused when none)."""
    return _FUSE_RHT.get()


def quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                     rescale: torch.Tensor, *, bits: int,
                     d: int) -> torch.Tensor:
    """Estimate X @ (r * (codes - c_b)) for an already-rotated X (..., d)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _use_kernel(x2):
        y = quantized_matmul_cuda(x2.to(torch.float32).contiguous(), packed,
                                  rescale, bits=bits, d=d)
    else:
        y = quantized_matmul_ref(x2, packed, rescale, bits=bits, d=d)
    return y.reshape(*lead, y.shape[-1])


def rht_quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                         rescale: torch.Tensor, signs1: torch.Tensor,
                         signs2: torch.Tensor | None, *, bits: int,
                         d: int) -> torch.Tensor:
    """Estimate practical_rht(X) @ (r * (codes - c_b)) for X (..., d): one
    fused dispatch, or under ``fusion(False)`` the RHT kernel then
    ``quantized_matmul``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not _FUSE_RHT.get():
        from repro_torch.kernels.hadamard import ops as hops  # late: no cycle
        xr = hops.practical_rht(x2.to(torch.float32), signs1, signs2)
        return quantized_matmul(xr, packed, rescale, bits=bits,
                                d=d).reshape(*lead, -1)
    if _use_kernel(x2):
        y = rht_quantized_matmul_cuda(x2, packed, rescale, signs1, signs2,
                                      bits=bits, d=d)
    else:
        y = rht_quantized_matmul_ref(x2, packed, rescale, signs1, signs2,
                                     bits=bits, d=d)
    return y.reshape(*lead, y.shape[-1])


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("rht_qmatmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rht_qmatmul.argtypes = [p, p, p, p, p, p, p, p, p,
                                    i, i, i, i, i, i, i, i, p]
        lib.rht_qmatmul.restype = ctypes.c_int
        lib.qmatmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.qmatmul.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def split_plan(n: int, d: int, c: int, bits: int, n_sm: int):
    """(rows_per_cta, packed_rows_per_split, splits) for the dequant GEMM:
    enough column x row x split tiles for about three CTAs per SM."""
    bn = 1
    while bn < min(n, 8):
        bn *= 2
    prow = packing.packed_rows(d, bits)
    tiles = -(-c // COLS_PER_CTA) * -(-n // bn)
    want = max(1, -(-CTAS_PER_SM * n_sm // tiles))
    splits = max(1, min(want, prow // MIN_ROWS_PER_SPLIT))
    rps = -(-prow // splits)
    return bn, rps, -(-prow // rps)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rht_quantized_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                              rescale: torch.Tensor, signs1: torch.Tensor,
                              signs2: torch.Tensor | None, *, bits: int,
                              d: int) -> torch.Tensor:
    """The kernel on the card: x (n, d) f32, packed (packed_rows(d), c)
    uint8, rescale (c,) f16, signs (d_hat,) f32 -> (n, c) f32."""
    global launches
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("rht_quantized_matmul_cuda needs CUDA tensors")
    n = x.shape[0]
    c = packed.shape[1]
    d_hat = hadamard.largest_pow2_leq(d)
    _check(x, "x", torch.float32, (n, d), dev)
    _check(packed, "packed", torch.uint8, (packing.packed_rows(d, bits), c),
           dev)
    _check(rescale, "rescale", torch.float16, (c,), dev)
    _check(signs1, "signs1", torch.float32, (d_hat,), dev)
    if (signs2 is None) != (d_hat == d):
        raise ValueError("signs2 is required exactly when d is not a power of 2")
    if signs2 is not None:
        _check(signs2, "signs2", torch.float32, (d_hat,), dev)
    if (d + 2 * d_hat) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"d={d}: the rotation kernel keeps a row and its "
                         f"signs in shared memory, {MAX_SMEM_BYTES} bytes")
    if packed.data_ptr() % 16:
        raise ValueError("packed must start 16-byte aligned (a fresh tensor)")
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bn, rps, splits = split_plan(n, d, c, bits, n_sm)
    xrot = torch.empty((n, d), dtype=torch.float32, device=dev)
    rowsum = torch.empty((n,), dtype=torch.float32, device=dev)
    partial = torch.empty((splits, n, c), dtype=torch.float32, device=dev)
    s2 = signs2 if signs2 is not None else signs1
    with torch.cuda.device(dev):
        err = _lib().rht_qmatmul(
            x.data_ptr(), signs1.data_ptr(), s2.data_ptr(), packed.data_ptr(),
            rescale.data_ptr(), xrot.data_ptr(), rowsum.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, d, d_hat, c, bits, bn,
            rps, splits, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rht_qmatmul launch failed with CUDA error {err}")
    launches += 1
    return out


def quantized_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                          rescale: torch.Tensor, *, bits: int,
                          d: int) -> torch.Tensor:
    """The unfused kernel on the card: an already-rotated x (n, d) f32,
    packed (packed_rows(d), c) uint8, rescale (c,) f16 -> (n, c) f32."""
    global unfused_launches
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("quantized_matmul_cuda needs CUDA tensors")
    n = x.shape[0]
    c = packed.shape[1]
    _check(x, "x", torch.float32, (n, d), dev)
    _check(packed, "packed", torch.uint8, (packing.packed_rows(d, bits), c),
           dev)
    _check(rescale, "rescale", torch.float16, (c,), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed must start 16-byte aligned (a fresh tensor)")
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bn, rps, splits = split_plan(n, d, c, bits, n_sm)
    rowsum = torch.empty((n,), dtype=torch.float32, device=dev)
    partial = torch.empty((splits, n, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().qmatmul(
            x.data_ptr(), packed.data_ptr(), rescale.data_ptr(),
            rowsum.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d, c,
            bits, bn, rps, splits, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qmatmul launch failed with CUDA error {err}")
    unfused_launches += 1
    return out
