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
calls once per block.  On the H100 one launch does both blocks of Alg. 5
(``csrc/fwht.cuh``, shared with the fused GEMM): one CTA of T threads per
row, each thread holding E = d_hat / T values of a block in registers with
the signs applied on load; the log2 E slot bits are butterflies in
registers, the 5 lane bits go through warp shuffles, and the log2(T / 32)
warp bits run in registers after one transpose through shared memory.
Block 2 reads block 1's overlap and the row's tail (copied by cp.async
while block 1 computes) from shared memory, so the reference's overlap
semantics hold and the row crosses device memory once each way.
``rotate_plan`` picks (T, E) per width and ``ref.rotate_walk`` walks the
same stages on the host.  What bounds it: at the decode path's 8-16 rows,
latency (a load, 1-3 barriers and 5 shuffles per value per block on 8-16
of 132 SMs), far above its 8 bytes per element of device traffic.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import hadamard as hcore

from .ref import practical_rht_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
launches = 0                    # kernel launches (one per wrapper call)
MAX_D_HAT = 16384               # fwht.cuh's widest block: d < 32768
MAX_THREADS = 512               # threads per row the kernel is built for
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


def rotate_plan(d: int) -> tuple[int, int]:
    """(threads per row T, values per thread E) of the rotation kernel for
    rows of width d, with T * E = max(d_hat, 32).  T is the largest power
    of 2 up to 512 that keeps E >= T / 32, so the warp bits fit one
    thread's registers after the transpose.  Raises for widths the kernel
    does not take (d_hat above 16384, i.e. d >= 32768)."""
    d_hat = hcore.largest_pow2_leq(d)
    if d_hat > MAX_D_HAT:
        raise ValueError(f"d={d}: the rotation kernel takes blocks up to "
                         f"d_hat={MAX_D_HAT} (d < {2 * MAX_D_HAT})")
    threads = 32
    while threads < MAX_THREADS and (2 * threads) ** 2 <= 32 * d_hat:
        threads *= 2
    return threads, max(1, d_hat // threads)


def practical_rht(x: torch.Tensor, signs1: torch.Tensor,
                  signs2: torch.Tensor | None) -> torch.Tensor:
    """Paper Alg. 5 over the last axis of x (..., d), any d, kernel-backed."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    with kernels.credited("rht", n=x2.shape[0], d=d):
        if kernels.is_fake(x2):
            rotate_plan(d)                      # the kernel's widths
            y = torch.empty_like(x2)
        elif _use_kernel(x2):
            y = rht_cuda(x2.contiguous(), signs1, signs2)
        else:
            y = practical_rht_ref(x2, signs1, signs2)
    return y.reshape(*lead, d)


def cost(n: int, d: int) -> dict:
    """The work of one call: each row read and written once and the signs
    read once per block; the butterflies' adds (each of the two blocks'
    log2 d_hat stages) as products with +-1 signs at the f32 x codes
    rate."""
    from repro_torch.launch import roofline as rl
    dh = hcore.largest_pow2_leq(d)
    passes = 1 if dh == d else 2
    work = [[passes * n * dh * (dh.bit_length() - 1), rl.CODES]]
    return {"flops": work[0][0], "bytes": 2 * n * d * 4 + passes * dh * 4,
            "work": work}


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("hadamard")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rht.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.rht.restype = ctypes.c_int
        lib.noop.argtypes = [p]
        lib.noop.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != shape):
        raise ValueError(f"{name}: expected float32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _rotate(x: torch.Tensor, signs1: torch.Tensor,
            signs2: torch.Tensor | None, out_ld: int,
            with_rowsum: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the rotation kernel needs CUDA tensors")
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    d_hat = hcore.largest_pow2_leq(d)
    threads, per_thread = rotate_plan(d)
    _check(x, "x", (n, d), dev)
    _check(signs1, "signs1", (d_hat,), dev)
    if (signs2 is None) != (d_hat == d):
        raise ValueError("signs2 is required exactly when d is not a power of 2")
    if signs2 is not None:
        _check(signs2, "signs2", (d_hat,), dev)
    if out_ld < d:
        raise ValueError(f"out_ld={out_ld} is narrower than d={d}")
    out = torch.empty((n, out_ld), dtype=torch.float32, device=dev)
    rowsum = (torch.empty((n,), dtype=torch.float32, device=dev)
              if with_rowsum else None)
    if n == 0:
        return out, rowsum
    s2 = signs2 if signs2 is not None else signs1
    with torch.cuda.device(dev):
        err = _lib().rht(x.data_ptr(), signs1.data_ptr(), s2.data_ptr(),
                         out.data_ptr(),
                         0 if rowsum is None else rowsum.data_ptr(), n, d,
                         d_hat, out_ld, threads, per_thread,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rht launch failed with CUDA error {err}")
    launches += 1
    return out, rowsum


def rht_cuda(x: torch.Tensor, signs1: torch.Tensor,
             signs2: torch.Tensor | None) -> torch.Tensor:
    """The kernel on the card: x (n, d) f32, signs (d_hat,) f32 (signs2
    exactly when d is not a power of 2) -> practical_rht(x) (n, d) f32."""
    return _rotate(x, signs1, signs2, x.shape[-1], False)[0]


def rht_padded_cuda(x: torch.Tensor, signs1: torch.Tensor,
                    signs2: torch.Tensor | None,
                    out_ld: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation as the fused GEMM launches it: practical_rht(x) in rows
    of out_ld f32, zeros past d, and each rotated row's sum (n,)."""
    return _rotate(x, signs1, signs2, out_ld, True)


def launch_floor(device: torch.device) -> None:
    """Launch an empty kernel (the card's launch floor, for timing)."""
    with torch.cuda.device(device):
        err = _lib().noop(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"noop launch failed with CUDA error {err}")
