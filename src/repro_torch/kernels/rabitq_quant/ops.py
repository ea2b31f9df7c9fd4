"""Dispatch for the RaBitQ code search (per-column grid-step search, codes
and least-squares rescale), mirroring ``repro/kernels/rabitq_quant/ops.py``.
``core/qlinear.quantize_linear`` reaches the code search through here.

Paths:
  * a CUDA tensor -> the hand-written kernel (``csrc/rabitq_quant.cu``),
  * a CPU tensor  -> the plain PyTorch version (``core/rabitq.quantize``).

``set_forced_path("ref")`` runs the plain version on the card too, so a
smoke run can hold the kernel against it.  A CUDA tensor never falls back:
the kernel launches or the call raises.

Kernel source note — replaces ``repro/kernels/rabitq_quant/quantize.py:
quantize_pallas`` (``_kernel``), which holds a (d, bc) column slab in VMEM
and sweeps the S candidate steps over it.  A slab does not fit a block's
227 KB of shared memory at d = 10974, so the CUDA kernel streams w three
times (absmax; all S candidates' <w,v>, <v,v> in registers in one sweep;
the chosen codes), a CTA per 32 columns with its warps splitting d and
summing in a fixed order.  Operations bound it (S IEEE divisions per
element); the plain version's scales, division and rounding are kept, so
codes agree except where two candidates' objectives tie to f32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.rabitq import RabitqCodes, candidate_scales

from .ref import quantize_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
launches = 0                    # kernel launches (one per wrapper call)
MAX_CANDIDATES = 16             # the kernel keeps 2 S sums in registers
_LIB = None


def set_forced_path(path: str | None) -> None:
    global _FORCE_PATH
    if path not in (None, "kernel", "ref"):
        raise ValueError(f"unknown path {path!r}")
    _FORCE_PATH = path


def _use_kernel(w: torch.Tensor) -> bool:
    if _FORCE_PATH == "ref":
        return False
    if w.is_cuda:
        return True
    if _FORCE_PATH == "kernel":
        raise RuntimeError("the CUDA kernel path needs tensors on the card")
    return False


def quantize(w: torch.Tensor, bits: int, n_candidates: int = 12) -> RabitqCodes:
    """Quantize columns of ``w`` (d, c) to ``bits``-bit codes + rescale."""
    if _use_kernel(w):
        codes, rescale = quantize_cuda(w.to(torch.float32).contiguous(), bits,
                                       n_candidates)
    else:
        codes, rescale = quantize_ref(w, bits, n_candidates)
    return RabitqCodes(codes=codes, rescale=rescale, bits=bits)


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("rabitq_quant")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rabitq_quant.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.rabitq_quant.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def quantize_cuda(w: torch.Tensor, bits: int, n_candidates: int = 12, *,
                  return_choice: bool = False):
    """The kernel on the card: w (d, c) f32 -> codes (d, c) uint8, rescale
    (c,) f32, and with ``return_choice`` the chosen candidate per column
    (c,) int32."""
    global launches
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    if not 1 <= n_candidates <= MAX_CANDIDATES:
        raise ValueError(f"the kernel searches 1 to {MAX_CANDIDATES} "
                         f"candidate steps, got {n_candidates}")
    dev = w.device
    if dev.type != "cuda":
        raise ValueError("quantize_cuda needs CUDA tensors")
    if w.ndim != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous float32 (d, c) tensor, got "
                         f"{w.dtype} {tuple(w.shape)}")
    d, c = w.shape
    codes = torch.empty((d, c), dtype=torch.uint8, device=dev)
    rescale = torch.empty((c,), dtype=torch.float32, device=dev)
    choice = (torch.empty((c,), dtype=torch.int32, device=dev)
              if return_choice else None)
    if d == 0 or c == 0:
        return (codes, rescale, choice) if return_choice else (codes, rescale)
    scales = torch.from_numpy(candidate_scales(n_candidates)).to(dev)
    with torch.cuda.device(dev):
        err = _lib().rabitq_quant(
            w.data_ptr(), scales.data_ptr(), codes.data_ptr(),
            rescale.data_ptr(), 0 if choice is None else choice.data_ptr(),
            d, c, bits, n_candidates,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rabitq_quant launch failed with CUDA error {err}")
    launches += 1
    return (codes, rescale, choice) if return_choice else (codes, rescale)
