"""Dispatch for fused flash attention, mirroring
``repro/kernels/flash_attention/ops.py``.

Paths:
  * a CUDA tensor -> the hand-written kernel (``csrc/flash_attention.cu``),
  * a CPU tensor  -> the plain version (``ref.attention_ref``).

``set_forced_path("ref")`` runs the plain version on the card too, so a
smoke run can hold the kernel against it.  A CUDA tensor never falls back:
the kernel launches or the call raises.

Kernel source note — replaces ``repro/kernels/flash_attention/flash.py:
flash_attention_pallas`` (``_kernel``), whose sequential KV grid axis
carries the online-softmax state in VMEM; on the H100 that axis is a loop
inside each (batch, head, 128-query) CTA over 64-key tiles, in the
FlashAttention-2 layout: each warp owns 16 query rows and keeps S, m, l and
its accumulator in registers, K/V tiles go through a two-stage cp.async
ring, and both products run on the tensor cores (``mma.sync``: bf16 inputs
in bf16 with f32 accumulation, P rounded to bf16 for P V; f32 inputs as
three TF32 products of hi/lo splits).  It keeps the reference's finite
NEG_INF and ``acc / max(l, 1e-30)`` epilogue, reads K/V through the GQA
index map (never expanded), skips key tiles outside the causal or window
band, and runs the longest query tiles first.  Tensor-core operations bound
it (989 TFLOP/s bf16, 165 TFLOP/s for three TF32 products).
``ref.flash_tile_walk`` walks the same tiles in the same order on the host.
As in the reference, no model path calls this dispatcher: sequence
attention in the models is ``models/attention.flash_attention``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels

from .ref import attention_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
launches = 0                    # kernel launches (one per wrapper call)
HEAD_DIMS = (64, 128)           # the kernel's compiled head widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def set_forced_path(path: str | None) -> None:
    global _FORCE_PATH
    if path not in (None, "kernel", "ref"):
        raise ValueError(f"unknown path {path!r}")
    _FORCE_PATH = path


def _use_kernel(q: torch.Tensor) -> bool:
    if _FORCE_PATH == "ref":
        return False
    if q.is_cuda:
        return True
    if _FORCE_PATH == "kernel":
        raise RuntimeError("the CUDA kernel path needs tensors on the card")
    return False


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd), H = KV*G -> (B,S,H,hd) in q's dtype."""
    b, s, h, hd = q.shape
    with kernels.credited("flash_attention", b=b, sq=s, sk=k.shape[1], h=h,
                          kv=k.shape[2], hd=hd, causal=causal, window=window,
                          elem_bytes=q.element_size()):
        if kernels.is_fake(q):
            if hd not in HEAD_DIMS:
                raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
            return torch.empty_like(q)
        if _use_kernel(q):
            return flash_attention_cuda(q, k, v, causal=causal, window=window)
        return attention_ref(q, k, v, causal=causal, window=window)


def pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """Unmasked (query, key) pairs of one head: the work a call needs
    (query i at position i, as the kernel's masks place it)."""
    q = np.arange(sq)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = np.minimum(q + 1, sk) if causal else np.full_like(q, sk)
    return int(np.sum(np.maximum(hi - lo, 0)))


def cost(b: int, sq: int, sk: int, h: int, kv: int, hd: int, causal: bool,
         window: int | None, elem_bytes: int) -> dict:
    """The work of one call: q, k and v read once and the output written
    once; the two products, 4 flops per unmasked pair and head element, on
    the tensor cores at bf16's rate (bf16 inputs) or three TF32 products'
    (f32)."""
    from repro_torch.launch import roofline as rl
    rate = rl.BF16 if elem_bytes == 2 else rl.F32
    work = [[4 * hd * pairs(sq, sk, causal, window) * h * b, rate]]
    nbytes = (2 * b * sq * h * hd + 2 * b * sk * kv * hd) * elem_bytes
    return {"flops": work[0][0], "bytes": nbytes, "work": work}


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        i, ctypes.c_float, p]
        lib.flash_attention.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """The kernel on the card: q (B,Sq,H,hd), k/v (B,Sk,KV,hd), all f32 or
    all bf16 and contiguous, hd in ``HEAD_DIMS`` -> (B,Sq,H,hd)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,S,H,hd), k = v (B,S,KV,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("no keys to attend to")
    with torch.cuda.device(q.device):
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kv, hd, _DTYPES[q.dtype], int(causal),
            0 if window is None else int(window), float(hd ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return out
