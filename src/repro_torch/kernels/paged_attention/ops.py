"""Dispatch for paged attention — the chokepoint every serving attention read
over the block arena routes through.  Mirrors
``repro/kernels/paged_attention/ops.py``.

Paths:
  * a CUDA tensor -> the hand-written flash-decode kernel
    (``csrc/paged_attention.cu``),
  * a CPU tensor  -> the plain block-walking version (``ref.py``).

``paged_kernel(False)`` (scoped) and ``set_forced_path("ref")`` run the
plain version on the card too, so a smoke run can hold the kernel against
it; neither is the default.  A CUDA tensor never falls back on its own.

Kernel source note — replaces ``repro/kernels/paged_attention/paged.py:
paged_attention_pallas`` (``_kernel``).  The Pallas grid (B, KV, MB) walks
blocks as a sequential grid axis with scalar-prefetched block ids; here one
CTA per (request, KV head, split) loops over its share of the request's
logical blocks, reading ``block_table[b, j]`` itself and stopping at
``nblk``, and a second small launch merges the splits' softmax partials in
a fixed order.  What bounds it on this card: arena bytes (a decode step
reads every live K/V byte once; the FLOPs per byte are few).  The design
reads blocks in place and never builds a dense gathered copy; the KV splits
give 8 requests x 32 heads enough CTAs to keep the 132 SMs loading.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

from .ref import paged_attention_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None — tests poke this
_USE_KERNEL: contextvars.ContextVar[bool | None] = contextvars.ContextVar(
    "repro_torch_paged_attention_kernel", default=None)
launches = 0                    # kernel launches (one per wrapper call)
CTAS_PER_SM = 8                 # 128-thread split CTAs the plan aims at
_LIB = None


def set_forced_path(path: str | None) -> None:
    global _FORCE_PATH
    if path not in (None, "kernel", "ref"):
        raise ValueError(f"unknown path {path!r}")
    _FORCE_PATH = path


@contextlib.contextmanager
def paged_kernel(enabled: bool | None):
    """Scoped kernel-vs-plain toggle (True = CUDA kernel, False = plain
    version, None = by the tensor's device)."""
    token = _USE_KERNEL.set(enabled if enabled is None else bool(enabled))
    try:
        yield
    finally:
        _USE_KERNEL.reset(token)


def _use_kernel(q: torch.Tensor) -> bool:
    use = _USE_KERNEL.get()
    if _FORCE_PATH is not None:
        use = _FORCE_PATH == "kernel"
    if use is None:
        return q.is_cuda
    if use and not q.is_cuda:
        raise RuntimeError("the CUDA kernel path needs tensors on the card")
    return use


def paged_attention(q, k_arena, v_arena, block_table, pos, ring_cap, *,
                    window: int | None = None):
    """q (B, W, H, hd) at absolute positions pos-W..pos-1 (K/V already in
    the arena); arenas (N, bs, KV, hd); block_table (B, MB); pos/ring_cap
    (B,) -> (B, W, H, hd).  ``window`` is None or at least 1."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if _use_kernel(q):
        return paged_attention_cuda(q, k_arena, v_arena, block_table, pos,
                                    ring_cap, window=window)
    return paged_attention_ref(q, k_arena, v_arena, block_table, pos,
                               ring_cap, window=window)


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i,
                                        ctypes.c_float, i, i, p]
        lib.paged_attention.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kv_splits(b: int, kv: int, mb: int, n_sm: int) -> int:
    """Splits of each request's blocks across CTAs (flash-decoding): enough
    (request, KV head, split) CTAs for about CTAS_PER_SM per SM, and never
    more splits than table entries."""
    return max(1, min(mb, -(-CTAS_PER_SM * n_sm // max(b * kv, 1))))


def paged_attention_cuda(q, k_arena, v_arena, block_table, pos, ring_cap, *,
                         window: int | None = None) -> torch.Tensor:
    """The kernel on the card: q f32, arenas f32 or bf16, block_table /
    pos / ring_cap int32, all contiguous on one device."""
    global launches
    dev = q.device
    b, w, h, hd = q.shape
    _, bs, kv, hd_k = k_arena.shape
    mb = block_table.shape[1] if block_table.ndim == 2 else -1
    problems = []
    if dev.type != "cuda":
        problems.append("q must be on a CUDA device")
    if q.dtype != torch.float32:
        problems.append(f"q must be float32, got {q.dtype}")
    if window is not None and window < 1:
        problems.append(f"window must be None or >= 1, got {window}")
    if k_arena.dtype not in (torch.float32, torch.bfloat16):
        problems.append(f"arena dtype must be f32 or bf16, got {k_arena.dtype}")
    if v_arena.dtype != k_arena.dtype or v_arena.shape != k_arena.shape:
        problems.append("k and v arenas must match in shape and dtype")
    if hd_k != hd or h % kv:
        problems.append(f"head shapes do not fit: q {tuple(q.shape)}, "
                        f"arena {tuple(k_arena.shape)}")
    if tuple(block_table.shape) != (b, mb) or block_table.dtype != torch.int32:
        problems.append("block_table must be int32 (B, MB)")
    for name, t in (("pos", pos), ("ring_cap", ring_cap)):
        if tuple(t.shape) != (b,) or t.dtype != torch.int32:
            problems.append(f"{name} must be int32 (B,)")
    tensors = (q, k_arena, v_arena, block_table, pos, ring_cap)
    if any(t.device != dev for t in tensors):
        problems.append("all tensors must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        problems.append("all tensors must be contiguous")
    if problems:
        raise ValueError("paged_attention_cuda: " + "; ".join(problems))
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits = kv_splits(b, kv, mb,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    rows = (splits, b, kv, w * (h // kv))
    m = torch.empty(rows, dtype=torch.float32, device=dev)
    l = torch.empty(rows, dtype=torch.float32, device=dev)
    acc = torch.empty((*rows, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().paged_attention(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), ring_cap.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
            b, w, h, kv, hd, bs, mb, window if window is not None else 0,
            hd ** -0.5, splits, int(k_arena.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed with CUDA error {err}")
    launches += 1
    return out
