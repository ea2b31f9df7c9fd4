"""Dispatch for paged attention — the chokepoint every serving attention read
over the block arena routes through.  Mirrors
``repro/kernels/paged_attention/ops.py``.

Paths:
  * a CUDA tensor -> the hand-written flash-decode kernel
    (``csrc/paged_attention.cu``),
  * a CPU tensor  -> the plain block-walking version (``ref.py``),
  * ``paged_kernel(False)`` -> the reference's dense gather
    (``ref.paged_attention_gather``) on either device: the CLI's
    ``--no-paged-kernel`` A/B baseline, which a CUDA graph can capture.

``set_forced_path("ref")`` runs the plain block walk on the card too, so a
smoke run can hold the kernel against it; it reads the host, so the engine
captures nothing while it is set.  Neither switch is the default, and a
CUDA tensor never falls back on its own.  ``paged_kernel`` is scoped (a
``contextvars.ContextVar``, as in the reference), so the engine enters its
own setting inside every step rather than relying on its caller's.

Kernel source note — replaces ``repro/kernels/paged_attention/paged.py:
paged_attention_pallas`` (``_kernel``).  The Pallas grid (B, KV, MB) walks
blocks as a sequential grid axis with scalar-prefetched block ids.  What
bounds it on this card: arena bytes (a decode step reads every live K/V
byte once, at about one FMA per byte), so the design keeps bytes in
flight.  One CTA of 4 warps per (request, KV head, split) copies its
split's block ids to shared memory and walks its keys in 32-key tiles
through a 3-slot ring filled by 16-byte ``cp.async`` (two tiles in flight
while one is computed; two CTAs per SM, but one at head_dim 256 with an f32
arena, whose ring is 192 KB: ``ctas_per_sm``).  Each warp owns
8 keys of every tile, with its own online softmax and accumulator in
registers; the one barrier per tile hands a slot back to the copier.  The
warps merge in warp order at the end of the split.

Launch plan (``kv_splits`` on the host; per request on the card, as
``ref.split_plan`` computes it): the grid has S splits, enough (request,
KV head, split) CTAs to fill the resident slots (``ctas_per_sm`` per SM)
without a second wave, and no more than one per ``MIN_SPLIT_KEYS`` keys of
the table. On the card each request then uses only as many of the S splits
as its own keys allow (MIN_SPLIT_KEYS or more each on average); a request
with one split writes its output directly, and the combine launch (S > 1
only) merges the others' partials in split order, so results repeat bit
for bit. ``ref.paged_attention_plan_walk`` walks the same plan on the
host. The kernel takes head_dim 64, 128 or 256 (``HEAD_DIMS``) and raises
for others.

``plan_heads(kv)`` names the KV-head count S is planned from (default: the
arena's).  A tensor-parallel rank's arena holds n_kv / tp heads; the engine
names the whole model's n_kv, so every request splits its keys as at TP=1
and each head's merge runs in the same order (``runtime/tp.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools

import torch

from .ref import (MIN_SPLIT_KEYS, TILE_KEYS, paged_attention_gather,
                  paged_attention_ref)

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None — tests poke this
_USE_KERNEL: contextvars.ContextVar[bool | None] = contextvars.ContextVar(
    "repro_torch_paged_attention_kernel", default=None)
_PLAN_KV: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "repro_torch_paged_attention_plan_kv", default=None)
launches = 0                    # kernel launches (one per wrapper call)
CTAS_PER_SM = 2                 # resident split CTAs per SM (f32 ring 96 KB
#                                 at hd 128; see ctas_per_sm)
HEAD_DIMS = (64, 128, 256)      # head dims the kernel is compiled for
STAGES = 3                      # the kernel's K/V ring slots (kStages)
SMEM_PER_SM = 228 * 1024        # shared memory an SM shares among its CTAs
_LIB = None


def set_forced_path(path: str | None) -> None:
    global _FORCE_PATH
    if path not in (None, "kernel", "ref"):
        raise ValueError(f"unknown path {path!r}")
    _FORCE_PATH = path


@contextlib.contextmanager
def paged_kernel(enabled: bool | None):
    """Scoped kernel-vs-gather toggle (True = the CUDA kernel, False = the
    dense gather, None = by the tensor's device: the kernel on the card,
    its plain block walk on the host).  Nests and unwinds."""
    token = _USE_KERNEL.set(enabled if enabled is None else bool(enabled))
    try:
        yield
    finally:
        _USE_KERNEL.reset(token)


@contextlib.contextmanager
def plan_heads(kv: int | None):
    """Scoped: the KV-head count the kernel's split plan counts (None: the
    arena's own).  Nests and unwinds."""
    token = _PLAN_KV.set(kv)
    try:
        yield
    finally:
        _PLAN_KV.reset(token)


def kernel_enabled() -> bool:
    """Whether the paged attention read resolves to the kernel's path (the
    CUDA kernel, or its plain block walk on the host) rather than the dense
    gather under the current scope, as the reference's ``kernel_enabled``:
    the verify step reads it to pick its order of arena writes and reads."""
    return _FORCE_PATH is not None or _USE_KERNEL.get() is not False


def _resolve(q: torch.Tensor) -> str:
    """"kernel", "ref" (the block walk) or "gather" for a read of ``q``."""
    if _FORCE_PATH is not None:
        use = _FORCE_PATH == "kernel"
    else:
        use = _USE_KERNEL.get()
        if use is False:
            return "gather"
    if use is None:
        use = q.is_cuda
    if use and not q.is_cuda:
        raise RuntimeError("the CUDA kernel path needs tensors on the card")
    return "kernel" if use else "ref"


def paged_attention(q, k_arena, v_arena, block_table, pos, ring_cap, *,
                    window: int | None = None):
    """q (B, W, H, hd) at absolute positions pos-W..pos-1 (K/V already in
    the arena); arenas (N, bs, KV, hd); block_table (B, MB); pos/ring_cap
    (B,) -> (B, W, H, hd).  ``window`` is None or at least 1."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    path = _resolve(q)
    if path == "kernel":
        return paged_attention_cuda(q, k_arena, v_arena, block_table, pos,
                                    ring_cap, window=window)
    plain = paged_attention_gather if path == "gather" else paged_attention_ref
    return plain(q, k_arena, v_arena, block_table, pos, ring_cap,
                 window=window)


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i,
                                        ctypes.c_float, i, i, i, i, p]
        lib.paged_attention.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ctas_per_sm(hd: int, bf16: bool) -> int:
    """Split CTAs resident on an SM at once: CTAS_PER_SM while two of the
    kernel's K/V rings (STAGES x 32 keys of K and V) fit in an SM's shared
    memory, else 1 (hd 256 with an f32 arena: 192 KB a ring)."""
    ring = STAGES * 2 * TILE_KEYS * hd * (2 if bf16 else 4)
    return CTAS_PER_SM if CTAS_PER_SM * ring <= SMEM_PER_SM - 4096 else 1


def kv_splits(b: int, kv: int, mb: int, bs: int, n_sm: int,
              per_sm: int = CTAS_PER_SM) -> int:
    """Grid splits of each request's keys (flash-decoding): as many as keep
    every (request, KV head, split) CTA resident at once (``per_sm`` per
    SM: ``ctas_per_sm`` of the launch's head dim and arena dtype), at most
    one per MIN_SPLIT_KEYS keys of a full table, at least 1."""
    by_slots = per_sm * n_sm // max(b * kv, 1)
    return max(1, min(mb * bs // MIN_SPLIT_KEYS, by_slots))


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
    if hd not in HEAD_DIMS:
        problems.append(f"head_dim {hd} is not one the kernel is compiled "
                        f"for {HEAD_DIMS}")
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
    if any(t.data_ptr() % 16 for t in tensors[:3]):
        problems.append("q and the arenas must be 16-byte aligned")
    if problems:
        raise ValueError("paged_attention_cuda: " + "; ".join(problems))
    out = torch.empty_like(q)
    if b == 0:
        return out
    plan_kv = _PLAN_KV.get() or kv          # see plan_heads
    splits = kv_splits(b, plan_kv, mb, bs, _sm_count(dev.index),
                       ctas_per_sm(hd, k_arena.dtype == torch.bfloat16))
    scratch = ()                # per-split partials, for the combine launch
    if splits > 1:
        rows = (splits, b, kv, w * (h // kv))
        scratch = (torch.empty(rows, dtype=torch.float32, device=dev),
                   torch.empty(rows, dtype=torch.float32, device=dev),
                   torch.empty((*rows, hd), dtype=torch.float32, device=dev))
    m, l, acc = (t.data_ptr() for t in scratch) if scratch else (0, 0, 0)
    with torch.cuda.device(dev):
        err = _lib().paged_attention(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), ring_cap.data_ptr(),
            m, l, acc, out.data_ptr(),
            b, w, h, kv, hd, bs, mb, window if window is not None else 0,
            hd ** -0.5, splits, int(k_arena.dtype == torch.bfloat16),
            TILE_KEYS, MIN_SPLIT_KEYS,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed with CUDA error {err}")
    launches += 1
    return out
