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
wrapper launches a rotation (``csrc/fwht.cuh`` under
``hadamard.ops.rotate_plan``: one CTA per row, the butterflies in registers
and warp shuffles with one shared-memory transpose per block, rowsum) that
writes x_rot f32 with rows zero-padded to a multiple of 64, a split-K
dequant GEMM on the tensor cores, and a small
pass that sums the splits in a fixed order (deterministic, so greedy tokens
do not vary run to run) and applies the Alg. 3 epilogue.  The unfused
wrapper launches a row-sum pass (which also writes the padded copy) and the
same GEMM and epilogue on a given x_rot.

The GEMM (``dequant_gemm_kernel``): one CTA covers every row of a group up
to 64 against 256 code columns (``mma.sync`` bf16 -> f32; a cp.async ring;
each x chunk cut in shared memory into three bf16 planes whose sum is x
exactly, ``ref.split_planes``; codes unpacked in registers; ``split_plan``),
so each code byte is read and unpacked once per CTA.  Three exact bf16
products per code make the f32 product.  What bounds it: the code bytes at
decode (n <= 8; 4-bit, d 4083, c 4096: 2.5 us), the three products at a
64-row prefill chunk (6.4 GFLOP at 989 TFLOP/s, 6.5 us).  Code rows are
read in 16-byte chunks, so c must be a multiple of 16.

The grouped form (``grouped_rht_quantized_matmul``, the MoE experts'
GEMM) replaces the reference's ``jax.vmap`` over experts of
``rht_quantized_matmul`` (``repro/kernels/qmatmul/ops.py:121``), which on a
TPU runs the Pallas kernels once per expert.  Here it is the same kernels
with an expert axis: the signs are shared by the experts, so the rotation
(or the unfused path's RHT kernel) runs once over the E*C rows as one
(E*C, d) matrix, and the GEMM folds the expert index into the row-block
axis of its grid, offsetting the packed codes by e*pr*c and x_rot by
e*C*x_ld; the epilogue reads rescale[e].  At decode C is 2 (one n-tile),
at a 64-token prefill chunk 20 (three).

Planning width: every entry takes ``plan_c``, the width the split of d is
planned from (default: the packed codes' own c).  Under tensor
parallelism a rank holds a column slice of a layer and passes the whole
layer's c (``QuantizedLinear.c``), so each column sums the same splits in
the same order as at TP=1 and greedy tokens do not depend on the degree
(``runtime/tp.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

from repro_torch.core import hadamard, packing

from .ref import (grouped_quantized_matmul_ref,
                  grouped_rht_quantized_matmul_ref, quantized_matmul_ref,
                  rht_quantized_matmul_ref)

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
_FUSE_RHT: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_qmatmul_fuse_rht", default=True)
launches = 0                    # fused kernel launches (one per call)
unfused_launches = 0            # quantized_matmul kernel launches
grouped_launches = 0            # grouped fused kernel launches
grouped_unfused_launches = 0    # grouped unfused GEMM kernel launches

# Tiling of the dequant GEMM; must match csrc/rht_qmatmul.cu.
COLS_PER_CTA = 256              # 8 warps x 32 code columns
K_CHUNK = 64                    # d values per staged chunk
N_TILES = (1, 2, 3, 4, 8)       # compiled n-tiles (8 rows each) per CTA
MIN_CHUNKS_PER_SPLIT = 4        # d chunks a split covers at least
# d chunks a split covers at most: the tensor cores' f32 accumulator loses
# precision over a long chain (at n 640 per expert, d 14336 in one split,
# the GEMM missed the 1e-4 tolerance against its plain version), so longer
# d is split and the partials are summed in f32 by the epilogue
MAX_CHUNKS_PER_SPLIT = 32
CTAS_PER_SM = 1                 # CTAs per SM the plan aims at
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
                     rescale: torch.Tensor, *, bits: int, d: int,
                     plan_c: int | None = None) -> torch.Tensor:
    """Estimate X @ (r * (codes - c_b)) for an already-rotated X (..., d)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _use_kernel(x2):
        y = quantized_matmul_cuda(x2.to(torch.float32).contiguous(), packed,
                                  rescale, bits=bits, d=d, plan_c=plan_c)
    else:
        y = quantized_matmul_ref(x2, packed, rescale, bits=bits, d=d)
    return y.reshape(*lead, y.shape[-1])


def rht_quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                         rescale: torch.Tensor, signs1: torch.Tensor,
                         signs2: torch.Tensor | None, *, bits: int,
                         d: int, plan_c: int | None = None) -> torch.Tensor:
    """Estimate practical_rht(X) @ (r * (codes - c_b)) for X (..., d): one
    fused dispatch, or under ``fusion(False)`` the RHT kernel then
    ``quantized_matmul``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not _FUSE_RHT.get():
        from repro_torch.kernels.hadamard import ops as hops  # late: no cycle
        xr = hops.practical_rht(x2.to(torch.float32), signs1, signs2)
        return quantized_matmul(xr, packed, rescale, bits=bits, d=d,
                                plan_c=plan_c).reshape(*lead, -1)
    if _use_kernel(x2):
        y = rht_quantized_matmul_cuda(x2, packed, rescale, signs1, signs2,
                                      bits=bits, d=d, plan_c=plan_c)
    else:
        y = rht_quantized_matmul_ref(x2, packed, rescale, signs1, signs2,
                                     bits=bits, d=d)
    return y.reshape(*lead, y.shape[-1])


def grouped_quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                             rescale: torch.Tensor, *, bits: int, d: int,
                             plan_c: int | None = None) -> torch.Tensor:
    """Per-expert ``quantized_matmul`` on an already-rotated x (E, C, d),
    packed (E, pr, c), rescale (E, c) -> (E, C, c)."""
    if _use_kernel(x):
        return grouped_quantized_matmul_cuda(
            x.to(torch.float32).contiguous(), packed, rescale, bits=bits, d=d,
            plan_c=plan_c)
    return grouped_quantized_matmul_ref(x, packed, rescale, bits=bits, d=d)


def grouped_rht_quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                                 rescale: torch.Tensor, signs1: torch.Tensor,
                                 signs2: torch.Tensor | None, *, bits: int,
                                 d: int,
                                 plan_c: int | None = None) -> torch.Tensor:
    """Per-expert fused estimate: x (E, C, d), packed (E, pr, c), rescale
    (E, c) -> (E, C, c), the signs shared by the experts.  Under
    ``fusion(False)``, as the reference's vmap does, the RHT runs first
    (one RHT kernel over the E*C rows), then the grouped unfused GEMM."""
    e, cap, _ = x.shape
    x = x.to(torch.float32).contiguous()
    if not _FUSE_RHT.get():
        from repro_torch.kernels.hadamard import ops as hops  # late: no cycle
        xr = hops.practical_rht(x.reshape(e * cap, d), signs1, signs2)
        return grouped_quantized_matmul(xr.reshape(e, cap, d), packed,
                                        rescale, bits=bits, d=d,
                                        plan_c=plan_c)
    if _use_kernel(x):
        return grouped_rht_quantized_matmul_cuda(
            x, packed, rescale, signs1, signs2, bits=bits, d=d,
            plan_c=plan_c)
    return grouped_rht_quantized_matmul_ref(x, packed, rescale, signs1,
                                            signs2, bits=bits, d=d)


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("rht_qmatmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rht_qmatmul.argtypes = [p] * 9 + [i] * 12 + [p]
        lib.rht_qmatmul.restype = ctypes.c_int
        lib.qmatmul.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.qmatmul.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def split_plan(n: int, d: int, c: int, n_sm: int, groups: int = 1):
    """(n_tiles, chunks_per_split, splits) for the dequant GEMM of
    ``groups`` experts of n rows each: a CTA covers 8 * n_tiles rows (every
    row of a group up to 64; wider groups take several row blocks), 256
    code columns and ``chunks_per_split`` 64-value chunks of d; splits of d
    are added until about ``CTAS_PER_SM`` CTAs per SM, and until no split
    covers more than ``MAX_CHUNKS_PER_SPLIT`` chunks.  The kernel reads
    code rows in 16-byte chunks, so c must be a multiple of 16."""
    _check_cols(c)
    rows = min(n, 8 * N_TILES[-1])
    nt = next(t for t in N_TILES if 8 * t >= rows)
    chunks = -(-d // K_CHUNK)
    tiles = -(-c // COLS_PER_CTA) * groups * -(-n // (8 * nt))
    want = max(1, -(-CTAS_PER_SM * n_sm // tiles))
    splits = max(1, min(want, chunks // MIN_CHUNKS_PER_SPLIT),
                 -(-chunks // MAX_CHUNKS_PER_SPLIT))
    cps = -(-chunks // splits)
    return nt, cps, -(-chunks // cps)


def _check_cols(c: int) -> None:
    if c % 16:
        raise ValueError(f"c={c}: the GEMM reads code rows in 16-byte chunks, "
                         f"so c must be a multiple of 16")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x: torch.Tensor, packed: torch.Tensor, rescale: torch.Tensor,
            signs1: torch.Tensor | None, signs2: torch.Tensor | None, *,
            bits: int, d: int, groups: int,
            plan_c: int | None = None) -> torch.Tensor:
    """One launch of the GEMM kernels for ``groups`` experts of n rows each
    (groups 1: a plain linear).  x (groups*n, d) f32; packed (groups, pr, c)
    uint8; rescale (groups, c) f16.  With ``signs1`` the fused entry
    (rotation inside), without it the unfused entry (x already rotated).
    The split of d is planned for ``plan_c`` columns where that is wider
    than c (a tensor-parallel slice of a wider layer).  Returns
    (groups*n, c) f32."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the dequant GEMM kernels need CUDA tensors")
    rows = x.shape[0]
    if rows % groups:
        raise ValueError(f"{rows} rows do not split into {groups} groups")
    n = rows // groups
    c = packed.shape[-1]
    prow = packing.packed_rows(d, bits)
    _check(x, "x", torch.float32, (rows, d), dev)
    _check(packed, "packed", torch.uint8, (groups, prow, c), dev)
    _check(rescale, "rescale", torch.float16, (groups, c), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed must start 16-byte aligned (a fresh tensor)")
    fused = signs1 is not None
    d_hat = hadamard.largest_pow2_leq(d)
    if fused:
        _check(signs1, "signs1", torch.float32, (d_hat,), dev)
        if (signs2 is None) != (d_hat == d):
            raise ValueError("signs2 is required exactly when d is not a "
                             "power of 2")
        if signs2 is not None:
            _check(signs2, "signs2", torch.float32, (d_hat,), dev)
        from repro_torch.kernels.hadamard import ops as hops  # late: no cycle
        rot_plan = hops.rotate_plan(d)          # raises past d_hat 16384
    out = torch.empty((rows, c), dtype=torch.float32, device=dev)
    if rows == 0 or c == 0:
        return out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    _check_cols(c)
    n_tiles, cps, splits = split_plan(n, d, max(c, plan_c or 0), n_sm,
                                      groups)
    x_ld = -(-d // K_CHUNK) * K_CHUNK           # zero-padded rows
    xrot = torch.empty((rows, x_ld), dtype=torch.float32, device=dev)
    rowsum = torch.empty((rows,), dtype=torch.float32, device=dev)
    partial = torch.empty((splits, rows, c), dtype=torch.float32, device=dev)
    plan = (bits, n_tiles, cps, splits, x_ld)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if fused:
            s2 = signs2 if signs2 is not None else signs1
            err = _lib().rht_qmatmul(
                x.data_ptr(), signs1.data_ptr(), s2.data_ptr(),
                packed.data_ptr(), rescale.data_ptr(), xrot.data_ptr(),
                rowsum.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
                groups, d, d_hat, c, *plan, *rot_plan, stream)
        else:
            err = _lib().qmatmul(
                x.data_ptr(), packed.data_ptr(), rescale.data_ptr(),
                xrot.data_ptr(), rowsum.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, groups, d, c, *plan, stream)
    if err != 0:
        entry = "rht_qmatmul" if fused else "qmatmul"
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    return out


def rht_quantized_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                              rescale: torch.Tensor, signs1: torch.Tensor,
                              signs2: torch.Tensor | None, *, bits: int,
                              d: int,
                              plan_c: int | None = None) -> torch.Tensor:
    """The kernel on the card: x (n, d) f32, packed (packed_rows(d), c)
    uint8, rescale (c,) f16, signs (d_hat,) f32 -> (n, c) f32."""
    global launches
    out = _launch(x, packed[None], rescale[None], signs1, signs2, bits=bits,
                  d=d, groups=1, plan_c=plan_c)
    launches += 1
    return out


def quantized_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                          rescale: torch.Tensor, *, bits: int, d: int,
                          plan_c: int | None = None) -> torch.Tensor:
    """The unfused kernel on the card: an already-rotated x (n, d) f32,
    packed (packed_rows(d), c) uint8, rescale (c,) f16 -> (n, c) f32."""
    global unfused_launches
    out = _launch(x, packed[None], rescale[None], None, None, bits=bits, d=d,
                  groups=1, plan_c=plan_c)
    unfused_launches += 1
    return out


def grouped_rht_quantized_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                                      rescale: torch.Tensor,
                                      signs1: torch.Tensor,
                                      signs2: torch.Tensor | None, *,
                                      bits: int, d: int,
                                      plan_c: int | None = None
                                      ) -> torch.Tensor:
    """The grouped kernel on the card: x (E, C, d) f32, packed (E, pr, c)
    uint8, rescale (E, c) f16, shared signs (d_hat,) f32 -> (E, C, c)."""
    global grouped_launches
    if x.ndim != 3:
        raise ValueError(f"x must be (E, C, d), got {tuple(x.shape)}")
    e, cap, _ = x.shape
    out = _launch(x.reshape(e * cap, -1), packed, rescale, signs1, signs2,
                  bits=bits, d=d, groups=e, plan_c=plan_c)
    grouped_launches += 1
    return out.reshape(e, cap, -1)


def grouped_quantized_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                                  rescale: torch.Tensor, *, bits: int, d: int,
                                  plan_c: int | None = None) -> torch.Tensor:
    """The grouped unfused kernel on the card: an already-rotated x (E, C,
    d) f32, packed (E, pr, c) uint8, rescale (E, c) f16 -> (E, C, c)."""
    global grouped_unfused_launches
    if x.ndim != 3:
        raise ValueError(f"x must be (E, C, d), got {tuple(x.shape)}")
    e, cap, _ = x.shape
    out = _launch(x.reshape(e * cap, -1), packed, rescale, None, None,
                  bits=bits, d=d, groups=e, plan_c=plan_c)
    grouped_unfused_launches += 1
    return out.reshape(e, cap, -1)
