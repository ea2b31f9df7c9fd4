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
and sweeps the S candidate steps over it.  On the H100 a thread-block
cluster of P CTAs (``search_plan``) owns 32 columns, one per lane, and
splits d into P slices (small, so the resident CTAs' slices of w may stay
in L2 across the kernel's three passes): absmax combines across the cluster
through distributed shared memory, one sweep accumulates all S candidates'
<w,v>, <v,v> in registers, the slices' sums combine in cluster-rank order
(so codes and rescales do not vary run to run), and each CTA writes the
codes of its own slice; ``ref.search_walk`` walks the same split on the
host.  Operations bound it (about 10 f32 instructions per element and
candidate): 256-thread CTAs, three per SM, and a division from the
correctly rounded reciprocal (a multiply and two fmas, bit-identical to
IEEE division, no branch) keep the issue slots busy.  The plain version's
scales, division and rounding are kept, so codes agree except where two
candidates' objectives tie to f32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.rabitq import RabitqCodes, candidate_scales

from .ref import quantize_ref

_FORCE_PATH: str | None = None  # "kernel" | "ref" | None (by device)
launches = 0                    # kernel launches (one per wrapper call)
MAX_CANDIDATES = 16             # the kernel keeps 2 S sums in registers
MAX_SLICES = 8                  # the portable thread-block cluster size
MIN_SLICE_ROWS = 128            # rows a slice keeps at least
_LIB = None
_SCALES: dict = {}              # (device, S) -> the candidate scales there


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
    d, c = w.shape
    with kernels.credited("rabitq_quant", d=d, c=c, n_cand=n_candidates):
        if kernels.is_fake(w):
            _check_args(bits, n_candidates)
            codes = w.new_empty((d, c), dtype=torch.uint8)
            rescale = w.new_empty((c,), dtype=torch.float32)
        elif _use_kernel(w):
            codes, rescale = quantize_cuda(w.to(torch.float32).contiguous(),
                                           bits, n_candidates)
        else:
            codes, rescale = quantize_ref(w, bits, n_candidates)
    return RabitqCodes(codes=codes, rescale=rescale, bits=bits)


def cost(d: int, c: int, n_cand: int = 12) -> dict:
    """The work of one call: w read once, codes and rescales written once;
    issue slots on the CUDA cores: per element and candidate the division
    (a multiply and two fmas from the column's reciprocal), the add of
    c_b, rint, the clamp (2), the subtract and the two sums' fmas (10); per
    element absmax (1) and the chosen step's code (8)."""
    from repro_torch.launch import roofline as rl
    work = [[(10 * n_cand + 9) * d * c, rl.SIMT_ISSUE]]
    return {"flops": work[0][0], "bytes": d * c * 4 + d * c + 4 * c,
            "work": work}


def _check_args(bits: int, n_candidates: int) -> None:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    if not 1 <= n_candidates <= MAX_CANDIDATES:
        raise ValueError(f"the kernel searches 1 to {MAX_CANDIDATES} "
                         f"candidate steps, got {n_candidates}")


def search_plan(d: int) -> int:
    """Row slices P of the code search (CTAs per cluster, a power of 2 up to
    8): d is split as far as the portable cluster allows while each slice
    keeps ``MIN_SLICE_ROWS`` rows.  Small slices shrink what the CTAs
    resident on the card read between the kernel's three passes over w
    (396 x 510 rows x 128 B = 26 MB at d 4083; L2 holds 50 MB).  In a
    one-off timing of P = 1, 2, 4, 8 on the H100 (PERF.md §6) eight
    were the fastest at the pipeline's 4096-column weights and close to
    the best at 22016 and 28672 columns, so one plan serves every shape."""
    slices = 1
    while slices < MAX_SLICES and d >= 2 * slices * MIN_SLICE_ROWS:
        slices *= 2
    return slices


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build
        lib = _build.load("rabitq_quant")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rabitq_quant.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.rabitq_quant.restype = ctypes.c_int
        u = ctypes.c_uint
        lib.rabitq_div_sweep.argtypes = [u, u, u, p, p]
        lib.rabitq_div_sweep.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def quantize_cuda(w: torch.Tensor, bits: int, n_candidates: int = 12, *,
                  return_choice: bool = False):
    """The kernel on the card: w (d, c) f32 -> codes (d, c) uint8, rescale
    (c,) f32, and with ``return_choice`` the chosen candidate per column
    (c,) int32."""
    global launches
    _check_args(bits, n_candidates)
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
    slices = search_plan(d)
    key = (str(dev), n_candidates)
    if key not in _SCALES:          # no host copy per call (graph capture)
        _SCALES[key] = torch.from_numpy(candidate_scales(n_candidates)).to(dev)
    scales = _SCALES[key]
    with torch.cuda.device(dev):
        err = _lib().rabitq_quant(
            w.data_ptr(), scales.data_ptr(), codes.data_ptr(),
            rescale.data_ptr(), 0 if choice is None else choice.data_ptr(),
            d, c, bits, n_candidates, slices,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rabitq_quant launch failed with CUDA error {err}")
    launches += 1
    return (codes, rescale, choice) if return_choice else (codes, rescale)


def division_mismatches(device: torch.device, first: int, count: int,
                        stride: int) -> int:
    """Pairs of f32 mantissas (x in all of [1, 2); delta = 1 + (first +
    stride * k) * 2^-23, k < count) where the kernel's division differs
    from IEEE division, counted on the card (``rabitq_div_sweep``)."""
    if first + stride * (count - 1) >= 1 << 23:
        raise ValueError("delta mantissas run past 2^23")
    bad = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().rabitq_div_sweep(
            first, count, stride, bad.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rabitq_div_sweep failed with CUDA error {err}")
    return int(bad)
