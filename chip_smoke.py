#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

  1. environment: the card's name and power limit, CUDA version; TF32 off
     (the plain versions are f32 matmuls and must be a full-f32 yardstick);
  2. build: compiles every kernel in ``src/repro_torch/csrc`` with nvcc, one
     process per source, all at once;
  3. kernels vs plain versions on the card, at the main path's shapes, with
     the tolerance stated beside each check, then timed (kernel, plain
     version, one PyTorch library call computing the same function where
     there is one): the fused RHT + dequant GEMM and the unfused GEMM (one
     tensor-core kernel behind both, at decode and prefill row counts, also
     timed at n in {1, 8, 16, 32, 64}), the RHT (rows 1-160, widths up to
     20480, both of its entries: plain rows, and rows padded with their
     sums as the fused GEMM launches it; against its host walk too; two
     calls bitwise equal; an empty kernel timed as the launch floor), the
     RaBitQ code search (two calls bitwise equal; its division held against
     IEEE division on sampled mantissa pairs),
     paged flash-decode (R up to 35, one split and several, two calls
     bitwise equal; timed at llama2's, Mixtral's and a serving mix's
     shapes, f32 and bf16), the grouped (MoE expert) GEMM fused and unfused at
     Mixtral's decode and prefill shapes, and the flash-attention forward
     at Mixtral's and llama2's shapes (also against its host tile walk);
  4. quantize: llama2-7b at its published width (32 layers, d_model 4096,
     32 heads, d_ff 11008, vocab 32000) in fp32, random weights from a
     seeded generator on the card; calibrated on the paper's zero-shot
     sentence (256 tokens), bit widths from AllocateBits at 4.0 average
     bits, every linear RaBitQ-H quantized with the code-search kernel; then
     the same layers again with the code search's plain version, compared
     column by column;
  5. serve: the fp weights dropped, 8 requests through ``PagedServer.run``
     three ways -- fused with the kernels, fused with the plain versions
     forced, and unfused (the RHT kernel, then the unfused GEMM kernel);
     greedy tokens must match; a profile of decode steps and one of
     prefill chunks (device ms by kernel); each run counts the GEMM
     launches of its prefill chunks and of its decode steps;
  6. Mixtral: mixtral-8x7b at its published width (d_model 4096, 32 heads
     over 8 KV heads, 8 experts top-2 of width 14336, capacity factor 1.25,
     window 4096, vocab 32000) with the depth cut to 4 of its 32 layers
     (the reference pipeline calibrates the whole fp32 model, 186 GB at 32
     layers, and one 80 GB card holds 24.3 GB at 4); calibrated, allocated
     (4.0 bits) and quantized with grouped experts, then quantized again
     with the plain code search and compared; the fp weights dropped and
     the 8 requests plus one of 4160 prompt tokens (its window
     ring wraps in prefill and in decode) served fused, with the plain
     versions and unfused; greedy tokens must match;
  7. a ``{"kernels": [...]}`` line (each kernel's launches per path, each
     path's runs counted from zero), the nvidia-smi line, and as the last
     line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --prefill-profile`` runs only the quantization and
the prefill-chunk profiles of both models (see ``prefill_profile_main``);
``python3 chip_smoke.py --attention`` only builds, checks and times the
paged-attention kernel (see ``attention_main``); ``--rotation`` and
``--code-search`` (either or both, with ``--division-sweep`` for the
division on all 2^46 mantissa pairs) the same for the rotation and the
code search (see ``redesign_main``).

Imports nothing of JAX or of the reference package.  Exits non-zero with no
result when no CUDA device is present.  Details too long for the end of the
output go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the package tree to import: this checkout's src/ unless REPRO_TORCH_SRC
# names another (``--prefill-profile`` compares two trees' packages)
SRC = Path(os.environ.get("REPRO_TORCH_SRC", ROOT / "src")).resolve()
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import hadamard, packing, rabitq  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core.qlinear import QuantizedGrouped, draw_signs  # noqa: E402
from repro_torch.core.tricks import centralize  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.hadamard import ops as hops  # noqa: E402
from repro_torch.kernels.hadamard import ref as href  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.kernels.qmatmul.ref import (  # noqa: E402
    grouped_quantized_matmul_ref, grouped_rht_quantized_matmul_ref,
    quantized_matmul_ref, rht_quantized_matmul_ref)
from repro_torch.kernels.rabitq_quant import ops as rq_ops  # noqa: E402
from repro_torch.models import attention as attnmod  # noqa: E402
from repro_torch.models import decode as decmod  # noqa: E402
from repro_torch.models import moe as moemod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

# H100 SXM published dense peaks at 700 W (NVIDIA data sheet): the HBM rate
# and, for a bound's operations, the rate for what their operands are.
HBM_BYTES_PER_S = 3.35e12
RATES = {
    # bf16 x bf16 on the tensor cores
    "bf16 989 TFLOP/s": 989e12,
    # f32 x RaBitQ codes (or x +-1 signs): the codes are integers 0-255,
    # exact in bf16, and three bf16 terms hold an f32 significand
    "f32 x codes 3 x bf16 330 TFLOP/s": 989e12 / 3,
    # f32 x f32: three TF32 products per product
    "f32 3 x TF32 165 TFLOP/s": 495e12 / 3,
    # f32 element-wise work with no product to put on the tensor cores
    "f32 CUDA cores 67 TFLOP/s": 67e12,
    # f32 instructions issued on the CUDA cores, each counted once (the
    # 67 TFLOP/s peak counts an fma as two operations): the code search's
    # candidate sweep, whose division, rounding and clamps are not fmas
    "f32 CUDA-core instructions 33.5 T/s": 67e12 / 2,
}
BF16, CODES, F32, SIMT, SIMT_ISSUE = RATES
# f32 results of two summation orders (split-K and butterfly vs Kronecker
# matmuls for the GEMMs; warp-shuffle vs cuBLAS dots for attention):
# |kernel - plain| <= RTOL * max|plain|.  bf16 arenas are read as the same
# bf16 values by both versions and computed in f32, so the same bound holds.
RTOL = 1e-4
# bf16 flash attention, held element by element.  Against the plain version
# (f32 softmax and P.V from the same bf16 inputs, output rounded to bf16
# once) the kernel differs by the bf16 rounding of P for P.V (about 2^-9 of
# each p, averaging out over a row's keys) and by one output rounding each
# (up to 2^-7 of an element): |kernel - plain| <= BF16_RTOL * |plain| +
# BF16_RTOL * the row's max|plain|, a row being one query's head_dim values.
BF16_RTOL = 1e-2
# Against its host tile walk, which rounds P to bf16 as the kernel does and
# differs only in f32 summation order and exp2: an output rounding may flip
# (an ulp of the element), and now and then a p's bf16 rounding, which
# moves the row by up to 2^-8 * (p / l) * |v| (in a query's first rows, where
# one key carries half the weight, about an ulp of the row's largest
# element): |kernel - walk| <= WALK_ULPS bf16 ulps of the walk's element +
# one bf16 ulp of the row's max|walk|.
WALK_ULPS = 2
# The RHT: butterfly vs Kronecker matmuls, the reference kernel test's atol
# (tests/test_kernels.py:56) on unit-normal rows.
RHT_ATOL = 2e-4
# Code search: in a column where kernel and plain version choose the same
# grid step, codes must be identical and rescales agree to RESCALE_RTOL
# (pass-2 sums vs torch.sum, summation order); a column where they choose
# differently must be a near-tie, the kernel's objective -<w,v>^2/<v,v>
# within OBJ_TIE of the plain version's minimum.
RESCALE_RTOL = 1e-5
OBJ_TIE = 1e-5
# A greedy divergence between two serve runs is accepted only where the
# other run's top-2 logit gap at that step is below this share of the
# step's largest |logit| (f32 reassociation across 32 layers).
GAP_TOL = 1e-3
N_CAND = 12
# the default run checks the code search's division on every x mantissa
# against every DIV_STRIDE-th delta mantissa
DIV_STRIDE = 1024
SEED = 0
AVG_BITS = 4.0
OUT_DIR = ROOT / "chiprun_out"

GEMM_SHAPES = [(4083, 4096), (4083, 22016), (10974, 4096), (4096, 4096)]
# the code search also at Mixtral's weights: an expert's wi and wo (no
# outlier rows are split off the grouped form) and wk/wv over 8 KV heads
SEARCH_SHAPES = GEMM_SHAPES + [(4096, 28672), (14336, 4096), (4083, 1024)]
GEMM_BITS = list(range(1, 9))
# n = 1 and 8 are decode; 16-64 prefill chunks and their remainders, 20 a
# prefill chunk's MoE capacity; 100 takes two 64-row blocks (no path of the
# two models sends more than 64 rows, the wrapper accepts any n)
GEMM_NS = [1, 8, 16, 20, 32, 64, 100]
# rows: decode (llama2 8 slots, Mixtral's E*C = 16), prefill chunks
# (llama2 64, Mixtral 160); widths: llama2's kept 4083 / 10974, Mixtral's
# expert wo 14336, yi-34b's FFN wo 20480, the powers of 2 and 8191 (the
# widest row of plan (256, 16): its shared memory and the static row sums
# just past 48 KB)
RHT_NS = [1, 8, 16, 64, 160]
RHT_DIMS = [2048, 4096, 8192, 16384, 4083, 8191, 10974, 14336, 20480]
RHT_TIMED = [(8, 4083), (8, 10974), (64, 4083), (8, 4096), (8, 16384),
             (16, 4096), (16, 14336), (160, 4096), (160, 14336)]
TIME_SHAPES = [(1, 4083, 4096), (8, 4083, 4096), (8, 4083, 22016),
               (8, 10974, 4096), (64, 4083, 4096), (16, 4083, 4096),
               (32, 4083, 4096)]
# Mixtral's expert GEMMs (E, C, d, c): wi and wo at decode (8 slots, top-2:
# C = 2) and at a 64-token prefill chunk (C = 20)
GROUPED_SHAPES = [(8, 2, 4096, 28672), (8, 2, 14336, 4096),
                  (8, 20, 4096, 28672), (8, 20, 14336, 4096)]
# checked, not timed: more rows per expert than one 64-row block holds
GROUPED_CHECK_SHAPES = GROUPED_SHAPES + [(3, 100, 4083, 1024)]
FLASH_CASES = [  # name, b, s, h, kv, hd, causal, window, dtype
    ("mixtral S=4608 G=4 window 4096", 1, 4608, 32, 8, 128, True, 4096,
     torch.float32),
    ("llama2 S=2048 causal", 1, 2048, 32, 32, 128, True, None,
     torch.float32),
    ("non-causal ragged S=1000 G=4 hd=64", 2, 1000, 8, 2, 64, False, None,
     torch.float32),
    ("bf16 S=2048 G=4 window 1024", 1, 2048, 32, 8, 128, True, 1024,
     torch.bfloat16),
    ("bf16 llama2 S=2048 causal", 1, 2048, 32, 32, 128, True, None,
     torch.bfloat16),
    ("bf16 hd=64 G=4 S=1000 causal", 2, 1000, 8, 2, 64, True, None,
     torch.bfloat16),
    ("f32 window 40 (inside one key tile) G=4", 1, 1000, 8, 2, 128, True, 40,
     torch.float32),
]
FLASH_TIMED = 5                 # the first cases are timed
WALK_MAX_S = 2048               # the host tile walk checks cases up to here
# Mixtral: depth cut to MOE_LAYERS of 32 (widths as published); the extra
# request is longer than the 4096-token window, so its ring wraps
MOE_LAYERS = 4
MOE_LONG_PROMPT = 4160


class SmokeFailure(RuntimeError):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def gpu_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per eager call of ``fn`` (CUDA events; host launch
    overhead included wherever it exceeds the device work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` with host launch overhead removed: the
    ``iters`` calls are captured in one CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cycler(items):
    """Calls a function on each item in turn (cold-L2 timing over copies)."""
    state = {"i": 0}

    def call(fn):
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return fn(*item)
    return call


def bound(nbytes: float, *work: tuple[float, str]) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate for their operands
    (``work``: (operations, rate name) pairs, their times summed)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / RATES[rate] for ops, rate in work)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": " + ".join(dict.fromkeys(
                rate for ops, rate in work if ops))}


def err_and_scale(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    return float((got - want).abs().max()), float(want.abs().max())


# ------------------------------------------------------------ GEMM kernels


def gemm_inputs(gen, dev, n, d, c, bits):
    rows = packing.packed_rows(d, bits)
    hi = 256 if packing.codes_per_byte(bits) > 1 or bits == 8 else 1 << bits
    packed = torch.randint(0, hi, (rows, c), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    rescale = (torch.rand(c, generator=gen, device=dev) * 0.09
               + 0.01).to(torch.float16)
    s1, s2 = draw_signs(d, gen)
    x = torch.randn((n, d), generator=gen, device=dev)
    return x, packed, rescale, s1, s2


def gemm_bound(n, d, c, bits, fused=True):
    dh = hadamard.largest_pow2_leq(d)
    passes = (1 if dh == d else 2) if fused else 0
    nbytes = (n * d * 4 + packing.packed_rows(d, bits) * c + 2 * c
              + passes * dh * 4 + n * c * 4)
    return bound(nbytes, (2 * n * d * c, CODES),
                 (passes * n * dh * (dh.bit_length() - 1), CODES))


def check_gemms(gen, dev) -> dict:
    """Both GEMM entries against their plain versions: bits 1-8 at every
    shape and row count.  The unfused GEMM gets an already-rotated x."""
    worst = dict.fromkeys(("fused", "unfused", "rel"), 0.0)
    for d, c in GEMM_SHAPES:
        for bits in GEMM_BITS:
            for n in GEMM_NS:
                x, packed, rescale, s1, s2 = gemm_inputs(gen, dev, n, d, c,
                                                         bits)
                cases = {
                    "fused": (qops.rht_quantized_matmul_cuda(
                        x, packed, rescale, s1, s2, bits=bits, d=d),
                        rht_quantized_matmul_ref(x, packed, rescale, s1, s2,
                                                 bits=bits, d=d)),
                    "unfused": (qops.quantized_matmul_cuda(
                        x, packed, rescale, bits=bits, d=d),
                        quantized_matmul_ref(x, packed, rescale, bits=bits,
                                             d=d))}
                torch.cuda.synchronize()
                for name, (got, want) in cases.items():
                    err, scale = err_and_scale(got, want)
                    check(bool(torch.isfinite(got).all())
                          and err <= RTOL * scale,
                          f"{name} GEMM n={n} d={d} c={c} bits={bits}: "
                          f"max|err| {err} > {RTOL} * {scale}")
                    worst[name] = max(worst[name], err)
                    worst["rel"] = max(worst["rel"], err / scale)
    n_cases = len(GEMM_SHAPES) * len(GEMM_BITS) * len(GEMM_NS)
    log(f"rht_qmatmul and qmatmul: {n_cases} cases each (bits 1-8, n "
        f"{GEMM_NS}) within {RTOL} * max|plain|; max|err| fused "
        f"{worst['fused']:.3e}, unfused {worst['unfused']:.3e}; largest "
        f"|err|/max|plain| {worst['rel']:.2e}")
    return worst


def time_gemm(gen, dev, n, d, c, bits, fused=True, full=True) -> dict:
    """Kernel, plain and library (torch.matmul on the dense equivalent
    weight) times, cycling over copies so the codes come from HBM.  The
    unfused GEMM's library call multiplies the rotated x by r*(codes-c_b).
    Without ``full`` only the kernel's graph-replay time."""
    x, packed, rescale, s1, s2 = gemm_inputs(gen, dev, n, d, c, bits)
    copies = max(2, int(200e6 // packed.numel()) + 1)
    packs = [packed] + [packed.clone() for _ in range(copies - 1)]
    kern = cycler([(p,) for p in packs])
    if fused:
        def kernel():
            return kern(lambda p: qops.rht_quantized_matmul_cuda(
                x, p, rescale, s1, s2, bits=bits, d=d))

        def plain(p):
            return rht_quantized_matmul_ref(x, p, rescale, s1, s2, bits=bits,
                                            d=d)
    else:
        def kernel():
            return kern(lambda p: qops.quantized_matmul_cuda(
                x, p, rescale, bits=bits, d=d))

        def plain(p):
            return quantized_matmul_ref(x, p, rescale, bits=bits, d=d)
    k_ms = graph_ms(kernel)
    if not full:
        del packs
        return {"n": n, "d": d, "c": c, "bits": bits, "ms": k_ms,
                **gemm_bound(n, d, c, bits, fused)}
    call_ms = time_ms(kernel)
    p_ms = time_ms(lambda: kern(plain), iters=5, warmup=1)
    codes = packing.unpack_codes(packed, bits, d).to(torch.float32)
    w_eff = (codes - ((1 << bits) - 1) / 2.0) * rescale.float()[None, :]
    if fused:
        w_eff = hadamard.practical_rht_inverse(w_eff, s1, s2, axis=0)
    del codes
    dense = [w_eff] + [w_eff.clone() for _ in range(2)]
    lib = cycler([(w,) for w in dense])
    l_ms = graph_ms(lambda: lib(lambda w: torch.matmul(x, w)))
    del dense, packs, w_eff
    return {"n": n, "d": d, "c": c, "bits": bits, "ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "library_ms": l_ms,
            **gemm_bound(n, d, c, bits, fused)}


# --------------------------------------------------------------------- RHT


def check_rht(gen, dev) -> dict:
    """The rotation at every RHT_NS x RHT_DIMS case: both entries (out_ld =
    d; and rows padded to the GEMM's multiple of 64 with the row sums, as
    the fused GEMM launches it) within RHT_ATOL of the plain version, the
    padding exactly zero, each row sum within RHT_ATOL of the f64 sum of
    the rotated row it came with, two calls bitwise equal, and the kernel
    against its host walk of the same stages (ref.rotate_walk, on the card)."""
    worst = dict.fromkeys(("err", "rowsum_err", "walk_err"), 0.0)
    walk_equal = 0
    for n in RHT_NS:
        for d in RHT_DIMS:
            x = torch.randn((n, d), generator=gen, device=dev)
            s1, s2 = draw_signs(d, gen)
            out_ld = -(-d // qops.K_CHUNK) * qops.K_CHUNK
            got = hops.rht_cuda(x, s1, s2)
            padded, rowsum = hops.rht_padded_cuda(x, s1, s2, out_ld)
            again, again_sum = hops.rht_padded_cuda(x, s1, s2, out_ld)
            want = hadamard.practical_rht(x, s1, s2)
            walk, walk_sum = href.rotate_walk(x, s1, s2, *hops.rotate_plan(d),
                                              out_ld=out_ld)
            torch.cuda.synchronize()
            err = max(float((got - want).abs().max()),
                      float((padded[:, :d] - want).abs().max()))
            sum_err = float((rowsum.double()
                             - padded[:, :d].double().sum(1)).abs().max())
            walk_err = max(float((padded - walk).abs().max()),
                           float((rowsum - walk_sum).abs().max()))
            what = f"rht n={n} d={d}"
            check(bool(torch.isfinite(got).all()) and err <= RHT_ATOL,
                  f"{what}: max|err| {err} > {RHT_ATOL}")
            check(bool((padded[:, d:] == 0).all()),
                  f"{what}: padding past d is not zero")
            check(sum_err <= RHT_ATOL,
                  f"{what}: row sum off by {sum_err} > {RHT_ATOL}")
            check(torch.equal(padded, again) and torch.equal(rowsum, again_sum)
                  and torch.equal(got, padded[:, :d]),
                  f"{what}: two calls (or the two entries) differ")
            check(walk_err <= RHT_ATOL,
                  f"{what}: kernel vs its host walk {walk_err} > {RHT_ATOL}")
            walk_equal += bool(walk_err == 0.0)
            for k, v in (("err", err), ("rowsum_err", sum_err),
                         ("walk_err", walk_err)):
                worst[k] = max(worst[k], v)
    cases = len(RHT_NS) * len(RHT_DIMS)
    log(f"rht: {cases} cases (n {RHT_NS} x d {RHT_DIMS}), both entries "
        f"within atol {RHT_ATOL} (max|err| {worst['err']:.3e}); padding "
        f"zero; row sums within {RHT_ATOL} of the rows' f64 sums (max "
        f"{worst['rowsum_err']:.3e}); two calls bitwise equal; the host walk "
        f"bitwise equal in {walk_equal} of {cases} cases (max|diff| "
        f"{worst['walk_err']:.3e})")
    return {**worst, "cases": cases, "walk_bitwise_equal": walk_equal}


def time_rht(gen, dev, n, d, full=True) -> dict:
    """Kernel times by graph replay (``padded_ms``: the rotation as the
    fused GEMM launches it, rows padded to a multiple of 64 with their sums;
    absent from an earlier tree); with ``full`` also eager calls, the plain
    version and the library call, which multiplies x by the dense (d, d)
    matrix of the same linear map (practical_rht of the identity)."""
    x = torch.randn((n, d), generator=gen, device=dev)
    s1, s2 = draw_signs(d, gen)
    out = {"n": n, "d": d,
           "ms": graph_ms(lambda: hops.rht_cuda(x, s1, s2))}
    if hasattr(hops, "rht_padded_cuda"):
        out_ld = -(-d // qops.K_CHUNK) * qops.K_CHUNK
        out["plan"] = hops.rotate_plan(d)
        out["padded_ms"] = graph_ms(
            lambda: hops.rht_padded_cuda(x, s1, s2, out_ld))
    if full:
        out["call_ms"] = time_ms(lambda: hops.rht_cuda(x, s1, s2))
        out["plain_ms"] = time_ms(lambda: hadamard.practical_rht(x, s1, s2),
                                  iters=5, warmup=1)
        m = hadamard.practical_rht(torch.eye(d, device=dev), s1, s2)
        out["library_ms"] = graph_ms(lambda: torch.matmul(x, m))
        del m
    return {**out, **rht_bound(n, d)}


def rht_bound(n, d) -> dict:
    """Each row read and written once and the signs read once; the
    butterflies' adds (each of the two blocks' log2 d_hat stages) as
    products with +-1 signs on the tensor cores' f32 x codes rate."""
    dh = hadamard.largest_pow2_leq(d)
    passes = 1 if dh == d else 2
    return bound(2 * n * d * 4 + passes * dh * 4,
                 (passes * n * dh * (dh.bit_length() - 1), CODES))


def launch_floor_ms(dev) -> float:
    """Device time of an empty kernel's launch under graph replay: the
    least a launch costs on this card."""
    return graph_ms(lambda: hops.launch_floor(dev), iters=100)


# -------------------------------------------------------------- code search


def plain_objectives(w: torch.Tensor, bits: int) -> torch.Tensor:
    """(S, c) objectives -<w,v>^2/<v,v> of every candidate step, computed as
    the plain version computes them."""
    levels = (1 << bits) - 1
    c_b = levels / 2.0
    absmax = torch.amax(torch.abs(w), dim=0)
    delta0 = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, c_b)
    scales = torch.from_numpy(rabitq.candidate_scales(N_CAND)).to(w.device)
    errs = []
    for s in scales:
        v = torch.clamp(torch.round(w / (delta0 * s) + c_b), 0.0,
                        float(levels)) - c_b
        wv, vv = torch.sum(w * v, dim=0), torch.sum(v * v, dim=0)
        errs.append(-(wv * wv) / torch.clamp(vv, min=1e-30))
    return torch.stack(errs)


def compare_search(w, codes, rescale, choice, bits) -> dict:
    """Kernel output (codes, rescale, choice) against the plain version on
    the same w: identical codes and close rescales where the choice agrees,
    a near-tie where it does not."""
    pc, pr = rq_ops.quantize_ref(w, bits, N_CAND)
    errs = plain_objectives(w, bits)
    best = torch.argmin(errs, dim=0)
    same = choice.to(torch.int64) == best
    cols_equal = (codes == pc).all(dim=0)
    check(bool(cols_equal[same].all()),
          f"code search bits={bits}: codes differ in a column where the "
          f"kernel and the plain version chose the same step")
    rel = ((rescale - pr).abs() / pr.abs().clamp(min=1e-30))[same]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    check(rel_max <= RESCALE_RTOL,
          f"code search bits={bits}: rescale rel err {rel_max} > "
          f"{RESCALE_RTOL}")
    n_diff = int((~same).sum())
    gap = 0.0
    if n_diff:
        e_kernel = errs.gather(0, choice.to(torch.int64)[None])[0][~same]
        e_min = errs.min(dim=0).values[~same]
        gap = float(((e_kernel - e_min).abs() / e_min.abs()).max())
        check(gap <= OBJ_TIE, f"code search bits={bits}: a differing column "
              f"is not a near-tie (objective gap {gap} > {OBJ_TIE})")
    return {"differing_columns": n_diff, "max_objective_gap": gap,
            "max_rescale_abs_err": float((rescale - pr).abs()[same].max())
            if same.any() else 0.0,
            "max_rescale_rel_err": rel_max}


def check_code_search(gen, dev) -> dict:
    # the plain version gives the same codes on the card as on the host
    # (it divides by tensors: CUDA PyTorch turns a scalar divisor into a
    # reciprocal multiply, an ulp off)
    w = torch.randn((4083, 512), generator=gen, device=dev)
    for bits in (3, 4):
        on_card = rabitq.quantize(w, bits)
        on_host = rabitq.quantize(w.cpu(), bits)
        check(torch.equal(on_card.codes.cpu(), on_host.codes),
              f"plain code search, bits={bits}: codes differ card vs host")
    scalar_div = torch.clamp(w.abs().amax(0), min=1e-30) / 7.5
    tensor_div = (torch.clamp(w.abs().amax(0), min=1e-30)
                  / torch.full((512,), 7.5, device=dev))
    out = {"differing_columns": 0, "columns": 0, "max_objective_gap": 0.0,
           "max_rescale_abs_err": 0.0, "max_rescale_rel_err": 0.0,
           "scalar_vs_tensor_division_differ":
               int((scalar_div != tensor_div).sum())}
    for d, c in SEARCH_SHAPES:
        # columns of different scale, as rotated weights have
        w = (torch.randn((d, c), generator=gen, device=dev)
             * (torch.rand((1, c), generator=gen, device=dev) + 0.1))
        for bits in GEMM_BITS:
            codes, rescale, choice = rq_ops.quantize_cuda(
                w, bits, N_CAND, return_choice=True)
            again = rq_ops.quantize_cuda(w, bits, N_CAND, return_choice=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(
                (codes, rescale, choice), again)),
                f"code search d={d} c={c} bits={bits}: two calls differ")
            res = compare_search(w, codes, rescale, choice, bits)
            out["differing_columns"] += res["differing_columns"]
            out["columns"] += c
            for k in ("max_objective_gap", "max_rescale_abs_err",
                      "max_rescale_rel_err"):
                out[k] = max(out[k], res[k])
        del w
    # the kernel's division against IEEE division: every x mantissa in
    # [1, 2) against every DIV_STRIDE-th delta mantissa (chip_smoke.py
    # --division-sweep takes all 2^23)
    out["division_pairs"] = (1 << 23) * ((1 << 23) // DIV_STRIDE)
    out["division_mismatches"] = rq_ops.division_mismatches(
        dev, 0, (1 << 23) // DIV_STRIDE, DIV_STRIDE)
    check(out["division_mismatches"] == 0,
          f"code search: the reciprocal division differs from IEEE division "
          f"in {out['division_mismatches']} of {out['division_pairs']} pairs")
    out["slices"] = {f"{d}x{c}": rq_ops.search_plan(d)
                     for d, c in SEARCH_SHAPES}
    log(f"rabitq_quant: {len(SEARCH_SHAPES) * len(GEMM_BITS)} cases ((d, c) "
        f"{SEARCH_SHAPES} x bits 1-8, slices {out['slices']}); two calls "
        f"bitwise equal; division bitwise IEEE on {out['division_pairs']} "
        f"mantissa pairs; codes identical where the step agrees; "
        f"{out['differing_columns']} of {out['columns']} columns chose "
        f"another step, all near-ties (max objective gap "
        f"{out['max_objective_gap']:.2e} <= {OBJ_TIE}); rescale max rel err "
        f"{out['max_rescale_rel_err']:.2e}; plain version identical on card "
        f"and host; absmax / 7.5 by scalar vs by tensor differ in "
        f"{out['scalar_vs_tensor_division_differ']} of 512 columns")
    return out


def search_bound(d, c):
    """w read once, codes written once; issue slots on the CUDA cores: per
    element and candidate the division (a multiply and two fmas from the
    column's reciprocal), the add of c_b, rint, the clamp (2), the subtract
    and the two sums' fmas (10); per element absmax (1) and the chosen
    step's code (8)."""
    return bound(d * c * 4 + d * c + 4 * c,
                 ((10 * N_CAND + 9) * d * c, SIMT_ISSUE))


def time_code_search(gen, dev, d, c, bits=4, plain=True) -> dict:
    """Kernel and plain times at one weight shape (w is 67-470 MB, past
    L2).  ``ms`` is CUDA-graph replay where the wrapper can be captured (an
    earlier tree's copies its scales to the card on every call: there
    ``ms`` is ``call_ms``, eager calls timed back to back)."""
    w = torch.randn((d, c), generator=gen, device=dev)

    def kernel():
        return rq_ops.quantize_cuda(w, bits, N_CAND)
    planned = hasattr(rq_ops, "search_plan")
    call_ms = time_ms(kernel, iters=5, warmup=1)
    k_ms = graph_ms(kernel, iters=5) if planned else call_ms
    # one candidate: the three passes over w with almost no sweep
    one_ms = (graph_ms(lambda: rq_ops.quantize_cuda(w, bits, 1), iters=5)
              if planned else None)
    p_ms = (time_ms(lambda: rq_ops.quantize_ref(w, bits, N_CAND), iters=3,
                    warmup=1) if plain else None)
    del w
    return {"d": d, "c": c, "bits": bits,
            "slices": rq_ops.search_plan(d) if planned else None, "ms": k_ms,
            "ms_by": "graph replay" if planned else "eager calls",
            "call_ms": call_ms, "one_candidate_ms": one_ms,
            "plain_ms": p_ms, "library_ms": None,
            **search_bound(d, c)}


# ------------------------------------------------------- paged attention


def attn_inputs(gen, dev, b, w, h, kv, hd, bs, mb, ctx_max, dtype, window,
                ring_blocks=None, full=False, ctx_lo=None):
    """Paged-attention inputs: every slot's ring of ``ring_blocks`` blocks
    (default the whole table) full; positions drawn from [w, ctx_max], all
    ctx_max (``full``), or spread evenly over [ctx_lo, ctx_max]."""
    ring_blocks = ring_blocks or mb
    n_phys = 1 + b * ring_blocks
    k = torch.randn((n_phys, bs, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((n_phys, bs, kv, hd), generator=gen, device=dev).to(dtype)
    q = torch.randn((b, w, h, hd), generator=gen, device=dev)
    bt = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    bt[:, :ring_blocks] = torch.arange(1, n_phys, device=dev,
                                       dtype=torch.int32).reshape(b, ring_blocks)
    ring = torch.full((b,), ring_blocks * bs, dtype=torch.int32, device=dev)
    if full:
        pos = torch.full((b,), ctx_max, dtype=torch.int32, device=dev)
    elif ctx_lo is not None:
        pos = torch.linspace(ctx_lo, ctx_max, b, device=dev).round().to(
            torch.int32)
    else:
        pos = torch.randint(w, ctx_max + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    return q, k, v, bt, pos, ring


ATTN_CASES = [  # name, w, h, kv, dtype, window, ring_blocks, ctx_max, ctx_lo
    ("f32 W=1", 1, 32, 32, torch.float32, None, None, 1024, None),
    ("bf16 W=1", 1, 32, 32, torch.bfloat16, None, None, 1024, None),
    ("f32 W=3", 3, 32, 32, torch.float32, None, None, 1024, None),
    ("bf16 W=3 G=4", 3, 32, 8, torch.bfloat16, None, None, 1024, None),
    ("f32 window 200, ring of 16 blocks wrapped", 1, 32, 32, torch.float32,
     200, 16, 1024, None),
    ("f32 G=4", 1, 32, 8, torch.float32, None, None, 1024, None),
    # Mixtral's decode: G = 4, window 4096 over a 256-block ring; positions
    # 3900-4192 (the long request's context), the last three past the ring
    ("mixtral f32 G=4 window 4096, ring of 256 blocks", 1, 32, 8,
     torch.float32, 4096, 256, 4192, 3900),
    # a verify span of 5 over G = 7: R = 35 rows, in row chunks of 8
    ("f32 R=35: W=5, H=56, KV=8", 5, 56, 8, torch.float32, None, None, 1024,
     None),
    # contexts 20-240 under a grid of four splits: every request keeps one
    # split (under 2 x 128 keys) and writes its output directly, and the
    # combine launch skips its rows
    ("f32 G=4 one split per request (contexts 20-240)", 1, 32, 8,
     torch.float32, None, None, 240, 20),
]
# timed: name, w, h, kv, dtype, window, ring_blocks, table width, ctx_max,
# ctx_lo (None: every request at ctx_max)
ATTN_TIMED = [
    ("llama2 f32 B=8 ctx 1024", 1, 32, 32, torch.float32, None, None, 64,
     1024, None),
    ("llama2 bf16 B=8 ctx 1024", 1, 32, 32, torch.bfloat16, None, None, 64,
     1024, None),
    ("mixtral f32 B=8 G=4 window 4096, pos 3900-4192", 1, 32, 8,
     torch.float32, 4096, 256, 256, 4192, 3900),
    # the llama2 serve run's shape: 8 requests at contexts 128-544 over a
    # 34-block table (prompts 64-512 + 32 new tokens)
    ("serving mix f32 B=8 ctx 128-544", 1, 32, 32, torch.float32, None,
     None, 34, 544, 128),
]


def attn_splits(args) -> int | None:
    """The grid splits the wrapper picks for these inputs; None for a
    package tree whose wrapper plans otherwise (an earlier tree given by
    REPRO_TORCH_SRC)."""
    if not hasattr(pops, "MIN_SPLIT_KEYS"):
        return None
    q, k, _, bt = args[:4]
    return pops.kv_splits(q.shape[0], k.shape[2], bt.shape[1], k.shape[1],
                          torch.cuda.get_device_properties(
                              q.device).multi_processor_count)


def check_attention(gen, dev) -> dict:
    """Every ATTN_CASES case against the plain version (|err| <= RTOL *
    max|plain|), an inactive slot, and determinism: two calls on the same
    inputs, with one split and with the combine, give equal bits."""
    worst = 0.0
    cases = []
    b, hd, bs = 8, 128, 16
    for name, w, h, kv, dtype, window, ring_blocks, ctx, ctx_lo in ATTN_CASES:
        mb = max(64, ring_blocks or 0)           # the block table's width
        args = attn_inputs(gen, dev, b, w, h, kv, hd, bs, mb, ctx, dtype,
                           window, ring_blocks, ctx_lo=ctx_lo)
        got = pops.paged_attention_cuda(*args, window=window)
        want = paged_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        err, scale = err_and_scale(got, want)
        check(bool(torch.isfinite(got).all()) and err <= RTOL * scale,
              f"paged_attention {name}: max|err| {err} > {RTOL} * {scale}")
        worst = max(worst, err)
        cases.append({"case": name, "splits": attn_splits(args),
                      "max_abs_err": err, "max_abs_plain": scale})
        if name in ("f32 W=1", "f32 G=4"):    # one split; four and combine
            again = pops.paged_attention_cuda(*args, window=window)
            check(torch.equal(got, again),
                  f"paged_attention {name}: two calls differ")
    # an inactive engine slot: pos 0, ring 1, all-zero table -> null block
    q, k, v, bt, pos, ring = attn_inputs(gen, dev, 2, 1, 32, 32, hd, bs, 4,
                                         64, torch.float32, None)
    bt[1], pos[1], ring[1] = 0, 0, 1
    got = pops.paged_attention_cuda(q, k, v, bt, pos, ring)
    check(bool(torch.isfinite(got).all()), "inactive slot gave non-finite")
    log(f"paged_attention: {len(ATTN_CASES)} cases + an inactive slot within "
        f"{RTOL} * max|plain|, two cases bitwise repeatable; max|err| "
        f"{worst:.3e}; splits {[c['splits'] for c in cases]}")
    return {"max_abs_err": worst, "cases": cases, "deterministic": True}


def sdpa_decode(q, k_arena, v_arena, bt, pos, ring):
    """One PyTorch call computing the same decode attention on K/V already
    gathered dense (timing only): (B, H, W=1, hd) queries over each
    request's min(pos, ring) live keys, a key-padding mask where the
    requests differ."""
    b, _, h, hd = q.shape
    _, bs, kv, _ = k_arena.shape
    live = torch.minimum(pos.clamp(min=1), ring.clamp(min=1))
    nb = int((live.max() + bs - 1) // bs)
    kd = k_arena[bt[:, :nb].long()].reshape(b, nb * bs, kv, hd).transpose(
        1, 2).contiguous()
    vd = v_arena[bt[:, :nb].long()].reshape(b, nb * bs, kv, hd).transpose(
        1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous().to(kd.dtype)
    mask = None
    if bool((live != nb * bs).any()):
        mask = (torch.arange(nb * bs, device=q.device)[None, :]
                < live[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=kv != h)


def time_attention(gen, dev, name, w, h, kv, dtype, window, ring_blocks, mb,
                   ctx, ctx_lo) -> dict:
    """One ATTN_TIMED case: the kernel (graph replay and eager), its plain
    version, SDPA on the gathered K/V, and the bound of the keys read."""
    b, hd, bs = 8, 128, 16
    args = attn_inputs(gen, dev, b, w, h, kv, hd, bs, mb, ctx, dtype,
                       window, ring_blocks, full=ctx_lo is None,
                       ctx_lo=ctx_lo)
    q, k_arena, v_arena, bt, pos, ring = args
    k_ms = graph_ms(lambda: pops.paged_attention_cuda(*args, window=window))
    call_ms = time_ms(lambda: pops.paged_attention_cuda(*args,
                                                        window=window))
    p_ms = time_ms(lambda: paged_attention_ref(*args, window=window),
                   iters=3, warmup=1)
    l_ms = graph_ms(sdpa_decode(*args))
    # the keys the kernel reads: each request's nblk whole blocks
    live = torch.minimum(pos.clamp(min=1), ring.clamp(min=1))
    keys = int((((live + bs - 1) // bs).clamp(1, mb) * bs).sum())
    nbytes = (keys * kv * hd * k_arena.element_size() * 2
              + 2 * q.numel() * 4 + bt.numel() * 4)
    return {"case": name, "b": b, "w": w, "h": h, "kv": kv, "hd": hd,
            "dtype": str(dtype), "window": window, "context": ctx,
            "context_lo": ctx_lo, "keys_read": keys,
            "splits": attn_splits(args), "ms": k_ms, "call_ms": call_ms,
            "plain_ms": p_ms, "library_ms": l_ms,
            **bound(nbytes, (4 * keys * (h // kv) * w * kv * hd, SIMT))}


def time_attentions(gen, dev) -> list:
    rows = [time_attention(gen, dev, *case) for case in ATTN_TIMED]
    for t in rows:
        log(f"paged_attention time {json.dumps(t)}")
    return rows


# ------------------------------------------------------ grouped (MoE) GEMM


def grouped_inputs(gen, dev, e, cap, d, c, bits):
    """Random codes, rescales and signs for E experts; each expert's last
    capacity row is zero, as dispatch leaves an unfilled row."""
    rows = packing.packed_rows(d, bits)
    hi = 256 if packing.codes_per_byte(bits) > 1 or bits == 8 else 1 << bits
    packed = torch.randint(0, hi, (e, rows, c), generator=gen, device=dev,
                           dtype=torch.uint8)
    rescale = (torch.rand((e, c), generator=gen, device=dev) * 0.09
               + 0.01).to(torch.float16)
    s1, s2 = draw_signs(d, gen)
    x = torch.randn((e, cap, d), generator=gen, device=dev)
    x[:, -1] = 0.0
    return x, packed, rescale, s1, s2


def grouped_bound(e, cap, d, c, bits, fused=True):
    dh = hadamard.largest_pow2_leq(d)
    passes = (1 if dh == d else 2) if fused else 0
    nbytes = (e * cap * d * 4 + e * packing.packed_rows(d, bits) * c
              + e * c * 2 + passes * dh * 4 + e * cap * c * 4)
    return bound(nbytes, (2 * e * cap * d * c, CODES),
                 (passes * e * cap * dh * (dh.bit_length() - 1), CODES))


def check_grouped(gen, dev) -> tuple[float, float]:
    """The grouped GEMM kernels against their plain versions (the
    reference's vmap over experts written out), bits 1-8 at Mixtral's
    shapes: the fused entry, the unfused entry on an already-rotated x, and
    the unfused dispatch (RHT kernel over the E*C rows, then the grouped
    GEMM) against the fused plain version.  A zero row must come out 0."""
    worst = {"fused": 0.0, "unfused": 0.0}
    for e, cap, d, c in GROUPED_CHECK_SHAPES:
        for bits in GEMM_BITS:
            x, packed, rescale, s1, s2 = grouped_inputs(gen, dev, e, cap, d,
                                                        c, bits)
            want = grouped_rht_quantized_matmul_ref(x, packed, rescale, s1,
                                                    s2, bits=bits, d=d)
            with qops.fusion(False):
                dispatched = qops.grouped_rht_quantized_matmul(
                    x, packed, rescale, s1, s2, bits=bits, d=d)
            cases = {
                "fused": (qops.grouped_rht_quantized_matmul_cuda(
                    x, packed, rescale, s1, s2, bits=bits, d=d), want),
                "unfused": (qops.grouped_quantized_matmul_cuda(
                    x, packed, rescale, bits=bits, d=d),
                    grouped_quantized_matmul_ref(x, packed, rescale,
                                                 bits=bits, d=d)),
                "unfused dispatch": (dispatched, want)}
            torch.cuda.synchronize()
            for name, (got, ref) in cases.items():
                err, scale = err_and_scale(got, ref)
                check(bool(torch.isfinite(got).all()) and err <= RTOL * scale
                      and not got[:, -1].any(),
                      f"grouped {name} E={e} C={cap} d={d} c={c} bits={bits}:"
                      f" max|err| {err} > {RTOL} * {scale} or a zero row "
                      f"gave a non-zero output")
                key = "fused" if name == "fused" else "unfused"
                worst[key] = max(worst[key], err)
            del x, packed, want, cases, dispatched
    n_cases = len(GROUPED_CHECK_SHAPES) * len(GEMM_BITS)
    log(f"grouped rht_qmatmul and qmatmul: {n_cases} cases each (bits 1-8 x "
        f"(E, C, d, c) {GROUPED_CHECK_SHAPES}) plus the unfused dispatch, "
        f"within {RTOL} * max|plain|, zero rows exact; max|err| fused "
        f"{worst['fused']:.3e}, unfused {worst['unfused']:.3e}")
    return worst["fused"], worst["unfused"]


def time_grouped(gen, dev, e, cap, d, c, bits=4, fused=True) -> dict:
    """Kernel, plain and library times; the library call is torch.bmm with
    the dense f32 (E, d, c) equivalent weights (timing only).  The codes of
    one call exceed the 50 MB L2, so every replay reads them from HBM."""
    x, packed, rescale, s1, s2 = grouped_inputs(gen, dev, e, cap, d, c, bits)
    if fused:
        def kernel():
            return qops.grouped_rht_quantized_matmul_cuda(
                x, packed, rescale, s1, s2, bits=bits, d=d)

        def plain():
            return grouped_rht_quantized_matmul_ref(x, packed, rescale, s1,
                                                    s2, bits=bits, d=d)
    else:
        def kernel():
            return qops.grouped_quantized_matmul_cuda(x, packed, rescale,
                                                      bits=bits, d=d)

        def plain():
            return grouped_quantized_matmul_ref(x, packed, rescale, bits=bits,
                                                d=d)
    k_ms = graph_ms(kernel)
    call_ms = time_ms(kernel)
    p_ms = time_ms(plain, iters=3, warmup=1)
    dense = torch.empty((e, d, c), dtype=torch.float32, device=dev)
    c_b = ((1 << bits) - 1) / 2.0
    for i in range(e):
        w = ((packing.unpack_codes(packed[i], bits, d).to(torch.float32) - c_b)
             * rescale[i].float()[None, :])
        dense[i] = (hadamard.practical_rht_inverse(w, s1, s2, axis=0)
                    if fused else w)
        del w
    l_ms = graph_ms(lambda: torch.bmm(x, dense), iters=10)
    del dense, packed, x
    return {"e": e, "cap": cap, "d": d, "c": c, "bits": bits, "ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "library_ms": l_ms,
            **grouped_bound(e, cap, d, c, bits, fused)}


# --------------------------------------------------------- flash attention


def flash_inputs(gen, dev, b, s, h, kv, hd, dtype):
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def flash_pairs(s, causal, window) -> int:
    """Unmasked (query, key) pairs of one head: the work this call needs."""
    q = np.arange(s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, s)
    return int(np.sum(hi - lo))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significand bits); 0 at 0."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def flash_limit(want: torch.Tensor, bf16: bool, walk: bool) -> torch.Tensor:
    """Each element's allowed |kernel - want| (see RTOL, BF16_RTOL,
    WALK_ULPS); ``want`` in f32."""
    if not bf16:
        return torch.full_like(want, RTOL * float(want.abs().max()))
    row_max = want.abs().amax(-1, keepdim=True)
    if walk:
        return WALK_ULPS * bf16_ulp(want) + bf16_ulp(row_max)
    return BF16_RTOL * (want.abs() + row_max)


def check_flash(gen, dev) -> dict:
    """The flash-attention kernel against its plain version (the port's
    sequence attention) and, up to S = WALK_MAX_S, against the host walk of
    its own tiles (``flash_tile_walk``): in f32 |kernel - other| <= RTOL *
    max|other|; in bf16 element by element (BF16_RTOL against the plain
    version, WALK_ULPS bf16 ulps against the walk).  Reports each
    comparison's max|err| and largest share of its limit."""
    from repro_torch.kernels.flash_attention.ref import flash_tile_walk
    worst = {f"{p}{t}{m}": 0.0 for p in ("", "walk_") for t in ("f32", "bf16")
             for m in ("", "_share")}
    for name, b, s, h, kv, hd, causal, window, dtype in FLASH_CASES:
        q, k, v = flash_inputs(gen, dev, b, s, h, kv, hd, dtype)
        got = fops.flash_attention_cuda(q, k, v, causal=causal, window=window)
        wants = {"": attention_ref(q, k, v, causal=causal, window=window)}
        if s <= WALK_MAX_S:
            wants["walk_"] = flash_tile_walk(q, k, v, causal=causal,
                                             window=window)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        for prefix, want in wants.items():
            want = want.float()
            err = (got.float() - want).abs()
            share = float((err / flash_limit(want, bf16, bool(prefix))).max())
            check(got.dtype == dtype and bool(torch.isfinite(got).all())
                  and share <= 1.0,
                  f"flash_attention {name} vs {prefix or 'plain '}: an "
                  f"element's |err| is {share:.3f} of its limit (max|err| "
                  f"{float(err.max())})")
            key = prefix + ("bf16" if bf16 else "f32")
            worst[key] = max(worst[key], float(err.max()))
            worst[key + "_share"] = max(worst[key + "_share"], share)
        del q, k, v, got, wants
    log(f"flash_attention: {len(FLASH_CASES)} cases; f32 within {RTOL} * "
        f"max|plain|, bf16 element by element within {BF16_RTOL} * (|plain| "
        f"+ row max|plain|) and {WALK_ULPS} bf16 ulps + one ulp of the row's "
        f"max|walk| of the host tile walk (S <= {WALK_MAX_S}); max|err| "
        f"(share of limit) f32 {worst['f32']:.3e} ({worst['f32_share']:.3f}),"
        f" bf16 {worst['bf16']:.3e} ({worst['bf16_share']:.3f}); walk f32 "
        f"{worst['walk_f32']:.3e} ({worst['walk_f32_share']:.3f}), bf16 "
        f"{worst['walk_bf16']:.3e} ({worst['walk_bf16_share']:.3f})")
    return worst


def sdpa(q, k, v, causal, window):
    """One PyTorch call computing the same attention (timing only)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = q.shape[1]
    mask = None
    if window is not None:
        pos = torch.arange(s, device=q.device)
        mask = (pos[:, None] - pos[None, :]) < window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=kt.shape[1] != qt.shape[1])


def time_flash(gen, dev, name, b, s, h, kv, hd, causal, window, dtype) -> dict:
    q, k, v = flash_inputs(gen, dev, b, s, h, kv, hd, dtype)
    k_ms = graph_ms(lambda: fops.flash_attention_cuda(
        q, k, v, causal=causal, window=window), iters=5)
    p_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal,
                                         window=window), iters=2, warmup=1)
    l_ms = graph_ms(lambda: sdpa(q, k, v, causal, window), iters=5)
    pairs = flash_pairs(s, causal, window)
    work = bound((q.numel() * 2 + k.numel() * 2) * q.element_size(),
                 (4 * hd * pairs * h * b,
                  BF16 if dtype == torch.bfloat16 else F32))
    del q, k, v
    return {"case": name, "b": b, "s": s, "h": h, "kv": kv, "hd": hd,
            "causal": causal, "window": window, "dtype": str(dtype),
            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, **work,
            "pairs_per_head": pairs}


# ---------------------------------------------------------------- quantize


def quantized_linears(params) -> dict:
    """name -> QuantizedLinear (or QuantizedGrouped), under the pipeline's
    names."""
    return {f"L{i}.{g}.{k}": lp[g][k] for i, lp in enumerate(params["layers"])
            for g in ("attn", "mlp", "moe") if g in lp for k in lp[g]
            if hasattr(lp[g][k], "packed")}


QUANT_TENSORS = ("packed", "rescale", "signs1", "signs2", "mean_col", "w_out",
                 "out_idx", "keep_idx")


def quant_bytes(q, names=QUANT_TENSORS) -> int:
    return sum(t.numel() * t.element_size()
               for t in (getattr(q, n, None) for n in names) if t is not None)


def rotated_weight(fp_params, name, q) -> torch.Tensor:
    """The rotated, centralized, outlier-free weight the code search saw."""
    i, group, key = name.split(".")
    w = fp_params["layers"][int(i[1:])][group][key]
    if q.keep_idx is not None:
        w = w[q.keep_idx]
    w, _ = centralize(w)
    return hadamard.practical_rht(w, q.signs1, q.signs2, axis=0)


def code_searches(fp_params, name, q) -> list:
    """(packed, rescale, d, rotated weight thunk) of each code search that
    made ``q``: one for a QuantizedLinear, one per expert of a
    QuantizedGrouped (each expert rotated with the shared signs, nothing
    centralized or split off)."""
    if isinstance(q, QuantizedGrouped):
        i, group, key = name.split(".")
        w = fp_params["layers"][int(i[1:])][group][key]
        return [(q.packed[e], q.rescale[e], q.d,
                 lambda e=e: hadamard.practical_rht(w[e], q.signs1, q.signs2,
                                                    axis=0))
                for e in range(q.packed.shape[0])]
    return [(q.packed, q.rescale, q.d_keep,
             lambda: rotated_weight(fp_params, name, q))]


def compare_quantizations(fp_params, kernel_q, plain_q) -> dict:
    """Per code search, the kernel run's codes against the plain run's:
    columns that differ must be near-ties of the plain objective on the same
    w."""
    n_diff, n_cols, gap, rescale_ulps = 0, 0, 0.0, 0
    for name, kq in kernel_q.items():
        for kern, plain in zip(code_searches(fp_params, name, kq),
                               code_searches(fp_params, name, plain_q[name])):
            k_packed, k_rescale, d, rotated = kern
            p_packed, p_rescale = plain[:2]
            kc = packing.unpack_codes(k_packed, kq.bits, d)
            pc = packing.unpack_codes(p_packed, kq.bits, d)
            differ = (kc != pc).any(dim=0)
            n_cols += kq.c
            rescale_ulps += int((k_rescale != p_rescale)[~differ].sum())
            if not differ.any():
                continue
            n_diff += int(differ.sum())
            gap = max(gap, near_tie_gap(rotated()[:, differ].double(),
                                        kc[:, differ], pc[:, differ], kq.bits))
    return {"differing_columns": n_diff, "columns": n_cols,
            "max_objective_gap": gap,
            "rescale_f16_differ_same_columns": rescale_ulps}


def near_tie_gap(w, kc, pc, bits) -> float:
    """Largest relative gap between the kernel's and the plain version's
    objective -<w,v>^2/<v,v> over the columns of ``w`` (f64)."""
    c_b = ((1 << bits) - 1) / 2.0

    def objective(codes):
        v = codes.double() - c_b
        wv, vv = (w * v).sum(0), (v * v).sum(0)
        return -(wv * wv) / vv.clamp(min=1e-30)
    ek, ep = objective(kc), objective(pc)
    return float(((ek - ep).abs() / ep.abs()).max())


def quantize_phase(dev, compare: bool = True) -> tuple[dict, dict]:
    """Build fp32 llama2-7b on the card, calibrate, allocate and quantize it
    with the code-search kernel (the main path, counted), then (``compare``)
    quantize the same layers with the plain code search and compare."""
    cfg = get_config("llama2-7b")
    t0 = time.monotonic()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    fp_gb = sum(t.numel() * 4 for lp in params["layers"]
                for g in ("attn", "mlp") for t in lp[g].values()) / 1e9
    total_gb = fp_gb + (params["embed"].numel()
                        + params["lm_head"].numel()) * 4 / 1e9
    log(f"llama2-7b fp32: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {fp_gb:.2f} GB of projections, "
        f"{total_gb:.2f} GB with embedding and lm_head, built in "
        f"{init_s:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    toks = torch.from_numpy(cal.zero_shot_tokens(cfg.vocab, 256)).to(dev)
    stats = cal.calibrate(lambda p, b, ctx: tf.loss_fn(cfg, p, b, ctx=ctx),
                          params, [{"tokens": toks}])
    torch.cuda.synchronize()
    calibrate_s = time.monotonic() - t0
    qparams, rep = pipe.quantize_model(
        cfg, params, stats, AVG_BITS,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1),
        device=dev)
    launches = counts()["rabitq_quant"]
    peak = torch.cuda.max_memory_allocated()
    qls = quantized_linears(qparams)
    hist = collections.Counter(rep.per_layer_bits.values())
    packed_gb = sum(q.packed.numel() for q in qls.values()) / 1e9
    side_gb = sum(quant_bytes(q, QUANT_TENSORS[1:])
                  for q in qls.values()) / 1e9
    out = {"calibrate_s": calibrate_s, "allocate_s": rep.allocate_s,
           "quantize_s": rep.quantize_s,
           "pipeline_s": calibrate_s + rep.wall_time_s,
           "avg_bits": rep.avg_bits, "requested_avg_bits": AVG_BITS,
           "n_layers": rep.n_layers,
           "bits_histogram": {str(b): hist[b] for b in sorted(hist)},
           "packed_gb": packed_gb, "side_info_gb": side_gb,
           "peak_mem_gib": peak / 2**30, "code_search_launches": launches,
           "fp_projection_gb": fp_gb, "fp_total_gb": total_gb,
           "init_s": init_s}
    log(f"quantize: calibrate_s {calibrate_s:.2f}, allocate_s "
        f"{rep.allocate_s:.2f}, quantize_s {rep.quantize_s:.2f}; achieved "
        f"{rep.avg_bits:.4f} bits over {rep.n_layers} layers; widths "
        f"{out['bits_histogram']}; packed codes {packed_gb:.3f} GB + side "
        f"info {side_gb:.3f} GB; code-search launches {launches}; peak "
        f"{out['peak_mem_gib']:.2f} GiB")
    check(launches == rep.n_layers == cfg.n_layers * 6,
          f"code-search kernel launched {launches} times for "
          f"{rep.n_layers} layers")
    check(abs(rep.avg_bits - AVG_BITS) < 0.05 and rep.avg_bits <= AVG_BITS,
          f"achieved {rep.avg_bits} bits for a {AVG_BITS}-bit budget")
    check(all(np.isfinite(st.alpha) and st.alpha > 0
              for st in stats.values()), "calibration gave a bad alpha")

    if compare:
        out["plain_comparison"] = quantize_plain_and_compare(
            cfg, params, stats, rep, qls, dev)
    del params, stats
    torch.cuda.empty_cache()
    return out, qparams


def quantize_plain_and_compare(cfg, params, stats, rep, qls, dev) -> dict:
    """Quantize the same weights again with the code search's plain version
    and the kernel run's signs; the allocation must not move, and every
    column whose codes differ must be a near-tie."""
    signs = {name: (q.signs1, q.signs2) for name, q in qls.items()}
    t0 = time.monotonic()
    rq_ops.set_forced_path("ref")
    try:
        plain_params, plain_rep = pipe.quantize_model(
            cfg, params, stats, AVG_BITS, signs=signs, device=dev)
    finally:
        rq_ops.set_forced_path(None)
    check(plain_rep.per_layer_bits == rep.per_layer_bits,
          f"{cfg.name}: the allocation moved with the code search")
    cmp = compare_quantizations(params, qls, quantized_linears(plain_params))
    cmp["plain_quantize_s"] = plain_rep.quantize_s
    log(f"{cfg.name} quantize with the plain code search: quantize_s "
        f"{plain_rep.quantize_s:.2f}; {cmp['differing_columns']} of "
        f"{cmp['columns']} columns differ from the kernel run, max relative "
        f"objective gap {cmp['max_objective_gap']:.2e} (<= {OBJ_TIE}); "
        f"{cmp['rescale_f16_differ_same_columns']} f16 rescales differ in "
        f"agreeing columns ({time.monotonic() - t0:.1f} s)")
    check(cmp["max_objective_gap"] <= OBJ_TIE,
          f"{cfg.name}: a column differs between kernel and plain "
          f"quantization without a near-tie")
    return cmp


# ------------------------------------------------------------------ serve


def zero_counts() -> None:
    """Every kernel wrapper's launch counter to 0."""
    qops.launches = qops.unfused_launches = 0
    qops.grouped_launches = qops.grouped_unfused_launches = 0
    hops.launches = pops.launches = fops.launches = rq_ops.launches = 0


def counts() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    return {"rht_qmatmul": qops.launches, "qmatmul": qops.unfused_launches,
            "grouped_rht_qmatmul": qops.grouped_launches,
            "grouped_qmatmul": qops.grouped_unfused_launches,
            "rht": hops.launches, "paged_attention": pops.launches,
            "flash_attention": fops.launches, "rabitq_quant": rq_ops.launches}


def gemm_launches() -> int:
    """Launches of the dequant GEMM kernel, through any of its entries."""
    return (qops.launches + qops.unfused_launches + qops.grouped_launches
            + qops.grouped_unfused_launches)


class GapRecordingServer(PagedServer):
    """Records each greedy step's top-2 logit gap and logit scale, the
    tokens held in the KV arena at each decode step (a windowed request
    holds at most its ring), how far a request ran past its ring, and the
    dequant GEMM's launches in prefill chunks and in decode steps."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps: dict = {}
        self.step_tokens: list = []
        self.past_ring = 0
        self.gemms = {"prefill": 0, "decode": 0}

    def _count_gemms(self, phase, fn, *a):
        before = gemm_launches()
        out = fn(*a)
        self.gemms[phase] += gemm_launches() - before
        return out

    def _prefill_one(self, t0, results):
        return self._count_gemms("prefill", super()._prefill_one, t0,
                                 results)

    def _decode_once(self, t0, results):
        lens = [(len(st.served) + len(st.out), st.ring_cap)
                for st in self._active.values()]
        self.step_tokens.append(sum(min(n, cap) for n, cap in lens))
        self.past_ring = max([self.past_ring] + [n - cap for n, cap in lens])
        return self._count_gemms("decode", super()._decode_once, t0,
                                 results)

    def _sample(self, logits, rid, step):
        top2 = np.partition(logits, -2)[-2:]
        self.gaps[(rid, step)] = (float(top2[1] - top2[0]),
                                  float(np.abs(logits).max()))
        return super()._sample(logits, rid, step)


PROMPT_LENS = [64, 512, 128, 384, 96, 256, 448, 192]
GEN_LEN = 32


def decode_step_bound_ms(cfg, params, tokens_in_arena: float) -> float:
    """Least time of one decode step: every weight byte (packed codes, side
    info, every expert's codes, the MoE routers, the f32 lm_head, the
    embedding rows read) and every live K/V byte once, over the HBM rate."""
    nbytes = params["lm_head"].numel() * 4 + 8 * cfg.d_model * 4
    nbytes += sum(quant_bytes(q) for q in quantized_linears(params).values())
    nbytes += sum(lp["moe"]["router"].numel() * 4
                  for lp in params["layers"] if "moe" in lp)
    kv_per_token = cfg.n_layers * 2 * cfg.n_kv * cfg.hd * 4
    return (nbytes + tokens_in_arena * kv_per_token) / HBM_BYTES_PER_S * 1e3


def requests(cfg, prompt_lens=PROMPT_LENS) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=GEN_LEN) for i, n in enumerate(prompt_lens)]


def serve(cfg, params, dev, pool, fused=True,
          prompt_lens=PROMPT_LENS) -> tuple:
    engine = GapRecordingServer(cfg, params, pool, fused=fused, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    results = engine.run(requests(cfg, prompt_lens))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return engine, results, wall


def serve_summary(engine, results, wall, cfg, params,
                  prompt_lens=PROMPT_LENS) -> dict:
    st = engine.stats
    n_tok = sum(len(r.tokens) for r in results.values())
    check(len(results) == len(prompt_lens)
          and all(len(r.tokens) == GEN_LEN for r in results.values())
          and all(0 <= int(t) < cfg.vocab for r in results.values()
                  for t in r.tokens), "serve produced malformed output")
    check(engine.gemms["prefill"] > 0 and engine.gemms["decode"] > 0,
          f"GEMM launches {engine.gemms}: the prefill chunks and the decode "
          f"steps must both reach the GEMM kernel")
    return {"wall_s": wall, "tokens": n_tok, "tok_per_s": n_tok / wall,
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "decode_steps": st["decode_steps"],
            "prefill_chunks": st["prefill_chunks"],
            "prefill_chunk_ms": 1e3 * st["prefill_s"] / st["prefill_chunks"],
            "gemm_launches": engine.gemms,
            "decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"],
            "mean_occupancy": st["mean_occupancy"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_step_bound_ms": decode_step_bound_ms(
                cfg, params, float(np.mean(engine.step_tokens)))}


def divergences(base, other_results, other_engine) -> list:
    """Requests whose greedy tokens differ from ``base``'s; each must sit on
    a near-tie of the other run's logits."""
    out = []
    for rid, r in base.items():
        a, b = r.tokens, other_results[rid].tokens
        if np.array_equal(a, b):
            continue
        step = int(np.argmax(a != b))
        gap, scale = other_engine.gaps[(rid, step)]
        out.append({"rid": rid, "step": step, "gap": gap, "scale": scale})
        check(gap < GAP_TOL * scale,
              f"rid {rid}: tokens diverge at step {step} where the top-2 gap "
              f"{gap} >= {GAP_TOL} * {scale}")
    return out


@contextlib.contextmanager
def labelled(patches):
    """Wrap module functions in ``torch.profiler.record_function`` ranges
    for one profile: [(module, attribute, label)]."""
    from torch.profiler import record_function
    saved = []
    for mod, attr, label in patches:
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profile_decode(cfg, params, dev, pool, steps: int = 8,
                   labels=()) -> dict:
    """Where a decode step's time goes: 8 requests (prompt 128, 64 new
    tokens) are admitted and prefilled, then ``steps`` pure decode steps
    run under torch.profiler (``profile_steps``)."""
    engine = PagedServer(cfg, params, pool, device=dev)
    rng = np.random.default_rng(SEED + 1)
    for i in range(pool.max_slots):
        engine.submit(Request(rid=100 + i, max_new=64, prompt=rng.integers(
            0, cfg.vocab, 128).astype(np.int32)))
    for _ in range(pool.max_slots * 128 // pool.prefill_chunk):
        engine.step()                 # one prompt chunk + one decode each
    out = profile_steps(engine, steps, labels)
    log(f"decode profile: {json.dumps(out)}")
    return out


def profile_prefill(cfg, params, dev, pool, chunks: int = 4,
                    labels=()) -> dict:
    """Where a prefill chunk's time goes: one request of (chunks + 2) full
    chunks is admitted, its first chunk runs outside the profile, then
    ``chunks`` steps that each run one 64-token chunk and nothing else
    (no request is decoding yet) run under torch.profiler."""
    engine = PagedServer(cfg, params, pool, device=dev)
    rng = np.random.default_rng(SEED + 2)
    engine.submit(Request(rid=200, max_new=2, prompt=rng.integers(
        0, cfg.vocab, (chunks + 2) * pool.prefill_chunk).astype(np.int32)))
    engine.step()
    out = profile_steps(engine, chunks, labels)
    check(engine.stats["prefill_chunks"] == chunks + 1
          and not engine.stats.get("decode_steps"),
          "the prefill profile ran something other than prompt chunks")
    log(f"prefill profile: {json.dumps(out)}")
    return out


def profile_steps(engine, steps: int, labels=()) -> dict:
    """``steps`` engine steps under torch.profiler.  Device time is the sum
    of kernel times (one stream, so kernels do not overlap); the idle share
    is the rest of the host-clock step time.  ``labels`` (see ``labelled``)
    name ranges whose device time is reported too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with labelled(labels), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    averages = prof.key_averages()
    wanted = {label for _, _, label in labels}
    # a labelled range shows up twice: as a host range and as a span on the
    # device timeline; neither is a kernel
    kern = [e for e in averages if e.device_type == DeviceType.CUDA
            and e.key not in wanted]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:40]
    out = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "device_ms_per_step": dev_us / 1e3 / steps if dev_us else None,
           "idle_share": 1 - dev_us / 1e6 / wall if dev_us else None,
           "launches_per_step": sum(e.count for e in kern) / steps,
           "top_kernels": [{"name": e.key[:100], "count": e.count,
                            "ms_per_step": e.self_device_time_total / 1e3 / steps}
                           for e in top]}
    # the paged-attention kernels, and the rotation (fwht.cuh) under each
    # plan, whether the fused GEMM or the RHT entry launched it
    for name, part in (("paged_attention", "paged_attention"),
                       ("rotation", "rotate_kernel")):
        ks = [e for e in kern if part in e.key]
        out[name] = {
            "ms_per_step": sum(e.self_device_time_total for e in ks) / 1e3
            / steps, "launches_per_step": sum(e.count for e in ks) / steps,
            "kernels": sorted({e.key[:100] for e in ks})}
    out["ranges"] = {label: {} for label in sorted(wanted)}
    for e in averages:
        if e.key not in wanted:
            continue
        r = out["ranges"][e.key]
        if e.device_type == DeviceType.CUDA:   # first to last kernel, gaps too
            r["device_span_ms_per_step"] = e.device_time_total / 1e3 / steps
        else:                                  # host range and its kernels
            r["count_per_step"] = e.count / steps
            r["host_ms_per_step"] = e.cpu_time_total / 1e3 / steps
            r["kernel_ms_per_step"] = e.device_time_total / 1e3 / steps
    return out


def llama2_pool():
    return PoolConfig(max_slots=8, block_size=16,
                      max_context=max(PROMPT_LENS) + GEN_LEN, prefill_chunk=64)


def serve_phase(dev, params) -> dict:
    cfg = get_config("llama2-7b")
    pool = llama2_pool()
    # warm-up (library loads, allocator, cuBLAS handles) outside the counts
    for fused in (True, False):
        PagedServer(cfg, params, pool, fused=fused, device=dev).run(
            [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])

    zero_counts()
    engine, results, wall = serve(cfg, params, dev, pool)
    launches = counts()
    out = serve_summary(engine, results, wall, cfg, params)
    out["weights_only_bound_ms"] = decode_step_bound_ms(cfg, params, 0.0)
    out["launches"] = launches
    log(f"serve fused (kernels): {out['tokens']} tokens in {wall:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s; prefill {out['prefill_s']:.2f} s over "
        f"{out['prefill_chunks']} chunks ({out['prefill_chunk_ms']:.2f} "
        f"ms/chunk), decode {out['decode_s']:.2f} s over "
        f"{out['decode_steps']} steps ({out['decode_step_ms']:.2f} ms/step, "
        f"bound {out['decode_step_bound_ms']:.3f} ms); peak "
        f"{out['peak_mem_gib']:.2f} GiB; launches {launches}; GEMM launches "
        f"{engine.gemms}")
    check(launches["rht_qmatmul"] > 0 and launches["paged_attention"] > 0,
          f"a kernel of the fused path never launched: {launches}")

    # launches one decode step makes, counted on a direct call
    per_step = launches_per_decode_step(cfg, params, dev, engine)
    out["launches_per_decode_step"] = per_step
    log(f"launches per decode step: {per_step}")
    del engine                  # its arena; later peaks count their own
    out["decode_profile"] = profile_decode(cfg, params, dev, pool)
    out["prefill_profile"] = profile_prefill(cfg, params, dev, pool)

    # the unfused A/B path: the RHT kernel, then the unfused GEMM kernel
    zero_counts()
    unf, unf_results, unf_wall = serve(cfg, params, dev, pool, fused=False)
    unf_launches = counts()
    unfused = serve_summary(unf, unf_results, unf_wall, cfg, params)
    unfused["launches"] = unf_launches
    unfused["divergences"] = divergences(results, unf_results, unf)
    out["unfused"] = unfused
    log(f"serve unfused (kernels): {unfused['tokens']} tokens in "
        f"{unf_wall:.2f} s = {unfused['tok_per_s']:.1f} tok/s; prefill "
        f"{unfused['prefill_s']:.2f} s; decode "
        f"{unfused['decode_step_ms']:.2f} ms/step (bound "
        f"{unfused['decode_step_bound_ms']:.3f} ms); launches {unf_launches};"
        f" greedy tokens identical to fused for "
        f"{len(results) - len(unfused['divergences'])}/{len(results)}")
    check(unf_launches["rht"] > 0 and unf_launches["qmatmul"] > 0
          and unf_launches["rht_qmatmul"] == 0,
          f"the unfused path did not run its kernels: {unf_launches}")

    # the same requests with the plain versions forced on the card
    for ops in (qops, pops, hops):
        ops.set_forced_path("ref")
    try:
        plain, plain_results, plain_wall = serve(cfg, params, dev, pool)
    finally:
        for ops in (qops, pops, hops):
            ops.set_forced_path(None)
    out["plain_wall_s"] = plain_wall
    out["plain_tok_per_s"] = out["tokens"] / plain_wall
    out["divergences"] = divergences(results, plain_results, plain)
    log(f"serve fused (plain versions): {plain_wall:.2f} s; greedy tokens "
        f"identical for {len(results) - len(out['divergences'])}/"
        f"{len(results)} requests; accepted near-tie divergences: "
        f"{len(out['divergences'])}")
    return out


# ------------------------------------------------------------------ Mixtral


def moe_config():
    """mixtral-8x7b at its published width, the depth cut to MOE_LAYERS."""
    return get_config("mixtral-8x7b").with_(n_layers=MOE_LAYERS)


MOE_PROMPT_LENS = PROMPT_LENS + [MOE_LONG_PROMPT]


def moe_quantize_phase(dev, compare: bool = True) -> tuple[dict, dict]:
    """fp32 Mixtral (4 layers, published widths) on the card, calibrated,
    allocated (4.0 bits) and quantized, the experts as QuantizedGrouped with
    one code-search launch per expert (the main path, counted); then
    (``compare``) the same weights again with the plain code search,
    compared column by column.  The fp weights are dropped after."""
    cfg = moe_config()
    t0 = time.monotonic()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    layer_gb = sum(t.numel() * 4 for g in ("attn", "moe")
                   for t in params["layers"][0][g].values()) / 1e9
    total_gb = (layer_gb * cfg.n_layers + (params["embed"].numel()
                + params["lm_head"].numel()) * 4 / 1e9)
    log(f"mixtral-8x7b fp32, {cfg.n_layers} of 32 layers: d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads, {cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k} of width {cfg.moe.d_ff_expert}, window "
        f"{cfg.window}; {layer_gb:.2f} GB per layer, {total_gb:.2f} GB with "
        f"embedding and lm_head, built in {init_s:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    toks = torch.from_numpy(cal.zero_shot_tokens(cfg.vocab, 256)).to(dev)
    stats = cal.calibrate(lambda p, b, ctx: tf.loss_fn(cfg, p, b, ctx=ctx),
                          params, [{"tokens": toks}])
    torch.cuda.synchronize()
    calibrate_s = time.monotonic() - t0
    grouped = sorted(n for n, st in stats.items() if st.grouped)
    check(grouped == sorted(f"L{i}.moe.{k}" for i in range(cfg.n_layers)
                            for k in ("wi", "wo"))
          and all(np.isfinite(st.alpha) and st.alpha > 0
                  for st in stats.values()),
          f"calibration: grouped taps {grouped} or a bad alpha")
    qparams, rep = pipe.quantize_model(
        cfg, params, stats, AVG_BITS,
        generator=torch.Generator(device=dev).manual_seed(SEED + 3),
        device=dev)
    launches = counts()["rabitq_quant"]
    peak = torch.cuda.max_memory_allocated()
    qls = quantized_linears(qparams)
    n_entries = cfg.n_layers * 6
    expected_searches = cfg.n_layers * (4 + 2 * cfg.moe.n_experts)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "depth_cut": f"{cfg.n_layers} of 32 layers (fp32: 186 GB at 32, "
                        f"{total_gb:.1f} GB at {cfg.n_layers})",
           "calibrate_s": calibrate_s, "allocate_s": rep.allocate_s,
           "quantize_s": rep.quantize_s,
           "pipeline_s": calibrate_s + rep.wall_time_s,
           "avg_bits": rep.avg_bits, "requested_avg_bits": AVG_BITS,
           "n_quantized": rep.n_layers, "per_layer_bits": rep.per_layer_bits,
           "packed_gb": sum(q.packed.numel() for q in qls.values()) / 1e9,
           "side_info_gb": sum(quant_bytes(q, QUANT_TENSORS[1:])
                               for q in qls.values()) / 1e9,
           "peak_mem_gib": peak / 2**30, "code_search_launches": launches,
           "fp_layer_gb": layer_gb, "fp_total_gb": total_gb,
           "init_s": init_s}
    log(f"mixtral quantize: calibrate_s {calibrate_s:.2f}, allocate_s "
        f"{rep.allocate_s:.2f}, quantize_s {rep.quantize_s:.2f}; achieved "
        f"{rep.avg_bits:.4f} bits over {rep.n_layers} weights; widths "
        f"{rep.per_layer_bits}; packed codes {out['packed_gb']:.3f} GB + side "
        f"info {out['side_info_gb']:.4f} GB; code-search launches {launches};"
        f" peak {out['peak_mem_gib']:.2f} GiB")
    check(rep.n_layers == n_entries and launches == expected_searches,
          f"mixtral: {rep.n_layers} weights quantized with {launches} code "
          f"searches, expected {n_entries} and {expected_searches}")
    check(AVG_BITS - 0.5 < rep.avg_bits <= AVG_BITS,
          f"mixtral: achieved {rep.avg_bits} bits for a {AVG_BITS}-bit budget")
    check(all(isinstance(lp["moe"][k], QuantizedGrouped)
              and lp["moe"]["router"].dtype == torch.float32
              for lp in qparams["layers"] for k in ("wi", "wo")),
          "mixtral: experts not grouped-quantized or router not fp32")
    if compare:
        out["plain_comparison"] = quantize_plain_and_compare(
            cfg, params, stats, rep, qls, dev)
    del params, stats
    torch.cuda.empty_cache()
    return out, qparams


def moe_pool():
    return PoolConfig(max_slots=8, block_size=16,
                      max_context=MOE_LONG_PROMPT + GEN_LEN, prefill_chunk=64)


MOE_PREFILL_LABELS = [(moemod, "moe_ffn", "moe_ffn"),
                      (moemod, "_expert_matmul", "moe_expert_gemms")]


def launches_per_decode_step(cfg, params, dev, engine) -> dict:
    """Kernel launches of one decode step (a direct call over inert slots),
    fused and unfused."""
    s = engine.pool.max_slots
    z = torch.zeros(s, dtype=torch.int32, device=dev)
    per_step = {}
    for fused in (True, False):
        zero_counts()
        with qops.fusion(fused):
            logits, _ = decmod.decode_step_paged(
                cfg, params, engine.caches, z[:, None], z,
                torch.zeros(s, dtype=torch.bool, device=dev),
                torch.zeros((s, engine.table_width), dtype=torch.int32,
                            device=dev),
                torch.ones(s, dtype=torch.int32, device=dev))
        check(bool(torch.isfinite(logits).all()),
              "decode step logits not finite")
        per_step["fused" if fused else "unfused"] = counts()
    return per_step


def moe_serve_phase(dev, params) -> dict:
    cfg = moe_config()
    pool = moe_pool()
    for fused in (True, False):     # warm-up outside the counts
        PagedServer(cfg, params, pool, fused=fused, device=dev).run(
            [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])

    zero_counts()
    engine, results, wall = serve(cfg, params, dev, pool,
                                  prompt_lens=MOE_PROMPT_LENS)
    launches = counts()
    out = serve_summary(engine, results, wall, cfg, params, MOE_PROMPT_LENS)
    out["weights_only_bound_ms"] = decode_step_bound_ms(cfg, params, 0.0)
    out["launches"] = launches
    out["tokens_past_ring"] = engine.past_ring
    log(f"mixtral serve fused (kernels): {out['tokens']} tokens in "
        f"{wall:.2f} s = {out['tok_per_s']:.1f} tok/s; prefill "
        f"{out['prefill_s']:.2f} s over {out['prefill_chunks']} chunks "
        f"({out['prefill_chunk_ms']:.2f} ms/chunk; GEMM launches "
        f"{engine.gemms}), decode "
        f"{out['decode_s']:.2f} s over {out['decode_steps']} steps "
        f"({out['decode_step_ms']:.2f} ms/step, bound "
        f"{out['decode_step_bound_ms']:.3f} ms); peak "
        f"{out['peak_mem_gib']:.2f} GiB; launches {launches}; the long "
        f"request ran {engine.past_ring} tokens past its "
        f"{cfg.window}-token ring")
    check(launches["rht_qmatmul"] > 0 and launches["grouped_rht_qmatmul"] > 0
          and launches["paged_attention"] > 0,
          f"a kernel of the Mixtral fused path never launched: {launches}")
    check(engine.past_ring > 0, "the long request never wrapped its ring")

    per_step = launches_per_decode_step(cfg, params, dev, engine)
    out["launches_per_decode_step"] = per_step
    log(f"mixtral launches per decode step: {per_step}")
    n = cfg.n_layers
    check(per_step["fused"]["grouped_rht_qmatmul"] == 2 * n
          and per_step["unfused"]["grouped_qmatmul"] == 2 * n
          and per_step["unfused"]["rht"] == 6 * n,
          f"mixtral launches per decode step: {per_step}")
    del engine
    out["decode_profile"] = profile_decode(
        cfg, params, dev, pool,
        labels=[(moemod, "moe_ffn", "moe_ffn"),
                (moemod, "_expert_matmul", "moe_expert_gemms"),
                (attnmod, "paged_decode_attention", "paged_attention")])
    out["prefill_profile"] = profile_prefill(cfg, params, dev, pool,
                                             labels=MOE_PREFILL_LABELS)

    zero_counts()
    unf, unf_results, unf_wall = serve(cfg, params, dev, pool, fused=False,
                                       prompt_lens=MOE_PROMPT_LENS)
    unf_launches = counts()
    unfused = serve_summary(unf, unf_results, unf_wall, cfg, params,
                            MOE_PROMPT_LENS)
    unfused["launches"] = unf_launches
    unfused["divergences"] = divergences(results, unf_results, unf)
    out["unfused"] = unfused
    log(f"mixtral serve unfused (kernels): {unfused['tokens']} tokens in "
        f"{unf_wall:.2f} s = {unfused['tok_per_s']:.1f} tok/s; prefill "
        f"{unfused['prefill_s']:.2f} s; decode "
        f"{unfused['decode_step_ms']:.2f} ms/step; launches {unf_launches}; "
        f"greedy tokens identical to fused for "
        f"{len(results) - len(unfused['divergences'])}/{len(results)}")
    check(unf_launches["rht"] > 0 and unf_launches["qmatmul"] > 0
          and unf_launches["grouped_qmatmul"] > 0
          and unf_launches["rht_qmatmul"] == 0
          and unf_launches["grouped_rht_qmatmul"] == 0,
          f"the Mixtral unfused path did not run its kernels: {unf_launches}")

    for ops in (qops, pops, hops):
        ops.set_forced_path("ref")
    try:
        plain, plain_results, plain_wall = serve(
            cfg, params, dev, pool, prompt_lens=MOE_PROMPT_LENS)
    finally:
        for ops in (qops, pops, hops):
            ops.set_forced_path(None)
    out["plain_wall_s"] = plain_wall
    out["plain_tok_per_s"] = out["tokens"] / plain_wall
    out["divergences"] = divergences(results, plain_results, plain)
    log(f"mixtral serve fused (plain versions): {plain_wall:.2f} s; greedy "
        f"tokens identical for {len(results) - len(out['divergences'])}/"
        f"{len(results)} requests; accepted near-tie divergences: "
        f"{len(out['divergences'])}")
    return out


def prefill_profile_main(dev, smi) -> int:
    """``--prefill-profile``: build, quantize llama2-7b and Mixtral as the
    full run does (without the plain code-search comparison) and run only
    ``profile_prefill`` for each, once to warm up and once measured; prints
    one JSON line.  With REPRO_TORCH_SRC naming an unpacked earlier tree
    (``git archive``), it measures that tree's package, so two trees'
    prefill device times can be compared on one card in one call:

        REPRO_TORCH_SRC=build/parent/src \
            python3 chip_smoke.py --prefill-profile
        python3 chip_smoke.py --prefill-profile
    """
    _build.build()
    out = {"src": str(SRC), "gpu": smi}
    for name, phase, cfg_of, pool_of, labels in (
            ("llama2", quantize_phase, lambda: get_config("llama2-7b"),
             llama2_pool, ()),
            ("mixtral", moe_quantize_phase, moe_config, moe_pool,
             MOE_PREFILL_LABELS)):
        _, qparams = phase(dev, compare=False)
        for _ in range(2):
            prof = profile_prefill(cfg_of(), qparams, dev, pool_of(),
                                   labels=labels)
        out[name] = prof
        del qparams
        torch.cuda.empty_cache()
    log(json.dumps({"prefill_profile": out}))
    return 0


def attention_main(smi) -> int:
    """``--attention``: build the paged-attention kernel, hold it against
    its plain version (``check_attention``) and time it (``ATTN_TIMED``);
    prints one JSON line.  REPRO_TORCH_SRC picks the package tree, as for
    ``--prefill-profile``, so an earlier kernel can be timed beside this
    one on one card in one call (run parent, change, change, parent)."""
    t0 = time.monotonic()
    logs = _build.build(["paged_attention"])
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for lg in logs.values() for ln in lg.splitlines()
             if "registers" in ln or "spill" in ln]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    checked = check_attention(gen, dev)
    times = time_attentions(gen, dev)
    log(json.dumps({"attention": {"src": str(SRC), "gpu": smi,
                                  "build_s": build_s, "ptxas": ptxas,
                                  "check": checked,
                                  "times": times}}))
    return 0


# the fused entry's shapes (d_keep 4083, c 4096) at decode and a chunk
FUSED_AB_NS = [1, 8, 64]
# the code search at llama2's and Mixtral's weight shapes
SEARCH_TIMED = [(4083, 4096), (4083, 22016), (10974, 4096), (4096, 28672),
                (14336, 4096)]
AB_MODES = ("--rotation", "--code-search", "--division-sweep")


def redesign_main(modes, smi) -> int:
    """``--rotation`` and/or ``--code-search`` (and ``--division-sweep``):
    build the kernels they need; on a tree with the redesigned kernels hold
    them against their plain versions (``check_rht``,
    ``check_code_search``), then time them: the rotation at RHT_TIMED (graph
    replay), the fused GEMM at FUSED_AB_NS and an empty kernel's launch (the
    card's launch floor); the code search at SEARCH_TIMED.  ``--division-sweep`` holds the code search's
    division against IEEE division on all 2^46 pairs of f32 mantissas.
    Prints one JSON line.  REPRO_TORCH_SRC picks the package tree, as for
    ``--attention``: an earlier tree is only timed, so one call can run
    parent, change, change, parent."""
    names = (["hadamard", "rht_qmatmul"] if "--rotation" in modes else []) + (
        ["rabitq_quant"] if modes & {"--code-search", "--division-sweep"}
        else [])
    t0 = time.monotonic()
    logs = _build.build(names)
    out = {"src": str(SRC), "gpu": smi, "build_s": time.monotonic() - t0,
           "ptxas": [ln.strip() for lg in logs.values()
                     for ln in lg.splitlines()
                     if "registers" in ln or "spill" in ln]}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    if "--rotation" in modes:
        redesigned = hasattr(hops, "rotate_plan")
        if redesigned:
            out["rht_check"] = check_rht(gen, dev)
            out["launch_floor_ms"] = launch_floor_ms(dev)
        out["rht_times"] = [time_rht(gen, dev, n, d, full=False)
                            for n, d in RHT_TIMED]
        out["fused_gemm_times"] = [time_gemm(gen, dev, n, 4083, 4096, 4,
                                             full=False)
                                   for n in FUSED_AB_NS]
    if "--code-search" in modes:
        redesigned = hasattr(rq_ops, "search_plan")
        if redesigned:
            out["code_search_check"] = check_code_search(gen, dev)
        out["code_search_times"] = [time_code_search(gen, dev, d, c,
                                                     plain=False)
                                    for d, c in SEARCH_TIMED]
    if "--division-sweep" in modes:
        t0 = time.monotonic()
        bad = rq_ops.division_mismatches(dev, 0, 1 << 23, 1)
        out["division_sweep"] = {"pairs": 1 << 46, "mismatches": bad,
                                 "seconds": time.monotonic() - t0}
        check(bad == 0, f"the code search's division differs from IEEE "
              f"division in {bad} of 2^46 mantissa pairs")
    log(json.dumps({"redesign": out}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_line()
    log(f"gpu: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--prefill-profile"]:
        return prefill_profile_main(dev, smi)
    if sys.argv[1:] == ["--attention"]:
        return attention_main(smi)
    modes = set(sys.argv[1:])
    if modes and modes <= set(AB_MODES):
        return redesign_main(modes, smi)
    if modes:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    t_build = time.monotonic()
    logs = _build.build()
    build_s = time.monotonic() - t_build
    log(f"build: {build_s:.1f} s ({len(logs)} sources)")
    regs = {name: [ln.strip() for ln in lg.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, lg in logs.items()}
    for name, lines in regs.items():
        used = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln]
        spills = sum(1 for ln in lines if "spill" in ln
                     and not ln.startswith("0 bytes stack frame"))
        log(f"  ptxas {name}: {len(used)} kernels, registers "
            f"{min(used, default=0)}-{max(used, default=0)}, {spills} "
            f"with spills (full report in chip_smoke.json)")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    gemm_worst = check_gemms(gen, dev)
    gemm_err, unfused_err = gemm_worst["fused"], gemm_worst["unfused"]
    rht_check = check_rht(gen, dev)
    rht_err = rht_check["err"]
    search = check_code_search(gen, dev)
    attn_check = check_attention(gen, dev)
    attn_err = attn_check["max_abs_err"]
    gemm_times = [time_gemm(gen, dev, n, d, c, 4) for n, d, c in TIME_SHAPES]
    unfused_times = [time_gemm(gen, dev, n, d, c, 4, fused=False)
                     for n, d, c in TIME_SHAPES]
    rht_times = [time_rht(gen, dev, n, d) for n, d in RHT_TIMED]
    floor_ms = launch_floor_ms(dev)
    log(f"launch floor (empty kernel, graph replay): {floor_ms:.4f} ms")
    search_times = [time_code_search(gen, dev, d, c)
                    for d, c in SEARCH_TIMED]
    for name, rows in (("rht_qmatmul", gemm_times), ("qmatmul", unfused_times),
                       ("rht", rht_times), ("rabitq_quant", search_times)):
        for t in rows:
            log(f"{name} time {json.dumps(t)}")
    attn_times = time_attentions(gen, dev)
    attn_time = attn_times[0]            # llama2's shape, f32
    grouped_err, grouped_unfused_err = check_grouped(gen, dev)
    flash_err = check_flash(gen, dev)
    grouped_times = [time_grouped(gen, dev, *shape)
                     for shape in GROUPED_SHAPES]
    grouped_unfused_times = [time_grouped(gen, dev, *shape, fused=False)
                             for shape in GROUPED_SHAPES]
    flash_times = [time_flash(gen, dev, *case)
                   for case in FLASH_CASES[:FLASH_TIMED]]
    for name, rows in (("grouped_rht_qmatmul", grouped_times),
                       ("grouped_qmatmul", grouped_unfused_times),
                       ("flash_attention", flash_times)):
        for t in rows:
            log(f"{name} time {json.dumps(t)}")
    torch.cuda.empty_cache()

    quant_out, qparams = quantize_phase(dev)
    serve_out = serve_phase(dev, qparams)
    del qparams
    torch.cuda.empty_cache()
    moe_quant, moe_params = moe_quantize_phase(dev)
    moe_serve = moe_serve_phase(dev, moe_params)
    del moe_params

    # launches per path, each from that path's own run with every count
    # zeroed just before it: the quantize run (the code search), the fused
    # serve run, the unfused serve run (the RHT and the unfused GEMMs)
    runs = {"llama2": {"quantize": quant_out["code_search_launches"],
                       "fused": serve_out["launches"],
                       "unfused": serve_out["unfused"]["launches"]},
            "mixtral": {"quantize": moe_quant["code_search_launches"],
                        "fused": moe_serve["launches"],
                        "unfused": moe_serve["unfused"]["launches"]}}

    def by_path(kernel, run):
        if run == "quantize":
            return {path: r["quantize"] for path, r in runs.items()}
        if run == "serve":      # the fused and the unfused run together
            return {path: r["fused"][kernel] + r["unfused"][kernel]
                    for path, r in runs.items()}
        return {path: r[run][kernel] for path, r in runs.items()}
    on_path = {  # kernel -> (run that counts it, paths that must launch it)
        "rht_qmatmul": ("fused", ("llama2", "mixtral")),
        "paged_attention": ("fused", ("llama2", "mixtral")),
        "qmatmul": ("unfused", ("llama2", "mixtral")),
        "rht": ("unfused", ("llama2", "mixtral")),
        "rabitq_quant": ("quantize", ("llama2", "mixtral")),
        "grouped_rht_qmatmul": ("fused", ("mixtral",)),
        "grouped_qmatmul": ("unfused", ("mixtral",)),
        "flash_attention": ("fused", ()),
    }
    launches = {k: by_path(k, run) for k, (run, _) in on_path.items()}
    for k, (_, paths) in on_path.items():
        check(all(launches[k][p] > 0 for p in paths),
              f"{k}: not launched on every path that runs it: {launches[k]}")
    # the GEMM kernel's launches by serve run and phase
    gemms = {path: {run: r["gemm_launches"] for run, r in (
                 ("fused", serve_r), ("unfused", serve_r["unfused"]))}
             for path, serve_r in (("llama2", serve_out),
                                   ("mixtral", moe_serve))}
    check(all(run["prefill"] and run["decode"] for by_run in gemms.values()
              for run in by_run.values()),
          f"the prefill chunks or the decode steps did not reach the GEMM "
          f"kernel: {gemms}")

    def entry(name, source, replaces, err, t, shape_keys, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name],
                "max_abs_err": err, "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "bound_rate": t["bound_rate"],
                "library_ms": t["library_ms"],
                "shape": {k: t[k] for k in shape_keys}, **extra}
    decode_gemm = gemm_times[1]          # n=8 slots, wq/wk/wv/wo at 4 bits
    prefill_gemm = gemm_times[4]         # n=64, a prefill chunk's wq
    decode_unfused = unfused_times[1]
    decode_rht = rht_times[0]            # n=8, d_keep 4083
    search_t = search_times[0]           # (4083, 4096): 128 of 192 weights
    grouped_decode = grouped_times[0]          # wi at decode, C = 2
    grouped_unfused_decode = grouped_unfused_times[0]
    flash_t = flash_times[0]                   # Mixtral's shape
    kernels = [
        entry("rht_qmatmul", "src/repro_torch/csrc/rht_qmatmul.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:164", gemm_err,
              decode_gemm, ("n", "d", "c", "bits"),
              prefill={k: prefill_gemm[k] for k in (
                  "n", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")},
              gemm_launches_by_run_and_phase=gemms,
              note="one GEMM kernel (dequant_gemm_kernel) behind every "
                   "entry; gemm_launches_by_run_and_phase counts its "
                   "launches through any entry in each serve run's prefill "
                   "chunks and decode steps"),
        entry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention/paged.py:98", attn_err,
              attn_time, ("b", "h", "kv", "hd", "context", "splits"),
              shapes=[{k: t[k] for k in (
                  "case", "splits", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")} for t in attn_times[1:]],
              decode_profile={path: serve_r["decode_profile"][
                  "paged_attention"] for path, serve_r in (
                      ("llama2", serve_out), ("mixtral", moe_serve))}),
        entry("qmatmul", "src/repro_torch/csrc/rht_qmatmul.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:66", unfused_err,
              decode_unfused, ("n", "d", "c", "bits")),
        entry("rht", "src/repro_torch/csrc/hadamard.cu",
              "src/repro/kernels/hadamard/hadamard.py:35", rht_err,
              decode_rht, ("n", "d", "plan"),
              launch_floor_ms=floor_ms, padded_ms=decode_rht["padded_ms"],
              decode_profile={path: serve_r["decode_profile"]["rotation"]
                              for path, serve_r in (("llama2", serve_out),
                                                    ("mixtral", moe_serve))},
              shapes=[{k: t[k] for k in (
                  "n", "d", "plan", "ms", "padded_ms", "plain_ms",
                  "bound_ms", "library_ms")} for t in rht_times[1:]],
              rowsum_err=rht_check["rowsum_err"],
              walk_err=rht_check["walk_err"],
              note="fwht.cuh's rotation, also launched inside rht_qmatmul "
                   "(padded_ms: rows padded to a multiple of 64 with their "
                   "sums, as the fused GEMM launches it)"),
        entry("rabitq_quant", "src/repro_torch/csrc/rabitq_quant.cu",
              "src/repro/kernels/rabitq_quant/quantize.py:49",
              search["max_rescale_abs_err"], search_t,
              ("d", "c", "bits", "slices"),
              measure="max|rescale err| where the step agrees; codes equal",
              differing_columns=search["differing_columns"],
              max_objective_gap=search["max_objective_gap"],
              division_mismatches=search["division_mismatches"],
              one_candidate_ms=search_t["one_candidate_ms"],
              shapes=[{k: t[k] for k in (
                  "d", "c", "slices", "ms", "one_candidate_ms", "plain_ms",
                  "bound_ms")} for t in search_times[1:]]),
        entry("grouped_rht_qmatmul", "src/repro_torch/csrc/rht_qmatmul.cu",
              "src/repro/kernels/qmatmul/ops.py:121", grouped_err,
              grouped_decode, ("e", "cap", "d", "c", "bits"),
              unfused={"launches": sum(launches["grouped_qmatmul"].values()),
                       "launches_by_path": launches["grouped_qmatmul"],
                       "max_abs_err": grouped_unfused_err,
                       **{k: grouped_unfused_decode[k] for k in (
                           "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}}),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/flash.py:68",
              flash_err["f32"], flash_t,
              ("b", "s", "h", "kv", "hd", "causal", "window"),
              on_main_path=False, max_abs_err_bf16=flash_err["bf16"],
              note="no model path calls it, as in the reference; held "
                   "against its plain version and its host tile walk in "
                   "the kernel phase"),
    ]
    detail = {"gpu": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": regs, "gemm_times": gemm_times,
              "unfused_gemm_times": unfused_times, "rht_check": rht_check,
              "rht_times": rht_times, "launch_floor_ms": floor_ms,
              "code_search_times": search_times, "code_search_check": search,
              "attention_check": attn_check, "attention_times": attn_times,
              "quantize": quant_out,
              "serve": serve_out, "grouped_times": grouped_times,
              "grouped_unfused_times": grouped_unfused_times,
              "flash_times": flash_times,
              "gemm_check": gemm_worst, "mixtral_quantize": moe_quant,
              "mixtral_serve": moe_serve, "kernels": kernels}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
