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
     bitwise equal; speculation's W = 2 and 4, Mixtral's verify over a
     wrapped ring; timed at llama2's, Mixtral's and a serving mix's
     shapes, f32 and bf16, and at the verify and catch-up spans), the
     grouped (MoE expert) GEMM fused and unfused at Mixtral's decode and
     prefill shapes and speculation's capacities (C = 5, 10), and the
     flash-attention forward at Mixtral's and llama2's shapes (also
     against its host tile walk);
  4. quantize: llama2-7b at its published width (32 layers, d_model 4096,
     32 heads, d_ff 11008, vocab 32000) in fp32, random weights from a
     seeded generator on the card; calibrated on the paper's zero-shot
     sentence (256 tokens), bit widths from AllocateBits at 4.0 average
     bits, every linear RaBitQ-H quantized with the code-search kernel, and
     from the same calibration and signs a 2.2-bit draft
     (``quantize_model_dual``); then the target's layers again with the
     code search's plain version, compared column by column;
  5. serve (``serve_four_ways``): the fp weights dropped, 8 requests
     through ``PagedServer.run`` four ways -- by graph (the engine's
     default: each decode step and prompt-chunk length captured once as a
     CUDA graph, then replayed) and by eager kernels (``graphs.eager()``),
     each 3 times for the spread of decode ms/step and ``prefill_s``; fused
     with the plain versions forced (eager); and unfused by graph (the RHT
     kernel, then the unfused GEMM kernel).  Graph and eager must give the
     same tokens and the same launches per kernel, the others the same
     tokens but at near-ties; the captures, their seconds and the graph
     pool's memory are reported; decode steps and prefill chunks are
     profiled in both modes (device ms by kernel, idle share, launches per
     step); each run counts the GEMM launches of its prefill chunks and of
     its decode steps;
  6. Mixtral: mixtral-8x7b at its published width (d_model 4096, 32 heads
     over 8 KV heads, 8 experts top-2 of width 14336, capacity factor 1.25,
     window 4096, vocab 32000) with the depth cut to 4 of its 32 layers
     (the reference pipeline calibrates the whole fp32 model, 186 GB at 32
     layers, and one 80 GB card holds 24.3 GB at 4); calibrated, allocated
     (4.0 bits) and quantized with grouped experts, then quantized again
     with the plain code search and compared; the fp weights dropped and
     the 8 requests plus one of 4160 prompt tokens (its window
     ring wraps in prefill and in decode) served the same four ways; its
     2.2-bit draft is quantized with it;
     the llama2 serve runs go through the prefix cache (on by default;
     their random prompts save nothing, which is checked), Mixtral's
     window bypasses it;
  7. prefix cache (``prefix_phase``, on llama2's quantization of phase 4):
     16 requests sharing a 512-token system prompt, one that diverges
     inside a cached block (copy-on-write) and a second turn of request 0,
     with 8 slots, block 16, chunk 64, f32 KV and max_context 672: cache on
     by graph, off by graph, on eagerly; with a pool of 4 requests'
     capacity, on (evicting) and cold; then the churn workload with
     request 0 preempted and replayed, and with cancels while queued,
     mid-prefill and mid-decode.  Tokens identical in every pair, cache
     counters consistent, blocks drained after every run;
  8. speculation (``spec_phase``, ``moe_spec_phase``): llama2 speculating
     k = 3 deep over phase 5's requests with draft = target (every
     proposal accepted) and with the 2.2-bit draft, each 3 runs by graph
     and one eager, tokens identical to phase 5's spec-off graph run, a
     round profiled; the prefix workload (a) with the cache on and the
     draft, tokens identical to phase 7's, the COW clone checked in both
     arenas; bf16 arenas, spec off and on, by graph and eager (identical
     four ways); then Mixtral's 9 requests with its draft, the target's
     capacity overflows counted per step, on = off except at a step that
     dropped tokens, graph = eager.  Catch-up, draft and verify steps
     each captured once per engine, no decode step;
  9. dense configs (``dense_phase``): internlm2-1.8b, llama3.2-3b,
     qwen3-0.6b and yi-34b at their published widths, each cut to 4
     layers, quantized at 4.0 bits and served by graph, unfused and plain;
 10. a ``{"kernels": [...]}`` line (each kernel's launches per path, each
     path's runs counted from zero), the nvidia-smi line, and as the last
     line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profiles`` runs only the quantization and the
decode-step and prefill-chunk profiles of both models, by graph and eager
(see ``profiles_main``);
``python3 chip_smoke.py --attention`` only builds, checks and times the
paged-attention kernel (see ``attention_main``); ``--rotation`` and
``--code-search`` (either or both, with ``--division-sweep`` for the
division on all 2^46 mantissa pairs) the same for the rotation and the
code search (see ``redesign_main``); ``--prefix-cache`` builds every
kernel and runs only phase 7 (see ``prefix_main``); ``--speculation``
builds every kernel and runs only phase 8, with the spec-off runs it is
held to (see ``spec_main``).

Imports nothing of JAX or of the reference package.  Exits non-zero with no
result when no CUDA device is present.  Details too long for the end of the
output go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parent
# the package tree to import: this checkout's src/ unless REPRO_TORCH_SRC
# names another (``--profiles`` compares two trees' packages)
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
from repro_torch import kernels  # noqa: E402
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
from repro_torch.serve import PagedServer, PoolConfig, Request, graphs  # noqa: E402
from repro_torch.serve.pool import request_blocks  # noqa: E402

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
# and at each rotation width the dense configs add, one of its weights
SEARCH_SHAPES += [(1020, 6144), (2041, 1024), (3062, 1024), (7146, 1024),
                  (8167, 2048), (20418, 7168)]
GEMM_BITS = list(range(1, 9))
# n = 1 and 8 are decode; 16-64 prefill chunks and their remainders (3,
# 48 and 56 the prefix path's chunks after a cache hit), 20 a prefill
# chunk's MoE capacity; 100 takes two 64-row blocks (no path of the two
# models sends more than 64 rows, the wrapper accepts any n)
GEMM_NS = [1, 3, 8, 16, 20, 32, 48, 56, 64, 100]
# the dense configs' (d_keep, c): wq, wk/wv, wo, wi, the FFN's wo of
# internlm2-1.8b, llama3.2-3b, qwen3-0.6b and yi-34b (shared ones once);
# their rows: decode over 4 slots, the chunks of DENSE_PROMPT_LENS, and
# the prefix path's chunk lengths
DENSE_GEMM_SHAPES = [
    (2041, 2048), (2041, 1024), (2041, 16384), (8167, 2048),
    (3062, 3072), (3062, 1024), (3062, 16384), (8167, 3072),
    (1020, 2048), (1020, 1024), (1020, 6144), (3062, 1024),
    (7146, 7168), (7146, 1024), (7146, 40960), (20418, 7168)]
DENSE_GEMM_NS = [1, 3, 4, 8, 32, 48, 56, 64]
# rows: decode (llama2 8 slots, the dense configs 4, Mixtral's E*C = 16),
# prefill chunks (llama2 64 and the prefix path's 3, 48 and 56 after a
# hit, Mixtral 160); widths: llama2's kept 4083 / 10974, Mixtral's expert
# wo 14336, the powers of 2, 20480 and 8191 (the widest row of plan
# (256, 16): its shared memory and the static row sums just past 48 KB),
# and the dense configs' kept widths 1020-20418
RHT_NS = [1, 3, 4, 8, 16, 48, 56, 64, 160]
RHT_DIMS = [2048, 4096, 8192, 16384, 4083, 8191, 10974, 14336, 20480,
            1020, 2041, 3062, 7146, 8167, 20418]
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
# + the capacities speculation gives Mixtral's 8 slots: C = 5 for the
# draft's catch-up (16 tokens), C = 10 for the verify (32 tokens)
GROUPED_CHECK_SHAPES = GROUPED_SHAPES + [(3, 100, 4083, 1024),
                                         (8, 5, 4096, 28672),
                                         (8, 10, 4096, 28672),
                                         (8, 10, 14336, 4096)]
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
    shape and its row counts (GEMM_SHAPES x GEMM_NS, DENSE_GEMM_SHAPES x
    DENSE_GEMM_NS).  The unfused GEMM gets an already-rotated x."""
    worst = dict.fromkeys(("fused", "unfused", "rel"), 0.0)
    shapes = [(d, c, n) for group, ns in ((GEMM_SHAPES, GEMM_NS),
                                          (DENSE_GEMM_SHAPES, DENSE_GEMM_NS))
              for d, c in group for n in ns]
    for d, c, n in shapes:
        for bits in GEMM_BITS:
            x, packed, rescale, s1, s2 = gemm_inputs(gen, dev, n, d, c, bits)
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
                check(bool(torch.isfinite(got).all()) and err <= RTOL * scale,
                      f"{name} GEMM n={n} d={d} c={c} bits={bits}: "
                      f"max|err| {err} > {RTOL} * {scale}")
                worst[name] = max(worst[name], err)
                worst["rel"] = max(worst["rel"], err / scale)
    log(f"rht_qmatmul and qmatmul: {len(shapes) * len(GEMM_BITS)} cases each "
        f"(bits 1-8; n {GEMM_NS} at {GEMM_SHAPES}, n {DENSE_GEMM_NS} at "
        f"{DENSE_GEMM_SHAPES}) within {RTOL} * max|plain|; max|err| fused "
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
    fused GEMM launches it, rows padded to a multiple of 64 with their
    sums); with ``full`` also eager calls, the plain version and the library
    call, which multiplies x by the dense (d, d) matrix of the same linear
    map (practical_rht of the identity)."""
    x = torch.randn((n, d), generator=gen, device=dev)
    s1, s2 = draw_signs(d, gen)
    out_ld = -(-d // qops.K_CHUNK) * qops.K_CHUNK
    out = {"n": n, "d": d, "plan": hops.rotate_plan(d),
           "ms": graph_ms(lambda: hops.rht_cuda(x, s1, s2)),
           "padded_ms": graph_ms(
               lambda: hops.rht_padded_cuda(x, s1, s2, out_ld))}
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
    L2): ``ms`` by CUDA-graph replay, ``call_ms`` eager calls back to
    back."""
    w = torch.randn((d, c), generator=gen, device=dev)

    def kernel():
        return rq_ops.quantize_cuda(w, bits, N_CAND)
    call_ms = time_ms(kernel, iters=5, warmup=1)
    k_ms = graph_ms(kernel, iters=5)
    # one candidate: the three passes over w with almost no sweep
    one_ms = graph_ms(lambda: rq_ops.quantize_cuda(w, bits, 1), iters=5)
    p_ms = (time_ms(lambda: rq_ops.quantize_ref(w, bits, N_CAND), iters=3,
                    warmup=1) if plain else None)
    del w
    return {"d": d, "c": c, "bits": bits,
            "slices": rq_ops.search_plan(d), "ms": k_ms,
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
    # the dense configs' decode at their serving contexts (64-232):
    # qwen3-0.6b and internlm2-1.8b G = 2, llama3.2-3b G = 3, yi-34b G = 7
    ("f32 G=2: H=16, KV=8", 1, 16, 8, torch.float32, None, None, 232, 64),
    ("f32 G=3: H=24, KV=8", 1, 24, 8, torch.float32, None, None, 232, 64),
    ("f32 G=7: H=56, KV=8", 1, 56, 8, torch.float32, None, None, 232, 64),
    # speculation on llama2 (G = 1): the draft's catch-up (W = 2) and the
    # verify of k = 3 proposals (W = 4), f32 and bf16 arenas
    ("spec f32 W=2 G=1", 2, 32, 32, torch.float32, None, None, 1024, None),
    ("spec bf16 W=2 G=1", 2, 32, 32, torch.bfloat16, None, None, 1024, None),
    ("spec f32 W=4 G=1", 4, 32, 32, torch.float32, None, None, 1024, None),
    ("spec bf16 W=4 G=1", 4, 32, 32, torch.bfloat16, None, None, 1024,
     None),
    # Mixtral's verify (W = 4, G = 4: R = 16) under its 4096 window over a
    # wrapped ring, positions up to k = 3 past the decode case's frontier;
    # the engine's ring holds window + lookahead (257 blocks)
    ("mixtral verify f32 W=4 G=4 window 4096, ring of 256 blocks", 4, 32, 8,
     torch.float32, 4096, 256, 4195, 3900),
    ("mixtral verify f32 W=4 G=4 window 4096, ring of 257 blocks", 4, 32, 8,
     torch.float32, 4096, 257, 4195, 3900),
    ("mixtral verify bf16 W=4 G=4 window 4096, ring of 257 blocks", 4, 32,
     8, torch.bfloat16, 4096, 257, 4195, 3900),
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
    # speculation on the same mix: the target's verify (W = 4) and the
    # draft's catch-up (W = 2), the table 35 blocks wide (lookahead 3)
    ("spec verify f32 B=8 W=4 ctx 128-547", 4, 32, 32, torch.float32, None,
     None, 35, 547, 128),
    ("spec catch-up f32 B=8 W=2 ctx 128-545", 2, 32, 32, torch.float32,
     None, None, 35, 545, 128),
    ("mixtral verify f32 B=8 W=4 G=4 window 4096, pos 3900-4195", 4, 32, 8,
     torch.float32, 4096, 257, 257, 4195, 3900),
]


def attn_splits(args) -> int:
    """The grid splits the wrapper picks for these inputs."""
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
        if name in ("f32 W=1", "f32 G=4", "mixtral verify f32 W=4 G=4 "
                    "window 4096, ring of 257 blocks"):  # one split; more
            again = pops.paged_attention_cuda(*args, window=window)
            check(torch.equal(got, again),
                  f"paged_attention {name}: two calls differ")
    # the prefix cache: every slot's table starts with slot 0's 32 blocks
    # (a cached 512-token system prompt), contexts 520-600 past them
    args = attn_inputs(gen, dev, b, 1, 32, 32, hd, bs, 42, 600,
                       torch.float32, None, ctx_lo=520)
    args[3][1:, :32] = args[3][0, :32]
    got = pops.paged_attention_cuda(*args)
    want = paged_attention_ref(*args)
    torch.cuda.synchronize()
    err, scale = err_and_scale(got, want)
    check(bool(torch.isfinite(got).all()) and err <= RTOL * scale,
          f"paged_attention over shared blocks: max|err| {err} > {RTOL} * "
          f"{scale}")
    worst = max(worst, err)
    cases.append({"case": "f32 shared 32-block prefix", "splits": attn_splits(
        args), "max_abs_err": err, "max_abs_plain": scale})
    # an inactive engine slot: pos 0, ring 1, all-zero table -> null block
    q, k, v, bt, pos, ring = attn_inputs(gen, dev, 2, 1, 32, 32, hd, bs, 4,
                                         64, torch.float32, None)
    bt[1], pos[1], ring[1] = 0, 0, 1
    got = pops.paged_attention_cuda(q, k, v, bt, pos, ring)
    check(bool(torch.isfinite(got).all()), "inactive slot gave non-finite")
    log(f"paged_attention: {len(cases)} cases + an inactive slot within "
        f"{RTOL} * max|plain|, three cases bitwise repeatable; max|err| "
        f"{worst:.3e}; splits {[c['splits'] for c in cases]}")
    return {"max_abs_err": worst, "cases": cases, "deterministic": True}


def sdpa_decode(q, k_arena, v_arena, bt, pos, ring):
    """One PyTorch call computing the same decode attention on K/V already
    gathered dense (timing only): (B, H, W, hd) queries over each
    request's min(pos, ring) live keys, a key-padding mask where the
    requests differ, and for W > 1 the causal mask within the span (where
    the ring has not wrapped, a key's slot is its position)."""
    b, w, h, hd = q.shape
    _, bs, kv, _ = k_arena.shape
    live = torch.minimum(pos.clamp(min=1), ring.clamp(min=1))
    nb = int((live.max() + bs - 1) // bs)
    kd = k_arena[bt[:, :nb].long()].reshape(b, nb * bs, kv, hd).transpose(
        1, 2).contiguous()
    vd = v_arena[bt[:, :nb].long()].reshape(b, nb * bs, kv, hd).transpose(
        1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous().to(kd.dtype)
    kpos = torch.arange(nb * bs, device=q.device)[None, None, :]
    keep = kpos < live[:, None, None]                       # (B, 1, L)
    if w > 1:
        qpos = (pos[:, None] - w + torch.arange(w, device=q.device))[
            :, :, None]
        keep = keep & ((kpos <= qpos) | (pos > ring)[:, None, None])
    mask = None if bool(keep.all()) else keep[:, None]
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


def quantize_phase(dev, compare: bool = True, draft_bits: float | None = None
                   ) -> tuple[dict, dict, dict | None]:
    """Build fp32 llama2-7b on the card, calibrate, allocate and quantize it
    with the code-search kernel (the main path, counted), then (``compare``)
    quantize the same layers with the plain code search and compare.  With
    ``draft_bits`` the target and a draft at that budget come from
    ``quantize_model_dual`` (one calibration, one set of signs; both
    quantizations counted); returns (summary, target, draft or None)."""
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
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    draft = None
    if draft_bits is None:
        qparams, rep = pipe.quantize_model(cfg, params, stats, AVG_BITS,
                                           generator=gen, device=dev)
    else:
        qparams, rep, draft, drep = pipe.quantize_model_dual(
            cfg, params, stats, AVG_BITS, draft_bits, generator=gen,
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
    if draft is not None:
        out["draft"] = draft_summary(qparams, draft, drep, draft_bits)
    check(launches == rep.n_layers * (1 if draft is None else 2)
          and rep.n_layers == cfg.n_layers * 6,
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
    return out, qparams, draft


def draft_summary(target, draft, drep, draft_bits) -> dict:
    """The draft's report beside the target's, and the sharing the dual
    quantization promises, checked: every quantized weight's signs are the
    target's tensors, the fp leaves are shared, the draft's bits are
    lower."""
    tq, dq = quantized_linears(target), quantized_linears(draft)
    hist = collections.Counter(drep.per_layer_bits.values())
    out = {"avg_bits": drep.avg_bits, "requested_avg_bits": draft_bits,
           "allocate_s": drep.allocate_s, "quantize_s": drep.quantize_s,
           "wall_s": drep.wall_time_s,
           "bits_histogram": {str(b): hist[b] for b in sorted(hist)},
           "packed_gb": sum(q.packed.numel() for q in dq.values()) / 1e9,
           "side_info_gb": sum(quant_bytes(q, QUANT_TENSORS[1:])
                               for q in dq.values()) / 1e9}
    log(f"draft quantize ({draft_bits} bits): allocate_s "
        f"{drep.allocate_s:.2f}, quantize_s {drep.quantize_s:.2f}; achieved "
        f"{drep.avg_bits:.4f} bits; widths {out['bits_histogram']}; packed "
        f"codes {out['packed_gb']:.3f} GB + side info "
        f"{out['side_info_gb']:.3f} GB")
    check(set(tq) == set(dq) and all(
        dq[n].signs1 is tq[n].signs1 and dq[n].signs2 is tq[n].signs2
        for n in tq) and draft["embed"] is target["embed"]
          and draft["lm_head"] is target["lm_head"],
          "the draft does not share the target's rotation and fp leaves")
    check(drep.avg_bits < draft_bits + 0.05 and drep.avg_bits <= draft_bits
          and drep.avg_bits < AVG_BITS,
          f"the draft achieved {drep.avg_bits} bits for {draft_bits}")
    return out


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
    kernels.set_launch_counts(dict.fromkeys(kernels.launch_counts(), 0))


def counts() -> dict:
    """Every kernel wrapper's launch counter, by kernel (a replayed graph
    credits the launches its capture recorded)."""
    return kernels.launch_counts()


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
            "captures": {"decode": engine.decode_trace_count,
                         "chunk": engine.chunk_trace_count},
            "capture_s": st["capture_s"],
            "graph_pool_mib": st["graph_pool_bytes"] / 2**20,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "tokens_past_ring": engine.past_ring,
            # llama2's random churn prompts never hit; Mixtral bypasses
            "prefix_cache": ("bypassed" if engine.prefix_cache is None
                             else "on"),
            "prefill_tokens_saved": st.get("prefill_tokens_saved", 0),
            "decode_step_bound_ms": decode_step_bound_ms(
                cfg, params, float(np.mean(engine.step_tokens)))}


# serve runs per mode, for the spread of the host-clock step times
REPEATS = 3
SPREAD_KEYS = ("decode_step_ms", "prefill_s", "wall_s", "tok_per_s",
               "capture_s")


def serve_repeats(cfg, params, dev, pool, prompt_lens, mode: str) -> tuple:
    """REPEATS serve runs of the same requests in one mode -- "graph" (the
    engine's default: each step captured once, then replayed) or "eager"
    (under ``graphs.eager()``, op by op) -- each counted from zero.  Every
    run must give the first run's tokens and launch counts.  Returns the
    first run's engine and results, and its summary with each
    SPREAD_KEYS metric over the runs (``repeats``)."""
    runs = []
    for _ in range(REPEATS):
        zero_counts()
        with graphs.eager(mode == "eager"):
            engine, results, wall = serve(cfg, params, dev, pool,
                                          prompt_lens=prompt_lens)
        summary = serve_summary(engine, results, wall, cfg, params,
                                prompt_lens)
        summary["launches"] = counts()
        runs.append(summary)
        if len(runs) == 1:
            first, first_results = engine, results
        else:
            check(all(np.array_equal(r.tokens, first_results[rid].tokens)
                      for rid, r in results.items())
                  and summary["launches"] == runs[0]["launches"],
                  f"{mode} serve runs differ in tokens or launches")
        del engine
    out = dict(runs[0])
    out["repeats"] = {k: [r[k] for r in runs] for k in SPREAD_KEYS}
    return first, first_results, out


def spread(values) -> str:
    return (f"median {float(np.median(values)):.4g} (min {min(values):.4g}, "
            f"max {max(values):.4g})")


def log_serve(name, mode, out, cfg) -> None:
    rep = out["repeats"]
    log(f"{name} serve {mode}: {out['tokens']} tokens, {REPEATS} runs; decode "
        f"ms/step {spread(rep['decode_step_ms'])} over "
        f"{out['decode_steps']} steps (bound "
        f"{out['decode_step_bound_ms']:.3f} ms); prefill_s "
        f"{spread(rep['prefill_s'])} over {out['prefill_chunks']} chunks; "
        f"tok/s {spread(rep['tok_per_s'])}; captures {out['captures']} in "
        f"{spread(rep['capture_s'])} s; graph pool "
        f"{out['graph_pool_mib']:.1f} MiB; peak {out['peak_mem_gib']:.2f} "
        f"GiB; launches {out['launches']}; GEMM launches "
        f"{out['gemm_launches']}; {out['tokens_past_ring']} tokens past the "
        f"{cfg.window}-token ring; prefix cache {out['prefix_cache']} "
        f"({out['prefill_tokens_saved']} prompt tokens saved)")


def mode_row(out) -> dict:
    """One serving mode's numbers: host-clock step times over the repeats,
    the profiles' device ms, idle share and launches per decode step and
    per prefill chunk, the captures and the graph pool."""
    row = {k: out["repeats"][k] for k in ("decode_step_ms", "prefill_s",
                                          "capture_s")}
    for prof in ("decode_profile", "prefill_profile"):
        row[prof] = {k: out[prof][k] for k in (
            "wall_ms_per_step", "unprofiled_wall_ms_per_step",
            "device_ms_per_step", "idle_share", "unprofiled_idle_share",
            "launches_per_step")}
    row.update(captures=out["captures"], graph_pool_mib=out["graph_pool_mib"])
    return row


def serve_four_ways(name, cfg, params, dev, pool, prompt_lens, labels=()
                    ) -> dict:
    """The same requests served four ways: by graph (the default), by eager
    kernels (``graphs.eager()``), each REPEATS times; unfused (by graph);
    and with the plain versions forced (eager: the engine captures nothing
    while a kernel is forced onto its plain version).  Graph and eager must
    give identical tokens and identical launch counts per kernel; unfused
    and plain may diverge only at a near-tie.  Decode steps and prefill
    chunks are profiled in both modes (``labels`` name ranges in the eager
    profiles; a replayed graph runs no Python)."""
    for fused in (True, False):     # warm-up outside the counts
        PagedServer(cfg, params, pool, fused=fused, device=dev).run(
            [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])

    engine, results, out = serve_repeats(cfg, params, dev, pool, prompt_lens,
                                         "graph")
    _, eager_results, eager = serve_repeats(cfg, params, dev, pool,
                                            prompt_lens, "eager")
    out["weights_only_bound_ms"] = decode_step_bound_ms(cfg, params, 0.0)
    out["eager"] = eager
    out["request_tokens"] = token_lists(results)
    log_serve(name, "by graph", out, cfg)
    log_serve(name, "eager", eager, cfg)
    same = sum(np.array_equal(r.tokens, eager_results[rid].tokens)
               for rid, r in results.items())
    log(f"{name}: graph and eager tokens identical for {same}/"
        f"{len(results)} requests; launches equal: "
        f"{out['launches'] == eager['launches']}")
    check(same == len(results), f"{name}: graph and eager tokens differ")
    check(out["launches"] == eager["launches"],
          f"{name}: graph launches {out['launches']} != eager "
          f"{eager['launches']}")
    check(out["captures"] == {"decode": 1, "chunk": len(
        {min(pool.prefill_chunk, n - s) for n in prompt_lens
         for s in range(0, n, pool.prefill_chunk)})}
          and eager["captures"] == {"decode": 0, "chunk": 0},
          f"{name}: captures graph {out['captures']}, eager "
          f"{eager['captures']}")

    # launches one decode step makes, counted on a direct call, against
    # what the decode graph's capture recorded
    per_step = launches_per_decode_step(cfg, params, dev, engine)
    out["launches_per_decode_step"] = per_step
    recorded = engine.graphs.steps[("decode", True, pool.max_slots)].launches
    log(f"{name} launches per decode step: {per_step}; the decode graph "
        f"replays {recorded}")
    check(recorded == per_step["fused"],
          f"{name}: the decode graph recorded {recorded}, a direct step "
          f"launches {per_step['fused']}")
    del engine
    out["decode_profile"] = profile_decode(cfg, params, dev, pool)
    out["prefill_profile"] = profile_prefill(cfg, params, dev, pool)
    with graphs.eager():
        eager["decode_profile"] = profile_decode(cfg, params, dev, pool,
                                                 labels=labels)
        eager["prefill_profile"] = profile_prefill(cfg, params, dev, pool,
                                                   labels=labels)
    out["modes"] = {mode: mode_row(o) for mode, o in (("graph", out),
                                                      ("eager", eager))}
    log(f"{name} graph vs eager: {json.dumps(out['modes'])}")

    # the unfused A/B path: the RHT kernel, then the unfused GEMM kernel
    zero_counts()
    unf, unf_results, unf_wall = serve(cfg, params, dev, pool, fused=False,
                                       prompt_lens=prompt_lens)
    unfused = serve_summary(unf, unf_results, unf_wall, cfg, params,
                            prompt_lens)
    unfused["launches"] = counts()
    unfused["divergences"] = divergences(results, unf_results, unf)
    out["unfused"] = unfused
    log(f"{name} serve unfused (by graph): {unfused['tokens']} tokens in "
        f"{unf_wall:.2f} s = {unfused['tok_per_s']:.1f} tok/s; prefill "
        f"{unfused['prefill_s']:.2f} s; decode "
        f"{unfused['decode_step_ms']:.2f} ms/step (bound "
        f"{unfused['decode_step_bound_ms']:.3f} ms); captures "
        f"{unfused['captures']}; launches {unfused['launches']}; greedy "
        f"tokens identical to fused for "
        f"{len(results) - len(unfused['divergences'])}/{len(results)}")
    del unf

    # the same requests with the plain versions forced on the card
    for ops in (qops, pops, hops):
        ops.set_forced_path("ref")
    try:
        plain, plain_results, plain_wall = serve(cfg, params, dev, pool,
                                                 prompt_lens=prompt_lens)
    finally:
        for ops in (qops, pops, hops):
            ops.set_forced_path(None)
    out["plain_wall_s"] = plain_wall
    out["plain_tok_per_s"] = out["tokens"] / plain_wall
    out["plain_captures"] = {"decode": plain.decode_trace_count,
                             "chunk": plain.chunk_trace_count}
    out["divergences"] = divergences(results, plain_results, plain)
    log(f"{name} serve fused (plain versions, eager): {plain_wall:.2f} s; "
        f"greedy tokens identical for "
        f"{len(results) - len(out['divergences'])}/{len(results)} requests; "
        f"accepted near-tie divergences: {len(out['divergences'])}; "
        f"captures {out['plain_captures']}")
    check(out["plain_captures"] == {"decode": 0, "chunk": 0},
          f"{name}: the plain run captured {out['plain_captures']}")
    return out


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
    run on the host clock and ``steps`` more under torch.profiler
    (``profile_steps``)."""
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


def profile_prefill(cfg, params, dev, pool, chunks: int = 3,
                    labels=()) -> dict:
    """Where a prefill chunk's time goes: one request of (2 chunks + 2)
    full chunks is admitted, its first chunk runs outside the measurement,
    then ``chunks`` steps that each run one 64-token chunk and nothing else
    (no request is decoding yet) run on the host clock and ``chunks`` more
    under torch.profiler."""
    engine = PagedServer(cfg, params, pool, device=dev)
    rng = np.random.default_rng(SEED + 2)
    engine.submit(Request(rid=200, max_new=2, prompt=rng.integers(
        0, cfg.vocab, (2 * chunks + 2) * pool.prefill_chunk).astype(np.int32)))
    engine.step()
    out = profile_steps(engine, chunks, labels)
    check(engine.stats["prefill_chunks"] == 2 * chunks + 1
          and not engine.stats.get("decode_steps"),
          "the prefill profile ran something other than prompt chunks")
    log(f"prefill profile: {json.dumps(out)}")
    return out


def profile_steps(engine, steps: int, labels=()) -> dict:
    """``steps`` engine steps on the host clock, then ``steps`` more under
    torch.profiler.  Device time is the sum of kernel times (one stream, so
    kernels do not overlap); the idle share is the rest of the host-clock
    step time, under the profiler (``idle_share``, which the profiler's own
    cost inflates) and without it (``unprofiled_idle_share``: the first
    steps' wall against the profiled steps' device time).  ``labels`` (see
    ``labelled``) name ranges whose device time is reported too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    unprofiled = time.monotonic() - t0
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
           "unprofiled_wall_ms_per_step": 1e3 * unprofiled / steps,
           "device_ms_per_step": dev_us / 1e3 / steps if dev_us else None,
           "idle_share": 1 - dev_us / 1e6 / wall if dev_us else None,
           "unprofiled_idle_share": (1 - dev_us / 1e6 / unprofiled
                                     if dev_us else None),
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
    out = serve_four_ways("llama2", cfg, params, dev, llama2_pool(),
                          PROMPT_LENS)
    launches, unf = out["launches"], out["unfused"]["launches"]
    check(launches["rht_qmatmul"] > 0 and launches["paged_attention"] > 0,
          f"a kernel of the fused path never launched: {launches}")
    # the cache is on, but no churn prompt shares a block with another, so
    # every run prefills every prompt token, as before the cache existed
    check(out["prefix_cache"] == "on" and out["prefill_tokens_saved"] == 0
          and out["eager"]["prefill_tokens_saved"] == 0,
          "llama2's churn prompts hit the prefix cache")
    check(unf["rht"] > 0 and unf["qmatmul"] > 0 and unf["rht_qmatmul"] == 0,
          f"the unfused path did not run its kernels: {unf}")
    return out


# ------------------------------------------------------------ prefix cache

PREFIX_SYSTEM = 512      # the shared system prompt: 32 blocks of 16
PREFIX_TAIL = 64         # each request's own tail
PREFIX_REQUESTS = 16     # two admission waves over 8 slots
PREFIX_COW_KEEP = 8      # tokens of request 0's tail the COW request keeps
PRESSURE_REQUESTS = 4    # the pressure pool: 4 requests' full capacity
ENGINE_COUNTERS = ("prompt_tokens", "prefill_tokens_saved", "prefix_hits",
                   "prefix_cow", "prefix_hit_rate", "prefix_evictions",
                   "prefix_cached_blocks", "replays", "preemptions",
                   "cancelled")


def prefix_pool(num_blocks=None, prefix_cache=True) -> PoolConfig:
    """llama2's serving pool (8 slots, block 16, chunk 64, f32 KV) with a
    context for the second turn: request 0's prompt and output, 32 new
    tokens, 32 generated (672 tokens, 42 blocks)."""
    return PoolConfig(max_slots=8, block_size=16,
                      max_context=PREFIX_SYSTEM + PREFIX_TAIL + 3 * GEN_LEN,
                      num_blocks=num_blocks, prefill_chunk=64,
                      prefix_cache=prefix_cache)


def prefix_requests(cfg) -> list:
    """16 requests sharing a 512-token system prompt, each with its own
    64-token tail, and one that follows the system prompt and 8 tokens of
    request 0's tail, then diverges inside that block (a COW clone)."""
    rng = np.random.default_rng(SEED + 3)

    def toks(n):
        return rng.integers(0, cfg.vocab, n).astype(np.int32)
    system = toks(PREFIX_SYSTEM)
    tails = [toks(PREFIX_TAIL) for _ in range(PREFIX_REQUESTS)]
    cow = np.concatenate([system, tails[0][:PREFIX_COW_KEEP],
                          toks(PREFIX_TAIL - PREFIX_COW_KEEP)])
    return [Request(rid=i, prompt=np.concatenate([system, t]),
                    max_new=GEN_LEN) for i, t in enumerate(tails)] + [
        Request(rid=PREFIX_REQUESTS, prompt=cow, max_new=GEN_LEN)]


def second_turn(cfg, first: Request, output) -> Request:
    """A second turn of ``first``'s conversation: its prompt, its output,
    then 32 new tokens; it hits the blocks ``first`` generated."""
    new = np.random.default_rng(SEED + 4).integers(0, cfg.vocab, GEN_LEN)
    return Request(rid=PREFIX_REQUESTS + 1, max_new=GEN_LEN,
                   prompt=np.concatenate([first.prompt, output,
                                          new]).astype(np.int32))


def prefix_summary(engine, wall: float) -> dict:
    """One run's numbers, its launches counted from zero, and the pool's
    state after it; every block must be back (free or cached idle) with no
    reference left."""
    st, a = engine.stats, engine.allocator
    if engine.speculate:
        steps = {"spec_rounds": st["spec_rounds"],
                 "ms_per_round": 1e3 * st["spec_s"] / st["spec_rounds"],
                 "acceptance_rate": st["acceptance_rate"]}
    else:
        steps = {"decode_steps": st["decode_steps"],
                 "decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"]}
    out = {"wall_s": wall, "prefill_s": st["prefill_s"],
           "prefill_chunks": st["prefill_chunks"],
           "prefill_tokens": st["prefill_tokens"], **steps,
           "captures": dict(engine.graphs.captures),
           "chunk_lengths": sorted(k[2] for k in engine.graphs.steps
                                   if k[0] == "chunk"),
           "capture_s": st["capture_s"],
           "graph_pool_mib": st["graph_pool_bytes"] / 2**20,
           "launches": counts(), "gemm_launches": engine.gemms,
           "num_blocks": a.num_blocks, "free_blocks": a.free_blocks,
           "cached_idle_blocks": a.cached_idle_blocks,
           "referenced_blocks": len(a._ref),
           **{k: st[k] for k in ENGINE_COUNTERS if k in st}}
    check(a.free_blocks == a.num_blocks - 1 and not a._ref,
          f"blocks did not drain: {a.free_blocks} of {a.num_blocks - 1} "
          f"free, {len(a._ref)} still referenced")
    return out


def serve_prefix(cfg, params, dev, pool) -> tuple:
    """The shared-prefix workload on a fresh engine, counted from zero:
    the 17 requests, then the second turn built from request 0's output.
    Returns (results, top-2 gaps, summary)."""
    zero_counts()
    engine = GapRecordingServer(cfg, params, pool, device=dev)
    reqs = prefix_requests(cfg)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = engine.run(reqs)
    results.update(engine.run([second_turn(cfg, reqs[0],
                                           results[0].tokens)]))
    torch.cuda.synchronize()
    out = prefix_summary(engine, time.monotonic() - t0)
    check(len(results) == PREFIX_REQUESTS + 2
          and all(len(r.tokens) == GEN_LEN
                  and all(0 <= int(t) < cfg.vocab for t in r.tokens)
                  for r in results.values()),
          "the prefix workload produced malformed output")
    return results, engine.gaps, out


def token_lists(results) -> dict:
    """rid -> the request's tokens as a list (JSON-ready)."""
    return {rid: [int(t) for t in r.tokens] for rid, r in results.items()}


def same_tokens(what: str, want: dict, got: dict, gaps: dict) -> None:
    """Every request's tokens identical; a failure names each differing
    request, its first differing step and that step's top-2 logit gap."""
    bad = []
    for rid, r in want.items():
        a, b = r.tokens, got[rid].tokens
        if not np.array_equal(a, b):
            step = int(np.argmax(a != b)) if len(a) == len(b) else 0
            bad.append((rid, step, gaps.get((rid, step))))
    check(not bad, f"{what}: tokens differ (rid, step, (gap, scale)): {bad}")


def log_prefix(name: str, out: dict) -> None:
    log(f"prefix {name}: prefill_s {out['prefill_s']:.4f} over "
        f"{out['prefill_chunks']} chunks ({out['prefill_tokens']} tokens); "
        f"decode {out['decode_step_ms']:.3f} ms/step over "
        f"{out['decode_steps']} steps; wall {out['wall_s']:.2f} s; captures "
        f"{out['captures']} (chunk lengths {out['chunk_lengths']}) in "
        f"{out['capture_s']:.3f} s; graph pool {out['graph_pool_mib']:.1f} "
        f"MiB; cache {({k: out[k] for k in ENGINE_COUNTERS if k in out})}; "
        f"blocks {out['free_blocks']}/{out['num_blocks'] - 1} free, "
        f"{out['cached_idle_blocks']} cached idle; launches "
        f"{out['launches']}")


def preempt_run(cfg, params, dev, pool, victim: int = 0,
                after: int = 3) -> tuple:
    """The churn workload by graph with ``victim`` preempted after its
    ``after``-th token and resubmitted at once; counted from zero."""
    zero_counts()
    engine = GapRecordingServer(cfg, params, pool, device=dev)
    engine.start_clock()
    for r in requests(cfg):
        engine.submit(r)
    results, preempted = {}, False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    while engine.poll():
        results.update(engine.step())
        for req, phase, n, _ in ([] if preempted else engine.inflight()):
            if req.rid == victim and phase == "decode" and n >= after:
                engine.submit(engine.preempt(victim))
                preempted = True
    torch.cuda.synchronize()
    engine.finalize_stats()
    check(preempted, f"request {victim} finished before its preemption")
    return results, prefix_summary(engine, time.monotonic() - t0)


def cancel_run(cfg, params, dev, pool) -> tuple:
    """The churn workload plus a ninth request by graph: the ninth is
    cancelled while queued, request 1 (512 prompt tokens) after its first
    chunk, request 0 after two decode tokens.  Counted from zero."""
    zero_counts()
    engine = GapRecordingServer(cfg, params, pool, device=dev)
    engine.start_clock()
    extra = Request(rid=len(PROMPT_LENS), max_new=GEN_LEN, prompt=np.arange(
        128, dtype=np.int32))
    for r in requests(cfg) + [extra]:
        engine.submit(r)
    results, phases = {}, {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    while engine.poll():
        results.update(engine.step())
        for req, phase, n, _ in engine.inflight():
            started = any(s.filled for s in engine._prefilling
                          if s.req.rid == req.rid)
            if (req.rid not in phases and (
                    (req.rid == extra.rid and phase == "pending")
                    or (req.rid == 1 and phase == "prefill" and started)
                    or (req.rid == 0 and phase == "decode" and n >= 2))):
                check(engine.cancel(req.rid), f"cancel({req.rid}) failed")
                phases[req.rid] = phase
    torch.cuda.synchronize()
    engine.finalize_stats()
    check(phases == {extra.rid: "pending", 1: "prefill", 0: "decode"}
          and set(results) == set(range(2, len(PROMPT_LENS))),
          f"cancelled {phases}, finished {sorted(results)}")
    return results, phases, prefix_summary(engine, time.monotonic() - t0)


def prefix_phase(dev, params) -> dict:
    """The prefix cache, copy-on-write and drop-and-replay preemption on
    full-width llama2-7b, four ways:

      (a) the shared-prefix workload (``prefix_requests`` and the second
          turn) with the cache on by graph, off by graph, on eagerly;
      (b) the same with a pool of 4 requests' capacity, so admissions wait
          on blocks and evict idle cached ones, cache on and cold;
      (c) the churn workload with request 0 preempted after its third
          token and resubmitted, against an uninterrupted run;
      (d) cancels while queued, mid-prefill and mid-decode.

    Tokens must be identical in every pair (on / off, graph / eager,
    pressure / cold, preempted / uninterrupted, cancelled / uninterrupted
    for the rest), and the blocks must drain after every run."""
    cfg = get_config("llama2-7b")
    PagedServer(cfg, params, prefix_pool(), device=dev).run(   # warm-up
        [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])
    out = {}
    base, gaps, out["on"] = serve_prefix(cfg, params, dev, prefix_pool())
    out["on"]["request_tokens"] = token_lists(base)
    runs = {"off": (prefix_pool(prefix_cache=False), False),
            "on eager": (prefix_pool(), True)}
    need = request_blocks(cfg, prefix_pool(),
                          PREFIX_SYSTEM + PREFIX_TAIL + GEN_LEN)
    pressure = 1 + PRESSURE_REQUESTS * need
    runs.update({"pressure": (prefix_pool(pressure), False),
                 "pressure cold": (prefix_pool(pressure, False), False)})
    for name, (pool, eager) in runs.items():
        with graphs.eager(eager):
            results, _, out[name] = serve_prefix(cfg, params, dev, pool)
        same_tokens(f"prefix {name} against on", base, results, gaps)
    for name in ("on", *runs):
        log_prefix(name, out[name])
    on, off = out["on"], out["off"]
    for name in ("on", "on eager", "pressure"):
        r = out[name]
        check(r["prefill_tokens"] + r["prefill_tokens_saved"]
              == r["prompt_tokens"] and r["prefill_tokens_saved"] > 0
              and r["prefix_cow"] >= 1,
              f"prefix {name}: cache counters {r}")
    check("prompt_tokens" not in off and "prompt_tokens" not in
          out["pressure cold"], "the cache-off runs used the cache")
    check(on["captures"].get("decode") == 1 and on["captures"].get("cow") == 1
          and off["captures"].get("decode") == 1
          and out["pressure"]["captures"].get("decode") == 1,
          f"captures: on {on['captures']}, off {off['captures']}, pressure "
          f"{out['pressure']['captures']}")
    check(not out["on eager"]["captures"], "the eager run captured")
    check(on["launches"] == out["on eager"]["launches"],
          f"prefix on: graph launches {on['launches']} != eager "
          f"{out['on eager']['launches']}")
    check(out["pressure"]["prefix_evictions"] > 0,
          "the pressure pool evicted no cached block")

    # (c) preemption, against an uninterrupted run of the same requests
    pool = llama2_pool()
    zero_counts()
    plain_eng, want, wall = serve(cfg, params, dev, pool)
    out["churn"] = prefix_summary(plain_eng, wall)
    del plain_eng
    got, out["preempt"] = preempt_run(cfg, params, dev, pool)
    same_tokens("preempted against uninterrupted", want, got, {})
    res0 = got[0]
    recomputed = out["preempt"]["prefill_tokens"] - sum(PROMPT_LENS)
    out["preempt"]["replay_recomputed_tokens"] = recomputed
    check(out["preempt"]["replays"] == out["preempt"]["preemptions"] == 1
          and res0.preemptions == 1
          and 0 < recomputed <= pool.prefill_chunk
          and out["preempt"]["prefix_hits"] == 1
          and len(res0.token_times) == GEN_LEN
          and bool(np.all(np.diff(res0.token_times) >= 0))
          and out["preempt"]["captures"].get("decode") == 1,
          f"preemption: {out['preempt']}; recomputed {recomputed}")
    log_prefix("churn uninterrupted", out["churn"])
    log_prefix("churn, request 0 preempted after 3 tokens", out["preempt"])

    # (d) cancel while queued, mid-prefill and mid-decode
    got, phases, out["cancel"] = cancel_run(cfg, params, dev, pool)
    same_tokens("the requests that were not cancelled", {
        rid: want[rid] for rid in got}, got, {})
    check(out["cancel"]["cancelled"] == 3, f"cancel: {out['cancel']}")
    out["cancel"]["phases"] = {str(k): v for k, v in phases.items()}
    log_prefix(f"churn + 1, cancelled {phases}", out["cancel"])

    saved = on["prefill_tokens_saved"] / on["prompt_tokens"]
    log(f"prefix on vs off: prefill_s {on['prefill_s']:.4f} / "
        f"{off['prefill_s']:.4f} ({on['prefill_chunks']} / "
        f"{off['prefill_chunks']} chunks; {saved:.4f} of prompt tokens "
        f"saved); decode ms/step {on['decode_step_ms']:.3f} / "
        f"{off['decode_step_ms']:.3f}; prefix_hit_rate "
        f"{on['prefix_hit_rate']:.4f}; captures {on['captures']} in "
        f"{on['capture_s']:.3f} s / {off['captures']} in "
        f"{off['capture_s']:.3f} s; graph pool {on['graph_pool_mib']:.1f} / "
        f"{off['graph_pool_mib']:.1f} MiB; launches {on['launches']} / "
        f"{off['launches']}; {gpu_line()}")
    return out


# ------------------------------------------------------------ speculation

SPEC_K = 3               # draft tokens per round
DRAFT_BITS = 2.2         # the draft's average bit budget
SPEC_PROFILE_NEW = 192   # new tokens a profiled request asks for: rounds
#   emit up to SPEC_K + 1 tokens, so the requests outlast the profile


class SpecServer(GapRecordingServer):
    """A ``GapRecordingServer``, speculating or not, that also records per
    emitted token the MoE capacity overflows of the target step that
    produced it (with ``overflow``, a 0-d device counter the target's
    decode, verify and chunk steps add to; see ``moe.count_overflow``),
    checks every copy-on-write clone in each arena it must copy (the
    draft's too), and counts the GEMM launches of its rounds."""

    def __init__(self, *a, overflow=None, **kw):
        super().__init__(*a, **kw)
        self.overflow = overflow
        self.emit_overflow: dict = {}     # (rid, token index) -> overflows
        self.step_overflow: list = []     # per decode step or round
        self._emitted: list = []
        self.cow_checked = 0

    def _compiled(self, key, fn, inert):
        counter = self.overflow           # the closure holds no engine
        if counter is not None and key[0] in ("decode", "chunk", "verify"):
            inner = fn

            def fn(**inputs):
                with moemod.count_overflow(counter):
                    return inner(**inputs)
        return super()._compiled(key, fn, inert)

    def _overflows(self, decode: bool, fn, *a):
        self._emitted = []
        before = int(self.overflow) if self.overflow is not None else 0
        out = fn(*a)
        if self.overflow is not None:
            n = int(self.overflow) - before
            if decode:
                self.step_overflow.append(n)
            self.emit_overflow.update(dict.fromkeys(self._emitted, n))
        return out

    def _prefill_one(self, t0, results):
        return self._overflows(False, super()._prefill_one, t0, results)

    def _decode_once(self, t0, results):
        return self._overflows(True, super()._decode_once, t0, results)

    def _spec_decode_once(self, t0, results):
        return self._overflows(True, self._count_gemms, "decode",
                               super()._spec_decode_once, t0, results)

    def _emit(self, st, tok, now):
        self._emitted.append((st.req.rid, st.n_done))
        super()._emit(st, tok, now)

    def _cow(self, src, dst):
        super()._cow(src, dst)
        for cache in self.caches + (self.draft_caches or []):
            for arena in cache.values():
                check(torch.equal(arena[dst], arena[src]),
                      f"the copy-on-write clone of block {src} into {dst} "
                      f"missed an arena")
                self.cow_checked += 1


def arena_gib(engine) -> float:
    return sum(a.numel() * a.element_size() for c in
               engine.caches + (engine.draft_caches or [])
               for a in c.values()) / 2**30


def spec_serve(cfg, params, dev, pool, draft=None, reqs=None,
               overflow=None) -> tuple:
    """One run of ``reqs`` (default: the churn workload) on a fresh
    ``SpecServer``, speculating SPEC_K deep when ``draft`` is given; the
    peak memory is reset just before it."""
    kw = {"draft_params": draft, "speculate": SPEC_K} if draft else {}
    engine = SpecServer(cfg, params, pool, device=dev, overflow=overflow,
                        **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    results = engine.run(reqs or requests(cfg))
    torch.cuda.synchronize()
    return engine, results, time.monotonic() - t0


def spec_summary(engine, results, wall, n_requests) -> dict:
    """A speculating run's numbers: acceptance, rounds, a request's tokens
    per round, host ms per round (catch-up, draft steps, verify and the
    host work between them, ending in the verify's logits), ms per token a
    request receives (ms per round over its tokens per round: the number
    to hold against plain decode's ms/step), prefill, captures, the graph
    pool, peak memory and the arenas."""
    st = engine.stats
    check(len(results) == n_requests
          and all(len(r.tokens) == GEN_LEN for r in results.values()),
          "a speculating run produced malformed output")
    rounds = st["spec_rounds"]
    # every request's first token comes from its last prompt chunk
    emitted = sum(len(r.tokens) for r in results.values()) - len(results)
    # a request's tokens per round: each active slot proposes k a round
    per_round = emitted / (st["spec_proposed"] / SPEC_K)
    ms_round = 1e3 * st["spec_s"] / rounds
    return {"wall_s": wall, "acceptance_rate": st["acceptance_rate"],
            "spec_rounds": rounds, "spec_proposed": st["spec_proposed"],
            "spec_accepted": st["spec_accepted"], "spec_emitted": emitted,
            "tokens_per_round": per_round, "ms_per_round": ms_round,
            "ms_per_emitted_token": ms_round / per_round,
            "prefill_s": st["prefill_s"],
            "prefill_chunks": st["prefill_chunks"],
            "captures": dict(engine.graphs.captures),
            "chunk_lengths": sorted(k[2] for k in engine.graphs.steps
                                    if k[0] == "chunk"),
            "capture_s": st["capture_s"],
            "graph_pool_mib": st["graph_pool_bytes"] / 2**20,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "arena_gib": arena_gib(engine), "lookahead": engine.pool.lookahead,
            "gemm_launches": engine.gemms, "launches": counts()}


def same_as(what: str, want: dict, got: dict) -> None:
    """Every request's tokens identical (both rid -> token list)."""
    bad = sorted(rid for rid in want if got.get(rid) != want[rid])
    check(not bad and set(want) == set(got),
          f"{what}: tokens differ for requests {bad}")


SPEC_SPREAD = ("ms_per_round", "ms_per_emitted_token", "prefill_s", "wall_s",
               "capture_s")


def spec_repeats(name, cfg, params, draft, dev, pool, base, mode,
                 repeats) -> tuple:
    """``repeats`` speculating runs of the churn workload in one mode, each
    counted from zero; tokens identical to ``base`` (the spec-off graph
    run's) and the first run's launches in every run."""
    runs = []
    for _ in range(repeats):
        zero_counts()
        with graphs.eager(mode == "eager"):
            engine, results, wall = spec_serve(cfg, params, dev, pool, draft)
        summ = spec_summary(engine, results, wall, len(base))
        same_as(f"{name} {mode} against speculation off", base,
                token_lists(results))
        if runs:
            check(summ["launches"] == runs[0]["launches"]
                  and summ["spec_accepted"] == runs[0]["spec_accepted"],
                  f"{name} {mode}: runs differ in launches or acceptance")
        runs.append(summ)
        del engine
    out = dict(runs[0])
    out["repeats"] = {k: [r[k] for r in runs] for k in SPEC_SPREAD}
    return out


def log_spec(name, mode, out) -> None:
    rep = out["repeats"]
    log(f"{name} {mode}: acceptance_rate {out['acceptance_rate']:.4f} "
        f"({out['spec_accepted']}/{out['spec_proposed']}); "
        f"{out['spec_rounds']} rounds, {out['tokens_per_round']:.3f} tokens "
        f"per round; ms/round {spread(rep['ms_per_round'])}; ms per emitted "
        f"token {spread(rep['ms_per_emitted_token'])}; prefill_s "
        f"{spread(rep['prefill_s'])} over {out['prefill_chunks']} chunks "
        f"(target + draft); captures {out['captures']} in "
        f"{spread(rep['capture_s'])} s; graph pool "
        f"{out['graph_pool_mib']:.1f} MiB; peak {out['peak_mem_gib']:.2f} "
        f"GiB with {out['arena_gib']:.2f} GiB of arenas (both models); "
        f"lookahead {out['lookahead']}; launches {out['launches']}")


def spec_captures(cfg, pool, prompt_lens) -> dict:
    """The captures a speculating graph run of ``prompt_lens`` must make:
    one catch-up, one draft step, one verify, each chunk length the
    engine's prefill takes (capped by the ring, which holds
    ``lookahead`` = SPEC_K more tokens) for the target and the draft, no
    decode step."""
    pool = dataclasses.replace(pool, lookahead=SPEC_K)
    lengths = set()
    for n in prompt_lens:
        ring = request_blocks(cfg, pool, n + GEN_LEN) * pool.block_size
        s = 0
        while s < n:
            lengths.add(min(pool.prefill_chunk, n - s, ring))
            s += min(pool.prefill_chunk, n - s, ring)
    return {"catchup": 1, "draft": 1, "verify": 1, "chunk": len(lengths),
            "draft_chunk": len(lengths)}


def profile_spec(cfg, params, draft, dev, pool) -> dict:
    """Where a round's time goes, by graph: 8 requests (prompt 128,
    SPEC_PROFILE_NEW new tokens) admitted and prefilled, then 8 rounds on
    the host clock and 8 under torch.profiler (``profile_steps``)."""
    engine = PagedServer(cfg, params, pool, draft_params=draft,
                         speculate=SPEC_K, device=dev)
    rng = np.random.default_rng(SEED + 1)
    for i in range(pool.max_slots):
        engine.submit(Request(rid=100 + i, max_new=SPEC_PROFILE_NEW,
                              prompt=rng.integers(0, cfg.vocab, 128).astype(
                                  np.int32)))
    for _ in range(pool.max_slots * 128 // pool.prefill_chunk):
        engine.step()
    rounds = engine.stats["spec_rounds"]
    out = profile_steps(engine, 8)
    check(len(engine._active) == pool.max_slots and not engine._prefilling
          and engine.stats["spec_rounds"] == rounds + 16,
          "the round profile ran something other than full rounds")
    log(f"round profile: {json.dumps(out)}")
    return out


def spec_phase(dev, params, draft, base, prefix_base, plain_ms,
               plain_peak) -> dict:
    """Self-speculative decoding on full-width llama2-7b (k = SPEC_K):

      (a) the churn workload with draft = target (every proposal accepted:
          the bonus token and the catch-up hole every round) and with the
          DRAFT_BITS draft, each REPEATS times by graph and once eager;
          tokens identical to ``base`` (phase 5's spec-off graph run), the
          launches of graph and eager runs equal; a round profiled by
          graph;
      (b) the prefix workload, cache on, with the draft: tokens identical
          to ``prefix_base`` (phase 7's cache-on run); the COW request's
          clone checked in both arenas, captured once;
      (c) bf16 arenas, speculation off and on, by graph and eager: graph =
          eager and on = off exactly.

    ``plain_ms`` and ``plain_peak`` are phase 5's median decode ms/step
    and peak memory, spec off, f32 arenas."""
    cfg = get_config("llama2-7b")
    pool = llama2_pool()
    out = {"k": SPEC_K, "plain_decode_ms_per_step": plain_ms}
    for name, d in (("draft=target", params), ("draft", draft)):
        graph = spec_repeats(name, cfg, params, d, dev, pool, base, "graph",
                             REPEATS)
        eager = spec_repeats(name, cfg, params, d, dev, pool, base, "eager",
                             1)
        graph["eager"] = eager
        log_spec(f"llama2 spec {name}", "by graph", graph)
        log_spec(f"llama2 spec {name}", "eager", eager)
        check(graph["captures"] == spec_captures(cfg, pool, PROMPT_LENS)
              and not eager["captures"],
              f"spec {name}: captures graph {graph['captures']}, eager "
              f"{eager['captures']}")
        check(graph["launches"] == eager["launches"],
              f"spec {name}: graph launches {graph['launches']} != eager "
              f"{eager['launches']}")
        check(graph["lookahead"] == SPEC_K, f"lookahead {graph['lookahead']}")
        out[name] = graph
    check(out["draft=target"]["acceptance_rate"] == 1.0,
          "draft = target did not accept every proposal")
    out["draft"]["round_profile"] = profile_spec(cfg, params, draft, dev,
                                                 pool)
    for name in ("draft=target", "draft"):
        per_token = float(np.median(out[name]["repeats"][
            "ms_per_emitted_token"]))
        out[name]["against_plain_decode"] = per_token / plain_ms
        log(f"llama2 spec {name}: {per_token:.3f} ms per emitted token "
            f"against plain decode's {plain_ms:.3f} ms/step "
            f"({per_token / plain_ms:.3f}x); {gpu_line()}")

    # (b) the prefix workload with the cache on, speculating
    zero_counts()
    ppool = prefix_pool()
    reqs = prefix_requests(cfg)
    engine = SpecServer(cfg, params, ppool, draft_params=draft,
                        speculate=SPEC_K, device=dev)
    t0 = time.monotonic()
    results = engine.run(reqs)
    results.update(engine.run([second_turn(
        cfg, reqs[0], np.asarray(prefix_base[0], np.int32))]))
    torch.cuda.synchronize()
    pre = prefix_summary(engine, time.monotonic() - t0)
    same_as("prefix + speculation against prefix, spec off", prefix_base,
            token_lists(results))
    check(pre["prefix_cow"] >= 1 and pre["captures"].get("cow") == 1
          and engine.cow_checked == pre["prefix_cow"] * 4 * cfg.n_layers
          and pre["prefill_tokens_saved"] > 0
          and "decode" not in pre["captures"],
          f"prefix + speculation: {pre}; {engine.cow_checked} arenas checked")
    pre["cow_arenas_checked"] = engine.cow_checked
    out["prefix"] = pre
    log(f"llama2 spec prefix (cache on, draft {DRAFT_BITS} bits): "
        f"{json.dumps(pre)}")
    del engine

    # (c) bf16 arenas, spec off and on, by graph and eager
    bpool = dataclasses.replace(pool, kv_dtype=torch.bfloat16)
    bf16 = {}
    for spec in (False, True):
        for mode in ("graph", "eager"):
            zero_counts()
            with graphs.eager(mode == "eager"):
                eng, res, wall = spec_serve(cfg, params, dev, bpool,
                                            draft if spec else None)
            row = {"wall_s": wall, "request_tokens": token_lists(res),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "arena_gib": arena_gib(eng), "launches": counts(),
                   "captures": dict(eng.graphs.captures),
                   "gemm_launches": eng.gemms}
            if spec:
                row.update({k: v for k, v in spec_summary(
                    eng, res, wall, len(base)).items() if k in (
                        "acceptance_rate", "spec_rounds", "ms_per_round",
                        "ms_per_emitted_token", "tokens_per_round")})
            else:
                row["decode_step_ms"] = (1e3 * eng.stats["decode_s"]
                                         / eng.stats["decode_steps"])
            check(all(a.dtype == torch.bfloat16 for c in
                      eng.caches + (eng.draft_caches or [])
                      for a in c.values()), "an arena is not bf16")
            bf16[f"{'on' if spec else 'off'} {mode}"] = row
            del eng
    off = bf16["off graph"]["request_tokens"]
    for key, row in bf16.items():
        same_as(f"bf16 {key} against bf16 off by graph", off,
                row["request_tokens"])
    bf16["identical_to_f32_off"] = sum(off[rid] == toks
                                       for rid, toks in base.items())
    bf16["f32_peak_mem_gib"] = {"off": plain_peak,
                                "on": out["draft"]["peak_mem_gib"]}
    bf16["f32_arena_gib_on"] = out["draft"]["arena_gib"]
    out["bf16"] = bf16
    log(f"llama2 bf16 KV: " + json.dumps(
        {k: ({kk: vv for kk, vv in v.items() if kk != "request_tokens"}
             if isinstance(v, dict) else v)
         for k, v in bf16.items()}) + f"; {gpu_line()}")
    return out


def moe_spec_phase(dev, params, draft, base) -> dict:
    """Mixtral (4 of 32 layers) speculating SPEC_K deep from its DRAFT_BITS
    draft over its 9 requests (the 4160-token one wraps its ring, which
    holds window + lookahead tokens): spec off and on by graph, the
    target's MoE capacity overflows counted per step, on eagerly too.
    Spec off must give ``base`` (phase 6's graph tokens: the counter
    changes nothing); on = off except where a step of either run that
    produced the first differing token dropped tokens at capacity (a
    verify step routes S (k + 1) tokens, a decode step S, so the
    capacities differ); two graph runs and an eager one exactly equal."""
    cfg = moe_config()
    pool = moe_pool()
    reqs = requests(cfg, MOE_PROMPT_LENS)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    zero_counts()
    off, off_res, _ = spec_serve(cfg, params, dev, pool, reqs=reqs,
                                 overflow=counter)
    same_as("mixtral spec off with overflows counted, against phase 6",
            base, token_lists(off_res))
    zero_counts()
    on, on_res, wall = spec_serve(cfg, params, dev, pool, draft, reqs=reqs,
                                  overflow=counter)
    out = spec_summary(on, on_res, wall, len(reqs))
    zero_counts()
    again, again_res, again_wall = spec_serve(cfg, params, dev, pool, draft,
                                              reqs=reqs)
    out["again"] = spec_summary(again, again_res, again_wall, len(reqs))
    same_as("mixtral spec by graph, a second run", token_lists(on_res),
            token_lists(again_res))
    zero_counts()
    with graphs.eager():
        eager, eager_res, eager_wall = spec_serve(cfg, params, dev, pool,
                                                  draft, reqs=reqs)
    out["eager"] = spec_summary(eager, eager_res, eager_wall, len(reqs))
    same_as("mixtral spec eager against by graph", token_lists(on_res),
            token_lists(eager_res))
    check(out["spec_accepted"] == out["again"]["spec_accepted"]
          == out["eager"]["spec_accepted"],
          "mixtral spec: the runs accepted different proposals")
    check(out["launches"] == out["eager"]["launches"],
          f"mixtral spec: graph launches {out['launches']} != eager "
          f"{out['eager']['launches']}")
    check(out["captures"] == spec_captures(cfg, pool, MOE_PROMPT_LENS)
          and not out["eager"]["captures"] and out["lookahead"] == SPEC_K
          and on.pool.lookahead == SPEC_K,
          f"mixtral spec: captures {out['captures']}, lookahead "
          f"{out['lookahead']}")
    ring = request_blocks(cfg, on.pool, MOE_LONG_PROMPT + GEN_LEN) * 16
    check(MOE_LONG_PROMPT + GEN_LEN > ring,
          f"the long request does not wrap its {ring}-token ring")
    diverged = []
    for rid, r in off_res.items():
        a, b = r.tokens, on_res[rid].tokens
        if np.array_equal(a, b):
            continue
        i = int(np.argmax(a != b))
        drops = (off.emit_overflow.get((rid, i), 0),
                 on.emit_overflow.get((rid, i), 0))
        diverged.append({"rid": rid, "token": i, "overflow_off": drops[0],
                         "overflow_on": drops[1]})
        check(max(drops) > 0, f"mixtral rid {rid}: speculation changed "
              f"token {i} at steps that dropped no token at capacity")

    def drops(steps):
        return {"steps": len(steps), "with_overflow": sum(
            n > 0 for n in steps), "mean": float(np.mean(steps)),
                "max": int(max(steps)), "per_step": steps}
    out.update(ring_tokens=ring, identical_to_off=len(reqs) - len(diverged),
               divergences=diverged,
               overflow_off=drops(off.step_overflow),
               overflow_on=drops(on.step_overflow))
    off_drops, on_drops = ({k: v for k, v in out[key].items()
                            if k != "per_step"}
                           for key in ("overflow_off", "overflow_on"))
    log(f"mixtral spec (draft {DRAFT_BITS} bits, k {SPEC_K}): acceptance_rate "
        f"{out['acceptance_rate']:.4f}; {out['spec_rounds']} rounds, "
        f"{out['tokens_per_round']:.3f} tokens/round, "
        f"{out['ms_per_round']:.3f} ms/round (eager "
        f"{out['eager']['ms_per_round']:.3f}), "
        f"{out['ms_per_emitted_token']:.3f} ms per emitted token; tokens "
        f"identical to spec off for {out['identical_to_off']}/{len(reqs)}, "
        f"divergences {diverged}; capacity overflows per step off "
        f"{off_drops}, per round on {on_drops}; captures {out['captures']}; lookahead {out['lookahead']}, ring "
        f"{ring} tokens; peak {out['peak_mem_gib']:.2f} GiB with "
        f"{out['arena_gib']:.2f} GiB of arenas; launches {out['launches']}; "
        f"{gpu_line()}")
    return out


# ------------------------------------------------------------------ Mixtral


def moe_config():
    """mixtral-8x7b at its published width, the depth cut to MOE_LAYERS."""
    return get_config("mixtral-8x7b").with_(n_layers=MOE_LAYERS)


MOE_PROMPT_LENS = PROMPT_LENS + [MOE_LONG_PROMPT]


def moe_quantize_phase(dev, compare: bool = True,
                       draft_bits: float | None = None
                       ) -> tuple[dict, dict, dict | None]:
    """fp32 Mixtral (4 layers, published widths) on the card, calibrated,
    allocated (4.0 bits) and quantized, the experts as QuantizedGrouped with
    one code-search launch per expert (the main path, counted); then
    (``compare``) the same weights again with the plain code search,
    compared column by column.  With ``draft_bits``, a draft too, as
    ``quantize_phase`` makes it.  The fp weights are dropped after."""
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
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    draft = None
    if draft_bits is None:
        qparams, rep = pipe.quantize_model(cfg, params, stats, AVG_BITS,
                                           generator=gen, device=dev)
    else:
        qparams, rep, draft, drep = pipe.quantize_model_dual(
            cfg, params, stats, AVG_BITS, draft_bits, generator=gen,
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
    if draft is not None:
        out["draft"] = draft_summary(qparams, draft, drep, draft_bits)
        expected_searches *= 2
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
    return out, qparams, draft


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
    out = serve_four_ways(
        "mixtral", cfg, params, dev, moe_pool(), MOE_PROMPT_LENS,
        labels=MOE_PREFILL_LABELS + [(attnmod, "paged_decode_attention",
                                      "paged_attention")])
    launches, unf = out["launches"], out["unfused"]["launches"]
    check(launches["rht_qmatmul"] > 0 and launches["grouped_rht_qmatmul"] > 0
          and launches["paged_attention"] > 0,
          f"a kernel of the Mixtral fused path never launched: {launches}")
    check(out["tokens_past_ring"] > 0, "the long request never wrapped its "
          "ring")
    check(out["prefix_cache"] == "bypassed",
          "the windowed Mixtral must bypass the prefix cache")
    per_step, n = out["launches_per_decode_step"], cfg.n_layers
    check(per_step["fused"]["grouped_rht_qmatmul"] == 2 * n
          and per_step["unfused"]["grouped_qmatmul"] == 2 * n
          and per_step["unfused"]["rht"] == 6 * n,
          f"mixtral launches per decode step: {per_step}")
    check(unf["rht"] > 0 and unf["qmatmul"] > 0 and unf["grouped_qmatmul"] > 0
          and unf["rht_qmatmul"] == 0 and unf["grouped_rht_qmatmul"] == 0,
          f"the Mixtral unfused path did not run its kernels: {unf}")
    return out


# ------------------------------------------------------------ dense configs

DENSE_ARCHS = ("internlm2-1.8b", "llama3.2-3b", "qwen3-0.6b", "yi-34b")
# every dense config's depth is cut to 4 layers (widths as published): the
# script's 1200 s limit holds the speculation phase beside them (at full
# depth the three small configs took 164 s of a 588 s run); yi-34b's fp32
# weights (2.2 GB a layer over 60 layers) would exceed the card's 80 GB
DENSE_LAYERS = 4
DENSE_PROMPT_LENS = [64, 200, 128, 96]


def dense_pool() -> PoolConfig:
    return PoolConfig(max_slots=4, block_size=16,
                      max_context=max(DENSE_PROMPT_LENS) + GEN_LEN,
                      prefill_chunk=64)


def dense_phase(dev) -> dict:
    """The four dense GQA configs the port's registry adds, each at its
    published width, the depth cut to DENSE_LAYERS: fp32 random weights
    from a seed,
    calibrated, allocated (4.0 bits) and quantized with the code-search
    kernel (counted), the fp weights dropped, then DENSE_PROMPT_LENS
    (32 new tokens each) served by graph, unfused by graph and with the
    plain versions forced (eager).  Tokens must agree across the three
    (a divergence only at a near-tie, as ``divergences`` holds); every run
    is counted from zero and must launch its path's kernels."""
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        cfg = cfg.with_(n_layers=DENSE_LAYERS)
        t0 = time.monotonic()
        params = tf.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 5), device=dev)
        fp_gb = sum(t.numel() * 4 for t in (
            *params["layers"][0]["attn"].values(),
            *params["layers"][0]["mlp"].values())) / 1e9 * cfg.n_layers
        fp_gb += (params["embed"].numel() + params["lm_head"].numel()) * 4e-9
        zero_counts()
        toks = torch.from_numpy(cal.zero_shot_tokens(cfg.vocab, 256)).to(dev)
        stats = cal.calibrate(
            lambda p, b, ctx, cfg=cfg: tf.loss_fn(cfg, p, b, ctx=ctx),
            params, [{"tokens": toks}])
        torch.cuda.synchronize()
        calibrate_s = time.monotonic() - t0
        qparams, rep = pipe.quantize_model(
            cfg, params, stats, AVG_BITS,
            generator=torch.Generator(device=dev).manual_seed(SEED + 6),
            device=dev)
        searches = counts()["rabitq_quant"]
        del params, stats
        torch.cuda.empty_cache()
        qls = quantized_linears(qparams)
        rot = sorted({q.d_keep for q in qls.values()})
        row = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "heads": [cfg.n_heads, cfg.n_kv],
               "gqa_group": cfg.n_heads // cfg.n_kv, "head_dim": cfg.hd,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab, "qk_norm": cfg.qk_norm,
               "fp32_gb": fp_gb, "calibrate_s": calibrate_s,
               "allocate_s": rep.allocate_s, "quantize_s": rep.quantize_s,
               "avg_bits": rep.avg_bits, "code_search_launches": searches,
               "rotation_widths": rot,
               "rotation_plans": {d: list(hops.rotate_plan(d))
                                  for d in rot}}
        check(searches == rep.n_layers == 6 * cfg.n_layers
              and AVG_BITS - 0.5 < rep.avg_bits <= AVG_BITS,
              f"{arch}: {rep.n_layers} weights, {searches} code searches, "
              f"{rep.avg_bits} bits")
        pool = dense_pool()
        runs = {}
        for name, fused in (("graph", True), ("unfused", False)):
            zero_counts()
            eng, res, wall = serve(cfg, qparams, dev, pool, fused=fused,
                                   prompt_lens=DENSE_PROMPT_LENS)
            runs[name] = (eng, res, serve_summary(
                eng, res, wall, cfg, qparams, DENSE_PROMPT_LENS))
            runs[name][2]["launches"] = counts()
        for ops in (qops, pops, hops):
            ops.set_forced_path("ref")
        try:
            zero_counts()
            eng, res, wall = serve(cfg, qparams, dev, pool,
                                   prompt_lens=DENSE_PROMPT_LENS)
        finally:
            for ops in (qops, pops, hops):
                ops.set_forced_path(None)
        runs["plain"] = (eng, res, {"wall_s": wall, "launches": counts()})
        base = runs["graph"][1]
        for name in ("graph", "unfused", "plain"):
            eng, res, summ = runs[name]
            summ["divergences"] = divergences(base, res, eng)
            summ["identical"] = len(base) - len(summ["divergences"])
            row[name] = {k: summ[k] for k in (
                "decode_step_ms", "prefill_s", "wall_s", "tok_per_s",
                "captures", "capture_s", "graph_pool_mib", "launches",
                "identical", "divergences") if k in summ}
        del runs, eng
        fused, unf, plain = (row[k]["launches"] for k in (
            "graph", "unfused", "plain"))
        launched = {k: v for k, v in fused.items() if v}
        log(f"{arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers, "
            f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv} (G = "
            f"{row['gqa_group']}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"qk_norm {cfg.qk_norm}; {fp_gb:.2f} GB fp32): {rep.avg_bits:.4f} "
            f"bits in {calibrate_s + rep.wall_time_s:.1f} s (allocate_s "
            f"{rep.allocate_s:.2f}); rotation widths {rot}; tokens "
            f"identical graph / unfused / plain "
            f"{row['graph']['identical']} / {row['unfused']['identical']} / "
            f"{row['plain']['identical']} of {len(DENSE_PROMPT_LENS)}; decode "
            f"{row['graph']['decode_step_ms']:.3f} ms/step, prefill_s "
            f"{row['graph']['prefill_s']:.4f}; kernels launched by graph "
            f"{launched}, unfused {({k: v for k, v in unf.items() if v})}; "
            f"{time.monotonic() - t0:.1f} s in all")
        check(fused["rht_qmatmul"] > 0 and fused["paged_attention"] > 0
              and unf["rht"] > 0 and unf["qmatmul"] > 0
              and unf["rht_qmatmul"] == 0 and not any(plain.values()),
              f"{arch}: kernels by run: fused {fused}, unfused {unf}, "
              f"plain {plain}")
        row["phase_s"] = time.monotonic() - t0
        out[arch] = row
        del qparams
        torch.cuda.empty_cache()
    return out


def profiles_main(dev, smi) -> int:
    """``--profiles``: build, quantize llama2-7b and Mixtral as the full run
    does (without the plain code-search comparison) and run only
    ``profile_decode`` and ``profile_prefill`` for each, replayed from its
    graphs and eager (under ``graphs.eager()``), each once to warm up and
    once measured, with no other serving phase before them; prints one
    JSON line.  With REPRO_TORCH_SRC naming an unpacked earlier tree
    (``git archive``), it measures that tree's package, so two trees'
    step times can be compared on one card in one call:

        REPRO_TORCH_SRC=build/parent/src python3 chip_smoke.py --profiles
        python3 chip_smoke.py --profiles
    """
    _build.build()
    out = {"src": str(SRC), "gpu": smi}
    for name, phase, cfg_of, pool_of, labels in (
            ("llama2", quantize_phase, lambda: get_config("llama2-7b"),
             llama2_pool, ()),
            ("mixtral", moe_quantize_phase, moe_config, moe_pool,
             MOE_PREFILL_LABELS)):
        _, qparams, _ = phase(dev, compare=False)
        for mode in ("graph", "eager"):
            with graphs.eager(mode == "eager"):
                for kind, profile in (("decode", profile_decode),
                                      ("prefill", profile_prefill)):
                    for _ in range(2):
                        prof = profile(cfg_of(), qparams, dev, pool_of(),
                                       labels=labels)
                    out[f"{name} {mode} {kind}"] = prof
        del qparams
        torch.cuda.empty_cache()
    log(json.dumps({"profiles": out}))
    return 0


def attention_main(smi) -> int:
    """``--attention``: build the paged-attention kernel, hold it against
    its plain version (``check_attention``) and time it (``ATTN_TIMED``);
    prints one JSON line.  REPRO_TORCH_SRC picks the package tree, as for
    ``--profiles``, so an earlier kernel can be timed beside this
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
    build the kernels they need, hold them against their plain versions
    (``check_rht``, ``check_code_search``), then time them: the rotation at RHT_TIMED (graph
    replay), the fused GEMM at FUSED_AB_NS and an empty kernel's launch (the
    card's launch floor); the code search at SEARCH_TIMED.  ``--division-sweep`` holds the code search's
    division against IEEE division on all 2^46 pairs of f32 mantissas.
    Prints one JSON line.  REPRO_TORCH_SRC picks the package tree, as for
    ``--attention``, so one call can run parent, change, change, parent."""
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
        out["rht_check"] = check_rht(gen, dev)
        out["launch_floor_ms"] = launch_floor_ms(dev)
        out["rht_times"] = [time_rht(gen, dev, n, d, full=False)
                            for n, d in RHT_TIMED]
        out["fused_gemm_times"] = [time_gemm(gen, dev, n, 4083, 4096, 4,
                                             full=False)
                                   for n in FUSED_AB_NS]
    if "--code-search" in modes:
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


def prefix_main(dev, smi) -> int:
    """``--prefix-cache``: build every kernel, quantize llama2-7b as the
    full run does (without the plain code-search comparison) and run only
    ``prefix_phase``; prints one JSON line (also written to
    ``chiprun_out/chip_smoke_prefix.json``)."""
    _build.build()
    _, qparams, _ = quantize_phase(dev, compare=False)
    out = {"gpu": smi, "prefix_cache": prefix_phase(dev, qparams)}
    (OUT_DIR / "chip_smoke_prefix.json").write_text(json.dumps(out, indent=1))
    log(json.dumps(out))
    return 0


def spec_main(dev, smi) -> int:
    """``--speculation``: build every kernel, quantize llama2-7b with its
    DRAFT_BITS draft (``quantize_model_dual``, without the plain
    code-search comparison), serve the churn workload once by graph with
    speculation off and the prefix workload with the cache on (the tokens
    speculation is held to), then ``spec_phase``; the same for Mixtral
    (one spec-off graph run, then ``moe_spec_phase``).  Prints one JSON
    line (also ``chiprun_out/chip_smoke_spec.json``)."""
    _build.build()
    cfg = get_config("llama2-7b")
    quant, qparams, draft = quantize_phase(dev, compare=False,
                                           draft_bits=DRAFT_BITS)
    zero_counts()
    eng, res, _ = serve(cfg, qparams, dev, llama2_pool())
    plain_ms = 1e3 * eng.stats["decode_s"] / eng.stats["decode_steps"]
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    del eng
    prefix_base, _, _ = serve_prefix(cfg, qparams, dev, prefix_pool())
    out = {"gpu": smi, "quantize": quant,
           "speculation": spec_phase(dev, qparams, draft, token_lists(res),
                                     token_lists(prefix_base), plain_ms,
                                     plain_peak)}
    del qparams, draft
    torch.cuda.empty_cache()
    moe_quant, moe_params, moe_draft = moe_quantize_phase(
        dev, compare=False, draft_bits=DRAFT_BITS)
    zero_counts()
    _, moe_res, _ = serve(moe_config(), moe_params, dev, moe_pool(),
                          prompt_lens=MOE_PROMPT_LENS)
    out["mixtral_quantize"] = moe_quant
    out["mixtral_speculation"] = moe_spec_phase(dev, moe_params, moe_draft,
                                                token_lists(moe_res))
    (OUT_DIR / "chip_smoke_spec.json").write_text(json.dumps(out, indent=1))
    log(json.dumps(compact(out)))
    return 0


def compact(node):
    """``node`` without its token lists, per-step lists and profiles (for
    a line short enough for the end of the output)."""
    if isinstance(node, dict):
        return {k: compact(v) for k, v in node.items() if k not in (
            "request_tokens", "per_step", "round_profile", "decode_profile",
            "prefill_profile", "per_layer_bits")}
    return node


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
    if sys.argv[1:] == ["--profiles"]:
        return profiles_main(dev, smi)
    if sys.argv[1:] == ["--attention"]:
        return attention_main(smi)
    modes = set(sys.argv[1:])
    if modes and modes <= set(AB_MODES):
        return redesign_main(modes, smi)
    if sys.argv[1:] == ["--prefix-cache"]:
        return prefix_main(dev, smi)
    if sys.argv[1:] == ["--speculation"]:
        return spec_main(dev, smi)
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

    quant_out, qparams, draft = quantize_phase(dev, draft_bits=DRAFT_BITS)
    serve_out = serve_phase(dev, qparams)
    prefix_out = prefix_phase(dev, qparams)
    spec_out = spec_phase(dev, qparams, draft, serve_out["request_tokens"],
                          prefix_out["on"]["request_tokens"],
                          float(np.median(serve_out["repeats"][
                              "decode_step_ms"])), serve_out["peak_mem_gib"])
    del qparams, draft
    torch.cuda.empty_cache()
    moe_quant, moe_params, moe_draft = moe_quantize_phase(
        dev, draft_bits=DRAFT_BITS)
    moe_serve = moe_serve_phase(dev, moe_params)
    moe_spec = moe_spec_phase(dev, moe_params, moe_draft,
                              moe_serve["request_tokens"])
    del moe_params, moe_draft
    torch.cuda.empty_cache()
    dense_out = dense_phase(dev)

    # launches per path, each from that path's own run with every count
    # zeroed just before it: the quantize run (the code search), the fused
    # serve run, the unfused serve run (the RHT and the unfused GEMMs);
    # the prefix path is the shared-prefix workload with the cache on, by
    # graph (it reuses llama2's quantization and runs fused only); the
    # speculation paths are the first graph run with the DRAFT_BITS draft
    # (llama2, Mixtral; their quantizations are counted with the targets')
    # and the bf16-arena path llama2's spec-off graph run; each dense
    # config counts its own quantization, fused and unfused runs
    none = dict.fromkeys(counts(), 0)
    runs = {"llama2": {"quantize": quant_out["code_search_launches"],
                       "fused": serve_out["launches"],
                       "unfused": serve_out["unfused"]["launches"]},
            "mixtral": {"quantize": moe_quant["code_search_launches"],
                        "fused": moe_serve["launches"],
                        "unfused": moe_serve["unfused"]["launches"]},
            "llama2_prefix": {"quantize": 0,
                              "fused": prefix_out["on"]["launches"],
                              "unfused": none},
            "llama2_spec": {"quantize": 0,
                            "fused": spec_out["draft"]["launches"],
                            "unfused": none},
            "llama2_bf16": {"quantize": 0,
                            "fused": spec_out["bf16"]["off graph"][
                                "launches"], "unfused": none},
            "mixtral_spec": {"quantize": 0, "fused": moe_spec["launches"],
                             "unfused": none}}
    runs.update({arch: {"quantize": row["code_search_launches"],
                        "fused": row["graph"]["launches"],
                        "unfused": row["unfused"]["launches"]}
                 for arch, row in dense_out.items()})
    dense = tuple(dense_out)

    def by_path(kernel, run):
        if run == "quantize":
            return {path: r["quantize"] for path, r in runs.items()}
        if run == "serve":      # the fused and the unfused run together
            return {path: r["fused"][kernel] + r["unfused"][kernel]
                    for path, r in runs.items()}
        return {path: r[run][kernel] for path, r in runs.items()}
    spec = ("llama2_spec", "llama2_bf16", "mixtral_spec")
    on_path = {  # kernel -> (run that counts it, paths that must launch it)
        "rht_qmatmul": ("fused", ("llama2", "mixtral", "llama2_prefix",
                                  *spec, *dense)),
        "paged_attention": ("fused", ("llama2", "mixtral", "llama2_prefix",
                                      *spec, *dense)),
        "qmatmul": ("unfused", ("llama2", "mixtral", *dense)),
        "rht": ("unfused", ("llama2", "mixtral", *dense)),
        "rabitq_quant": ("quantize", ("llama2", "mixtral", *dense)),
        "grouped_rht_qmatmul": ("fused", ("mixtral", "mixtral_spec")),
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
    gemms.update({"llama2_spec": {"fused": spec_out["draft"][
                      "gemm_launches"]},
                  "mixtral_spec": {"fused": moe_spec["gemm_launches"]}})
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
              "mixtral_serve": moe_serve, "prefix_cache": prefix_out,
              "speculation": spec_out, "mixtral_speculation": moe_spec,
              "dense_configs": dense_out, "kernels": kernels,
              "seconds": time.monotonic() - T_START}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"chip_smoke: {detail['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
