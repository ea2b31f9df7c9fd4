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
     there is one): the fused RHT + dequant GEMM, the unfused GEMM, the RHT,
     the RaBitQ code search and paged flash-decode;
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
     greedy tokens must match;
  6. a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
     line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the reference package.  Exits non-zero with no
result when no CUDA device is present.  Details too long for the end of the
output go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import hadamard, packing, rabitq  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core.qlinear import draw_signs  # noqa: E402
from repro_torch.core.tricks import centralize  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hadamard import ops as hops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.kernels.qmatmul.ref import (  # noqa: E402
    quantized_matmul_ref, rht_quantized_matmul_ref)
from repro_torch.kernels.rabitq_quant import ops as rq_ops  # noqa: E402
from repro_torch.models import decode as decmod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and f32 without
# tensor cores; every kernel computes in f32, as the TPU kernels do.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 results of two summation orders (split-K and butterfly vs Kronecker
# matmuls for the GEMMs; warp-shuffle vs cuBLAS dots for attention):
# |kernel - plain| <= RTOL * max|plain|.  bf16 arenas are read as the same
# bf16 values by both versions and computed in f32, so the same bound holds.
RTOL = 1e-4
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
SEED = 0
AVG_BITS = 4.0
OUT_DIR = ROOT / "chiprun_out"

GEMM_SHAPES = [(4083, 4096), (4083, 22016), (10974, 4096), (4096, 4096)]
GEMM_BITS = list(range(1, 9))
GEMM_NS = [1, 8, 64]
RHT_NS = [1, 8, 64]
RHT_DIMS = [2048, 4096, 8192, 16384, 4083, 10974]
TIME_SHAPES = [(1, 4083, 4096), (8, 4083, 4096), (8, 4083, 22016),
               (8, 10974, 4096), (64, 4083, 4096)]


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    ops = 2 * n * d * c + passes * n * dh * (dh.bit_length() - 1)
    return bound(nbytes, ops)


def check_gemms(gen, dev) -> tuple[float, float]:
    """Both GEMM kernels against their plain versions: bits 1-8 at every
    shape and row count.  The unfused GEMM gets an already-rotated x."""
    worst = {"fused": 0.0, "unfused": 0.0}
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
    n_cases = len(GEMM_SHAPES) * len(GEMM_BITS) * len(GEMM_NS)
    log(f"rht_qmatmul and qmatmul: {n_cases} cases each (bits 1-8) within "
        f"{RTOL} * max|plain|; max|err| fused {worst['fused']:.3e}, "
        f"unfused {worst['unfused']:.3e}")
    return worst["fused"], worst["unfused"]


def time_gemm(gen, dev, n, d, c, bits, fused=True) -> dict:
    """Kernel, plain and library (torch.matmul on the dense equivalent
    weight) times, cycling over copies so the codes come from HBM.  The
    unfused GEMM's library call multiplies the rotated x by r*(codes-c_b)."""
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
    b_ms, by = gemm_bound(n, d, c, bits, fused)
    del dense, packs, w_eff
    return {"n": n, "d": d, "c": c, "bits": bits, "ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": by}


# --------------------------------------------------------------------- RHT


def check_rht(gen, dev) -> float:
    worst = 0.0
    for n in RHT_NS:
        for d in RHT_DIMS:
            x = torch.randn((n, d), generator=gen, device=dev)
            s1, s2 = draw_signs(d, gen)
            got = hops.rht_cuda(x, s1, s2)
            want = hadamard.practical_rht(x, s1, s2)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= RHT_ATOL,
                  f"rht n={n} d={d}: max|err| {err} > {RHT_ATOL}")
            worst = max(worst, err)
    log(f"rht: {len(RHT_NS) * len(RHT_DIMS)} cases (n {RHT_NS} x d "
        f"{RHT_DIMS}) within atol {RHT_ATOL}; max|err| {worst:.3e}")
    return worst


def time_rht(gen, dev, n, d) -> dict:
    """Kernel and plain times; the library call multiplies x by the dense
    (d, d) matrix of the same linear map (practical_rht of the identity)."""
    x = torch.randn((n, d), generator=gen, device=dev)
    s1, s2 = draw_signs(d, gen)
    k_ms = graph_ms(lambda: hops.rht_cuda(x, s1, s2))
    call_ms = time_ms(lambda: hops.rht_cuda(x, s1, s2))
    p_ms = time_ms(lambda: hadamard.practical_rht(x, s1, s2), iters=5,
                   warmup=1)
    m = hadamard.practical_rht(torch.eye(d, device=dev), s1, s2)
    l_ms = graph_ms(lambda: torch.matmul(x, m))
    dh = hadamard.largest_pow2_leq(d)
    passes = 1 if dh == d else 2
    b_ms, by = bound(2 * n * d * 4 + passes * dh * 4,
                     passes * n * dh * (dh.bit_length() - 1))
    del m
    return {"n": n, "d": d, "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": by}


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
    for d, c in GEMM_SHAPES:
        # columns of different scale, as rotated weights have
        w = (torch.randn((d, c), generator=gen, device=dev)
             * (torch.rand((1, c), generator=gen, device=dev) + 0.1))
        for bits in GEMM_BITS:
            codes, rescale, choice = rq_ops.quantize_cuda(
                w, bits, N_CAND, return_choice=True)
            torch.cuda.synchronize()
            res = compare_search(w, codes, rescale, choice, bits)
            out["differing_columns"] += res["differing_columns"]
            out["columns"] += c
            for k in ("max_objective_gap", "max_rescale_abs_err",
                      "max_rescale_rel_err"):
                out[k] = max(out[k], res[k])
        del w
    log(f"rabitq_quant: {len(GEMM_SHAPES) * len(GEMM_BITS)} cases ((d, c) "
        f"{GEMM_SHAPES} x bits 1-8); codes identical where the step agrees; "
        f"{out['differing_columns']} of {out['columns']} columns chose "
        f"another step, all near-ties (max objective gap "
        f"{out['max_objective_gap']:.2e} <= {OBJ_TIE}); rescale max rel err "
        f"{out['max_rescale_rel_err']:.2e}; plain version identical on card "
        f"and host; absmax / 7.5 by scalar vs by tensor differ in "
        f"{out['scalar_vs_tensor_division_differ']} of 512 columns")
    return out


def search_bound(d, c):
    return bound(d * c * 4 + d * c + 4 * c, 7 * N_CAND * d * c)


def time_code_search(gen, dev, d, c, bits=4) -> dict:
    w = torch.randn((d, c), generator=gen, device=dev)
    k_ms = time_ms(lambda: rq_ops.quantize_cuda(w, bits, N_CAND), iters=5,
                   warmup=1)
    p_ms = time_ms(lambda: rq_ops.quantize_ref(w, bits, N_CAND), iters=3,
                   warmup=1)
    b_ms, by = search_bound(d, c)
    del w
    return {"d": d, "c": c, "bits": bits, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by}


# ------------------------------------------------------- paged attention


def attn_inputs(gen, dev, b, w, h, kv, hd, bs, mb, ctx_max, dtype, window,
                ring_blocks=None, full=False):
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
    else:
        pos = torch.randint(w, ctx_max + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    return q, k, v, bt, pos, ring


ATTN_CASES = [  # name, w, h, kv, dtype, window, ring_blocks, ctx_max
    ("f32 W=1", 1, 32, 32, torch.float32, None, None, 1024),
    ("bf16 W=1", 1, 32, 32, torch.bfloat16, None, None, 1024),
    ("f32 W=3", 3, 32, 32, torch.float32, None, None, 1024),
    ("bf16 W=3 G=4", 3, 32, 8, torch.bfloat16, None, None, 1024),
    ("f32 window 200, ring of 16 blocks wrapped", 1, 32, 32, torch.float32,
     200, 16, 1024),
    ("f32 G=4", 1, 32, 8, torch.float32, None, None, 1024),
]


def check_attention(gen, dev) -> float:
    worst = 0.0
    b, hd, bs, mb = 8, 128, 16, 64
    for name, w, h, kv, dtype, window, ring_blocks, ctx in ATTN_CASES:
        args = attn_inputs(gen, dev, b, w, h, kv, hd, bs, mb, ctx, dtype,
                           window, ring_blocks)
        got = pops.paged_attention_cuda(*args, window=window)
        want = paged_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        err, scale = err_and_scale(got, want)
        check(bool(torch.isfinite(got).all()) and err <= RTOL * scale,
              f"paged_attention {name}: max|err| {err} > {RTOL} * {scale}")
        worst = max(worst, err)
    # an inactive engine slot: pos 0, ring 1, all-zero table -> null block
    q, k, v, bt, pos, ring = attn_inputs(gen, dev, 2, 1, 32, 32, hd, bs, 4,
                                         64, torch.float32, None)
    bt[1], pos[1], ring[1] = 0, 0, 1
    got = pops.paged_attention_cuda(q, k, v, bt, pos, ring)
    check(bool(torch.isfinite(got).all()), "inactive slot gave non-finite")
    log(f"paged_attention: {len(ATTN_CASES)} cases + an inactive slot within "
        f"{RTOL} * max|plain|; max|err| {worst:.3e}")
    return worst


def time_attention(gen, dev) -> dict:
    b, h, kv, hd, bs, mb, ctx = 8, 32, 32, 128, 16, 64, 1024
    args = attn_inputs(gen, dev, b, 1, h, kv, hd, bs, mb, ctx, torch.float32,
                       None, full=True)
    k_ms = graph_ms(lambda: pops.paged_attention_cuda(*args))
    call_ms = time_ms(lambda: pops.paged_attention_cuda(*args))
    p_ms = time_ms(lambda: paged_attention_ref(*args), iters=5, warmup=1)
    q, k_arena, v_arena, bt = args[:4]
    kd = k_arena[bt.long()].reshape(b, mb * bs, kv, hd).transpose(1, 2).contiguous()
    vd = v_arena[bt.long()].reshape(b, mb * bs, kv, hd).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()                    # (B, H, 1, hd)
    l_ms = graph_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd))
    b_ms, by = bound(b * kv * ctx * hd * 4 * 2 + 2 * q.numel() * 4
                     + bt.numel() * 4, 4 * b * h * ctx * hd)
    return {"b": b, "h": h, "kv": kv, "hd": hd, "context": ctx, "ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": by}


# ---------------------------------------------------------------- quantize


def quantized_linears(params) -> dict:
    """name -> QuantizedLinear, under the pipeline's names."""
    return {f"L{i}.{g}.{k}": lp[g][k] for i, lp in enumerate(params["layers"])
            for g in ("attn", "mlp") for k in lp[g]
            if hasattr(lp[g][k], "packed")}


def rotated_weight(fp_params, name, q) -> torch.Tensor:
    """The rotated, centralized, outlier-free weight the code search saw."""
    i, group, key = name.split(".")
    w = fp_params["layers"][int(i[1:])][group][key]
    if q.keep_idx is not None:
        w = w[q.keep_idx]
    w, _ = centralize(w)
    return hadamard.practical_rht(w, q.signs1, q.signs2, axis=0)


def compare_quantizations(fp_params, kernel_q, plain_q) -> dict:
    """Per layer, the kernel run's codes against the plain run's: columns
    that differ must be near-ties of the plain objective on the same w."""
    n_diff, n_cols, gap, rescale_ulps = 0, 0, 0.0, 0
    for name, kq in kernel_q.items():
        pq = plain_q[name]
        kc = packing.unpack_codes(kq.packed, kq.bits, kq.d_keep)
        pc = packing.unpack_codes(pq.packed, pq.bits, pq.d_keep)
        differ = (kc != pc).any(dim=0)
        n_cols += kq.c
        rescale_ulps += int((kq.rescale != pq.rescale)[~differ].sum())
        if not differ.any():
            continue
        n_diff += int(differ.sum())
        w = rotated_weight(fp_params, name, kq)[:, differ].double()
        c_b = ((1 << kq.bits) - 1) / 2.0

        def objective(codes):
            v = codes[:, differ].double() - c_b
            wv, vv = (w * v).sum(0), (v * v).sum(0)
            return -(wv * wv) / vv.clamp(min=1e-30)
        ek, ep = objective(kc), objective(pc)
        gap = max(gap, float(((ek - ep).abs() / ep.abs()).max()))
        del w
    return {"differing_columns": n_diff, "columns": n_cols,
            "max_objective_gap": gap,
            "rescale_f16_differ_same_columns": rescale_ulps}


def quantize_phase(dev) -> tuple[dict, dict]:
    """Build fp32 llama2-7b on the card, calibrate, allocate and quantize it
    with the code-search kernel (the main path, counted), then quantize the
    same layers with the plain code search and compare."""
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
    rq_ops.launches = 0
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
    launches = rq_ops.launches
    peak = torch.cuda.max_memory_allocated()
    qls = quantized_linears(qparams)
    hist = collections.Counter(rep.per_layer_bits.values())
    packed_gb = sum(q.packed.numel() for q in qls.values()) / 1e9
    side_gb = sum(t.numel() * t.element_size() for q in qls.values()
                  for t in (q.rescale, q.signs1, q.signs2, q.mean_col,
                            q.w_out, q.out_idx, q.keep_idx)
                  if t is not None) / 1e9
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

    # the same layers with the code search's plain version, same signs
    signs = {name: (q.signs1, q.signs2) for name, q in qls.items()}
    t0 = time.monotonic()
    rq_ops.set_forced_path("ref")
    try:
        plain_params, plain_rep = pipe.quantize_model(
            cfg, params, stats, AVG_BITS, signs=signs, device=dev)
    finally:
        rq_ops.set_forced_path(None)
    check(plain_rep.per_layer_bits == rep.per_layer_bits,
          "the allocation moved with the code search")
    cmp = compare_quantizations(params, qls, quantized_linears(plain_params))
    cmp["plain_quantize_s"] = plain_rep.quantize_s
    log(f"quantize with the plain code search: quantize_s "
        f"{plain_rep.quantize_s:.2f}; {cmp['differing_columns']} of "
        f"{cmp['columns']} columns differ from the kernel run, max relative "
        f"objective gap {cmp['max_objective_gap']:.2e} (<= {OBJ_TIE}); "
        f"{cmp['rescale_f16_differ_same_columns']} f16 rescales differ in "
        f"agreeing columns ({time.monotonic() - t0:.1f} s)")
    check(cmp["max_objective_gap"] <= OBJ_TIE,
          "a column differs between kernel and plain quantization without "
          "a near-tie")
    out["plain_comparison"] = cmp
    del plain_params, params, stats, signs
    torch.cuda.empty_cache()
    return out, qparams


# ------------------------------------------------------------------ serve


class GapRecordingServer(PagedServer):
    """Records each greedy step's top-2 logit gap and logit scale, and the
    tokens held in the KV arena at each decode step."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps: dict = {}
        self.step_tokens: list = []

    def _decode_once(self, t0, results):
        self.step_tokens.append(sum(len(st.served) + len(st.out)
                                    for st in self._active.values()))
        return super()._decode_once(t0, results)

    def _sample(self, logits, rid, step):
        top2 = np.partition(logits, -2)[-2:]
        self.gaps[(rid, step)] = (float(top2[1] - top2[0]),
                                  float(np.abs(logits).max()))
        return super()._sample(logits, rid, step)


PROMPT_LENS = [64, 512, 128, 384, 96, 256, 448, 192]
GEN_LEN = 32


def decode_step_bound_ms(cfg, params, tokens_in_arena: float) -> float:
    """Least time of one decode step: every weight byte (packed codes, side
    info, the f32 lm_head, the embedding rows read) and every live K/V byte
    once, over the HBM rate."""
    nbytes = params["lm_head"].numel() * 4 + 8 * cfg.d_model * 4
    for q in quantized_linears(params).values():
        nbytes += sum(t.numel() * t.element_size() for t in
                      (q.packed, q.rescale, q.signs1, q.signs2, q.mean_col,
                       q.w_out, q.out_idx, q.keep_idx) if t is not None)
    kv_per_token = cfg.n_layers * 2 * cfg.n_kv * cfg.hd * 4
    return (nbytes + tokens_in_arena * kv_per_token) / HBM_BYTES_PER_S * 1e3


def requests(cfg) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=GEN_LEN) for i, n in enumerate(PROMPT_LENS)]


def serve(cfg, params, dev, pool, fused=True) -> tuple:
    engine = GapRecordingServer(cfg, params, pool, fused=fused, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    results = engine.run(requests(cfg))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return engine, results, wall


def serve_summary(engine, results, wall, cfg, params) -> dict:
    st = engine.stats
    n_tok = sum(len(r.tokens) for r in results.values())
    check(len(results) == len(PROMPT_LENS)
          and all(len(r.tokens) == GEN_LEN for r in results.values())
          and all(0 <= int(t) < cfg.vocab for r in results.values()
                  for t in r.tokens), "serve produced malformed output")
    return {"wall_s": wall, "tokens": n_tok, "tok_per_s": n_tok / wall,
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "decode_steps": st["decode_steps"],
            "prefill_chunks": st["prefill_chunks"],
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


def profile_decode(cfg, params, dev, pool, steps: int = 8) -> dict:
    """Where a decode step's time goes: 8 requests (prompt 128, 64 new
    tokens) are admitted and prefilled, then ``steps`` pure decode steps
    run under torch.profiler.  Device time is the sum of kernel times (one
    stream, so kernels do not overlap); the idle share is the rest of the
    host-clock step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = PagedServer(cfg, params, pool, device=dev)
    rng = np.random.default_rng(SEED + 1)
    for i in range(pool.max_slots):
        engine.submit(Request(rid=100 + i, max_new=64, prompt=rng.integers(
            0, cfg.vocab, 128).astype(np.int32)))
    for _ in range(pool.max_slots * 128 // pool.prefill_chunk):
        engine.step()                 # one prompt chunk + one decode each
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    out = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "device_ms_per_step": dev_us / 1e3 / steps if dev_us else None,
           "idle_share": 1 - dev_us / 1e6 / wall if dev_us else None,
           "launches_per_step": sum(e.count for e in kern) / steps,
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms_per_step": e.self_device_time_total / 1e3 / steps}
                           for e in top]}
    log(f"decode profile: {json.dumps(out)}")
    return out


def serve_phase(dev, params) -> dict:
    cfg = get_config("llama2-7b")
    pool = PoolConfig(max_slots=8, block_size=16,
                      max_context=max(PROMPT_LENS) + GEN_LEN, prefill_chunk=64)
    # warm-up (library loads, allocator, cuBLAS handles) outside the counts
    for fused in (True, False):
        PagedServer(cfg, params, pool, fused=fused, device=dev).run(
            [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])

    qops.launches = 0
    pops.launches = 0
    engine, results, wall = serve(cfg, params, dev, pool)
    launches = {"rht_qmatmul": qops.launches, "paged_attention": pops.launches}
    out = serve_summary(engine, results, wall, cfg, params)
    out["weights_only_bound_ms"] = decode_step_bound_ms(cfg, params, 0.0)
    out["launches"] = launches
    log(f"serve fused (kernels): {out['tokens']} tokens in {wall:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s; prefill {out['prefill_s']:.2f} s, "
        f"decode {out['decode_s']:.2f} s over {out['decode_steps']} steps "
        f"({out['decode_step_ms']:.2f} ms/step, bound "
        f"{out['decode_step_bound_ms']:.3f} ms); peak "
        f"{out['peak_mem_gib']:.2f} GiB; launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the fused path never launched: {launches}")

    # launches one decode step makes, counted on a direct call, fused and
    # unfused
    s = pool.max_slots
    z = torch.zeros(s, dtype=torch.int32, device=dev)
    per_step = {}
    for fused in (True, False):
        qops.launches = qops.unfused_launches = 0
        hops.launches = pops.launches = 0
        with qops.fusion(fused):
            logits, _ = decmod.decode_step_paged(
                cfg, params, engine.caches, z[:, None], z,
                torch.zeros(s, dtype=torch.bool, device=dev),
                torch.zeros((s, engine.table_width), dtype=torch.int32,
                            device=dev),
                torch.ones(s, dtype=torch.int32, device=dev))
        check(bool(torch.isfinite(logits).all()),
              "decode step logits not finite")
        per_step["fused" if fused else "unfused"] = {
            "rht_qmatmul": qops.launches, "qmatmul": qops.unfused_launches,
            "rht": hops.launches, "paged_attention": pops.launches}
    out["launches_per_decode_step"] = per_step
    log(f"launches per decode step: {per_step}")
    del engine, logits          # its arena; later peaks count their own
    out["decode_profile"] = profile_decode(cfg, params, dev, pool)

    # the unfused A/B path: the RHT kernel, then the unfused GEMM kernel
    hops.launches = 0
    qops.unfused_launches = 0
    qops.launches = 0
    pops.launches = 0
    unf, unf_results, unf_wall = serve(cfg, params, dev, pool, fused=False)
    unf_launches = {"rht": hops.launches, "qmatmul": qops.unfused_launches,
                    "paged_attention": pops.launches,
                    "rht_qmatmul": qops.launches}
    unfused = serve_summary(unf, unf_results, unf_wall, cfg, params)
    unfused["launches"] = unf_launches
    unfused["divergences"] = divergences(results, unf_results, unf)
    out["unfused"] = unfused
    log(f"serve unfused (kernels): {unfused['tokens']} tokens in "
        f"{unf_wall:.2f} s = {unfused['tok_per_s']:.1f} tok/s; decode "
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
    gemm_err, unfused_err = check_gemms(gen, dev)
    rht_err = check_rht(gen, dev)
    search = check_code_search(gen, dev)
    attn_err = check_attention(gen, dev)
    gemm_times = [time_gemm(gen, dev, n, d, c, 4) for n, d, c in TIME_SHAPES]
    unfused_times = [time_gemm(gen, dev, n, d, c, 4, fused=False)
                     for n, d, c in TIME_SHAPES]
    rht_times = [time_rht(gen, dev, n, d) for n, d in
                 [(8, 4083), (8, 10974), (64, 4083), (8, 4096), (8, 16384)]]
    search_times = [time_code_search(gen, dev, d, c) for d, c in
                    [(4083, 4096), (4083, 22016), (10974, 4096)]]
    for name, rows in (("rht_qmatmul", gemm_times), ("qmatmul", unfused_times),
                       ("rht", rht_times), ("rabitq_quant", search_times)):
        for t in rows:
            log(f"{name} time {json.dumps(t)}")
    attn_time = time_attention(gen, dev)
    log(f"paged_attention time {json.dumps(attn_time)}")
    torch.cuda.empty_cache()

    quant_out, qparams = quantize_phase(dev)
    serve_out = serve_phase(dev, qparams)

    decode_gemm = gemm_times[1]          # n=8 slots, wq/wk/wv/wo at 4 bits
    decode_unfused = unfused_times[1]
    decode_rht = rht_times[0]            # n=8, d_keep 4083
    search_t = search_times[0]           # (4083, 4096): 128 of 192 weights

    def entry(name, source, replaces, launches, err, t, shape_keys, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": {k: t[k] for k in shape_keys}, **extra}
    kernels = [
        entry("rht_qmatmul", "src/repro_torch/csrc/rht_qmatmul.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:164",
              serve_out["launches"]["rht_qmatmul"], gemm_err, decode_gemm,
              ("n", "d", "c", "bits")),
        entry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention/paged.py:98",
              serve_out["launches"]["paged_attention"], attn_err, attn_time,
              ("b", "h", "kv", "hd", "context")),
        entry("qmatmul", "src/repro_torch/csrc/rht_qmatmul.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:66",
              serve_out["unfused"]["launches"]["qmatmul"], unfused_err,
              decode_unfused, ("n", "d", "c", "bits")),
        entry("rht", "src/repro_torch/csrc/hadamard.cu",
              "src/repro/kernels/hadamard/hadamard.py:35",
              serve_out["unfused"]["launches"]["rht"], rht_err, decode_rht,
              ("n", "d")),
        entry("rabitq_quant", "src/repro_torch/csrc/rabitq_quant.cu",
              "src/repro/kernels/rabitq_quant/quantize.py:49",
              quant_out["code_search_launches"],
              search["max_rescale_abs_err"], search_t, ("d", "c", "bits"),
              measure="max|rescale err| where the step agrees; codes equal",
              differing_columns=search["differing_columns"],
              max_objective_gap=search["max_objective_gap"]),
    ]
    detail = {"gpu": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": regs, "gemm_times": gemm_times,
              "unfused_gemm_times": unfused_times, "rht_times": rht_times,
              "code_search_times": search_times, "code_search_check": search,
              "attention_time": attn_time, "quantize": quant_out,
              "serve": serve_out, "kernels": kernels}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
