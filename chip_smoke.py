#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

  1. environment: the card's name and power limit, CUDA version; TF32 off
     (the plain versions are f32 matmuls and must be a full-f32 yardstick);
  2. build: compiles every kernel in ``src/repro_torch/csrc`` with nvcc;
  3. kernels vs plain versions on the card, at the main path's shapes, with
     the tolerance stated beside each check, then timed (kernel, plain
     version, one PyTorch library call computing the same function);
  4. serve: llama2-7b at its published width (32 layers, d_model 4096, 32
     heads, d_ff 11008, vocab 32000), random weights from a seeded
     generator on the card, every linear quantized to 4 bits with
     ``quantize_linear`` (seeded column norms, outlier_frac 0.003, so every
     layer runs the overlapped non-power-of-2 RHT), 8 requests through
     ``PagedServer.run`` with the kernels, then again with the plain
     versions forced; greedy tokens must match;
  5. a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
     line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the reference package.  Exits non-zero with no
result when no CUDA device is present.  Details too long for the end of the
output go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

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
from repro_torch.core import hadamard, packing, tricks  # noqa: E402
from repro_torch.core.qlinear import draw_signs, quantize_linear  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.kernels.qmatmul.ref import rht_quantized_matmul_ref  # noqa: E402
from repro_torch.models import decode as decmod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import dense_init, norm_params  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and f32 without
# tensor cores; both kernels compute in f32, as the TPU kernels do.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 results of two summation orders (split-K and butterfly vs Kronecker
# matmuls for the GEMM; warp-shuffle vs cuBLAS dots for attention):
# |kernel - plain| <= RTOL * max|plain|.  bf16 arenas are read as the same
# bf16 values by both versions and computed in f32, so the same bound holds.
RTOL = 1e-4
# A greedy divergence between the kernel and plain runs is accepted only
# where the plain run's top-2 logit gap at that step is below this share of
# the step's largest |logit| (f32 reassociation across 32 layers).
GAP_TOL = 1e-3
SEED = 0
OUT_DIR = ROOT / "chiprun_out"

GEMM_SHAPES = [(4083, 4096), (4083, 22016), (10974, 4096), (4096, 4096)]
GEMM_BITS = [1, 2, 3, 4, 8]
GEMM_NS = [1, 8, 64]


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


# ------------------------------------------------------------ GEMM kernel


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


def gemm_bound(n, d, c, bits):
    dh = hadamard.largest_pow2_leq(d)
    passes = 1 if dh == d else 2
    nbytes = (n * d * 4 + packing.packed_rows(d, bits) * c + 2 * c
              + passes * dh * 4 + n * c * 4)
    ops = 2 * n * d * c + passes * n * dh * (dh.bit_length() - 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_gemm(gen, dev) -> float:
    worst = 0.0
    for d, c in GEMM_SHAPES:
        for bits in GEMM_BITS:
            for n in GEMM_NS:
                args = gemm_inputs(gen, dev, n, d, c, bits)
                got = qops.rht_quantized_matmul_cuda(*args, bits=bits, d=d)
                want = rht_quantized_matmul_ref(*args, bits=bits, d=d)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                check(bool(torch.isfinite(got).all()) and err <= RTOL * scale,
                      f"rht_qmatmul n={n} d={d} c={c} bits={bits}: "
                      f"max|err| {err} > {RTOL} * {scale}")
                worst = max(worst, err)
    log(f"rht_qmatmul: {len(GEMM_SHAPES) * len(GEMM_BITS) * len(GEMM_NS)} "
        f"cases within {RTOL} * max|plain|; max|err| {worst:.3e}")
    return worst


def time_gemm(gen, dev, n, d, c, bits) -> dict:
    """Kernel, plain and library (torch.matmul on the dense equivalent
    weight) times, cycling over copies so the codes come from HBM."""
    x, packed, rescale, s1, s2 = gemm_inputs(gen, dev, n, d, c, bits)
    copies = max(2, int(200e6 // packed.numel()) + 1)
    packs = [packed] + [packed.clone() for _ in range(copies - 1)]
    kern = cycler([(p,) for p in packs])

    def kernel():
        return kern(lambda p: qops.rht_quantized_matmul_cuda(
            x, p, rescale, s1, s2, bits=bits, d=d))
    k_ms = graph_ms(kernel)
    call_ms = time_ms(kernel)
    p_ms = time_ms(lambda: kern(lambda p: rht_quantized_matmul_ref(
        x, p, rescale, s1, s2, bits=bits, d=d)), iters=5, warmup=1)
    codes = packing.unpack_codes(packed, bits, d).to(torch.float32)
    w_rot = (codes - ((1 << bits) - 1) / 2.0) * rescale.float()[None, :]
    w_eff = hadamard.practical_rht_inverse(w_rot, s1, s2, axis=0)
    del codes, w_rot
    dense = [w_eff] + [w_eff.clone() for _ in range(2)]
    lib = cycler([(w,) for w in dense])
    l_ms = graph_ms(lambda: lib(lambda w: torch.matmul(x, w)))
    bound, by = gemm_bound(n, d, c, bits)
    del dense, packs, w_eff
    return {"n": n, "d": d, "c": c, "bits": bits, "ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": bound, "bound_by": by}


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
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and err <= RTOL * scale,
              f"paged_attention {name}: max|err| {err} > {RTOL} * {scale}")
        worst = max(worst, err)
        log(f"paged_attention {name}: max|err| {err:.3e} (scale {scale:.3f})")
    # an inactive engine slot: pos 0, ring 1, all-zero table -> null block
    q, k, v, bt, pos, ring = attn_inputs(gen, dev, 2, 1, 32, 32, hd, bs, 4,
                                         64, torch.float32, None)
    bt[1], pos[1], ring[1] = 0, 0, 1
    got = pops.paged_attention_cuda(q, k, v, bt, pos, ring)
    check(bool(torch.isfinite(got).all()), "inactive slot gave non-finite")
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
    nbytes = b * kv * ctx * hd * 4 * 2 + 2 * q.numel() * 4 + bt.numel() * 4
    ops = 4 * b * h * ctx * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return {"b": b, "h": h, "kv": kv, "hd": hd, "context": ctx, "ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------------ serve


def build_quantized_llama(cfg, dev, bits: int = 4) -> dict:
    """Random llama weights from a seeded generator on the card, every
    linear quantized layer by layer (fp32 weights never all resident)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layers = []
    for _ in range(cfg.n_layers):
        lp = tf.init_layer(cfg, gen, dev)
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("wi", "wo"))):
            for name in names:
                w = lp[group][name]
                # stand-in for calibrated activation column norms
                norms = (torch.rand(w.shape[0], generator=gen, device=dev)
                         + 0.5).cpu().numpy()
                _, keep = tricks.outlier_indices(norms, 0.003)
                s1, s2 = draw_signs(int(keep.size), gen)
                lp[group][name] = quantize_linear(
                    w, bits, s1, s2, x_col_norms=norms, outlier_frac=0.003,
                    device=dev)
                del w
        layers.append(lp)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                        device=dev) * 0.02
    return {"embed": embed, "layers": layers,
            "final_norm": norm_params(cfg.norm, cfg.d_model, dev),
            "lm_head": dense_init(gen, cfg.d_model, cfg.vocab, dev)}


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
    for lp in params["layers"]:
        for q in (*lp["attn"].values(), *lp["mlp"].values()):
            nbytes += sum(t.numel() * t.element_size() for t in
                          (q.packed, q.rescale, q.signs1, q.signs2, q.mean_col,
                           q.w_out, q.out_idx, q.keep_idx) if t is not None)
    kv_per_token = cfg.n_layers * 2 * cfg.n_kv * cfg.hd * 4
    return (nbytes + tokens_in_arena * kv_per_token) / HBM_BYTES_PER_S * 1e3


def requests(cfg) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=GEN_LEN) for i, n in enumerate(PROMPT_LENS)]


def serve(cfg, params, dev, pool) -> tuple:
    engine = GapRecordingServer(cfg, params, pool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    results = engine.run(requests(cfg))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return engine, results, wall


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


def serve_phase(dev) -> dict:
    cfg = get_config("llama2-7b")
    t0 = time.monotonic()
    params = build_quantized_llama(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    log(f"llama2-7b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; built + quantized to 4 bits in "
        f"{build_s:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pool = PoolConfig(max_slots=8, block_size=16,
                      max_context=max(PROMPT_LENS) + GEN_LEN, prefill_chunk=64)
    # warm-up (library loads, allocator, cuBLAS handles) outside the counts
    PagedServer(cfg, params, pool, device=dev).run(
        [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])

    qops.launches = 0
    pops.launches = 0
    engine, results, wall = serve(cfg, params, dev, pool)
    launches = {"rht_qmatmul": qops.launches, "paged_attention": pops.launches}
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    n_tok = sum(len(r.tokens) for r in results.values())
    out = {"wall_s": wall, "tokens": n_tok, "tok_per_s": n_tok / wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"],
           "decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"],
           "mean_occupancy": st["mean_occupancy"], "peak_mem_gib": peak / 2**30,
           "decode_step_bound_ms": decode_step_bound_ms(
               cfg, params, float(np.mean(engine.step_tokens))),
           "weights_only_bound_ms": decode_step_bound_ms(cfg, params, 0.0),
           "launches": launches, "build_quantize_s": build_s}
    log(f"serve (kernels): {n_tok} tokens in {wall:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s; prefill {st['prefill_s']:.2f} s, "
        f"decode {st['decode_s']:.2f} s over {st['decode_steps']} steps "
        f"({out['decode_step_ms']:.2f} ms/step, bound "
        f"{out['decode_step_bound_ms']:.3f} ms); peak {out['peak_mem_gib']:.2f}"
        f" GiB; launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(len(results) == len(PROMPT_LENS)
          and all(len(r.tokens) == GEN_LEN for r in results.values())
          and all(0 <= int(t) < cfg.vocab for r in results.values()
                  for t in r.tokens), "serve produced malformed output")

    # launches one decode step makes, counted on a direct call
    qops.launches = 0
    pops.launches = 0
    s = pool.max_slots
    z = torch.zeros(s, dtype=torch.int32, device=dev)
    logits, _ = decmod.decode_step_paged(
        cfg, params, engine.caches, z[:, None], z,
        torch.zeros(s, dtype=torch.bool, device=dev),
        torch.zeros((s, engine.table_width), dtype=torch.int32, device=dev),
        torch.ones(s, dtype=torch.int32, device=dev))
    check(bool(torch.isfinite(logits).all()), "decode step logits not finite")
    out["launches_per_decode_step"] = {"rht_qmatmul": qops.launches,
                                       "paged_attention": pops.launches}

    out["decode_profile"] = profile_decode(cfg, params, dev, pool)

    # the same requests with the plain versions forced on the card
    qops.set_forced_path("ref")
    pops.set_forced_path("ref")
    try:
        plain, plain_results, plain_wall = serve(cfg, params, dev, pool)
    finally:
        qops.set_forced_path(None)
        pops.set_forced_path(None)
    divergences = []
    for rid, r in results.items():
        a, b = r.tokens, plain_results[rid].tokens
        if np.array_equal(a, b):
            continue
        step = int(np.argmax(a != b))
        gap, scale = plain.gaps[(rid, step)]
        divergences.append({"rid": rid, "step": step, "gap": gap,
                            "scale": scale})
        check(gap < GAP_TOL * scale,
              f"rid {rid}: tokens diverge at step {step} where the plain "
              f"run's top-2 gap {gap} >= {GAP_TOL} * {scale}")
    out["plain_wall_s"] = plain_wall
    out["plain_tok_per_s"] = n_tok / plain_wall
    out["divergences"] = divergences
    log(f"serve (plain versions): {plain_wall:.2f} s; greedy tokens "
        f"identical for {len(results) - len(divergences)}/{len(results)} "
        f"requests; accepted near-tie divergences: {len(divergences)}")
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
    log(f"build: {build_s:.1f} s")
    regs = [ln.strip() for lg in logs.values() for ln in lg.splitlines()
            if "registers" in ln]
    for ln in regs:
        log(f"  ptxas: {ln}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    gemm_err = check_gemm(gen, dev)
    attn_err = check_attention(gen, dev)
    gemm_times = [time_gemm(gen, dev, n, d, c, 4)
                  for n, d, c in [(1, 4083, 4096), (8, 4083, 4096),
                                  (8, 4083, 22016), (8, 10974, 4096),
                                  (64, 4083, 4096)]]
    for t in gemm_times:
        log(f"rht_qmatmul time {json.dumps(t)}")
    attn_time = time_attention(gen, dev)
    log(f"paged_attention time {json.dumps(attn_time)}")

    serve_out = serve_phase(dev)

    decode_gemm = gemm_times[1]          # n=8 slots, wq/wk/wv/wo at 4 bits
    kernels = [
        {"name": "rht_qmatmul", "route": "cuda",
         "source": "src/repro_torch/csrc/rht_qmatmul.cu",
         "replaces": "src/repro/kernels/qmatmul/qmatmul.py:164",
         "launches": serve_out["launches"]["rht_qmatmul"],
         "max_abs_err": gemm_err, "ms": decode_gemm["ms"],
         "kernel_ms": decode_gemm["ms"], "plain_ms": decode_gemm["plain_ms"],
         "bound_ms": decode_gemm["bound_ms"],
         "bound_by": decode_gemm["bound_by"],
         "library_ms": decode_gemm["library_ms"],
         "shape": {k: decode_gemm[k] for k in ("n", "d", "c", "bits")}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/paged.py:98",
         "launches": serve_out["launches"]["paged_attention"],
         "max_abs_err": attn_err, "ms": attn_time["ms"],
         "kernel_ms": attn_time["ms"], "plain_ms": attn_time["plain_ms"],
         "bound_ms": attn_time["bound_ms"], "bound_by": attn_time["bound_by"],
         "library_ms": attn_time["library_ms"],
         "shape": {k: attn_time[k] for k in ("b", "h", "kv", "hd", "context")}},
    ]
    detail = {"gpu": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": regs, "gemm_times": gemm_times,
              "attention_time": attn_time, "serve": serve_out,
              "kernels": kernels}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
