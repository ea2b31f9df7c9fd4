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
     IEEE division on sampled mantissa pairs; also at
     ``quantize_params_uniform``'s 8 candidates at qwen3-0.6b's shapes),
     paged flash-decode (R up to 35, one split and several, two calls
     bitwise equal; speculation's W = 2 and 4, Mixtral's verify over a
     wrapped ring; timed at llama2's, Mixtral's and a serving mix's
     shapes, f32 and bf16, and at the verify and catch-up spans), the
     grouped (MoE expert) GEMM fused and unfused at Mixtral's decode and
     prefill shapes and speculation's capacities (C = 5, 10), the GEMMs,
     the RHT and the grouped GEMM also at the lockstep prefill's shapes
     (2048 rows; 5120 rotated rows; C = 640), the GEMMs and the RHT at
     qwen2-vl-2b's and whisper-large-v3's kept widths (Whisper's encoder
     at 1500 and 6000 rows, against ``exact_gemm`` too), paged attention
     at qwen2-vl's G = 6 (R = 6 at decode, R = 24 in a W = 4 verify), and
     the flash-attention forward at Mixtral's and llama2's shapes (also
     against its host tile walk);
  4. quantize: llama2-7b at its published width (d_model 4096, 32 heads,
     d_ff 11008, vocab 32000; LLAMA2_LAYERS of its 32 layers in the whole
     run, all 32 in the single-phase modes) in fp32, random weights from a
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
 5a. the dry-run (``dryrun_phase``): ``launch/dryrun.py``'s cells
     DRYRUN_CELLS (llama2-7b decode_32k bf16 and 4-bit, mixtral-8x7b
     prefill_32k, rwkv6-3b long_500k, deepseek-v2-236b decode_32k at 4
     bits) counted on fake CUDA tensors at full width on the H100 mesh
     32x8 (CUDA memory may grow by less than DRYRUN_MEM); phase 4's model
     counted for one paged decode step with the GEMM and paged-attention
     kernels launching, equal to the same step on fake tensors, its bytes
     over the HBM rate beside ``decode_step_bound_ms`` and phase 5's graph
     ms a step; the kernels' ``cost(...)`` against PERF.md section 6's
     bound column (PERF6_BOUNDS);
 5b. tensor parallelism (``tp_phase``): phase 4's quantization and its
     draft saved to a temporary file under ``build/``; two ranks
     (``launch.mesh.spawn``), both on this card with the gloo backend
     (NCCL puts one rank on each card), each load it and slice their
     column shard (``runtime/tp.py``: heads of wq/wk/wv and the KV arena,
     FFN columns of wi, vocab of lm_head); rank 0 drives phase 5's first
     TP_REQUESTS requests (TP_GEN new tokens each) at TP=2 fused (decode
     and chunked prefill), unfused, and speculating k = 3 deep with the
     2.2-bit draft (the verify steps).  Each run's tokens must equal
     TP=1's request by request (the first TP_GEN of phase 5's fused and
     unfused runs' tokens; the speculating run phase 5's fused tokens);
     against a TP=1 fused run eager in this process, the first 8 decode
     steps' logits are compared
     bit for bit (max |diff| printed) beside checks of each rank's
     columns against the whole op: the cuBLAS products whose N the
     sharding halves (lm_head, the outlier GEMMs: reported) and the GEMM
     and paged-attention kernels planned from the full widths (must be
     bit for bit) and from the slice's own (reported); each rank's GEMM
     and paged-attention launches at shard widths are counted (paths
     ``llama2_tp`` and ``llama2_tp_spec``), and the ranks' host ms per
     step beside TP=1's (gloo through the host, eager, two ranks on one
     card: no speed claim);
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
  9. the gather (``gather_phase``, llama2): ``PagedServer(paged_kernel=
     False)``, the CLI's ``--no-paged-kernel``, over phase 5's requests by
     graph and eagerly (graph = eager, no paged-attention launch, tokens =
     phase 5's but at near-ties), a decode profile beside the kernel's,
     and one speculating run (k = 3, the 2.2-bit draft) whose verify steps
     take the gather branch, tokens = the spec-off gather run;
 10. the front door (``frontdoor_phase``, llama2, 8 slots): a
     ``FrontDoor`` on port 0 on a thread of this process, two passes of 16
     concurrent streaming clients (two tenants, weights 2:1, priorities 0
     and 1, 32 new tokens) and a priority-2 request once every slot is
     busy, which preempts; pass 2 with the SLO target at half pass 1's
     median decode gap, which throttles prefill.  Streams hold
     ``PagedServer.run``'s tokens; client TTFT and inter-token gaps,
     engine decode ms/step and idle share beside ``run``'s; every capture
     made in the driver thread; /healthz, /v1/stats, a clean stop;
 11. lockstep (``lockstep_phase``): ``BatchedServer`` over 8 prompts of
     256 tokens, 32 new: llama2 fused by graph and eagerly and unfused by
     graph, against the paged engine on the same prompts (tokens equal
     but at near-ties; prefill s, decode ms/step); Mixtral by graph and
     eagerly (graph = eager exactly), after phase 8;
 12. dense configs (``dense_phase``): internlm2-1.8b, llama3.2-3b,
     qwen3-0.6b and yi-34b at their published widths, each cut to 2
     layers (``DENSE_LAYERS`` says why), quantized at 4.0 bits and served
     by graph, unfused and plain;
 13. training (``train_phase``): qwen3-0.6b at its published width and
     depth (28 layers, d_model 1024, 16/8 heads at hd 128, d_ff 3072,
     vocab 151936; 0.75 B fp32 params; TRAIN_LAYERS of the 28 in the
     whole run, all of them with ``--train``) trained from a seeded init on the
     synthetic corpus (batch 8 x 256, lr 2e-3, warmup 20,
     SMOKE_TRAIN_STEPS steps through ``launch.train.train``: losses,
     ms/step, tokens/s, peak memory), then the same run through
     ``FaultTolerantLoop`` with a checkpoint TRAIN_TAIL steps before its
     end, failures past ``max_retries`` at the step after it and a
     restore: the losses after the restore, the final params and the
     checkpoint's round trip must equal the uninterrupted run's bit for
     bit (deterministic algorithms); each save's seconds; then the trained
     model calibrated on 5 corpus batches, quantized at 4.0 bits (code
     search counted), its fp32 and quantized perplexity, and served (4
     corpus prompts) by graph and by eager kernels with the same tokens;
     Table 1's protocol on it (``baselines_phase``): the layer Hessians
     of the calibration batches, RTN, GPTQ and AWQ at group 128 and
     uniform RaanA (``quantize_params_uniform``, its 168 code searches
     counted) at 4 bits, each one's average bits, seconds and
     perplexity; RTN, AWQ and GPTQ's row loop on L0.attn.wq on the card
     against the host (bit for bit, GPTQ with the same factor), the
     factor's seconds on the host and by cuSOLVER, and the codes that
     cuSOLVER's factor would move, counted; the uniform model and GPTQ's
     reconstruction served by graph and eagerly, tokens identical
     (paths ``qwen3_uniform`` and ``qwen3_gptq``);
 14. qwen2-vl-2b (``qwen2_vl_phase``) at its published width, cut to
     QWEN2_VL_LAYERS of its 28 layers (mrope): quantized at 4.0 bits,
     served through the paged
     engine by graph, eagerly and unfused (a request sharing 256 prompt
     tokens hits the prefix cache), speculating (k = 3, draft = target),
     through ``BatchedServer`` against the paged engine, and through
     ``make_prefill_step`` / ``make_serve_step`` on a (3, B, S)
     vision-grid position batch fused and unfused; then whisper-large-v3
     (``whisper_phase``) at its published width, cut to WHISPER_LAYERS
     decoder and encoder layers: seeded random (4, 1500, 1280) frames for
     the audio stub, calibrated with frames, quantized at 4.0 bits
     (encoder, decoder and cross-attention), 4 prompts through the
     lockstep steps fused, unfused and plain, tokens identical but at
     near-ties;
 15. a ``{"kernels": [...]}`` line (each kernel's launches per path, each
     path's runs counted from zero), the phases' seconds, the nvidia-smi
     line, and as the last line ``{"ok": true, "device": {...}}``.

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
held to (see ``spec_main``); ``--frontdoor`` builds every kernel and runs
only phases 9-11, after the quantizations they need (see
``frontdoor_main``); ``--train`` builds every kernel and runs only phase
13, with TRAIN_STEPS of training, the example's table of perplexities at
4.3 / 3.3 / 2.3 bits, Table 1's baselines and uniform RaanA at 2 / 3 / 4
bits and a 2.2-bit draft's acceptance on the trained weights (see
``train_main``); ``--mrope-whisper`` builds every kernel
and runs only phase 14, Whisper at its full 32 + 32 layers (see
``mrope_whisper_main``); ``--tp`` builds every kernel and runs only
phase 5b at the whole run's depth, after the quantization and the fused
serve run it needs (see ``tp_main``); ``--dryrun`` builds every kernel
and runs phase 5a after phases 4 (without the plain comparison) and 5 at
the whole run's depth (see ``dryrun_main``).

Imports nothing of JAX or of the reference package.  Exits non-zero with no
result when no CUDA device is present.  Details too long for the end of the
output go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
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

from repro_torch import tree as ptree  # noqa: E402
from repro_torch.baselines import apply as bapply  # noqa: E402
from repro_torch.baselines import quant_baselines as qb  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import hadamard, packing, rabitq  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core.qlinear import QuantizedGrouped, draw_signs  # noqa: E402
from repro_torch.core.tricks import centralize  # noqa: E402
from repro_torch.data import LMBatchLoader, make_corpus_tokens  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
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
from repro_torch.launch import dryrun as dryrunmod  # noqa: E402
from repro_torch.launch import hlocost, mesh  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    QUANT_TENSORS, RATES, SIMT, cost_bound, decode_step_bound_ms, quant_bytes,
    quantized_linears)
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.train import loader_batch, train  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import tp as tpmod  # noqa: E402
from repro_torch.runtime.fault import FaultTolerantLoop, LoopConfig  # noqa: E402
from repro_torch.runtime.steps import (  # noqa: E402
    make_prefill_step, make_serve_step, make_train_step)
from repro_torch.serve import PagedServer, PoolConfig, Request, graphs  # noqa: E402
from repro_torch.serve.frontdoor import FrontDoor, SchedConfig  # noqa: E402
from repro_torch.serve.frontdoor.client import stream_generate  # noqa: E402
from repro_torch.serve.pool import init_pool_caches, request_blocks  # noqa: E402

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
# quantize_params_uniform's candidate count, checked at qwen3-0.6b's code
# searches (no outlier split there, so d_keep = d): wq, wk / wv, the
# attention's wo, wi and the FFN's wo
UNIFORM_N_CAND = pipe.UNIFORM_N_CANDIDATES
UNIFORM_SEARCH_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024),
                         (1024, 6144), (3072, 1024)]
UNIFORM_SEARCH_TIMED = [(1024, 2048), (3072, 1024)]   # wq, the FFN's wo
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
# and at the families' widths: deepseek-v2's wq_b, wo and an expert's wi /
# wo (the grouped form keeps the full width), rwkv6's time-mix weight and
# cv, recurrentgemma's FFN wo
SEARCH_SHAPES += [(1531, 24576), (16334, 5120), (5120, 3072), (1536, 5120),
                  (2552, 2560), (8933, 2560), (7656, 2560)]
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
# the family phases (``family_phase``): FAMILY_SLOTS engine slots,
# FAMILY_PROMPT_LENS (recurrentgemma also RG_LONG_PROMPT, past its window),
# 64-token chunks; the lockstep server's FAMILY_LOCK prompts of
# FAMILY_LOCK_PROMPT tokens
FAMILY_SLOTS = 4
FAMILY_PROMPT_LENS = [64, 200, 128, 96]
RG_LONG_PROMPT = 2100
FAMILY_LOCK, FAMILY_LOCK_PROMPT = 4, 128
FAMILY_GEMM_NS = [4, 8, 32, 52, 64, FAMILY_LOCK * FAMILY_LOCK_PROMPT]
# the MLA, RWKV6 and RG-LRU families' (d_keep, c) at published width:
# deepseek-v2-236b's wq_a, wq_b, wkv_a, wo, shared swi and swo;
# rwkv6-3b's time-mix projections (and RG-LRU's wg / wi / wo, attention's
# wq / wo, all 2552 x 2560), ck and cv; recurrentgemma-2b's wk / wv (one
# KV head of 256) and its FFN's wi and wo.  Rows: decode over 4 slots,
# the family phases' prompt chunks (FAMILY_PROMPT_LENS in 64-token chunks:
# 64, 8 and the long prompt's 52) and their lockstep prefill (FAMILY_LOCK
# prompts of FAMILY_LOCK_PROMPT tokens at once)
FAMILY_GEMM_SHAPES = [
    (5104, 1536), (1531, 24576), (5104, 576), (16334, 5120), (5104, 6144),
    (3062, 5120), (2552, 2560), (2552, 8960), (8933, 2560), (2552, 256),
    (2552, 15360), (7656, 2560)]
# qwen2-vl-2b's (d_keep, c) at published width: wq / wo (1536 kept 1531),
# wk / wv (2 KV heads of 128: c = 256), the GLU's wi (2 x 8960) and its wo
# (8960 kept 8933); rows: decode over 8 slots, speculation's catch-up (16)
# and verify (32), a prompt chunk (64) and the lockstep and mrope-step
# prefills (4 x 128)
MROPE_GEMM_SHAPES = [(1531, 1536), (1531, 256), (1531, 17920), (8933, 1536)]
MROPE_GEMM_NS = [1, 8, 16, 32, 64, 512]
# whisper-large-v3's: its attention and cross-attention projections (1280
# kept 1276) and its GELU FFN's wi and wo (5120 kept 5104); rows: decode
# over 4 prompts, the decoder's prefill (4 x 64), and the encoder over one
# clip (1500 frames: calibration) and over four (6000: the prefill step,
# and the cross-attention's K/V), both also against ``exact_gemm``
WHISPER_GEMM_SHAPES = [(1276, 1280), (1276, 5120), (5104, 1280)]
WHISPER_ENC_ROWS = [1500, 4 * 1500]
WHISPER_GEMM_NS = [1, 4, 256] + WHISPER_ENC_ROWS
# the lockstep prefill's rows: 8 prompts of 256 tokens at once, through
# llama2's projections and Mixtral's attention (wq/wo, wk/wv)
LOCKSTEP_ROWS = 8 * 256
LOCKSTEP_GEMM_SHAPES = GEMM_SHAPES + [(4083, 1024)]
# rows: decode (llama2 8 slots, the dense configs 4, Mixtral's E*C = 16),
# prefill chunks (llama2 64 and the prefix path's 3, 48 and 56 after a
# hit, Mixtral 160); widths: llama2's kept 4083 / 10974, Mixtral's expert
# wo 14336, the powers of 2, 20480 and 8191 (the widest row of plan
# (256, 16): its shared memory and the static row sums just past 48 KB),
# and the dense configs' kept widths 1020-20418
RHT_NS = [1, 3, 4, 8, 16, 48, 56, 64, 160]
RHT_DIMS = [2048, 4096, 8192, 16384, 4083, 8191, 10974, 14336, 20480,
            1020, 2041, 3062, 7146, 8167, 20418]
# and the lockstep prefill's: 2048 rows at llama2's and Mixtral's kept
# widths, Mixtral's experts' E*C = 8 * 640 rows at 4096 and 14336
LOCKSTEP_RHT = [(2048, 4083), (2048, 10974), (5120, 4096), (5120, 14336)]
# the families' kept widths (FAMILY_GEMM_SHAPES) at decode and chunk rows,
# and DeepSeek-V2's grouped experts' full widths (wi 5120, wo 1536) at a
# decode step's E * C = 160 * 6 rows
FAMILY_RHT = ([(n, d) for n in (4, 64) for d in (5104, 1531, 16334, 2552,
                                                 8933, 7656)]
              + [(960, 5120), (960, 1536)])
# qwen2-vl's kept widths at its decode and prefill rows, Whisper's at its
# decode rows, its decoder's prefill and its encoder's one and four clips
MROPE_WHISPER_RHT = ([(n, d) for n in (8, 32, 512) for d in (1531, 8933)]
                     + [(n, d) for n in [4, 256] + WHISPER_ENC_ROWS
                        for d in (1276, 5104)])
RHT_TIMED = [(8, 4083), (8, 10974), (64, 4083), (8, 4096), (8, 16384),
             (16, 4096), (16, 14336), (160, 4096), (160, 14336),
             (8, 1531), (8, 8933), (4, 1276), (6000, 1276), (6000, 5104)]
TIME_SHAPES = [(1, 4083, 4096), (8, 4083, 4096), (8, 4083, 22016),
               (8, 10974, 4096), (64, 4083, 4096), (16, 4083, 4096),
               (32, 4083, 4096), (LOCKSTEP_ROWS, 4083, 4096)]
# the GEMMs (fused and unfused) at qwen2-vl's decode (8 slots) and
# Whisper's decode (4 prompts) and encoder (four clips: 6000 rows)
MROPE_WHISPER_TIMED = [(8, 1531, 1536), (8, 1531, 256), (8, 8933, 1536),
                       (4, 1276, 1280), (6000, 1276, 1280),
                       (6000, 5104, 1280)]
# Mixtral's expert GEMMs (E, C, d, c): wi and wo at decode (8 slots, top-2:
# C = 2) and at a 64-token prefill chunk (C = 20)
GROUPED_SHAPES = [(8, 2, 4096, 28672), (8, 2, 14336, 4096),
                  (8, 20, 4096, 28672), (8, 20, 14336, 4096),
                  # DeepSeek-V2's 160 experts (top-6) at a decode step and a
                  # 64-token chunk: C = 6 either way
                  (160, 6, 5120, 3072), (160, 6, 1536, 5120)]
# checked, not timed: more rows per expert than one 64-row block holds
# + the capacities speculation gives Mixtral's 8 slots: C = 5 for the
# draft's catch-up (16 tokens), C = 10 for the verify (32 tokens)
# + the lockstep prefill's capacity: 2048 tokens top-2 over 8 experts at
# capacity factor 1.25, C = 640
LOCKSTEP_CAP = 640
GROUPED_CHECK_SHAPES = GROUPED_SHAPES + [(3, 100, 4083, 1024),
                                         (8, 5, 4096, 28672),
                                         (8, 10, 4096, 28672),
                                         (8, 10, 14336, 4096),
                                         (8, LOCKSTEP_CAP, 4096, 28672),
                                         (8, LOCKSTEP_CAP, 14336, 4096),
                                         # DeepSeek-V2's lockstep prefill:
                                         # 512 tokens top-6, C = 24
                                         (160, 24, 5120, 3072),
                                         (160, 24, 1536, 5120)]
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


# llama2-7b's depth in the whole run: LLAMA2_LAYERS of its 32 layers
# (published widths), to pay for the later phases inside the script's
# 1050 s aim.  On an H100 80GB HBM3 at 700 W its phases took 737 s of a
# 1110.4 s run at 32 layers (quantize 187.5, serve 171.0, prefix 72.8,
# speculation 219.3, gather 39.3, front door 28.9, lockstep 16.6), 382 s
# of a 793.8 s run at 16 (90.2, 91.3, 37.6, 117.2, 21.1, 16.9, 8.2), and
# 473 s of a 1229.7 s run at 16 on a slower host (98.5, 117.6, 50.2,
# 157.0, 22.7, 18.0, 8.9): there the kernels' build and the phases whose
# code was the same as in the runs before and after it (Mixtral, the cache
# families, Whisper, the dense configs) took 1.1-1.55 x their times.  At 8
# (193 s) such a host still finishes near 1020 s.  The single-phase modes
# (--prefix-cache, --speculation, --frontdoor, --profiles) keep all 32.
LLAMA2_LAYERS = 8
_LLAMA2_DEPTH = [32]          # main() sets LLAMA2_LAYERS for the whole run


def llama2_config():
    """llama2-7b at its published width, at this run's depth."""
    return get_config("llama2-7b").with_(n_layers=_LLAMA2_DEPTH[0])


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
    return cost_bound(qops.cost(n, d, c, bits, fused))


def exact_gemm(x, packed, rescale, s1, s2, bits, d) -> torch.Tensor:
    """The fused GEMM's function in f64 after the f32 rotation both entries
    share: rht(x) @ (r * (codes - c_b)), x (n, d) or (E, C, d) (packed and
    rescale with an expert axis then).  The yardstick the plain version and
    the kernel are each measured against at the lockstep shapes."""
    if x.dim() == 3:
        return torch.stack([exact_gemm(x[i], packed[i], rescale[i], s1, s2,
                                       bits, d) for i in range(x.shape[0])])
    xr = hadamard.practical_rht(x.to(torch.float32), s1, s2, axis=-1)
    c_b = ((1 << bits) - 1) / 2.0
    codes = packing.unpack_codes(packed, bits, d).to(torch.float64) - c_b
    return (xr.to(torch.float64) @ codes) * rescale.to(torch.float64)


def exact_rel(worst: dict, x, packed, rescale, s1, s2, bits, d, got,
              plain) -> None:
    """The kernel's and the plain version's largest error against
    ``exact_gemm``, relative to max|plain|, into ``worst``."""
    exact = exact_gemm(x, packed, rescale, s1, s2, bits, d)
    scale = float(plain.abs().max())
    for key, t in (("kernel_vs_f64", got), ("plain_vs_f64", plain)):
        rel = float((t.to(torch.float64) - exact).abs().max()) / scale
        worst[key] = max(worst.get(key, 0.0), rel)


def check_gemms(gen, dev) -> dict:
    """Both GEMM entries against their plain versions: bits 1-8 at every
    shape and its row counts (GEMM_SHAPES x GEMM_NS, DENSE_GEMM_SHAPES x
    DENSE_GEMM_NS, LOCKSTEP_GEMM_SHAPES at LOCKSTEP_ROWS, where the fused
    kernel and its plain version are also measured against ``exact_gemm``).
    The unfused GEMM gets an already-rotated x."""
    worst = dict.fromkeys(("fused", "unfused", "rel"), 0.0)
    shapes = [(d, c, n) for group, ns in ((GEMM_SHAPES, GEMM_NS),
                                          (DENSE_GEMM_SHAPES, DENSE_GEMM_NS),
                                          (LOCKSTEP_GEMM_SHAPES,
                                           [LOCKSTEP_ROWS]),
                                          (FAMILY_GEMM_SHAPES,
                                           FAMILY_GEMM_NS),
                                          (MROPE_GEMM_SHAPES, MROPE_GEMM_NS),
                                          (WHISPER_GEMM_SHAPES,
                                           WHISPER_GEMM_NS))
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
            if n == LOCKSTEP_ROWS or n in WHISPER_ENC_ROWS:
                exact_rel(worst, x, packed, rescale, s1, s2, bits, d,
                          *(cases["fused"]))
    log(f"rht_qmatmul at n {[LOCKSTEP_ROWS] + WHISPER_ENC_ROWS}, against "
        f"f64: kernel "
        f"{worst['kernel_vs_f64']:.2e}, plain {worst['plain_vs_f64']:.2e} "
        f"of max|plain| (the split plan's MAX_CHUNKS_PER_SPLIT "
        f"{qops.MAX_CHUNKS_PER_SPLIT})")
    log(f"rht_qmatmul and qmatmul: {len(shapes) * len(GEMM_BITS)} cases each "
        f"(bits 1-8; n {GEMM_NS} at {GEMM_SHAPES}, n {DENSE_GEMM_NS} at "
        f"{DENSE_GEMM_SHAPES}, n {LOCKSTEP_ROWS} at {LOCKSTEP_GEMM_SHAPES}, "
        f"n {FAMILY_GEMM_NS} at {FAMILY_GEMM_SHAPES}, n {MROPE_GEMM_NS} at "
        f"{MROPE_GEMM_SHAPES}, n {WHISPER_GEMM_NS} at {WHISPER_GEMM_SHAPES}) "
        f"within {RTOL} * max|plain|; max|err| fused "
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
    cases = ([(n, d) for n in RHT_NS for d in RHT_DIMS] + LOCKSTEP_RHT
             + FAMILY_RHT + MROPE_WHISPER_RHT)
    for n, d in cases:
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
    log(f"rht: {len(cases)} cases (n {RHT_NS} x d {RHT_DIMS}, and "
        f"{LOCKSTEP_RHT + FAMILY_RHT + MROPE_WHISPER_RHT}"
        f"), both entries "
        f"within atol {RHT_ATOL} (max|err| {worst['err']:.3e}); padding "
        f"zero; row sums within {RHT_ATOL} of the rows' f64 sums (max "
        f"{worst['rowsum_err']:.3e}); two calls bitwise equal; the host walk "
        f"bitwise equal in {walk_equal} of {len(cases)} cases (max|diff| "
        f"{worst['walk_err']:.3e})")
    return {**worst, "cases": len(cases), "walk_bitwise_equal": walk_equal}


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
    return cost_bound(hops.cost(n, d))


def launch_floor_ms(dev) -> float:
    """Device time of an empty kernel's launch under graph replay: the
    least a launch costs on this card."""
    return graph_ms(lambda: hops.launch_floor(dev), iters=100)


# -------------------------------------------------------------- code search


def plain_objectives(w: torch.Tensor, bits: int,
                     n_cand: int = N_CAND) -> torch.Tensor:
    """(S, c) objectives -<w,v>^2/<v,v> of every candidate step, computed as
    the plain version computes them."""
    levels = (1 << bits) - 1
    c_b = levels / 2.0
    absmax = torch.amax(torch.abs(w), dim=0)
    delta0 = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, c_b)
    scales = torch.from_numpy(rabitq.candidate_scales(n_cand)).to(w.device)
    errs = []
    for s in scales:
        v = torch.clamp(torch.round(w / (delta0 * s) + c_b), 0.0,
                        float(levels)) - c_b
        wv, vv = torch.sum(w * v, dim=0), torch.sum(v * v, dim=0)
        errs.append(-(wv * wv) / torch.clamp(vv, min=1e-30))
    return torch.stack(errs)


def compare_search(w, codes, rescale, choice, bits, n_cand=N_CAND) -> dict:
    """Kernel output (codes, rescale, choice) against the plain version on
    the same w: identical codes and close rescales where the choice agrees,
    a near-tie where it does not."""
    pc, pr = rq_ops.quantize_ref(w, bits, n_cand)
    errs = plain_objectives(w, bits, n_cand)
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
    out = search_cases(gen, dev, SEARCH_SHAPES, N_CAND)
    out["scalar_vs_tensor_division_differ"] = int(
        (scalar_div != tensor_div).sum())
    out["uniform"] = search_cases(gen, dev, UNIFORM_SEARCH_SHAPES,
                                  UNIFORM_N_CAND)
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
    uni = out["uniform"]
    log(f"rabitq_quant at {UNIFORM_N_CAND} candidates (quantize_params_"
        f"uniform): {len(UNIFORM_SEARCH_SHAPES) * len(GEMM_BITS)} cases "
        f"((d, c) {UNIFORM_SEARCH_SHAPES} x bits 1-8); two calls bitwise "
        f"equal; codes identical where the step agrees; "
        f"{uni['differing_columns']} of {uni['columns']} columns chose "
        f"another step, all near-ties (max objective gap "
        f"{uni['max_objective_gap']:.2e}); rescale max rel err "
        f"{uni['max_rescale_rel_err']:.2e}")
    return out


def search_cases(gen, dev, shapes, n_cand) -> dict:
    """The code-search kernel at ``n_cand`` candidates against its plain
    version on seeded weights of each (d, c) in ``shapes``, bits 1-8: two
    calls bitwise equal, then ``compare_search``; the worst case's
    numbers."""
    out = {"n_candidates": n_cand, "cases": 0, "differing_columns": 0,
           "columns": 0, "max_objective_gap": 0.0,
           "max_rescale_abs_err": 0.0, "max_rescale_rel_err": 0.0}
    for d, c in shapes:
        # columns of different scale, as rotated weights have
        w = (torch.randn((d, c), generator=gen, device=dev)
             * (torch.rand((1, c), generator=gen, device=dev) + 0.1))
        for bits in GEMM_BITS:
            codes, rescale, choice = rq_ops.quantize_cuda(
                w, bits, n_cand, return_choice=True)
            again = rq_ops.quantize_cuda(w, bits, n_cand, return_choice=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(
                (codes, rescale, choice), again)),
                f"code search d={d} c={c} bits={bits} candidates={n_cand}: "
                f"two calls differ")
            res = compare_search(w, codes, rescale, choice, bits, n_cand)
            out["cases"] += 1
            out["differing_columns"] += res["differing_columns"]
            out["columns"] += c
            for k in ("max_objective_gap", "max_rescale_abs_err",
                      "max_rescale_rel_err"):
                out[k] = max(out[k], res[k])
        del w
    return out


def search_bound(d, c, n_cand=N_CAND):
    return cost_bound(rq_ops.cost(d, c, n_cand))


def time_code_search(gen, dev, d, c, bits=4, plain=True,
                     n_cand=N_CAND) -> dict:
    """Kernel and plain times at one weight shape (w is 67-470 MB, past
    L2): ``ms`` by CUDA-graph replay, ``call_ms`` eager calls back to
    back."""
    w = torch.randn((d, c), generator=gen, device=dev)

    def kernel():
        return rq_ops.quantize_cuda(w, bits, n_cand)
    call_ms = time_ms(kernel, iters=5, warmup=1)
    k_ms = graph_ms(kernel, iters=5)
    # one candidate: the three passes over w with almost no sweep
    one_ms = graph_ms(lambda: rq_ops.quantize_cuda(w, bits, 1), iters=5)
    p_ms = (time_ms(lambda: rq_ops.quantize_ref(w, bits, n_cand), iters=3,
                    warmup=1) if plain else None)
    del w
    return {"d": d, "c": c, "bits": bits, "n_candidates": n_cand,
            "slices": rq_ops.search_plan(d), "ms": k_ms,
            "call_ms": call_ms, "one_candidate_ms": one_ms,
            "plain_ms": p_ms, "library_ms": None,
            **search_bound(d, c, n_cand)}


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
    #              [, head_dim: 128 when absent]
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
    # recurrentgemma-2b's local attention: MQA (G = 10 = R, in row chunks
    # of 4 at hd 256), window 2048 over a 128-block ring; positions
    # 1900-2200, the later ones past the ring (wrapped); one CTA per SM
    # with the f32 ring, two with bf16
    ("recurrentgemma f32 G=10 hd=256 window 2048, ring of 128 blocks", 1,
     10, 1, torch.float32, 2048, 128, 2200, 1900, 256),
    ("recurrentgemma bf16 G=10 hd=256 window 2048, ring of 128 blocks", 1,
     10, 1, torch.bfloat16, 2048, 128, 2200, 1900, 256),
    # qwen2-vl-2b's decode: G = 6 (12 heads over 2 KV heads of 128), R = 6
    # rows of the 8-row instantiation; its verify of k = 3 proposals (W =
    # 4): R = 24, in row chunks of 8
    ("qwen2-vl f32 G=6: H=12, KV=2", 1, 12, 2, torch.float32, None, None,
     1024, None),
    ("qwen2-vl bf16 G=6: H=12, KV=2", 1, 12, 2, torch.bfloat16, None, None,
     1024, None),
    ("qwen2-vl verify f32 W=4 G=6 (R=24)", 4, 12, 2, torch.float32, None,
     None, 1024, None),
    ("qwen2-vl verify bf16 W=4 G=6 (R=24)", 4, 12, 2, torch.bfloat16, None,
     None, 1024, None),
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
    # recurrentgemma-2b's decode (hd 256, MQA G = 10, window 2048 over a
    # wrapped 128-block ring), f32 and bf16 arenas
    ("recurrentgemma f32 B=8 G=10 hd=256 window 2048, pos 1900-2200", 1,
     10, 1, torch.float32, 2048, 128, 128, 2200, 1900, 256),
    ("recurrentgemma bf16 B=8 G=10 hd=256 window 2048, pos 1900-2200", 1,
     10, 1, torch.bfloat16, 2048, 128, 128, 2200, 1900, 256),
    # qwen2-vl-2b's decode (G = 6) at context 1024, f32 and bf16 arenas,
    # and its verify (W = 4, R = 24) on the serving mix
    ("qwen2-vl f32 B=8 G=6 ctx 1024", 1, 12, 2, torch.float32, None, None,
     64, 1024, None),
    ("qwen2-vl bf16 B=8 G=6 ctx 1024", 1, 12, 2, torch.bfloat16, None, None,
     64, 1024, None),
    ("qwen2-vl verify f32 B=8 W=4 G=6 ctx 128-547", 4, 12, 2, torch.float32,
     None, None, 35, 547, 128),
]


def attn_splits(args) -> int:
    """The grid splits the wrapper picks for these inputs."""
    q, k, _, bt = args[:4]
    return pops.kv_splits(q.shape[0], k.shape[2], bt.shape[1], k.shape[1],
                          torch.cuda.get_device_properties(
                              q.device).multi_processor_count,
                          pops.ctas_per_sm(q.shape[-1],
                                           k.dtype == torch.bfloat16))


def check_attention(gen, dev) -> dict:
    """Every ATTN_CASES case against the plain version (|err| <= RTOL *
    max|plain|), an inactive slot, and determinism: two calls on the same
    inputs, with one split and with the combine, give equal bits."""
    worst = 0.0
    cases = []
    b, bs = 8, 16
    for (name, w, h, kv, dtype, window, ring_blocks, ctx, ctx_lo,
         *head_dim) in ATTN_CASES:
        hd = head_dim[0] if head_dim else 128
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
        cases.append({"case": name, "hd": hd, "splits": attn_splits(args),
                      "max_abs_err": err, "max_abs_plain": scale})
        if name in ("f32 W=1", "f32 G=4", "mixtral verify f32 W=4 G=4 "
                    "window 4096, ring of 257 blocks",
                    "recurrentgemma f32 G=10 hd=256 window 2048, ring of "
                    "128 blocks"):                # one split; more
            again = pops.paged_attention_cuda(*args, window=window)
            check(torch.equal(got, again),
                  f"paged_attention {name}: two calls differ")
    # the prefix cache: every slot's table starts with slot 0's 32 blocks
    # (a cached 512-token system prompt), contexts 520-600 past them
    hd = 128
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
        f"{RTOL} * max|plain|, four cases bitwise repeatable; max|err| "
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
                   ctx, ctx_lo, hd=128) -> dict:
    """One ATTN_TIMED case: the kernel (graph replay and eager), its plain
    version, SDPA on the gathered K/V, and the bound of the keys read."""
    b, bs = 8, 16
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
    return {"case": name, "b": b, "w": w, "h": h, "kv": kv, "hd": hd,
            "dtype": str(dtype), "window": window, "context": ctx,
            "context_lo": ctx_lo, "keys_read": keys,
            "splits": attn_splits(args), "ms": k_ms, "call_ms": call_ms,
            "plain_ms": p_ms, "library_ms": l_ms,
            **cost_bound(pops.cost(b, w, h, kv, hd, keys,
                                   k_arena.element_size(), bt.numel()))}


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
    return cost_bound(qops.cost(cap, d, c, bits, fused, groups=e))


def check_grouped(gen, dev) -> dict:
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
            if cap == LOCKSTEP_CAP:
                exact_rel(worst, x, packed, rescale, s1, s2, bits, d,
                          *(cases["fused"]))
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
    log(f"grouped rht_qmatmul at C {LOCKSTEP_CAP}, against f64: kernel "
        f"{worst['kernel_vs_f64']:.2e}, plain {worst['plain_vs_f64']:.2e} "
        f"of max|plain|")
    log(f"grouped rht_qmatmul and qmatmul: {n_cases} cases each (bits 1-8 x "
        f"(E, C, d, c) {GROUPED_CHECK_SHAPES}) plus the unfused dispatch, "
        f"within {RTOL} * max|plain|, zero rows exact; max|err| fused "
        f"{worst['fused']:.3e}, unfused {worst['unfused']:.3e}")
    return worst


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
    pairs = fops.pairs(s, s, causal, window)
    work = cost_bound(fops.cost(b, s, s, h, kv, hd, causal, window,
                                q.element_size()))
    del q, k, v
    return {"case": name, "b": b, "s": s, "h": h, "kv": kv, "hd": hd,
            "causal": causal, "window": window, "dtype": str(dtype),
            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, **work,
            "pairs_per_head": pairs}


# ---------------------------------------------------------------- quantize


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
    cfg = llama2_config()
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
        # an arch without attention layers holds every token (MLA) or none
        # (RWKV6) in per-slot rows, not in a ring of blocks
        lens = [(len(st.served) + len(st.out),
                 st.ring_cap if self.has_attn else 1 << 30)
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


def requests(cfg, prompt_lens=PROMPT_LENS) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=GEN_LEN) for i, n in enumerate(prompt_lens)]


def serve(cfg, params, dev, pool, fused=True,
          prompt_lens=PROMPT_LENS, paged_kernel=None) -> tuple:
    engine = GapRecordingServer(cfg, params, pool, fused=fused,
                                paged_kernel=paged_kernel, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    results = engine.run(requests(cfg, prompt_lens))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return engine, results, wall


def serve_summary(engine, results, wall, cfg, params,
                  prompt_lens=PROMPT_LENS, quantized=True) -> dict:
    """A serve run's numbers; a quantized model's prefill chunks and decode
    steps must both reach the GEMM kernel, a full-precision one's
    neither."""
    st = engine.stats
    n_tok = sum(len(r.tokens) for r in results.values())
    check(len(results) == len(prompt_lens)
          and all(len(r.tokens) == GEN_LEN for r in results.values())
          and all(0 <= int(t) < cfg.vocab for r in results.values()
                  for t in r.tokens), "serve produced malformed output")
    reached = [engine.gemms[k] > 0 for k in ("prefill", "decode")]
    check(all(reached) if quantized else not any(reached),
          f"GEMM launches {engine.gemms}: the prefill chunks and the decode "
          f"steps must both reach the GEMM kernel"
          if quantized else f"GEMM launches {engine.gemms} serving "
          f"full-precision weights")
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
                cfg, params, float(np.mean(engine.step_tokens)),
                engine.pool.max_slots)}


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


def chunk_captures(pool, prompt_lens) -> int:
    """Prompt-chunk lengths a graph run of ``prompt_lens`` captures."""
    return len({min(pool.prefill_chunk, n - s) for n in prompt_lens
                for s in range(0, n, pool.prefill_chunk)})


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
    check(out["captures"] == {"decode": 1, "chunk": chunk_captures(
        pool, prompt_lens)} and eager["captures"] == {"decode": 0,
                                                      "chunk": 0},
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
    unfused["request_tokens"] = token_lists(unf_results)
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
    return tie_divergences("greedy tokens", token_lists(base),
                           token_lists(other_results), other_engine.gaps)


def tie_divergences(what: str, want: dict, got: dict, gaps: dict) -> list:
    """Requests (rid -> token list in both ``want`` and ``got``) whose
    tokens differ; each must first differ at a near-tie of the run that gave
    ``got`` (``gaps``: (rid, step) -> (top-2 gap, max |logit|))."""
    out = []
    for rid, a in want.items():
        b = got[rid]
        check(len(a) == len(b), f"{what}: rid {rid} has {len(b)} tokens, "
              f"not {len(a)}")
        if a == b:
            continue
        step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap, scale = gaps[(rid, step)]
        out.append({"rid": rid, "step": step, "gap": gap, "scale": scale})
        check(gap < GAP_TOL * scale,
              f"{what}: rid {rid} diverges at step {step} where the top-2 "
              f"gap {gap} >= {GAP_TOL} * {scale}")
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
                   labels=(), paged_kernel=None) -> dict:
    """Where a decode step's time goes: 8 requests (prompt 128, 64 new
    tokens) are admitted and prefilled, then ``steps`` pure decode steps
    run on the host clock and ``steps`` more under torch.profiler
    (``profile_steps``)."""
    engine = PagedServer(cfg, params, pool, paged_kernel=paged_kernel,
                         device=dev)
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
    cfg = llama2_config()
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


# --------------------------------------------------------- tensor parallel

TP_DEGREE = 2            # ranks of the parity run, every one on cuda:0
TP_LOGIT_STEPS = 8       # decode steps whose logits TP=2 and TP=1 compare
TP_RUNS = (("fused", True, False), ("unfused", False, False),
           ("spec", True, True))     # name, fused, speculating (SPEC_K deep)
TP_CHECK_ROWS = (8, 64)  # a decode step's and a prefill chunk's rows
# the serve phase's first TP_REQUESTS requests (prompts 64, 512, 128, 384:
# one and several prefill chunks) with TP_GEN of their GEN_LEN new tokens:
# the ranks' eager steps over gloo run 2-3x slower on some hosts, which
# took the whole run past its limit at all eight requests and 32 tokens
TP_REQUESTS = 4
TP_GEN = 16
TP_THREADS = 2           # each rank's intra-op threads (8 cores, 2 ranks)


class LogitServer(PagedServer):
    """Keeps host copies of its first TP_LOGIT_STEPS decode steps'
    logits."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.decode_logits: list = []

    def _compiled(self, key, inert):
        step = super()._compiled(key, inert)
        if key[0] != "decode":
            return step
        kept = self.decode_logits

        def call(inputs):
            out = step(inputs)
            if len(kept) < TP_LOGIT_STEPS:
                kept.append(out.to(torch.float32).cpu().numpy().copy())
            return out
        return call


def tp_engine(cfg, art: dict, pool, run: str, dev, group=None):
    """A ``LogitServer`` for TP_RUNS' ``run`` over ``art`` (the target
    and its draft), alone or as a rank of ``group``."""
    _, fused, spec = next(r for r in TP_RUNS if r[0] == run)
    kw = {"draft_params": art["draft"], "speculate": SPEC_K} if spec else {}
    return LogitServer(cfg, art["target"], pool, fused=fused, device=dev,
                       group=group, **kw)


def tp_run(engine, reqs) -> dict:
    """One run of ``reqs``, driven by ``engine`` (alone, or rank 0 of a TP
    group), its launches counted from zero: tokens, the first decode
    steps' logits, host ms per decode step, prefill chunk and speculative
    round (ending in a synchronize, as every step reads its logits)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    st = engine.stats
    out = {"request_tokens": token_lists(results), "launches": counts(),
           "wall_s": time.monotonic() - t0, "tp": st["tp"],
           "captures": st["captures"], "logits": engine.decode_logits,
           "prefill_chunk_ms": 1e3 * st["prefill_s"] / st["prefill_chunks"]}
    if engine.speculate:
        out["acceptance_rate"] = st["acceptance_rate"]
        out["ms_per_round"] = 1e3 * st["spec_s"] / st["spec_rounds"]
    else:
        out["decode_step_ms"] = 1e3 * st["decode_s"] / st["decode_steps"]
    return out


def tp_rank(group, path: str, cfg, pool, reqs) -> dict:
    """One rank of the TP=2 parity run: load the quantization artifact
    onto this rank's device, then serve TP_RUNS over ``group``.  Rank 0
    drives each run (``tp_run``) and reports its shard widths; the worker
    mirrors it and reports its launches, counted from zero per run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    art = torch.load(path, map_location=group.device, weights_only=False)
    out = {"load_s": time.monotonic() - t0, "runs": {}}
    for name, _, _ in TP_RUNS:
        engine = tp_engine(cfg, art, pool, name, group.device, group)
        if group.rank:
            zero_counts()
            engine.serve_worker()
            out["runs"][name] = {"launches": counts()}
            continue
        try:
            run = tp_run(engine, reqs)
        finally:
            engine.close()
        lp = engine.params["layers"][0]
        run["shard_cols"] = {f"{g}.{k}": int(lp[g][k].rescale.shape[-1])
                             for g, ks in (("attn", ("wq", "wk", "wv", "wo")),
                                           ("mlp", ("wi", "wo"))) for k in ks}
        run["shard_cols"]["lm_head"] = int(engine.params["lm_head"].shape[1])
        run["arena_kv_heads"] = int(engine.caches[0]["k"].shape[2])
        out["runs"][name] = run
        del engine
    return out


def tp_candidate_ops(params, dev) -> dict:
    """Whether each rank's columns (heads) come out bit for bit as in the
    whole op, for the ops whose widths the sharding halves: the cuBLAS
    products ``lm_head`` and the outlier GEMMs (``core/qlinear.py``'s
    ``x_out @ w_out``) of the first quantized wq and wi with outliers; the
    dequant GEMM kernel on those weights' slices planned from the layer's
    c (``plan_c``, as the engine runs it) and from the slice's own c; and
    the paged-attention kernel on half the KV heads planned from all of
    them (``pops.plan_heads``, as the engine runs it) and from its own.
    At a decode step's and a prefill chunk's rows (attention: W = 1 and
    speculation's W = 4 over llama2's pool); each rank's columns are
    ``tp._columns``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qls = quantized_linears(params)
    weights = [(key, glu, next(q for n, q in qls.items() if n.endswith(key)
                               and q.w_out is not None))
               for key, glu in (("attn.wq", False), ("mlp.wi", True))]
    cands = [("lm_head", params["lm_head"], False)] + [
        (f"outlier {key}", q.w_out.to(torch.float32), glu)
        for key, glu, q in weights]
    out = {}

    def ranks_cols(c, glu):
        return [torch.from_numpy(tpmod._columns(c, r, TP_DEGREE, glu)).to(
            dev) for r in range(TP_DEGREE)]
    for name, w, glu in cands:
        for n in TP_CHECK_ROWS:
            x = torch.randn(n, w.shape[0], generator=gen, device=dev)
            full = x @ w
            out[f"{name} n={n}"] = all(
                torch.equal(full[:, cols], x @ w[:, cols].contiguous())
                for cols in ranks_cols(w.shape[1], glu))
    for key, glu, q in weights:
        for n in TP_CHECK_ROWS:
            x = torch.randn(n, q.d_keep, generator=gen, device=dev)

            def gemm(packed, rescale, plan_c=None):
                return qops.rht_quantized_matmul(
                    x, packed, rescale, q.signs1, q.signs2, bits=q.bits,
                    d=q.d_keep, plan_c=plan_c)
            full = gemm(q.packed, q.rescale)
            for how, plan in (("layer's c", q.c), ("slice's c", None)):
                out[f"GEMM {key} n={n}, planned from the {how}"] = all(
                    torch.equal(full[:, cols], gemm(
                        q.packed.index_select(1, cols).contiguous(),
                        q.rescale.index_select(0, cols).contiguous(), plan))
                    for cols in ranks_cols(q.c, glu))
    cfg, pool = llama2_config(), llama2_pool()
    mb = pool.max_context // pool.block_size
    for w in (1, SPEC_K + 1):
        q, k, v, bt, pos, ring = attn_inputs(
            gen, dev, pool.max_slots, w, cfg.n_heads, cfg.n_kv, cfg.hd,
            pool.block_size, mb, pool.max_context, torch.float32, None)
        full = pops.paged_attention(q, k, v, bt, pos, ring)
        hq, hk = cfg.n_heads // TP_DEGREE, cfg.n_kv // TP_DEGREE
        for how, plan in (("all KV heads", cfg.n_kv), ("its own", None)):
            with pops.plan_heads(plan):
                out[f"paged attention W={w}, planned from {how}"] = all(
                    torch.equal(full[:, :, r * hq:(r + 1) * hq],
                                pops.paged_attention(
                                    q[:, :, r * hq:(r + 1) * hq].contiguous(),
                                    k[:, :, r * hk:(r + 1) * hk].contiguous(),
                                    v[:, :, r * hk:(r + 1) * hk].contiguous(),
                                    bt, pos, ring))
                    for r in range(TP_DEGREE))
    return out


def tp_phase(dev, params, draft, serve_out) -> dict:
    """llama2-7b's quantization (and its DRAFT_BITS draft) served at TP=2:
    TP_DEGREE ranks, every one on cuda:0 with the gloo backend (NCCL will
    not put two ranks on one card), each loading the artifact this process
    saves and slicing its shard; rank 0 drives TP_RUNS over the serve
    phase's first TP_REQUESTS requests, TP_GEN new tokens each (fused:
    decode and chunked prefill; unfused; and speculating with the draft:
    the verify steps).  Each run's tokens must equal TP=1's request by
    request: the first TP_GEN of the serve phase's fused and unfused graph
    runs (graph = eager, phase 5), the speculating run the fused one's
    (greedy speculation emits plain decoding's tokens, as phase 8
    checks).  One TP=1 fused run here, eagerly as the ranks run,
    gives the logits of the first TP_LOGIT_STEPS decode steps, compared
    bit for bit, beside the candidate ops whose widths change."""
    cfg, pool = llama2_config(), llama2_pool()
    reqs = [dataclasses.replace(r, max_new=TP_GEN)
            for r in requests(cfg)[:TP_REQUESTS]]

    def head(tokens):           # greedy: a prefix of the serve phase's
        return {r.rid: tokens[r.rid][:TP_GEN] for r in reqs}
    art = {"target": params, "draft": draft}
    with graphs.eager():
        base = tp_run(tp_engine(cfg, art, pool, "fused", dev), reqs)
    check(base["request_tokens"] == head(serve_out["request_tokens"]),
          "tp: the eager TP=1 run's tokens differ from the serve phase's")
    want_tokens = {"fused": head(serve_out["request_tokens"]),
                   "unfused": head(serve_out["unfused"]["request_tokens"]),
                   "spec": head(serve_out["request_tokens"])}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tp_artifact_", dir=ROOT / "build")
    try:
        path = os.path.join(tmp, "llama2.pt")
        t0 = time.monotonic()
        torch.save(art, path)
        save_s = time.monotonic() - t0
        artifact_gb = os.path.getsize(path) / 1e9
        t0 = time.monotonic()
        ranks = mesh.spawn(tp_rank, TP_DEGREE, path, cfg, pool, reqs,
                           backend="gloo", device=dev, threads=TP_THREADS)
        ranks_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lead, worker = ranks
    out = {"degree": TP_DEGREE, "backend": "gloo", "save_s": save_s,
           "artifact_gb": artifact_gb, "ranks_s": ranks_s,
           "load_s": [r["load_s"] for r in ranks], "runs": {}}
    log(f"tp: artifact {artifact_gb:.2f} GB saved in {save_s:.1f} s; "
        f"{TP_DEGREE} ranks on one card over gloo ran {len(TP_RUNS)} runs in "
        f"{ranks_s:.1f} s (load {out['load_s'][0]:.1f} s)")
    out["tp1_fused"] = {k: base[k] for k in base
                        if k not in ("logits", "request_tokens")}
    for name, _, _ in TP_RUNS:
        want, got = want_tokens[name], lead["runs"][name]
        same = sum(got["request_tokens"].get(rid) == toks
                   for rid, toks in want.items())
        launches = {k: got["launches"][k] + worker["runs"][name][
            "launches"][k] for k in got["launches"]}
        row = {k: got[k] for k in got if k not in ("logits",
                                                  "request_tokens")}
        row.update(launches=launches,
                   worker_launches=worker["runs"][name]["launches"],
                   identical_requests=same)
        out["runs"][name] = row
        log(f"tp {name}: TP=2 tokens identical to TP=1 for {same}/"
            f"{len(want)} requests; shard columns {got['shard_cols']}, arena "
            f"KV heads {got['arena_kv_heads']} of {cfg.n_kv}; launches (both "
            f"ranks) {launches}; host ms at TP=2: " + ", ".join(
                f"{k} {got[k]:.2f}" for k in (
                    "decode_step_ms", "prefill_chunk_ms", "ms_per_round",
                    "acceptance_rate") if k in got)
            + (f" (TP=1 eager: decode_step_ms {base['decode_step_ms']:.2f}, "
               f"prefill_chunk_ms {base['prefill_chunk_ms']:.2f})"
               if name == "fused" else ""))
        check(same == len(want),
              f"tp {name}: TP=2 tokens differ from TP=1's")
        check(got["tp"] == TP_DEGREE and got["captures"] == 0,
              f"tp {name}: the ranks' engine reported tp {got['tp']}, "
              f"captures {got['captures']}")
        gemm = "rht_qmatmul" if name != "unfused" else "qmatmul"
        for rank, by in enumerate((got["launches"],
                                   worker["runs"][name]["launches"])):
            check(by[gemm] > 0 and by["paged_attention"] > 0
                  and (name != "unfused" or (by["rht"] > 0
                                             and by["rht_qmatmul"] == 0)),
                  f"tp {name}: rank {rank} launched {by}")
    steps = []
    for i, (a, b) in enumerate(zip(base["logits"],
                                   lead["runs"]["fused"]["logits"])):
        steps.append({"step": i, "bit_identical": bool(np.array_equal(a, b)),
                      "max_abs_diff": float(np.max(np.abs(a - b)))})
    check(len(steps) == TP_LOGIT_STEPS,
          f"tp: {len(steps)} decode steps' logits compared")
    out["logit_steps"] = steps
    out["candidate_ops"] = tp_candidate_ops(params, dev)
    check(all(v for k, v in out["candidate_ops"].items()
              if "planned from the layer's" in k or "from all KV" in k),
          f"tp: a kernel planned from the full widths changed a rank's "
          f"columns: {out['candidate_ops']}")
    differ = [s["step"] for s in steps if not s["bit_identical"]]
    log(f"tp logits, first {TP_LOGIT_STEPS} decode steps: bit-identical to "
        f"TP=1 at {TP_LOGIT_STEPS - len(differ)}, max |diff| "
        f"{max(s['max_abs_diff'] for s in steps):.3g}"
        + (f"; differing steps {differ}" if differ else ""))
    unequal = [k for k, v in out["candidate_ops"].items() if not v]
    log(f"tp candidate ops (each rank's columns bit for bit as in the whole "
        f"product): {json.dumps(out['candidate_ops'])}"
        + (f"; candidates that differ: {', '.join(unequal) or 'none'}"
           if differ else ""))
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
    cfg = llama2_config()
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

    def _op(self, kind):
        fn = super()._op(kind)
        counter = self.overflow           # the closure holds no engine
        if counter is None or kind not in ("decode", "chunk", "verify"):
            return fn

        def counted(**inputs):
            with moemod.count_overflow(counter):
                return fn(**inputs)
        return counted

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
               overflow=None, paged_kernel=None) -> tuple:
    """One run of ``reqs`` (default: the churn workload) on a fresh
    ``SpecServer``, speculating SPEC_K deep when ``draft`` is given; the
    peak memory is reset just before it."""
    kw = {"draft_params": draft, "speculate": SPEC_K} if draft else {}
    engine = SpecServer(cfg, params, pool, device=dev, overflow=overflow,
                        paged_kernel=paged_kernel, **kw)
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
    cfg = llama2_config()
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
# every dense config's depth is cut to 2 layers (widths as published; 4
# until the tensor-parallel phase joined the script: a whole run on a
# slow host then took 1210.2 s on an H100 80GB HBM3 at 700 W, dense 66.5 s
# of it at 4 layers).
# yi-34b's fp32 weights (2.2 GB a layer over 60 layers) would exceed the
# card's 80 GB.  The three small ones fit but the time does not: with them
# at full depth the whole script ran 1059.8 s on an H100 (80GB HBM3, 700
# W), past the 1050 s it keeps to, in phases of (s): kernels 49.6,
# quantize 179.8, serve 157.6, prefix 71.8, speculation 218.8, gather
# 41.0, front door 28.6, lockstep 16.0 + 1.9, Mixtral 24.1 + 75.8 + 22.8
# and dense 172.0
DENSE_LAYERS = 2
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


# ----------------------------------------------- MLA, RWKV6 and RG-LRU

# each family at its published width, the depth cut (the widths, heads,
# experts, windows and states are as published):
#   deepseek-v2-236b 2 of 60 layers: one layer is 3.97 B fp32 params (15.9
#     GB: MLA 149 M, 160 experts 3.77 B, 2 shared experts 47 M), the
#     embedding and lm_head 4.2 GB, 36 GB in all; the calibration holds it
#     whole on the 80 GB card beside the quantized copy;
#   rwkv6-3b 4 of 32 layers and recurrentgemma-2b 5 of 26 (one (rglru,
#     rglru, attn) period and the remainder of 2, as its TINY variant):
#     the time of the whole run, not memory, limits them.
FAMILY_ARCHS = {"deepseek-v2-236b": 2, "rwkv6-3b": 4, "recurrentgemma-2b": 5}
FAMILY_PATH = {"deepseek-v2-236b": "deepseek_v2", "rwkv6-3b": "rwkv6",
               "recurrentgemma-2b": "recurrentgemma"}


def family_config(arch):
    """``arch`` at its published width, the depth cut to FAMILY_ARCHS."""
    cfg = get_config(arch)
    n = FAMILY_ARCHS[arch]
    return cfg.with_(n_layers=n, mixer_pattern=cfg.pattern[:n])


def family_prompt_lens(arch) -> list:
    """FAMILY_PROMPT_LENS, and for recurrentgemma one prompt past its
    2048-token window, whose KV ring wraps in prefill and in decode."""
    return FAMILY_PROMPT_LENS + ([RG_LONG_PROMPT] if arch ==
                                 "recurrentgemma-2b" else [])


def family_pool(arch) -> PoolConfig:
    return PoolConfig(max_slots=FAMILY_SLOTS, block_size=16,
                      max_context=max(family_prompt_lens(arch)) + GEN_LEN,
                      prefill_chunk=64)


def family_quantize(arch, dev, cfg=None, extra=None) -> tuple:
    """fp32 ``cfg`` (default ``family_config(arch)``) from a seed on the
    card, calibrated on the zero-shot sentence (256 tokens; ``extra``:
    more entries of the batch, Whisper's frames), allocated (AVG_BITS) and
    quantized with the code-search kernel (counted: one launch per 2-D
    weight, one per expert of a grouped stack).  The fp weights are
    dropped after.  -> (summary, quantized params)."""
    cfg = cfg or family_config(arch)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 11), device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    fp_gb = sum(t.numel() * 4 for t in ptree.leaves(params)) / 1e9
    layer_gb = [sum(t.numel() * 4 for t in ptree.leaves(lp)) / 1e9
                for lp in params["layers"]]
    zero_counts()
    t0 = time.monotonic()
    toks = torch.from_numpy(cal.zero_shot_tokens(cfg.vocab, 256)).to(dev)
    stats = cal.calibrate(
        lambda p, b, ctx, cfg=cfg: tf.loss_fn(cfg, p, b, ctx=ctx), params,
        [{"tokens": toks, **(extra or {})}])
    torch.cuda.synchronize()
    calibrate_s = time.monotonic() - t0
    calibrate_peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(st.alpha) and st.alpha > 0
              for st in stats.values()), f"{arch}: calibration gave a bad "
          f"alpha")
    qparams, rep = pipe.quantize_model(
        cfg, params, stats, AVG_BITS,
        generator=torch.Generator(device=dev).manual_seed(SEED + 12),
        device=dev)
    searches = counts()["rabitq_quant"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, stats
    torch.cuda.empty_cache()
    qls = quantized_linears(qparams)
    grouped = [q for q in qls.values() if isinstance(q, QuantizedGrouped)]
    expected = len(qls) - len(grouped) + sum(q.packed.shape[0]
                                             for q in grouped)
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "published_layers": get_config(arch).n_layers,
           "pattern": list(cfg.pattern), "d_model": cfg.d_model,
           "fp32_gb": fp_gb, "fp32_layer_gb": layer_gb, "init_s": init_s,
           "calibrate_s": calibrate_s, "allocate_s": rep.allocate_s,
           "quantize_s": rep.quantize_s, "avg_bits": rep.avg_bits,
           "n_quantized": rep.n_layers, "code_search_launches": searches,
           "grouped_weights": len(grouped),
           "per_layer_bits": rep.per_layer_bits,
           "packed_gb": sum(q.packed.numel() for q in qls.values()) / 1e9,
           "calibrate_peak_gib": calibrate_peak, "peak_mem_gib": peak,
           "rotation_widths": sorted({getattr(q, "d_keep", q.d)
                                      for q in qls.values()})}
    check(searches == expected and rep.n_layers == len(qls)
          and AVG_BITS - 0.5 < rep.avg_bits <= AVG_BITS,
          f"{arch}: {rep.n_layers} weights, {searches} code searches "
          f"(expected {expected}), {rep.avg_bits} bits")
    log(f"{arch} quantize ({cfg.n_layers} of {out['published_layers']} "
        f"layers, d_model {cfg.d_model}; {fp_gb:.2f} GB fp32, "
        f"{layer_gb[0]:.2f} GB a layer): init {init_s:.1f} s, calibrate_s "
        f"{calibrate_s:.2f}, allocate_s {rep.allocate_s:.2f}, quantize_s "
        f"{rep.quantize_s:.2f}; {rep.avg_bits:.4f} bits over {rep.n_layers} "
        f"weights ({len(grouped)} grouped); code searches {searches}; "
        f"rotation widths {out['rotation_widths']}; peak {peak:.2f} GiB "
        f"(calibration {calibrate_peak:.2f} GiB)")
    return out, qparams


def family_phase(arch, dev) -> dict:
    """One family at published width (``family_config``): quantized
    (``family_quantize``), then FAMILY_SLOTS slots serve
    ``family_prompt_lens(arch)`` (GEN_LEN new each) by graph, eagerly
    (``graphs.eager()``: tokens and launches identical to the graph run)
    and unfused by graph (tokens equal but at near-ties), each counted from
    zero; a decode step profiled by graph and eagerly (device ms, idle
    share); then ``BatchedServer`` by graph and eagerly (identical) against
    the paged engine on FAMILY_LOCK prompts of FAMILY_LOCK_PROMPT tokens.
    The prefix cache and speculation are bypassed (per-slot state); only
    recurrentgemma's attention layers launch paged attention."""
    t_phase = time.monotonic()
    cfg = family_config(arch)
    out, params = family_quantize(arch, dev)
    pool = family_pool(arch)
    lens = family_prompt_lens(arch)
    PagedServer(cfg, params, pool, device=dev).run(   # warm-up, not counted
        [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])
    runs = {}
    for mode, fused, eager in (("graph", True, False), ("eager", True, True),
                               ("unfused", False, False)):
        zero_counts()
        with graphs.eager(eager):
            eng, res, wall = serve(cfg, params, dev, pool, fused=fused,
                                   prompt_lens=lens)
        summ = serve_summary(eng, res, wall, cfg, params, lens)
        summ["launches"] = counts()
        runs[mode] = (eng, res, summ)
    base = runs["graph"][1]
    for mode in ("graph", "eager", "unfused"):
        eng, res, summ = runs[mode]
        summ["divergences"] = divergences(base, res, eng)
        summ["identical"] = len(base) - len(summ["divergences"])
        out[mode] = {k: summ[k] for k in (
            "decode_step_ms", "decode_step_bound_ms", "prefill_s",
            "prefill_chunk_ms", "wall_s", "tok_per_s", "decode_steps",
            "prefill_chunks", "captures", "capture_s", "graph_pool_mib",
            "peak_mem_gib", "launches", "gemm_launches", "identical",
            "divergences", "tokens_past_ring", "prefix_cache")}
    graph, eager, unf = out["graph"], out["eager"], out["unfused"]
    engine = runs["graph"][0]
    check(eager["identical"] == len(base)
          and graph["launches"] == eager["launches"],
          f"{arch}: graph and eager differ: tokens {eager['identical']}/"
          f"{len(base)}, launches {graph['launches']} vs "
          f"{eager['launches']}")
    check(graph["captures"] == {"decode": 1, "chunk": chunk_captures(
        pool, lens)} and eager["captures"] == {"decode": 0, "chunk": 0},
          f"{arch}: captures graph {graph['captures']}, eager "
          f"{eager['captures']}")
    check(engine.prefix_cache is None and engine.speculate == 0,
          f"{arch}: the prefix cache and speculation must be bypassed")
    out["request_tokens"] = token_lists(base)
    del runs, engine
    fused_l, unf_l = graph["launches"], unf["launches"]
    attn = "attn" in cfg.pattern
    check(fused_l["rht_qmatmul"] > 0 and unf_l["rht"] > 0
          and unf_l["qmatmul"] > 0 and unf_l["rht_qmatmul"] == 0
          and (fused_l["paged_attention"] > 0) == attn
          and (fused_l["grouped_rht_qmatmul"] > 0) == (cfg.moe is not None)
          and (unf_l["grouped_qmatmul"] > 0) == (cfg.moe is not None),
          f"{arch}: kernels by run: fused {fused_l}, unfused {unf_l}")
    if arch == "recurrentgemma-2b":
        check(graph["tokens_past_ring"] > 0,
              f"{arch}: the long request never wrapped its window ring")
    out["decode_profile"] = {"graph": profile_decode(cfg, params, dev, pool)}
    with graphs.eager():
        out["decode_profile"]["eager"] = profile_decode(cfg, params, dev,
                                                        pool)
    out["lockstep"] = lockstep_phase(
        FAMILY_PATH[arch], cfg, params, dev, True,
        modes={"graph": (True, False), "eager": (True, True)},
        n_prompts=FAMILY_LOCK, prompt_len=FAMILY_LOCK_PROMPT, pool=pool)
    prof = {m: {k: out["decode_profile"][m][k] for k in (
        "device_ms_per_step", "wall_ms_per_step", "idle_share",
        "launches_per_step")} for m in ("graph", "eager")}
    out["phase_s"] = time.monotonic() - t_phase
    log(f"{arch} serve ({len(lens)} requests of {lens} prompt tokens, "
        f"{GEN_LEN} new, {FAMILY_SLOTS} slots): decode ms/step graph "
        f"{graph['decode_step_ms']:.3f} / eager {eager['decode_step_ms']:.3f}"
        f" / unfused {unf['decode_step_ms']:.3f} (bound "
        f"{graph['decode_step_bound_ms']:.3f}); prefill_s graph "
        f"{graph['prefill_s']:.3f} / eager {eager['prefill_s']:.3f}; tokens "
        f"identical graph / eager / unfused {graph['identical']} / "
        f"{eager['identical']} / {unf['identical']} of {len(base)}; peak "
        f"{graph['peak_mem_gib']:.2f} GiB; launches by graph {fused_l}; "
        f"decode profile {json.dumps(prof)}; {out['phase_s']:.1f} s in all; "
        f"{gpu_line()}")
    del params
    torch.cuda.empty_cache()
    return out


def families_phase(dev) -> dict:
    return {arch: family_phase(arch, dev) for arch in FAMILY_ARCHS}


# ------------------------------------- mrope (qwen2-vl) and Whisper's steps

QWEN2_VL, WHISPER = "qwen2-vl-2b", "whisper-large-v3"
# whisper-large-v3's depth in the whole run: WHISPER_LAYERS decoder layers
# and as many encoder layers of its 32 + 32 (published widths: d_model
# 1280, 20 heads of 64, d_ff 5120, 1500 frames), to keep the script inside
# its 1050 s aim as later phases join it.  On an H100 80GB HBM3 at 700 W
# the phase took 10.4 s at 8 + 8 layers in a whole run of 879.9 s
# (AllocateBits 3.77 s over 128 weights) and 41.5 s at 32 + 32 in
# --mrope-whisper (AllocateBits 15.18 s over 512 weights; 6.40 GB fp32,
# a 19.83 GiB calibration peak), which keeps all 64.
WHISPER_LAYERS = 8
_WHISPER_DEPTH = [32]          # main() sets WHISPER_LAYERS for the whole run
# qwen2-vl-2b's depth in the whole run: QWEN2_VL_LAYERS of its 28 layers
# (published widths).  At 28 the phase took 99.3 s of an 846.7 s whole
# run and 158.7 s of a 1210.2 s one on a slower host, past the 1200 s
# limit once the tensor-parallel phase joined (H100 80GB HBM3, 700 W);
# --mrope-whisper keeps all 28.
QWEN2_VL_LAYERS = 14
_QWEN2_VL_DEPTH = [28]         # main() sets QWEN2_VL_LAYERS for the whole run
WHISPER_BATCH = 4              # decoder prompts, each over its own clip
WHISPER_PROMPT = 64            # decoder prompt tokens before GEN_LEN new
# the mrope steps' batch: MROPE_BATCH prompts of MROPE_PROMPT tokens, a
# GRID_SIDE x GRID_SIDE vision grid (temporal 0, height i // side, width
# i % side) and then text from the grid's largest position + 1
MROPE_BATCH, MROPE_PROMPT, GRID_SIDE = 4, 128, 8


def qwen2_vl_config():
    return get_config(QWEN2_VL).with_(n_layers=_QWEN2_VL_DEPTH[0])


def whisper_config():
    return get_config(WHISPER).with_(n_layers=_WHISPER_DEPTH[0],
                                     n_enc_layers=_WHISPER_DEPTH[0])


def grid_positions(b: int, s: int) -> np.ndarray:
    """(3, b, s) int32 vision-grid positions (see MROPE_BATCH)."""
    n = GRID_SIDE * GRID_SIDE
    pos = np.zeros((3, s), np.int32)
    i = np.arange(n)
    pos[1, :n], pos[2, :n] = i // GRID_SIDE, i % GRID_SIDE
    pos[:, n:] = (np.arange(s - n) + GRID_SIDE)[None]
    return np.broadcast_to(pos[:, None], (3, b, s)).copy()


def lockstep_steps(cfg, params, batch: dict, n_tokens: int) -> dict:
    """``make_prefill_step`` on ``batch``, then ``n_tokens`` greedy
    ``make_serve_step`` calls (op by op) in the current fusion setting:
    tokens (row -> list), each step's top-2 logit gaps ((row, step) ->
    (gap, max |logit|)), the prefill step's seconds (Whisper's encoder
    included), decode ms/step, peak memory and the launches."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    prefill = make_prefill_step(cfg, s + n_tokens)
    serve_step = make_serve_step(cfg)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.monotonic()
        last, caches = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        logits, out = [], []
        for t in range(n_tokens):
            logits.append(last.float())
            tok = torch.argmax(last, dim=-1).to(torch.int32)
            out.append(tok)
            last, caches = serve_step(params, caches, tok[:, None], s + t)
        torch.cuda.synchronize()
        t2 = time.monotonic()
    toks = torch.stack(out, 1).cpu().numpy()
    gaps = {}
    for t, lg in enumerate(logits):
        top2 = torch.topk(lg, 2, dim=-1).values.cpu().numpy()
        scale = lg.abs().amax(-1).cpu().numpy()
        for r in range(b):
            gaps[(r, t)] = (float(top2[r, 0] - top2[r, 1]), float(scale[r]))
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all())
          and bool(torch.isfinite(last).all()),
          f"{cfg.name} lockstep steps: malformed tokens or logits")
    return {"request_tokens": {r: toks[r].tolist() for r in range(b)},
            "gaps": gaps, "prefill_step_s": t1 - t0,
            "decode_step_ms": 1e3 * (t2 - t1) / n_tokens,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts()}


def steps_three_ways(what: str, cfg, params, batch, n_tokens,
                     plain: bool) -> dict:
    """``lockstep_steps`` fused, unfused and (with ``plain``) with the
    plain versions forced; each other run's tokens equal the fused run's
    but at near-ties of its own logits."""
    runs = {}
    for mode, fused in (("fused", True), ("unfused", False)) + (
            (("plain", True),) if plain else ()):
        forced = (qops, pops, hops) if mode == "plain" else ()
        for ops in forced:
            ops.set_forced_path("ref")
        try:
            with qops.fusion(fused):
                runs[mode] = lockstep_steps(cfg, params, batch, n_tokens)
        finally:
            for ops in forced:
                ops.set_forced_path(None)
    base = runs["fused"]["request_tokens"]
    for mode, run in runs.items():
        run["divergences"] = tie_divergences(
            f"{what} {mode} against fused", base, run["request_tokens"],
            run.pop("gaps"))
        run["identical"] = len(base) - len(run["divergences"])
    unf, fus = runs["unfused"]["launches"], runs["fused"]["launches"]
    check(fus["rht_qmatmul"] > 0 and unf["rht"] > 0 and unf["qmatmul"] > 0
          and unf["rht_qmatmul"] == 0 and fus["paged_attention"] == 0
          and unf["paged_attention"] == 0,
          f"{what}: kernels fused {fus}, unfused {unf}")
    if plain:
        check(not any(runs["plain"]["launches"].values()),
              f"{what}: the plain run launched {runs['plain']['launches']}")
    return runs


def qwen2_vl_phase(dev) -> dict:
    """qwen2-vl-2b at its published width (d_model 1536, 12 heads over 2
    KV heads of 128, d_ff 8960, vocab 151936, mrope sections (16, 24,
    24)), at this run's depth (``qwen2_vl_config``): quantized (``family_quantize``, AVG_BITS), then
    the paged engine over 8 slots serves the churn workload by graph,
    eagerly (tokens and launches identical) and unfused by graph (tokens
    equal but at near-ties), each followed on the same engine by one
    request sharing 256 prompt tokens with request 1 (the prefix cache
    hits); a speculating run (k = SPEC_K, draft = target: every proposal
    accepted, W = SPEC_K + 1 verify steps) with the graph run's tokens but
    at near-ties; a decode step profiled by graph and eagerly; the
    lockstep ``BatchedServer`` by graph and eagerly against the paged
    engine; then ``make_prefill_step`` / ``make_serve_step`` on a
    (3, B, S) vision-grid batch, fused and unfused."""
    t_phase = time.monotonic()
    cfg = qwen2_vl_config()
    out, params = family_quantize(QWEN2_VL, dev, cfg=cfg)
    pool = llama2_pool()
    lens = PROMPT_LENS
    reqs = requests(cfg, lens)
    pair = Request(rid=len(lens), max_new=GEN_LEN, prompt=np.concatenate(
        [reqs[1].prompt[:256], np.random.default_rng(SEED + 5).integers(
            0, cfg.vocab, 64).astype(np.int32)]))
    PagedServer(cfg, params, pool, device=dev).run(   # warm-up, not counted
        [Request(rid=-1, prompt=np.arange(16, dtype=np.int32), max_new=2)])
    runs = {}
    for mode, fused, eager in (("graph", True, False), ("eager", True, True),
                               ("unfused", False, False)):
        zero_counts()
        with graphs.eager(eager):
            eng, res, wall = serve(cfg, params, dev, pool, fused=fused,
                                   prompt_lens=lens)
            summ = serve_summary(eng, res, wall, cfg, params, lens)
            summ["launches"] = counts()
            saved = eng.stats.get("prefill_tokens_saved", 0)
            res.update(eng.run([dataclasses.replace(pair)]))
            summ["pair_tokens_saved"] = (
                eng.stats.get("prefill_tokens_saved", 0) - saved)
        runs[mode] = (eng, res, summ)
    base = runs["graph"][1]
    for mode in ("graph", "eager", "unfused"):
        eng, res, summ = runs[mode]
        summ["divergences"] = divergences(base, res, eng)
        summ["identical"] = len(base) - len(summ["divergences"])
        check(summ["pair_tokens_saved"] >= 256,
              f"{QWEN2_VL} {mode}: the shared-prefix request saved "
              f"{summ['pair_tokens_saved']} prompt tokens, not 256")
        out[mode] = {k: summ[k] for k in (
            "decode_step_ms", "decode_step_bound_ms", "prefill_s",
            "prefill_chunk_ms", "wall_s", "tok_per_s", "decode_steps",
            "prefill_chunks", "captures", "capture_s", "graph_pool_mib",
            "peak_mem_gib", "launches", "gemm_launches", "identical",
            "divergences", "pair_tokens_saved")}
    graph, eager, unf = out["graph"], out["eager"], out["unfused"]
    check(eager["identical"] == len(base)
          and graph["launches"] == eager["launches"],
          f"{QWEN2_VL}: graph and eager differ: tokens {eager['identical']}/"
          f"{len(base)}, launches {graph['launches']} vs "
          f"{eager['launches']}")
    check(graph["captures"]["decode"] == 1
          and eager["captures"] == {"decode": 0, "chunk": 0},
          f"{QWEN2_VL}: captures graph {graph['captures']}, eager "
          f"{eager['captures']}")
    fused_l, unf_l = graph["launches"], unf["launches"]
    check(fused_l["rht_qmatmul"] > 0 and fused_l["paged_attention"] > 0
          and unf_l["rht"] > 0 and unf_l["qmatmul"] > 0
          and unf_l["rht_qmatmul"] == 0
          and fused_l["grouped_rht_qmatmul"] == 0
          and unf_l["grouped_qmatmul"] == 0,
          f"{QWEN2_VL}: kernels by run: fused {fused_l}, unfused {unf_l}")
    # speculation, draft = target: W = SPEC_K + 1 verify steps (R = 24)
    zero_counts()
    spec = GapRecordingServer(cfg, params, pool, draft_params=params,
                              speculate=SPEC_K, device=dev)
    t0 = time.monotonic()
    spec_res = spec.run(requests(cfg, lens))
    torch.cuda.synchronize()
    st = spec.stats
    want = {r: base[r].tokens.tolist() for r in range(len(lens))}
    out["speculation"] = {
        "wall_s": time.monotonic() - t0, "k": SPEC_K,
        "acceptance_rate": st["acceptance_rate"],
        "spec_rounds": st["spec_rounds"], "ms_per_round":
        1e3 * st["spec_s"] / st["spec_rounds"],
        "captures": dict(spec.graphs.captures), "launches": counts(),
        "divergences": tie_divergences(
            f"{QWEN2_VL} speculation against speculation off", want,
            token_lists(spec_res), runs["graph"][0].gaps)}
    check(st["spec_rounds"] > 0 and st["acceptance_rate"] > 0.9
          and out["speculation"]["launches"]["paged_attention"] > 0,
          f"{QWEN2_VL} speculation: {out['speculation']}")
    out["request_tokens"] = token_lists(base)
    del runs, spec, eng
    out["decode_profile"] = {"graph": profile_decode(cfg, params, dev, pool)}
    with graphs.eager():
        out["decode_profile"]["eager"] = profile_decode(cfg, params, dev,
                                                        pool)
    out["lockstep"] = lockstep_phase(
        "qwen2_vl", cfg, params, dev, True,
        modes={"graph": (True, False), "eager": (True, True)},
        n_prompts=FAMILY_LOCK, prompt_len=FAMILY_LOCK_PROMPT, pool=pool)
    rng = np.random.default_rng(SEED + 9)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (MROPE_BATCH, MROPE_PROMPT)).astype(np.int32)).to(dev),
        "positions": torch.from_numpy(grid_positions(
            MROPE_BATCH, MROPE_PROMPT)).to(dev)}
    out["mrope_steps"] = steps_three_ways(f"{QWEN2_VL} mrope steps", cfg,
                                          params, batch, GEN_LEN, False)
    prof = {m: {k: out["decode_profile"][m][k] for k in (
        "device_ms_per_step", "wall_ms_per_step", "idle_share",
        "launches_per_step")} for m in ("graph", "eager")}
    ms = out["mrope_steps"]
    out["phase_s"] = time.monotonic() - t_phase
    log(f"{QWEN2_VL} serve ({len(lens)} requests of {lens} prompt tokens "
        f"and one sharing 256 of request 1's, {GEN_LEN} new, 8 slots): "
        f"decode ms/step graph {graph['decode_step_ms']:.3f} / eager "
        f"{eager['decode_step_ms']:.3f} / unfused "
        f"{unf['decode_step_ms']:.3f} (bound "
        f"{graph['decode_step_bound_ms']:.3f}); prefill_s graph "
        f"{graph['prefill_s']:.3f} / eager {eager['prefill_s']:.3f}; tokens "
        f"identical graph / eager / unfused {graph['identical']} / "
        f"{eager['identical']} / {unf['identical']} of {len(base)}; prefix "
        f"pair saved {graph['pair_tokens_saved']} tokens; speculation "
        f"k={SPEC_K} acceptance {out['speculation']['acceptance_rate']:.3f},"
        f" {out['speculation']['ms_per_round']:.3f} ms/round, divergences "
        f"{len(out['speculation']['divergences'])}; peak "
        f"{graph['peak_mem_gib']:.2f} GiB; launches by graph {fused_l}; "
        f"decode profile {json.dumps(prof)}; mrope steps ({MROPE_BATCH} x "
        f"{MROPE_PROMPT}, a {GRID_SIDE}x{GRID_SIDE} grid): prefill step s "
        f"fused {ms['fused']['prefill_step_s']:.3f} / unfused "
        f"{ms['unfused']['prefill_step_s']:.3f}, decode ms/step "
        f"{ms['fused']['decode_step_ms']:.3f} / "
        f"{ms['unfused']['decode_step_ms']:.3f}, unfused tokens identical "
        f"{ms['unfused']['identical']} of {MROPE_BATCH}; "
        f"{out['phase_s']:.1f} s in all; {gpu_line()}")
    del params
    torch.cuda.empty_cache()
    return out


def whisper_phase(dev) -> dict:
    """whisper-large-v3 at its published width (``whisper_config``):
    seeded random (B, 1500, 1280) encoder frames stand in for the audio
    stub; calibrated on the zero-shot sentence with one clip's frames,
    quantized at AVG_BITS (encoder and decoder, the cross-attention
    included; code searches counted); then WHISPER_BATCH decoder prompts
    of WHISPER_PROMPT tokens, each over its own clip, through
    ``make_prefill_step`` (the encoder at B x 1500 rows, the cross K/V
    cached) and GEN_LEN greedy ``make_serve_step`` calls, fused, unfused
    and with the plain versions forced: tokens identical but at near-ties.
    No paged attention: Whisper's attention is plain torch, as the
    reference's is."""
    t_phase = time.monotonic()
    cfg = whisper_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    frames = torch.randn((WHISPER_BATCH, cfg.n_audio_ctx, cfg.d_model),
                         generator=gen, device=dev)
    out, params = family_quantize(WHISPER, dev, cfg=cfg,
                                  extra={"enc_embeds": frames[:1]})
    out["n_enc_layers"] = cfg.n_enc_layers
    enc_names = [n for n in out["per_layer_bits"] if n.startswith("enc")]
    check(len(enc_names) == 6 * cfg.n_enc_layers
          and len(out["per_layer_bits"]) == len(enc_names)
          + 10 * cfg.n_layers
          and list(out["per_layer_bits"])[-len(enc_names):] == enc_names,
          f"{WHISPER}: the allocation's entries are not the decoder's 10 a "
          f"layer and then the encoder's 6 a layer")
    rng = np.random.default_rng(SEED + 10)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT)).astype(np.int32)).to(
            dev), "enc_embeds": frames}
    out["steps"] = steps_three_ways(WHISPER, cfg, params, batch, GEN_LEN,
                                    True)
    out["phase_s"] = time.monotonic() - t_phase
    st = out["steps"]
    log(f"{WHISPER} steps ({cfg.n_layers} + {cfg.n_enc_layers} of 32 + 32 "
        f"layers; {WHISPER_BATCH} prompts of {WHISPER_PROMPT} tokens over "
        f"{cfg.n_audio_ctx} frames each, {GEN_LEN} new): prefill step s "
        + " / ".join(f"{m} {r['prefill_step_s']:.3f}" for m, r in st.items())
        + "; decode ms/step " + " / ".join(
            f"{m} {r['decode_step_ms']:.3f}" for m, r in st.items())
        + "; tokens identical to fused " + " / ".join(
            f"{m} {r['identical']}" for m, r in st.items())
        + f" of {WHISPER_BATCH}; peak {st['fused']['peak_mem_gib']:.2f} GiB;"
        f" launches fused {st['fused']['launches']}; {out['phase_s']:.1f} s "
        f"in all; {gpu_line()}")
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ training

TRAIN_ARCH = "qwen3-0.6b"
# qwen3-0.6b at its published width and depth (28 layers, 0.75 B fp32
# params: 12 GB with gradients and AdamW's moments; llama2-7b's 6.7 B would
# need 107 GB), trained from a seeded init on the synthetic corpus with the
# reference example's protocol (examples/train_and_quantize.py: lr 2e-3,
# warmup 20) at batch 8 x 256 tokens: TRAIN_STEPS with --train; the whole
# run cuts them to SMOKE_TRAIN_STEPS to keep to its 1050 s.  On an H100
# 80GB HBM3 at 700 W the two runs and their checkpoints took 182.6 s at
# 100 steps and 122.2 s at 60 (two 9 GB saves 44.0 s and a restore 15.9 s
# of it), and at 60 the whole script took 1123.2 s
TRAIN_STEPS = 100
SMOKE_TRAIN_STEPS = 30
# the whole run also cuts qwen3-0.6b to TRAIN_LAYERS of its 28 layers
# (published widths): at 28 its phase took 321.4 and 344.8 s of whole runs
# of 1225.6 and 1173.4 s on slow hosts (H100 80GB HBM3, 700 W), past or
# at the 1200 s limit; --train keeps all 28
TRAIN_LAYERS = 14
_TRAIN_DEPTH = [28]            # main() sets TRAIN_LAYERS for the whole run
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, TRAIN_WARMUP = 8, 256, 2e-3, 20
TRAIN_LOG = 10
# the fault-tolerant run checkpoints TRAIN_TAIL steps before its end,
# fails TRAIN_RETRIES + 1 times at the step after and is restored from it;
# keep=1, so at most that checkpoint and the one being written (9 GB each)
# sit in TRAIN_DIR
TRAIN_TAIL = 10
TRAIN_RETRIES = 2
TRAIN_DIR = ROOT / "build" / "train_ckpt"
# the last loss must be below this share of the first
TRAIN_DROP = 0.5
# the quantized model's perplexity may undercut the fp32 one by this share
# (a 4-bit model is not expected to beat its fp32 source; the gap is
# reported, not gated)
PPL_SLACK = 0.02
EVAL_BATCHES, EVAL_BATCH, CALIB_BATCHES = 4, 8, 5
TRAIN_PROMPT_LENS = [64, 128, 96, 200]
TRAIN_TABLE_BITS = (4.3, 3.3, 2.3)     # --train: the example's table


class TimedCheckpoints(CheckpointManager):
    """A ``CheckpointManager`` that records the seconds of each save (the
    device -> host copy, the write, fsync and rename) and restore, and
    holds a restore of step ``held`` against a device copy of what was
    saved there (``roundtrip``: every leaf equal, bit for bit)."""

    def __init__(self, *a, held: int, **kw):
        super().__init__(*a, **kw)
        self.held, self.copy, self.roundtrip = held, None, None
        self.saves: list = []
        self.restores: list = []

    def save(self, step, tree, extra=None):
        t0 = time.monotonic()
        super().save(step, tree, extra)
        self.saves.append({"step": step, "s": time.monotonic() - t0})
        if step == self.held:           # the train step updates in place
            self.copy = [t.clone() for t in ptree.leaves(tree)]

    def restore(self, step, like, placement_fn=None):
        t0 = time.monotonic()
        out = super().restore(step, like, placement_fn)
        torch.cuda.synchronize()
        self.restores.append({"step": step, "s": time.monotonic() - t0})
        if step == self.held and self.copy is not None:
            got = ptree.leaves(out[0])
            self.roundtrip = len(got) == len(self.copy) and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, self.copy))
            self.copy = None
        return out


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the training runs: the embedding's
    backward (an indexed accumulate) and the loss's gather backward use
    their sorted, atomic-free forms, so a replay can equal the first run
    bit for bit.  cuBLAS asks for a workspace setting, which PyTorch reads
    when a GEMM is called; the GEMMs run on one stream either way.  New
    tensors are not filled with NaN (a check for reads of uninitialised
    memory, not a part of determinism; it cost time on every step)."""
    import torch.utils.deterministic as det
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    fill = det.fill_uninitialized_memory
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = env or ":4096:8"
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def train_runs(cfg, dev, corpus, n_steps: int) -> tuple:
    """The uninterrupted run through ``launch.train.train`` and the
    fault-tolerant run through ``FaultTolerantLoop`` and a checkpoint
    manager, ``n_steps`` each; returns (summary, the trained params)."""
    steps_a = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with deterministic():
        _, params_a, losses_a = train(
            arch=TRAIN_ARCH, tiny=False, steps=n_steps,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
            warmup=TRAIN_WARMUP, seed=SEED, log_every=TRAIN_LOG,
            corpus=corpus, device=dev, depth=cfg.n_layers,
            on_step=lambda s, m, dt: steps_a.append(
                (float(m["grad_norm"]), float(m["lr"]), dt)))
    run_a_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in ptree.leaves(params_a))
    ms = [1e3 * dt for _, _, dt in steps_a[1:]]      # the first warms up
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop = train_step_flop(cfg)
    out = {"params": n_params, "steps": n_steps,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP, "losses": losses_a,
           "grad_norms": [g for g, _, _ in steps_a],
           "first_loss": losses_a[0], "last_loss": losses_a[-1],
           "first_step_ms": 1e3 * steps_a[0][2],
           "step_ms": ms, "step_ms_median": float(np.median(ms)),
           "step_ms_min": min(ms), "step_ms_max": max(ms),
           "tokens_per_s": tokens / (float(np.median(ms)) / 1e3),
           "peak_mem_gib": peak, "run_s": run_a_s,
           "tflop_per_step": flop / 1e12,
           "step_bound_ms": flop / RATES[SIMT] * 1e3,
           "bound_rate": SIMT}
    log(f"train {TRAIN_ARCH} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_params / 1e9:.4f} B fp32 params): {n_steps} "
        f"steps of {TRAIN_BATCH} x {TRAIN_SEQ}, loss {losses_a[0]:.4f} -> "
        f"{losses_a[-1]:.4f}; ms/step {spread(ms)} (first "
        f"{out['first_step_ms']:.1f}; bound {out['step_bound_ms']:.1f}: "
        f"{flop / 1e12:.2f} TFLOP at {SIMT}); {out['tokens_per_s']:.0f} "
        f"tokens/s; peak {peak:.2f} GiB; {run_a_s:.1f} s")
    check(np.isfinite(losses_a).all()
          and losses_a[-1] < TRAIN_DROP * losses_a[0],
          f"training did not learn: loss {losses_a[0]} -> {losses_a[-1]}")

    # the fault-tolerant run: the same init, loader and step as train()
    k = n_steps - TRAIN_TAIL
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    mgr = TimedCheckpoints(str(TRAIN_DIR), keep=1, held=k)
    step_fn = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                              total_steps=n_steps)
    loader = LMBatchLoader(corpus, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    fed, fails, losses_b = [], [], []

    def batches(step):
        b = loader_batch(loader, step)
        fed.append((step, zlib.crc32(b.tobytes())))
        return b

    def wrapped(state, batch_np):
        p, o = state
        p, o, m = step_fn(p, o, {"tokens": torch.from_numpy(batch_np).to(dev)})
        return (p, o), m

    def inject(step):
        if step == k + 1 and len(fails) <= TRAIN_RETRIES:
            fails.append(step)
            return True
        return False

    params_b = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    loop = FaultTolerantLoop(wrapped, mgr, LoopConfig(
        ckpt_every=k, max_retries=TRAIN_RETRIES),
        inject_failure=inject)
    t0 = time.monotonic()
    with deterministic():
        state, start = loop.maybe_resume((params_b, adamw_init(params_b)))
        check(start == 0, "the checkpoint directory was not empty")
        state = loop.run(state, batches, n_steps,
                         on_metrics=lambda s, m, dt: losses_b.append(
                             float(m["loss"])))
    run_b_s = time.monotonic() - t0
    replayed = [c for s, c in fed if s == k]
    # (the straggler watchdog may add a checkpoint after a slow streak)
    saved = [s["step"] for s in mgr.saves]
    check(len(fails) == TRAIN_RETRIES + 1 and loop.stats.restores == 1
          and [r["step"] for r in mgr.restores] == [k] and k in saved
          and saved[-1] == n_steps,
          f"the fault-tolerant run: failures {fails}, restores "
          f"{mgr.restores}, saves {mgr.saves}")
    check(len(replayed) == 2 and replayed[0] == replayed[1],
          "the restored run did not replay the checkpoint step's batch")
    same = losses_b == losses_a[:k + 1] + losses_a[k:]
    leaves_a, leaves_b = ptree.leaves(params_a), ptree.leaves(state[0])
    params_same = all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))
    roundtrip = mgr.roundtrip
    del params_a, leaves_a
    check(mgr.all_steps() == [n_steps], f"checkpoints left {mgr.all_steps()}")
    out["fault"] = {
        "ckpt_step": k, "failures_at": fails,
        "retries": loop.stats.retries, "restores": loop.stats.restores,
        "saves": mgr.saves, "restores_s": mgr.restores,
        "checkpoint_gb": os.path.getsize(mgr._path(n_steps)) / 1e9,
        "losses_after_restore": losses_b[k + 1:],
        "losses_identical": same, "params_identical": params_same,
        "roundtrip_identical": roundtrip,
        "deterministic_algorithms": True, "run_s": run_b_s,
        "straggler_events": loop.stats.straggler_events}
    log(f"train fault-tolerant run: checkpoint at step {k}, step {k + 1} "
        f"failed {len(fails)} times ({loop.stats.retries} retries), restored "
        f"from step {k} and replayed; {len(losses_b[k + 1:])} losses after "
        f"the restore identical to the uninterrupted run's: {same}; final "
        f"params identical: {params_same}; checkpoint {k} round trip identical: "
        f"{roundtrip}; saves (s) {[round(s['s'], 2) for s in mgr.saves]} of "
        f"{out['fault']['checkpoint_gb']:.2f} GB each, restores (s) "
        f"{[round(r['s'], 2) for r in mgr.restores]}; straggler events "
        f"{loop.stats.straggler_events}; {run_b_s:.1f} s")
    check(same and params_same and roundtrip,
          "the restored run's losses, params or checkpoint differ from the "
          "uninterrupted run's")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    params = state[0]
    del state, loop
    torch.cuda.empty_cache()
    return out, params


def train_step_flop(cfg) -> float:
    """A train step's f32 operations: the projections, lm_head and the
    plain attention's two (S x S) products (which compute every pair, the
    masked ones too), each 2 x in the forward, 2 x again for the remat's
    second forward and 4 x in the backward."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    per_layer = d * h * hd * 2 + 2 * d * kv * hd + 3 * d * cfg.d_ff
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gemm = 2 * tokens * (cfg.n_layers * per_layer + d * cfg.vocab)
    attn = 2 * 2 * TRAIN_BATCH * h * TRAIN_SEQ ** 2 * hd * cfg.n_layers
    # lm_head is outside the checkpointed layers: no second forward
    return 4 * (gemm + attn) - 2 * tokens * d * cfg.vocab


def perplexity(cfg, params, evals) -> float:
    with torch.no_grad():
        return float(np.exp(np.mean([
            float(tf.loss_fn(cfg, params, {"tokens": b})) for b in evals])))


def train_requests(cfg, corpus) -> list:
    """TRAIN_PROMPT_LENS prompts cut from the corpus at fixed offsets."""
    return [Request(rid=i, prompt=corpus[5000 * i: 5000 * i + n].copy(),
                    max_new=GEN_LEN)
            for i, n in enumerate(TRAIN_PROMPT_LENS)]


# -------------------------------------------------- Table 1's baselines

BASELINE_GROUP = 128      # Table 1: RTN, GPTQ and AWQ in groups of 128 rows
TABLE1_BITS = (2, 3, 4)   # --train: every method at each; the whole run 4
GPTQ_CHECK = ("L0.attn.wq", 4)     # the row loop's check: weight, bits


def uniform_avg_bits(qparams) -> float:
    """Code bits and side information over the weights of a uniform
    quantization, as ``QuantReport.avg_bits`` counts them."""
    qs = list(quantized_linears(qparams).values())
    m = sum(q.d * q.c * (q.packed.shape[0] if isinstance(q, QuantizedGrouped)
                         else 1) for q in qs)
    return sum(q.bits * q.d * q.c * (q.packed.shape[0] if isinstance(
        q, QuantizedGrouped) else 1) + q.overhead_bits() for q in qs) / m


def cusolver_factor(hessian, percdamp: float, dev) -> tuple:
    """GPTQ's (u, dead) as ``quant_baselines._gptq_factor_host`` takes it,
    but by ``torch.linalg`` in f64 on the card (cuSOLVER): what a card-side
    factor would give, for the card check's comparison only."""
    h = hessian.to(device=dev, dtype=torch.float64, copy=True)
    diag = torch.diagonal(h)
    dead = diag == 0
    diag.masked_fill_(dead, 1.0)
    diag.add_(percdamp * torch.mean(diag))
    return torch.linalg.cholesky(torch.linalg.inv(h)).mT.contiguous(), dead


def baseline_card_check(params, hess, norms, dev) -> dict:
    """RTN, AWQ and GPTQ on one full-width weight (GPTQ_CHECK) on the card
    and on the host, which must agree bit for bit: RTN's and AWQ's
    reconstructions (and AWQ's alpha), and GPTQ's row loop with the same
    (host LAPACK) factor, codes included, as ``gptq_quantize`` on the card.
    Then the factor's seconds on the host and by cuSOLVER on the card, and
    the codes that cuSOLVER's factor would move, counted."""
    name, bits = GPTQ_CHECK
    i, group, key = name.split(".")
    w = params["layers"][int(i[1:])][group][key]
    h, n = hess[name], norms[name]
    d, c = w.shape
    rtn = [qb.rtn_quantize(w, bits, BASELINE_GROUP, device=x)
           for x in (dev, "cpu")]
    awq = [qb.awq_quantize(w, n, bits, BASELINE_GROUP, device=x)
           for x in (dev, "cpu")]
    rtn_same = torch.equal(rtn[0][0].cpu(), rtn[1][0])
    awq_same = (torch.equal(awq[0][0].cpu(), awq[1][0])
                and awq[0][2] == awq[1][2])
    t0 = time.monotonic()
    u, dead = qb._gptq_factor_host(h, 0.01)
    host_factor_s = time.monotonic() - t0
    w0 = w.detach().clone()
    w0[dead.to(dev)] = 0.0

    def rows(w_in, u_in):
        codes = torch.empty((d, c), dtype=torch.uint8, device=w_in.device)
        t0 = time.monotonic()
        out = qb._gptq_rows(w_in, u_in, bits, BASELINE_GROUP, codes=codes)
        if w_in.is_cuda:
            torch.cuda.synchronize()
        return out, codes, time.monotonic() - t0
    card, card_codes, card_s = rows(w0.clone(), u.to(dev))
    host, host_codes, host_s = rows(w0.cpu(), u)
    same = (torch.equal(card.cpu(), host)
            and torch.equal(card_codes.cpu(), host_codes))
    port, _ = qb.gptq_quantize(w, h, bits, BASELINE_GROUP, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    u_dev, dead_dev = cusolver_factor(h, 0.01, dev)
    torch.cuda.synchronize()
    card_factor_s = time.monotonic() - t0
    own, own_codes, _ = rows(w0.clone(), u_dev)
    code_diff = (own_codes.cpu().to(torch.int16) - host_codes.to(torch.int16))
    out = {"weight": name, "d": d, "c": c, "bits": bits,
           "rtn_identical": rtn_same, "awq_identical": awq_same,
           "awq_alpha": awq[0][2], "dead_inputs": int(dead.sum()),
           "card_s": card_s, "host_s": host_s, "identical": same,
           "host_factor_s": host_factor_s, "cusolver_factor_s": card_factor_s,
           "cusolver_u_rel_diff": float((u_dev.cpu() - u).abs().max()
                                        / u.abs().max()),
           "cusolver_codes_differ": int((code_diff != 0).sum()),
           "cusolver_max_code_diff": int(code_diff.abs().max()),
           "cusolver_entries_differ": int((own.cpu() != host).sum()),
           "codes": d * c}
    log(f"train baselines card vs host, {name} ({d} x {c}, {bits} bits, "
        f"group {BASELINE_GROUP}): RTN identical {rtn_same}, AWQ identical "
        f"{awq_same} (alpha {awq[0][2]}); GPTQ's row loop ("
        f"{out['dead_inputs']} dead inputs) card {card_s:.2f} s vs host "
        f"{host_s:.2f} s with the same factor, identical (reconstruction and "
        f"codes): {same}; the factor {host_factor_s:.3f} s on the host, "
        f"{card_factor_s:.3f} s by cuSOLVER (max |u - u_host| / max |u_host| "
        f"{out['cusolver_u_rel_diff']:.2e}), whose factor would move "
        f"{out['cusolver_codes_differ']} of {d * c} codes (by at most "
        f"{out['cusolver_max_code_diff']}) and "
        f"{out['cusolver_entries_differ']} entries")
    check(rtn_same and awq_same,
          f"RTN or AWQ on the card differs from the host ({name})")
    check(same, f"GPTQ's row loop on the card differs from the host's with "
          f"the same factor ({name})")
    check(torch.equal(dead_dev.cpu(), dead) and torch.equal(port, card),
          f"gptq_quantize on the card is not its row loop with the host's "
          f"factor ({name})")
    return out


def baselines_phase(cfg, params, calib, evals, dev, extra) -> tuple:
    """Table 1's protocol on the trained model: the layer Hessians and
    input norms of the calibration batches (``collect_hessians``), then
    RTN, GPTQ and AWQ in groups of BASELINE_GROUP (``apply_baseline``) and
    uniform RaanA (``quantize_params_uniform``, its code searches counted
    from zero) at 4 bits, or at each of TABLE1_BITS with ``extra``: each
    one's average bits, seconds and perplexity; then the card against the
    host (``baseline_card_check``).  Returns (summary, {"uniform": the 4-bit uniform params,
    "gptq": GPTQ's 4-bit reconstruction}) for serving."""
    t0 = time.monotonic()
    hess, norms = bapply.collect_hessians(cfg, params, calib, device=dev)
    torch.cuda.synchronize()
    out = {"collect_s": time.monotonic() - t0, "hessians": len(hess),
           "group": BASELINE_GROUP, "rows": {}}
    keep = {}
    for bits in (TABLE1_BITS if extra else (4,)):
        for method in bapply.METHODS:
            qp, avg, secs = bapply.apply_baseline(
                cfg, params, method, bits, hessians=hess, x_col_norms=norms,
                group=BASELINE_GROUP, device=dev)
            row = {"avg_bits": avg, "s": secs,
                   "ppl": perplexity(cfg, qp, evals)}
            out["rows"][f"{method} {bits}"] = row
            if (method, bits) == ("gptq", 4):
                keep["gptq"] = qp
            del qp
            log(f"train {method.upper()} {bits} bits (group "
                f"{BASELINE_GROUP}): avg_bits {avg:.4f}, {secs:.2f} s, ppl "
                f"{row['ppl']:.4f}")
            check(np.isfinite(row["ppl"]),
                  f"{method} {bits}-bit perplexity is not finite")
        zero_counts()
        t1 = time.monotonic()
        qp = pipe.quantize_params_uniform(
            cfg, params, bits, device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 2))
        torch.cuda.synchronize()
        row = {"avg_bits": uniform_avg_bits(qp), "s": time.monotonic() - t1,
               "code_search_launches": counts()["rabitq_quant"],
               "ppl": perplexity(cfg, qp, evals)}
        out["rows"][f"uniform {bits}"] = row
        log(f"train uniform RaanA {bits} bits ({UNIFORM_N_CAND} candidates):"
            f" avg_bits {row['avg_bits']:.4f}, {row['s']:.2f} s, code-search "
            f"launches {row['code_search_launches']}, ppl {row['ppl']:.4f}")
        check(row["code_search_launches"] == 6 * cfg.n_layers
              and np.isfinite(row["ppl"]),
              f"uniform {bits} bits: {row['code_search_launches']} code "
              f"searches, perplexity {row['ppl']}")
        if bits == 4:
            keep["uniform"] = qp
        del qp
    out["card_check"] = baseline_card_check(params, hess, norms, dev)
    del hess, norms
    torch.cuda.empty_cache()
    return out, keep


def table1(out: dict) -> dict:
    """Table 1's rows of a train phase: fp32, RaanA at AVG_BITS (and at
    TRAIN_TABLE_BITS with --train), uniform RaanA and the baselines: each
    one's average bits and perplexity."""
    q = out["quantize"]
    rows = {"fp32": {"avg_bits": 32.0, "ppl": q["fp32_ppl"]},
            f"RaanA {AVG_BITS}": {"avg_bits": q["avg_bits"],
                                  "ppl": q["quantized_ppl"]}}
    rows.update({f"RaanA {bits}": {"avg_bits": r["avg_bits"], "ppl": r["ppl"]}
                 for bits, r in out.get("ppl_table", {}).items()})
    rows.update({name: {"avg_bits": r["avg_bits"], "ppl": r["ppl"]}
                 for name, r in out["baselines"]["rows"].items()})
    return rows


def serve_twice(cfg, params, dev, pool, reqs, quantized=True) -> tuple:
    """``reqs`` served by graph (every count zeroed just before) and then by
    eager kernels: (the graph run's summary with its launches and the eager
    decode ms/step, graph results, eager results, the eager engine)."""
    zero_counts()
    eng, res, wall = spec_serve(cfg, params, dev, pool, reqs=reqs)
    summ = serve_summary(eng, res, wall, cfg, params, TRAIN_PROMPT_LENS,
                         quantized=quantized)
    summ["launches"] = counts()
    del eng
    with graphs.eager():
        eng_e, res_e, _ = spec_serve(cfg, params, dev, pool, reqs=reqs)
    summ["eager_decode_step_ms"] = (1e3 * eng_e.stats["decode_s"]
                                    / eng_e.stats["decode_steps"])
    summ["request_tokens"] = token_lists(res)
    return summ, res, res_e, eng_e


def train_phase(dev, extra: bool = False) -> dict:
    """qwen3-0.6b at its published width and depth: trained (``train_runs``:
    an uninterrupted run, then a fault-tolerant one restored from a
    checkpoint, which must replay the same losses bit for bit), quantized
    at AVG_BITS (calibrated on CALIB_BATCHES loader batches of 1 x 257,
    AllocateBits, the code-search kernel, counted), its fp32 and quantized
    perplexity over EVAL_BATCHES batches of EVAL_BATCH, then the quantized
    model served by graph (counted from zero: the ``qwen3_trained`` path)
    and by eager kernels, tokens identical but at near-ties; Table 1's
    protocol (``baselines_phase``) at 4 bits, and its uniform RaanA and
    GPTQ models served by graph (counted from zero: ``qwen3_uniform``,
    ``qwen3_gptq``) and eagerly, tokens identical.  ``extra``
    (``--train``): also the example's table (TRAIN_TABLE_BITS), Table 1 at
    TABLE1_BITS, a DRAFT_BITS draft from ``quantize_model_dual``
    speculating SPEC_K deep, tokens identical to spec off, its acceptance
    on trained weights, and TRAIN_STEPS of training where the whole run
    takes SMOKE_TRAIN_STEPS."""
    cfg = get_config(TRAIN_ARCH).with_(n_layers=_TRAIN_DEPTH[0])
    phase_s = {}
    t0 = time.monotonic()
    corpus = make_corpus_tokens(cfg.vocab, 20000, seed=SEED)
    out, params = train_runs(cfg, dev, corpus,
                             TRAIN_STEPS if extra else SMOKE_TRAIN_STEPS)
    phase_s["train"] = time.monotonic() - t0

    t0 = time.monotonic()
    # the example's evaluation: a 30000-sentence corpus, eval windows of
    # batch 8, calibration on the first row of the next 5 batches
    eval_corpus = make_corpus_tokens(cfg.vocab, 30000, seed=SEED)
    loader = LMBatchLoader(eval_corpus, EVAL_BATCH, TRAIN_SEQ)
    evals = [torch.from_numpy(b).to(dev)
             for b in loader.eval_batches(EVAL_BATCHES)]
    calib = [{"tokens": torch.from_numpy(loader.next_batch()[:1]).to(dev)}
             for _ in range(CALIB_BATCHES)]
    fp_ppl = perplexity(cfg, params, evals)
    zero_counts()
    t1 = time.monotonic()
    stats = cal.calibrate(lambda p, b, ctx: tf.loss_fn(cfg, p, b, ctx=ctx),
                          params, calib)
    torch.cuda.synchronize()
    calibrate_s = time.monotonic() - t1

    def quantize(bits):
        return pipe.quantize_model(
            cfg, params, stats, bits, device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    qparams, rep = quantize(AVG_BITS)
    searches = counts()["rabitq_quant"]
    q_ppl = perplexity(cfg, qparams, evals)
    hist = collections.Counter(rep.per_layer_bits.values())
    out["quantize"] = {
        "avg_bits": rep.avg_bits, "requested_avg_bits": AVG_BITS,
        "n_layers": rep.n_layers, "calibrate_s": calibrate_s,
        "allocate_s": rep.allocate_s, "quantize_s": rep.quantize_s,
        "bits_histogram": {str(b): hist[b] for b in sorted(hist)},
        "code_search_launches": searches, "fp32_ppl": fp_ppl,
        "quantized_ppl": q_ppl, "ppl_gap": q_ppl - fp_ppl,
        "ppl_gap_rel": q_ppl / fp_ppl - 1}
    log(f"train quantize ({AVG_BITS} bits): calibrated on {CALIB_BATCHES} "
        f"batches of 1 x {TRAIN_SEQ + 1} in {calibrate_s:.2f} s, allocate_s "
        f"{rep.allocate_s:.2f}, quantize_s {rep.quantize_s:.2f}; achieved "
        f"{rep.avg_bits:.4f} bits, widths {out['quantize']['bits_histogram']}"
        f"; code-search launches {searches}; perplexity over {EVAL_BATCHES} "
        f"x {EVAL_BATCH} x {TRAIN_SEQ}: fp32 {fp_ppl:.4f}, {AVG_BITS}-bit "
        f"{q_ppl:.4f} (gap {q_ppl - fp_ppl:+.4f}, "
        f"{100 * (q_ppl / fp_ppl - 1):+.2f}%)")
    check(searches == rep.n_layers == 6 * cfg.n_layers
          and AVG_BITS - 0.5 < rep.avg_bits <= AVG_BITS,
          f"{TRAIN_ARCH}: {rep.n_layers} weights, {searches} code searches, "
          f"{rep.avg_bits} bits")
    check(np.isfinite(q_ppl) and q_ppl >= fp_ppl * (1 - PPL_SLACK),
          f"quantized perplexity {q_ppl} against fp32 {fp_ppl}")
    if extra:
        table = {}
        for bits in TRAIN_TABLE_BITS:
            qp, r = quantize(bits)
            h = collections.Counter(r.per_layer_bits.values())
            table[str(bits)] = {"avg_bits": r.avg_bits,
                                "ppl": perplexity(cfg, qp, evals),
                                "allocation": {str(b): h[b] for b in sorted(h)},
                                "allocate_s": r.allocate_s}
            log(f"train RaanA {bits} bits (achieved {r.avg_bits:.4f}): ppl "
                f"{table[str(bits)]['ppl']:.4f} against fp32 {fp_ppl:.4f}; "
                f"allocation {table[str(bits)]['allocation']}")
            check(np.isfinite(table[str(bits)]["ppl"]),
                  f"{bits}-bit perplexity is not finite")
            del qp
        out["ppl_table"] = table
        target, trep, draft, drep = pipe.quantize_model_dual(
            cfg, params, stats, AVG_BITS, DRAFT_BITS, device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        out["dual"] = {"target_bits": trep.avg_bits,
                       "draft_bits": drep.avg_bits,
                       "draft_ppl": perplexity(cfg, draft, evals)}
    del stats
    phase_s["quantize"] = time.monotonic() - t0

    t0 = time.monotonic()
    out["baselines"], baseline_models = baselines_phase(
        cfg, params, calib, evals, dev, extra)
    out["table1"] = table1(out)
    log(f"train Table 1 ({TRAIN_ARCH}, perplexity over {EVAL_BATCHES} x "
        f"{EVAL_BATCH} x {TRAIN_SEQ}): " + "; ".join(
            f"{k} {r['ppl']:.4f} ({r['avg_bits']:.4f} bits)"
            for k, r in out["table1"].items()))
    del params
    torch.cuda.empty_cache()
    phase_s["baselines"] = time.monotonic() - t0

    t0 = time.monotonic()
    pool = PoolConfig(max_slots=4, block_size=16,
                      max_context=max(TRAIN_PROMPT_LENS) + GEN_LEN,
                      prefill_chunk=64)
    reqs = train_requests(cfg, eval_corpus)
    summ, res, res_e, eng_e = serve_twice(cfg, qparams, dev, pool, reqs)
    summ["divergences"] = divergences(res, res_e, eng_e)
    text = ByteTokenizer(cfg.vocab)
    summ["samples"] = {rid: {"prompt_tail": text.decode(r.prompt[-48:]),
                             "continuation": text.decode(res[rid].tokens)}
                       for rid, r in enumerate(reqs)}
    launched = {k: v for k, v in summ["launches"].items() if v}
    log(f"train serve ({AVG_BITS}-bit trained {TRAIN_ARCH}, "
        f"{len(reqs)} corpus prompts of {TRAIN_PROMPT_LENS}, {GEN_LEN} new): "
        f"by graph decode {summ['decode_step_ms']:.3f} ms/step, prefill_s "
        f"{summ['prefill_s']:.4f}, eager decode "
        f"{summ['eager_decode_step_ms']:.3f} ms/step; tokens identical "
        f"graph / eager {len(reqs) - len(summ['divergences'])} of "
        f"{len(reqs)}; launches by graph {launched}")
    log(f"train sample: ...{summ['samples'][0]['prompt_tail']!r} -> "
        f"{summ['samples'][0]['continuation']!r}")
    check(summ["launches"]["rht_qmatmul"] > 0
          and summ["launches"]["paged_attention"] > 0,
          f"the trained model's serve run missed a kernel: {launched}")
    out["serve"] = summ
    del eng_e
    if extra:
        zero_counts()
        eng, off, _ = spec_serve(cfg, target, dev, pool, reqs=reqs)
        del eng
        eng, on, wall = spec_serve(cfg, target, dev, pool, draft=draft,
                                   reqs=reqs)
        spec = spec_summary(eng, on, wall, len(reqs))
        same_as("trained spec on vs off", token_lists(off), token_lists(on))
        out["dual"].update({k: spec[k] for k in (
            "acceptance_rate", "spec_rounds", "spec_proposed",
            "spec_accepted", "tokens_per_round", "ms_per_round",
            "ms_per_emitted_token")})
        log(f"train speculation (target {trep.avg_bits:.4f} bits, draft "
            f"{drep.avg_bits:.4f} bits, draft ppl "
            f"{out['dual']['draft_ppl']:.4f}, k {SPEC_K}): acceptance_rate "
            f"{spec['acceptance_rate']:.4f} ({spec['spec_accepted']} / "
            f"{spec['spec_proposed']}), {spec['tokens_per_round']:.3f} "
            f"tokens a round, {spec['ms_per_round']:.2f} ms a round; tokens "
            f"identical to spec off {len(reqs)} of {len(reqs)}")
        del eng, target, draft
    del qparams
    torch.cuda.empty_cache()
    phase_s["serve"] = time.monotonic() - t0

    # the uniform RaanA model (rows 5, 1, 2) and GPTQ's reconstruction
    # (full-precision weights: row 2 only)
    t0 = time.monotonic()
    served = {}
    for path, key, quantized in (("qwen3_uniform", "uniform", True),
                                 ("qwen3_gptq", "gptq", False)):
        summ, res, res_e, _ = serve_twice(
            cfg, baseline_models.pop(key), dev, pool, reqs, quantized)
        same_as(f"{path} graph vs eager", token_lists(res),
                token_lists(res_e))
        served[path] = summ
        launched = {k: v for k, v in summ["launches"].items() if v}
        log(f"train serve {path} ({len(reqs)} corpus prompts, {GEN_LEN} "
            f"new): by graph decode {summ['decode_step_ms']:.3f} ms/step, "
            f"prefill_s {summ['prefill_s']:.4f}, eager decode "
            f"{summ['eager_decode_step_ms']:.3f} ms/step; tokens identical "
            f"graph / eager {len(reqs)} of {len(reqs)}; launches by graph "
            f"{launched}")
    out["baselines"]["serve"] = served
    torch.cuda.empty_cache()
    phase_s["baselines_serve"] = time.monotonic() - t0
    out["phase_s"] = phase_s
    log(f"train phase seconds: {json.dumps(phase_s)}")
    return out


def train_main(dev, smi) -> int:
    """``--train``: build every kernel, then ``train_phase`` with the
    example's table of perplexities, Table 1 at TABLE1_BITS and the
    trained draft's acceptance.
    Prints one JSON line (also ``chiprun_out/chip_smoke_train.json``), the
    nvidia-smi line and the contract's last line."""
    _build.build()
    out = {"gpu": smi, "train": train_phase(dev, extra=True),
           "seconds": time.monotonic() - T_START}
    (OUT_DIR / "chip_smoke_train.json").write_text(json.dumps(out, indent=1))
    log(json.dumps(compact(out)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------- the gather, the front door, lockstep


def gather_phase(dev, params, draft, serve_out) -> dict:
    """The dense gather behind ``PagedServer(paged_kernel=False)`` (the
    CLI's ``--no-paged-kernel``) on llama2-7b over phase 5's requests: by
    graph and eagerly (graph = eager exactly, the same launches, no
    paged-attention launch), tokens equal phase 5's kernel run by graph but
    at near-ties, a decode profile beside the kernel's; then one run
    speculating SPEC_K deep from the DRAFT_BITS draft, whose verify steps
    take the gather branch, tokens equal to the spec-off gather run."""
    cfg = llama2_config()
    pool = llama2_pool()
    runs = {}
    for mode in ("graph", "eager"):
        zero_counts()
        with graphs.eager(mode == "eager"):
            eng, res, wall = serve(cfg, params, dev, pool, paged_kernel=False)
        summ = serve_summary(eng, res, wall, cfg, params)
        summ.update(launches=counts(), request_tokens=token_lists(res))
        runs[mode] = (eng, summ)
    (graph_eng, out), (_, eager) = runs["graph"], runs["eager"]
    same_as("gather eager against gather by graph", out["request_tokens"],
            eager["request_tokens"])
    check(out["launches"] == eager["launches"]
          and out["launches"]["paged_attention"] == 0
          and out["launches"]["rht_qmatmul"] > 0,
          f"gather launches: graph {out['launches']}, eager "
          f"{eager['launches']}")
    check(out["captures"] == {"decode": 1, "chunk": chunk_captures(
        pool, PROMPT_LENS)} and eager["captures"] == {"decode": 0,
                                                      "chunk": 0},
          f"gather captures: graph {out['captures']}, eager "
          f"{eager['captures']}")
    out["divergences"] = tie_divergences(
        "gather against the kernel", serve_out["request_tokens"],
        out["request_tokens"], graph_eng.gaps)
    del graph_eng, runs
    out["eager"] = {k: eager[k] for k in ("decode_step_ms", "prefill_s",
                                          "wall_s", "launches")}
    out["decode_profile"] = profile_decode(cfg, params, dev, pool,
                                           paged_kernel=False)
    kernel_ms = float(np.median(serve_out["repeats"]["decode_step_ms"]))
    out["kernel"] = {
        "decode_step_ms": kernel_ms,
        "device_ms_per_step": serve_out["decode_profile"][
            "device_ms_per_step"],
        "eager_decode_step_ms": float(np.median(
            serve_out["eager"]["repeats"]["decode_step_ms"]))}

    zero_counts()
    eng, res, wall = spec_serve(cfg, params, dev, pool, draft,
                                paged_kernel=False)
    spec = spec_summary(eng, res, wall, len(PROMPT_LENS))
    del eng
    same_as("gather spec against gather spec off", out["request_tokens"],
            token_lists(res))
    check(spec["launches"]["paged_attention"] == 0
          and spec["captures"].get("verify") == 1,
          f"gather spec: launches {spec['launches']}, captures "
          f"{spec['captures']}")
    out["spec"] = {k: spec[k] for k in (
        "acceptance_rate", "spec_rounds", "ms_per_round",
        "ms_per_emitted_token", "tokens_per_round", "captures", "launches")}
    prof = out["decode_profile"]
    log(f"llama2 gather (paged_kernel=False): decode ms/step "
        f"{out['decode_step_ms']:.3f} by graph, {eager['decode_step_ms']:.3f} "
        f"eager (kernel: {kernel_ms:.3f}, eager "
        f"{out['kernel']['eager_decode_step_ms']:.3f}); device ms/step "
        f"{prof['device_ms_per_step']} (kernel "
        f"{out['kernel']['device_ms_per_step']}); prefill_s "
        f"{out['prefill_s']:.4f}; tokens identical to the kernel run for "
        f"{len(PROMPT_LENS) - len(out['divergences'])}/{len(PROMPT_LENS)} "
        f"(near-tie divergences {out['divergences']}); graph = eager; "
        f"launches {out['launches']}; speculating (k {SPEC_K}): "
        f"acceptance_rate {spec['acceptance_rate']:.4f}, "
        f"{spec['ms_per_round']:.3f} ms/round, tokens = spec off; "
        f"{gpu_line()}")
    return out


# the front door's traffic: tenant, weight, priority by client parity, and
# the one urgent request that arrives once every slot is busy
FD_TENANTS = (("a", 2.0, 0), ("b", 1.0, 1))
FD_URGENT = ("a", 2.0, 2)
FD_DRIVER = "frontdoor-driver"


class DriverServer(GapRecordingServer):
    """A ``GapRecordingServer`` that records the thread making each capture
    and, with CUDA events around each step's replay, the device time of the
    engine's steps (``device_s``; the idle share of a window is the rest of
    it; a replay is one launch, so the events bracket device work)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.capture_threads: dict = {}
        self.step_events: list = []

    def _compiled(self, key, inert):
        if key not in self.graphs.steps and not graphs.eager_enabled():
            self.capture_threads[key] = threading.current_thread().name
        step = super()._compiled(key, inert)
        events = self.step_events

        def timed(inputs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(inputs)
            end.record()
            events.append((start, end))
            return out
        return timed

    def device_s(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.step_events) / 1e3


def fd_prompts(cfg, k: int) -> list:
    """Pass ``k``'s 17 prompts: PROMPT_LENS twice and the urgent request's
    128 tokens (last), fresh for each pass, so no pass hits another's
    blocks in the prefix cache."""
    rng = np.random.default_rng(SEED + 9 + k)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in PROMPT_LENS * 2 + [128]]


def fd_client(port: int, i: int, prompt, tenant: str, weight: float,
              priority: int, record: dict) -> None:
    """One streaming client: the events of its request with their seconds
    since it sent it (or the exception it met) go to ``record[i]``."""
    t0 = time.monotonic()
    try:
        record[i] = [(time.monotonic() - t0, event, data)
                     for event, data in stream_generate(
                         "127.0.0.1", port, tokens=prompt.tolist(),
                         max_new=GEN_LEN, tenant=tenant, priority=priority,
                         weight=weight, timeout=600.0)]
    except Exception as exc:                              # noqa: BLE001
        record[i] = exc


def http_get(port: int, path: str) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def percentiles(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)), "n": int(v.size)}


def frontdoor_pass(engine, sched: SchedConfig, prompts) -> dict:
    """One pass of the front door's traffic over ``engine`` (a
    ``DriverServer``): a ``FrontDoor`` on port 0 served on a thread of this
    process, a streaming client (a thread) for each prompt but the last,
    the last (urgent) one once every slot is busy, /healthz and /v1/stats,
    then a clean stop."""
    engine.stats, engine.gaps, engine.step_events = {}, {}, []
    engine.decode_gaps.clear()
    engine.start_clock(reset=True)
    door = FrontDoor(engine, sched, port=0)
    failures = []

    def serve_():
        try:
            door.serve_forever()
        except BaseException as exc:                      # noqa: BLE001
            failures.append(repr(exc))
    server = threading.Thread(target=serve_, name="frontdoor-server")
    server.start()
    check(door.ready.wait(60), "the front door did not start listening")
    record: dict = {}
    *streams, urgent = prompts
    clients = [threading.Thread(target=fd_client, args=(
        door.port, i, p, *FD_TENANTS[i % 2], record))
        for i, p in enumerate(streams)]
    t0 = time.monotonic()
    for c in clients:
        c.start()
    deadline = time.monotonic() + 120
    while engine.free_slots and time.monotonic() < deadline:
        time.sleep(0.001)
    slots_busy = not engine.free_slots
    late = threading.Thread(target=fd_client, args=(
        door.port, len(streams), urgent, *FD_URGENT, record))
    late.start()
    for c in clients + [late]:
        c.join(600)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    health, stats_body = http_get(door.port, "/healthz"), http_get(
        door.port, "/v1/stats")
    sched_stats = dict(door.scheduler.stats)
    door.stop()
    server.join(120)
    check(not server.is_alive() and not failures and door.failure is None,
          f"the front door did not stop cleanly: {failures}")
    check(slots_busy, "the slots never filled before the urgent request")
    check(health[0] == 200 and stats_body[0] == 200,
          f"/healthz {health[0]}, /v1/stats {stats_body[0]}")
    stats = json.loads(stats_body[1])
    check({"engine", "scheduler", "queued"} <= set(stats),
          f"/v1/stats: {sorted(stats)}")
    bad = {i: r for i, r in record.items() if not isinstance(r, list)}
    check(len(record) == len(prompts) and not bad, f"clients failed: {bad}")
    return {"record": record, "wall_s": wall, "sched": sched_stats,
            "device_s": engine.device_s(), "stats": stats,
            "engine_stats": dict(engine.stats), "gaps": dict(engine.gaps)}


def fd_streams(what: str, out: dict, want: list) -> dict:
    """Check one pass's streams against ``want`` (the tokens of each
    prompt, the urgent one last): each stream's token events are its done
    event's tokens, no error event, tokens equal ``want`` but at a near-tie
    of the front door's engine, a replayed request exactly equal; returns
    its client-side latencies and counts."""
    ttft, itl, preempted = [], [], []
    got_by_rid, want_by_rid = {}, {}
    for i, events in out["record"].items():
        kinds = [e for _, e, _ in events]
        check("error" not in kinds and kinds.count("done") == 1
              and kinds[-1] == "done", f"{what}: client {i} events {kinds}")
        done = events[-1][2]
        toks = [d["token"] for _, e, d in events if e == "token"]
        times = [t for t, e, _ in events if e == "token"]
        check(done["n_tokens"] == len(toks) == GEN_LEN
              and done["tokens"] == toks,
              f"{what}: client {i} streamed {len(toks)} tokens, done says "
              f"{done['n_tokens']}")
        ttft.append(times[0])
        itl.extend(np.diff(times).tolist())
        got_by_rid[done["rid"]], want_by_rid[done["rid"]] = toks, want[i]
        if done["preemptions"]:
            preempted.append(i)
            check(toks == want[i], f"{what}: the replayed client {i}'s "
                  f"tokens differ from the uninterrupted run's")
    divs = tie_divergences(f"{what} against PagedServer.run", want_by_rid,
                           got_by_rid, out["gaps"])
    st = out["engine_stats"]
    gaps = st.get("decode_gap_s", [])
    res = {"ttft_s": percentiles(ttft), "inter_token_s": percentiles(itl),
           "engine_decode_gap_s": percentiles(gaps) if gaps else None,
           "decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"],
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"], "wall_s": out["wall_s"],
           "preempted_clients": preempted, "divergences": divs,
           "scheduler": out["sched"],
           "idle_share": (1 - out["device_s"] / out["wall_s"]
                          if out["device_s"] else None)}
    check(out["sched"].get("preempted", 0) >= 1 and preempted,
          f"{what}: no request was preempted ({out['sched']})")
    return res


def run_summary(engine, wall: float) -> dict:
    """A ``DriverServer`` window's decode ms/step and device idle share."""
    st = engine.stats
    return {"decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"],
            "decode_steps": st["decode_steps"],
            "prefill_chunks": st["prefill_chunks"], "wall_s": wall,
            "idle_share": 1 - engine.device_s() / wall}


def frontdoor_phase(dev, params) -> dict:
    """The streaming front door over llama2-7b's engine (8 slots, block 16,
    chunk 64, f32 KV), two passes of the same traffic on fresh prompts: 16
    concurrent streaming clients, two tenants of weights 2:1 at priorities
    0 and 1, 32 new tokens each, and a priority-2 request once every slot
    is busy, which must preempt one.  Pass 2 sets the SLO controller's
    target at half pass 1's median decode gap, and must throttle prefill.
    Both passes run on one engine, whose captures are all made in the
    driver thread.  Each stream's tokens are held to ``PagedServer.run``'s
    of the same pass's prompts on an identically configured engine, whose
    decode ms/step and idle share stand beside the front door's (device
    time from CUDA events around each step's replay)."""
    cfg = llama2_config()
    pool = llama2_pool()
    prompts = {k: fd_prompts(cfg, k) for k in (1, 2)}
    ref = DriverServer(cfg, params, pool, device=dev)
    want, out = {}, {}
    for k in (1, 2):
        ref.stats, ref.step_events = {}, []
        t0 = time.monotonic()
        res = ref.run([Request(rid=i, prompt=p, max_new=GEN_LEN)
                       for i, p in enumerate(prompts[k])])
        torch.cuda.synchronize()
        out[f"run{k}"] = run_summary(ref, time.monotonic() - t0)
        want[k] = [[int(t) for t in res[i].tokens]
                   for i in range(len(prompts[k]))]
    del ref, res

    engine = DriverServer(cfg, params, pool, device=dev)
    zero_counts()
    first = frontdoor_pass(engine, SchedConfig(), prompts[1])
    out["launches"] = counts()
    out["pass1"] = fd_streams("front door pass 1", first, want[1])
    target = 0.5e3 * out["pass1"]["engine_decode_gap_s"]["p50"]
    second = frontdoor_pass(engine, SchedConfig(slo_p95_ms=target),
                            prompts[2])
    out["pass2"] = fd_streams("front door pass 2", second, want[2])
    out["pass2"]["slo_p95_ms"] = target
    check(out["pass2"]["scheduler"].get("slo_throttled_ticks", 0) >= 1,
          f"pass 2 never throttled prefill: {out['pass2']['scheduler']}")
    out["captures"] = dict(engine.graphs.captures)
    out["capture_threads"] = sorted(set(engine.capture_threads.values()))
    check(engine.decode_trace_count == 1
          and out["capture_threads"] == [FD_DRIVER],
          f"front door captures {out['captures']} made in "
          f"{out['capture_threads']}")
    check(out["launches"]["paged_attention"] > 0
          and out["launches"]["rht_qmatmul"] > 0,
          f"front door launches {out['launches']}")

    def lat(k):
        p, r = out[f"pass{k}"], out[f"run{k}"]
        return (f"TTFT p50/p95 {p['ttft_s']['p50']:.4f}/"
                f"{p['ttft_s']['p95']:.4f} s, inter-token p50/p95 "
                f"{p['inter_token_s']['p50'] * 1e3:.3f}/"
                f"{p['inter_token_s']['p95'] * 1e3:.3f} ms, engine decode "
                f"{p['decode_step_ms']:.3f} ms/step over {p['decode_steps']}"
                f" steps, idle share {p['idle_share']:.4f}, preempted "
                f"clients {p['preempted_clients']} (run's: "
                f"{r['decode_step_ms']:.3f} ms/step over {r['decode_steps']}"
                f" steps, idle share {r['idle_share']:.4f})")
    log(f"front door (llama2, 17 streams over 8 slots, 2 tenants 2:1, one "
        f"urgent): pass 1 {lat(1)}; pass 2 (SLO {target:.3f} ms, "
        f"{out['pass2']['scheduler'].get('slo_throttled_ticks')} throttled "
        f"ticks) {lat(2)}; near-tie divergences "
        f"{[out[f'pass{k}']['divergences'] for k in (1, 2)]}; captures "
        f"{out['captures']} in {out['capture_threads']}; launches (pass 1) "
        f"{out['launches']}; {gpu_line()}")
    return out


LOCKSTEP_PROMPT = 256
LOCKSTEP_REQUESTS = 8
LOCKSTEP_MODES = {  # mode -> (fused, eager)
    "llama2": {"graph": (True, False), "eager": (True, True),
               "unfused": (False, False)},
    "mixtral": {"graph": (True, False), "eager": (True, True)}}


def lockstep_phase(name, cfg, params, dev, paged: bool, modes=None,
                   n_prompts=LOCKSTEP_REQUESTS, prompt_len=LOCKSTEP_PROMPT,
                   pool=None) -> dict:
    """``BatchedServer`` (aligned prefill, lockstep decode) over
    ``n_prompts`` random prompts of ``prompt_len`` tokens, GEN_LEN new
    each, in each of ``modes`` (default LOCKSTEP_MODES[name]): two calls
    per mode (the first counted from zero, capturing; the second timed,
    tokens equal).  Graph = eager exactly, no paged-attention launch; with
    ``paged``, the paged engine (``pool``, default llama2's) serves the
    same prompts and the lockstep tokens equal its tokens but at near-ties
    (of the paged run's logits).  Both runs count their MoE capacity drops
    (``moe.count_overflow``): a batch prefilled whole and one in chunks
    drop different tokens, so a model whose runs dropped any may differ
    at a drop as well (listed, not checked)."""
    prompts = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (n_prompts, prompt_len)).astype(np.int32)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    out = {}
    for mode, (fused, eager) in (modes or LOCKSTEP_MODES[name]).items():
        zero_counts()
        with graphs.eager(eager), moemod.count_overflow(dropped):
            server = BatchedServer(cfg, params,
                                   max_context=prompt_len + GEN_LEN,
                                   fused=fused, device=dev)
            torch.cuda.reset_peak_memory_stats()
            first = server.generate(prompts, GEN_LEN)
            launches = counts()
            again = server.generate(prompts, GEN_LEN)
        st = server.stats
        check(first.shape == (n_prompts, GEN_LEN)
              and bool(((first >= 0) & (first < cfg.vocab)).all())
              and np.array_equal(first, again),
              f"lockstep {name} {mode}: malformed or unrepeatable tokens")
        check(launches["paged_attention"] == 0,
              f"lockstep {name} {mode} launched paged attention: {launches}")
        out[mode] = {"request_tokens": first.tolist(), "launches": launches,
                     "prefill_s": st["prefill_s"],
                     "decode_step_ms": 1e3 * st["decode_s"]
                     / st["decode_steps"],
                     "captures": server.decode_trace_count,
                     "capture_s": server.graphs.capture_s,
                     "peak_mem_gib": torch.cuda.max_memory_allocated()
                     / 2**30}
        del server
    graph, eager = out["graph"], out["eager"]
    check(graph["request_tokens"] == eager["request_tokens"]
          and graph["launches"] == eager["launches"],
          f"lockstep {name}: graph and eager differ in tokens or launches")
    check(graph["captures"] == 1 and eager["captures"] == 0,
          f"lockstep {name}: captures graph {graph['captures']}, eager "
          f"{eager['captures']}")
    if "unfused" in out:
        unf = out["unfused"]["launches"]
        check(unf["rht"] > 0 and unf["qmatmul"] > 0
              and unf["rht_qmatmul"] == 0,
              f"lockstep {name} unfused launches {unf}")
        out["unfused"]["identical_to_fused"] = (
            out["unfused"]["request_tokens"] == graph["request_tokens"])
    lock_drops = int(dropped)
    if paged:
        zero_counts()
        dropped.zero_()
        with moemod.count_overflow(dropped):
            eng = GapRecordingServer(cfg, params, pool or llama2_pool(),
                                     device=dev)
            t0 = time.monotonic()
            res = eng.run([Request(rid=i, prompt=p, max_new=GEN_LEN)
                           for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
        st = eng.stats
        out["paged"] = {"prefill_s": st["prefill_s"],
                        "decode_step_ms": 1e3 * st["decode_s"]
                        / st["decode_steps"],
                        "decode_steps": st["decode_steps"],
                        "wall_s": time.monotonic() - t0,
                        "moe_drops": {"lockstep": lock_drops,
                                      "paged": int(dropped)}}
        want = dict(enumerate(graph["request_tokens"]))
        got = token_lists(res)
        if lock_drops or int(dropped):
            out["paged"]["differing"] = [r for r in want if want[r] != got[r]]
            out["paged"]["identical"] = len(want) - len(
                out["paged"]["differing"])
        else:
            out["paged"]["divergences"] = tie_divergences(
                f"lockstep {name} against the paged engine", want, got,
                eng.gaps)
            out["paged"]["identical"] = len(want) - len(
                out["paged"]["divergences"])
        del eng
    log(f"lockstep {name} ({n_prompts} x {prompt_len} prompt "
        f"tokens, {GEN_LEN} new): " + "; ".join(
            f"{mode} prefill_s {r['prefill_s']:.4f}, decode "
            f"{r['decode_step_ms']:.3f} ms/step"
            for mode, r in out.items())
        + f"; graph = eager; launches {graph['launches']}"
        + (f"; paged: {json.dumps(out['paged'])}" if paged else "")
        + f"; {gpu_line()}")
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
            ("llama2", quantize_phase, lambda: llama2_config(),
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


def tp_main(dev, smi) -> int:
    """``--tp``: build every kernel, quantize llama2-7b with its
    DRAFT_BITS draft (without the plain code-search comparison), serve the
    churn workload by graph fused and unfused (the tokens TP=2 is held
    to), then
    ``tp_phase``, at the whole run's depth (LLAMA2_LAYERS).  Prints one
    JSON line (also ``chiprun_out/chip_smoke_tp.json``)."""
    _LLAMA2_DEPTH[0] = LLAMA2_LAYERS
    _build.build()
    quant, qparams, draft = quantize_phase(dev, compare=False,
                                           draft_bits=DRAFT_BITS)
    _, res, _ = serve(llama2_config(), qparams, dev, llama2_pool())
    _, unf, _ = serve(llama2_config(), qparams, dev, llama2_pool(),
                      fused=False)
    t0 = time.monotonic()
    out = {"gpu": smi, "quantize": quant,
           "tp": tp_phase(dev, qparams, draft, {
               "request_tokens": token_lists(res),
               "unfused": {"request_tokens": token_lists(unf)}})}
    out["tp_s"] = time.monotonic() - t0
    (OUT_DIR / "chip_smoke_tp.json").write_text(json.dumps(out, indent=1))
    log(json.dumps(compact(out)))
    log(smi)
    return 0


# ---------------------------------------------------------------- dry-run

# the dry-run's cells on the card (fake CUDA tensors, mesh 32x8): arch,
# shape, --quant
DRYRUN_CELLS = [("llama2-7b", "decode_32k", None),
                ("llama2-7b", "decode_32k", 4),
                ("mixtral-8x7b", "prefill_32k", 4),
                ("rwkv6-3b", "long_500k", 4),
                ("deepseek-v2-236b", "decode_32k", 4)]
DRYRUN_MEM = 64 * 2 ** 20       # what the fake cells may add to CUDA memory
# the kernels' bounds as PERF.md section 6 printed them (the formulas this
# script held before they moved into the wrappers' cost(...)): kernel, cost
# keywords, the printed bound in ms
PERF6_BOUNDS = [
    *[("rht_qmatmul", dict(n=n, d=d, c=c, bits=4), v) for n, d, c, v in (
        (1, 4083, 4096, "0.0025"), (8, 4083, 4096, "0.0026"),
        (8, 4083, 22016, "0.0137"), (8, 10974, 4096, "0.0069"),
        (64, 4083, 4096, "0.0065"), (16, 4083, 4096, "0.0027"),
        (32, 4083, 4096, "0.0033"), (2048, 4083, 4096, "0.2081"),
        (8, 1531, 1536, "0.00038"), (8, 1531, 256, "0.00008"),
        (8, 8933, 1536, "0.00217"), (4, 1276, 1280, "0.00026"),
        (6000, 1276, 1280, "0.0598"), (6000, 5104, 1280, "0.2396"))],
    *[("qmatmul", dict(n=n, d=d, c=c, bits=4), v) for n, d, c, v in (
        (1, 4083, 4096, "0.0025"), (8, 4083, 4096, "0.0026"),
        (8, 1531, 1536, "0.00038"), (8, 1531, 256, "0.00008"),
        (8, 8933, 1536, "0.00215"), (4, 1276, 1280, "0.00026"),
        (6000, 1276, 1280, "0.0595"), (6000, 5104, 1280, "0.2378"))],
    *[("rht", dict(n=n, d=d), v) for n, d, v in (
        (8, 4083, "0.00008"), (8, 10974, "0.00023"), (16, 4096, "0.00016"),
        (160, 4096, "0.0016"), (16, 14336, "0.00057"),
        (160, 14336, "0.0055"), (8, 1531, "0.00003"), (8, 8933, "0.00019"),
        (4, 1276, "0.00001"), (6000, 1276, "0.0183"),
        (6000, 5104, "0.0731"))],
    *[("rabitq_quant", dict(d=d, c=c, n_cand=s), v) for d, c, s, v in (
        (4083, 4096, 12, "0.0644"), (4083, 22016, 12, "0.346"),
        (10974, 4096, 12, "0.173"), (1024, 2048, 8, "0.00557"),
        (3072, 1024, 8, "0.00836"))],
    *[("grouped_rht_qmatmul", dict(n=cap, d=d, c=c, bits=4, groups=e), v)
      for e, cap, d, c, v in (
          (8, 2, 4096, 28672, "0.141"), (8, 2, 14336, 4096, "0.0705"),
          (160, 6, 5120, 3072, "0.3853"), (160, 6, 1536, 5120, "0.1959"))],
    # every request of the llama2 and qwen2-vl cases at context 1024: 64
    # blocks of 16 keys each
    *[("paged_attention", dict(b=8, w=1, h=h, kv=kv, hd=128, keys=8 * 1024,
                               elem_bytes=e, table=8 * 64), v)
      for h, kv, e, v in ((32, 32, 4, "0.0802"), (32, 32, 2, "0.0401"),
                          (12, 2, 4, "0.00504"), (12, 2, 2, "0.00253"))],
    *[("flash_attention", dict(b=1, sq=s, sk=s, h=32, kv=kv, hd=128,
                               causal=True, window=w, elem_bytes=e), v)
      for s, kv, w, e, v in ((4608, 8, 4096, 4, "1.041"),
                             (2048, 32, None, 4, "0.208"),
                             (2048, 32, None, 2, "0.0348"))],
]


def bound_column_check() -> dict:
    """Each PERF6_BOUNDS entry from its wrapper's ``cost(...)``: equal to
    the printed bound to the printed digits."""
    worst, bad = 0.0, []
    for kernel, shape, printed in PERF6_BOUNDS:
        got = cost_bound(kernels.kernel_cost(kernel, **shape))["bound_ms"]
        digits = len(printed.split(".")[1])
        off = abs(got - float(printed)) / (0.5 * 10 ** -digits)
        worst = max(worst, off)
        if off > 1 + 1e-9:
            bad.append((kernel, shape, printed, got))
    return {"entries": len(PERF6_BOUNDS), "disagree": bad,
            "worst_half_ulps": worst}


def fake_copy(node, mode):
    """``node`` with every tensor replaced by a fake one of its shape,
    dtype and device (dataclasses rebuilt field by field)."""
    if isinstance(node, torch.Tensor):
        return mode.from_tensor(node)
    if isinstance(node, dict):
        return {k: fake_copy(v, mode) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(fake_copy(v, mode) for v in node)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: fake_copy(getattr(node, f.name), mode)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
    return node


def counted_decode_step(cfg, params, dev) -> dict:
    """One paged decode step of ``params`` (8 slots at contexts 130-151,
    the kernels launching) under the cost counter, and the same step on
    fake CUDA tensors of the same shapes: flops, bytes and per-kernel
    credits must agree."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    pool = llama2_pool()
    b, bs = pool.max_slots, pool.block_size
    mb = -(-pool.max_context // bs)
    caches = init_pool_caches(cfg, pool, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    args = (torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.arange(130, 130 + 3 * b, 3, dtype=torch.int32, device=dev),
            torch.ones(b, dtype=torch.bool, device=dev),
            torch.arange(1, 1 + b * mb, dtype=torch.int32,
                         device=dev).reshape(b, mb),
            torch.full((b,), mb * bs, dtype=torch.int32, device=dev))
    before = kernels.launch_counts()
    with torch.no_grad(), hlocost.CostCounter() as real:
        decmod.decode_step_paged(cfg, params, caches, *args)
    torch.cuda.synchronize()
    launched = kernels.launches_since(before)
    with FakeTensorMode() as mode, torch.no_grad():
        fparams, fcaches, fargs = fake_copy((params, caches, args), mode)
        with hlocost.CostCounter() as fake:
            decmod.decode_step_paged(cfg, fparams, fcaches, *fargs)
    del caches
    tokens = float(args[1].sum())
    return {"real": real.totals(), "fake": fake.totals(),
            "launched": {k: n for k, n in launched.items() if n},
            "tokens_in_arena": tokens,
            "bytes_over_hbm_ms": real.bytes / roofline.HBM_BW * 1e3,
            "flops_over_peak_ms": real.flops / roofline.PEAK_FLOPS * 1e3,
            "decode_step_bound_ms": decode_step_bound_ms(cfg, params,
                                                         tokens)}


def dryrun_phase(dev, params, serve_out) -> dict:
    """(a) ``launch/dryrun.py``'s cells DRYRUN_CELLS on fake CUDA tensors
    on mesh 32x8, records in chiprun_out/dryrun/ (CUDA memory may grow by
    less than DRYRUN_MEM); (b) phase 4's quantized llama2 counted for one
    paged decode step with kernels 1 and 2 launching, equal to the same
    step on fake tensors, its bytes over the HBM rate beside
    ``decode_step_bound_ms`` and phase 5's graph ms a step; (c) the
    wrappers' ``cost(...)`` against PERF.md section 6's bound column."""
    t0 = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cells = []
    for arch, shape, quant in DRYRUN_CELLS:
        rec = dryrunmod.run_cell(arch, shape, quant=quant, force=True,
                                 device=dev, art_dir=str(OUT_DIR / "dryrun"))
        check(rec["status"] == "ok", f"dry-run {arch} {shape} q{quant}: "
              f"{rec.get('error')}")
        rl = roofline.analyze(rec, get_config(arch))
        row = {"arch": arch, "shape": shape, "quant": quant,
               "batch": rec["batch"], "flops": rec["flops"],
               "bytes": rec["hlo_bytes"], "coll_bytes": rec["coll_bytes"],
               "argument_gib": rec["memory"]["argument"] / 2 ** 30,
               "argument_specs_gib": rec["argument_specs"] / 2 ** 30,
               "peak_gib": rec["memory"]["peak"] / 2 ** 30,
               "fits_80gb": rec["fits"], "dominant": rl.dominant,
               "roofline_frac": rl.roofline_frac,
               "t_ms": {"compute": rl.t_compute * 1e3,
                        "memory": rl.t_memory * 1e3,
                        "collective": rl.t_collective * 1e3},
               "build_s": rec["build_s"], "count_s": rec["count_s"]}
        cells.append(row)
        log(f"dryrun {arch} {shape} q{quant}: flops {row['flops']:.4e} "
            f"bytes {row['bytes']:.4e} coll {row['coll_bytes']:.4e}; "
            f"argument {row['argument_gib']:.2f} GiB/chip (GSPMD rules "
            f"{row['argument_specs_gib']:.2f}), peak {row['peak_gib']:.2f} "
            f"GiB, fits 80 GB: {row['fits_80gb']}; {rl.dominant}-bound, "
            f"roofline fraction {rl.roofline_frac:.4f}; build "
            f"{row['build_s']} s, count {row['count_s']} s")
    grew = torch.cuda.max_memory_allocated(dev) - base
    check(grew < DRYRUN_MEM, f"the fake dry-run cells grew CUDA memory by "
          f"{grew} bytes (limit {DRYRUN_MEM})")
    cells_s = time.monotonic() - t0
    step = counted_decode_step(llama2_config(), params, dev)
    real, fake = step["real"], step["fake"]
    check(all(step["launched"].get(k) for k in ("rht_qmatmul",
                                                "paged_attention")),
          f"the counted step did not launch kernels 1 and 2: "
          f"{step['launched']}")
    check(real == fake, f"the counted step differs real / fake: {real} / "
          f"{fake}")
    graph_ms = float(np.median(serve_out["repeats"]["decode_step_ms"]))
    log(f"dryrun counted decode step (llama2-7b, {llama2_config().n_layers} "
        f"layers, 8 slots): flops {real['flops']:.4e}, bytes "
        f"{real['bytes']:.4e} = {step['bytes_over_hbm_ms']:.4f} ms at "
        f"{roofline.HBM_BW:.3g} B/s, beside decode_step_bound_ms "
        f"{step['decode_step_bound_ms']:.4f} and phase 5's graph "
        f"{graph_ms:.3f} ms a step (share {step['bytes_over_hbm_ms'] / graph_ms:.3f}); "
        f"credits {json.dumps(real['kernel_credits'])}; real = fake")
    col = bound_column_check()
    check(not col["disagree"], f"cost(...) against PERF.md's bound column: "
          f"{col['disagree']}")
    log(f"dryrun bound column: {col['entries']} kernel shapes agree with "
        f"PERF.md section 6 to the printed digits (worst "
        f"{col['worst_half_ulps']:.3f} half-units of the last digit)")
    out = {"cells": cells, "cuda_memory_growth_bytes": int(grew),
           "cells_s": cells_s, "counted_step": step,
           "graph_decode_step_ms": graph_ms, "bound_column": col,
           "seconds": time.monotonic() - t0}
    log(f"dryrun phase: {out['seconds']:.1f} s (cells {cells_s:.1f} s)")
    return out


def dryrun_main(dev, smi) -> int:
    """``--dryrun``: build every kernel, quantize llama2-7b at the whole
    run's depth (without the plain comparison), serve it (phase 5), then
    ``dryrun_phase``.  Prints one JSON line (also
    ``chiprun_out/chip_smoke_dryrun.json``)."""
    _LLAMA2_DEPTH[0] = LLAMA2_LAYERS
    _build.build()
    _, qparams, _ = quantize_phase(dev, compare=False)
    serve_out = serve_phase(dev, qparams)
    out = {"gpu": smi, "dryrun": dryrun_phase(dev, qparams, serve_out)}
    (OUT_DIR / "chip_smoke_dryrun.json").write_text(json.dumps(out, indent=1))
    log(json.dumps(compact(out)))
    log(smi)
    return 0


def ptxas_lines(logs: dict) -> dict:
    """Each source's ptxas register and spill lines from its build log."""
    return {name: [ln.strip() for ln in lg.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, lg in logs.items()}


def families_main(dev, smi) -> int:
    """``--families``: build every kernel and run only the three family
    phases (``families_phase``); prints each phase's seconds and one JSON
    line (also written to ``chiprun_out/chip_smoke_families.json``)."""
    out = {"gpu": smi, "ptxas": ptxas_lines(_build.build()),
           "families": families_phase(dev)}
    (OUT_DIR / "chip_smoke_families.json").write_text(
        json.dumps(out, indent=1))
    log("phase seconds: " + json.dumps(
        {a: r["phase_s"] for a, r in out["families"].items()}))
    log(json.dumps(compact(out)))
    return 0


def mrope_whisper_main(dev, smi) -> int:
    """``--mrope-whisper``: build every kernel and run only the qwen2-vl
    and Whisper phases, both at full depth (qwen2-vl-2b 28 layers,
    whisper-large-v3 32 + 32); prints each phase's seconds and one JSON
    line (also ``chiprun_out/chip_smoke_mrope_whisper.json``)."""
    out = {"gpu": smi, "ptxas": ptxas_lines(_build.build()),
           "qwen2_vl": qwen2_vl_phase(dev), "whisper": whisper_phase(dev)}
    (OUT_DIR / "chip_smoke_mrope_whisper.json").write_text(
        json.dumps(out, indent=1))
    log("phase seconds: " + json.dumps(
        {k: out[k]["phase_s"] for k in ("qwen2_vl", "whisper")}))
    log(json.dumps(compact(out)))
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
    cfg = llama2_config()
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


def frontdoor_main(dev, smi) -> int:
    """``--frontdoor``: build every kernel, quantize llama2-7b with its
    DRAFT_BITS draft as the full run does (without the plain code-search
    comparison), serve phase 5's requests once by graph on the kernel (the
    tokens and numbers the gather is held to, a decode profile), then
    ``gather_phase``, ``frontdoor_phase`` and ``lockstep_phase`` for llama2;
    then Mixtral's quantization and its ``lockstep_phase``.  Prints one
    JSON line (also ``chiprun_out/chip_smoke_frontdoor.json``)."""
    _build.build()
    cfg = llama2_config()
    pool = llama2_pool()
    quant, qparams, draft = quantize_phase(dev, compare=False,
                                           draft_bits=DRAFT_BITS)
    zero_counts()
    eng, res, wall = serve(cfg, qparams, dev, pool)
    kernel = serve_summary(eng, res, wall, cfg, qparams)
    del eng
    with graphs.eager():
        eng, _, _ = serve(cfg, qparams, dev, pool)
    kernel.update(request_tokens=token_lists(res),
                  repeats={"decode_step_ms": [kernel["decode_step_ms"]]},
                  eager={"repeats": {"decode_step_ms": [
                      1e3 * eng.stats["decode_s"]
                      / eng.stats["decode_steps"]]}},
                  decode_profile=profile_decode(cfg, qparams, dev, pool))
    del eng
    out = {"gpu": smi, "quantize": quant, "phase_s": {}}
    for name, fn, args in (
            ("gather", gather_phase, (dev, qparams, draft, kernel)),
            ("frontdoor", frontdoor_phase, (dev, qparams)),
            ("lockstep_llama2", lockstep_phase,
             ("llama2", cfg, qparams, dev, True))):
        t0 = time.monotonic()
        out[name] = fn(*args)
        out["phase_s"][name] = time.monotonic() - t0
    del qparams, draft
    torch.cuda.empty_cache()
    _, moe_params, _ = moe_quantize_phase(dev, compare=False)
    t0 = time.monotonic()
    out["lockstep_mixtral"] = lockstep_phase("mixtral", moe_config(),
                                             moe_params, dev, False)
    out["phase_s"]["lockstep_mixtral"] = time.monotonic() - t0
    out["seconds"] = time.monotonic() - T_START
    (OUT_DIR / "chip_smoke_frontdoor.json").write_text(
        json.dumps(out, indent=1))
    log(json.dumps(compact(out)))
    return 0


def compact(node):
    """``node`` without its token lists, per-step lists and profiles (for
    a line short enough for the end of the output)."""
    if isinstance(node, dict):
        return {k: compact(v) for k, v in node.items() if k not in (
            "request_tokens", "per_step", "round_profile", "decode_profile",
            "prefill_profile", "per_layer_bits", "losses", "grad_norms",
            "step_ms", "samples")}
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
    if sys.argv[1:] == ["--frontdoor"]:
        return frontdoor_main(dev, smi)
    if sys.argv[1:] == ["--train"]:
        return train_main(dev, smi)
    if sys.argv[1:] == ["--families"]:
        return families_main(dev, smi)
    if sys.argv[1:] == ["--mrope-whisper"]:
        return mrope_whisper_main(dev, smi)
    if sys.argv[1:] == ["--tp"]:
        return tp_main(dev, smi)
    if sys.argv[1:] == ["--dryrun"]:
        return dryrun_main(dev, smi)
    if modes:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    _LLAMA2_DEPTH[0] = LLAMA2_LAYERS
    _WHISPER_DEPTH[0] = WHISPER_LAYERS
    _QWEN2_VL_DEPTH[0] = QWEN2_VL_LAYERS
    _TRAIN_DEPTH[0] = TRAIN_LAYERS
    t_build = time.monotonic()
    logs = _build.build()
    build_s = time.monotonic() - t_build
    log(f"build: {build_s:.1f} s ({len(logs)} sources)")
    regs = ptxas_lines(logs)
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
    uniform_search_times = [time_code_search(gen, dev, d, c,
                                             n_cand=UNIFORM_N_CAND)
                            for d, c in UNIFORM_SEARCH_TIMED]
    mw_times = [time_gemm(gen, dev, n, d, c, 4)
                for n, d, c in MROPE_WHISPER_TIMED]
    mw_unfused_times = [time_gemm(gen, dev, n, d, c, 4, fused=False)
                        for n, d, c in MROPE_WHISPER_TIMED]
    for name, rows in (("rht_qmatmul", gemm_times + mw_times),
                       ("qmatmul", unfused_times + mw_unfused_times),
                       ("rht", rht_times),
                       ("rabitq_quant", search_times + uniform_search_times)):
        for t in rows:
            log(f"{name} time {json.dumps(t)}")
    attn_times = time_attentions(gen, dev)
    attn_time = attn_times[0]            # llama2's shape, f32
    grouped_check = check_grouped(gen, dev)
    grouped_err, grouped_unfused_err = (grouped_check["fused"],
                                        grouped_check["unfused"])
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

    phase_s = {"kernels": time.monotonic() - T_START}

    def timed(name, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        phase_s[name] = time.monotonic() - t0
        return out

    quant_out, qparams, draft = timed("quantize", quantize_phase, dev, True,
                                      DRAFT_BITS)
    serve_out = timed("serve", serve_phase, dev, qparams)
    dryrun_out = timed("dryrun", dryrun_phase, dev, qparams, serve_out)
    tp_out = timed("tp", tp_phase, dev, qparams, draft, serve_out)
    prefix_out = timed("prefix", prefix_phase, dev, qparams)
    spec_out = timed("speculation", spec_phase, dev, qparams, draft,
                     serve_out["request_tokens"],
                     prefix_out["on"]["request_tokens"],
                     float(np.median(serve_out["repeats"]["decode_step_ms"])),
                     serve_out["peak_mem_gib"])
    gather_out = timed("gather", gather_phase, dev, qparams, draft,
                       serve_out)
    frontdoor_out = timed("frontdoor", frontdoor_phase, dev, qparams)
    lockstep_out = timed("lockstep_llama2", lockstep_phase, "llama2",
                         llama2_config(), qparams, dev, True)
    del qparams, draft
    torch.cuda.empty_cache()
    moe_quant, moe_params, moe_draft = timed(
        "mixtral_quantize", moe_quantize_phase, dev, True, DRAFT_BITS)
    moe_serve = timed("mixtral_serve", moe_serve_phase, dev, moe_params)
    moe_spec = timed("mixtral_speculation", moe_spec_phase, dev, moe_params,
                     moe_draft, moe_serve["request_tokens"])
    moe_lockstep = timed("lockstep_mixtral", lockstep_phase, "mixtral",
                         moe_config(), moe_params, dev, False)
    del moe_params, moe_draft
    torch.cuda.empty_cache()
    family_out = {}
    for arch in FAMILY_ARCHS:
        family_out[arch] = timed(FAMILY_PATH[arch], family_phase, arch, dev)
    qwen2_vl_out = timed("qwen2_vl", qwen2_vl_phase, dev)
    whisper_out = timed("whisper", whisper_phase, dev)
    dense_out = timed("dense", dense_phase, dev)
    train_out = timed("train", train_phase, dev)
    log(f"phase seconds: {json.dumps(phase_s)}")

    # launches per path, each from that path's own run with every count
    # zeroed just before it: the quantize run (the code search), the fused
    # serve run, the unfused serve run (the RHT and the unfused GEMMs);
    # the prefix path is the shared-prefix workload with the cache on, by
    # graph (it reuses llama2's quantization and runs fused only); the
    # speculation paths are the first graph run with the DRAFT_BITS draft
    # (llama2, Mixtral; their quantizations are counted with the targets')
    # and the bf16-arena path llama2's spec-off graph run; the gather path
    # is llama2's paged_kernel=False run by graph, the front door its first
    # pass, the lockstep paths each mode's first call; the TP paths are the
    # TP=2 runs at shard widths, fused and unfused (llama2_tp) and
    # speculating (llama2_tp_spec), each run's launches on both ranks; each
    # dense config counts its own quantization, fused and unfused runs
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
            "llama2_tp": {"quantize": 0,
                          "fused": tp_out["runs"]["fused"]["launches"],
                          "unfused": tp_out["runs"]["unfused"]["launches"]},
            "llama2_tp_spec": {"quantize": 0,
                               "fused": tp_out["runs"]["spec"]["launches"],
                               "unfused": none},
            "llama2_bf16": {"quantize": 0,
                            "fused": spec_out["bf16"]["off graph"][
                                "launches"], "unfused": none},
            "mixtral_spec": {"quantize": 0, "fused": moe_spec["launches"],
                             "unfused": none},
            "llama2_gather": {"quantize": 0, "fused": gather_out["launches"],
                              "unfused": none},
            "frontdoor": {"quantize": 0, "fused": frontdoor_out["launches"],
                          "unfused": none},
            "lockstep_llama2": {"quantize": 0,
                                "fused": lockstep_out["graph"]["launches"],
                                "unfused": none},
            "lockstep_llama2_unfused": {
                "quantize": 0, "fused": none,
                "unfused": lockstep_out["unfused"]["launches"]},
            "lockstep_mixtral": {"quantize": 0,
                                 "fused": moe_lockstep["graph"]["launches"],
                                 "unfused": none}}
    runs.update({arch: {"quantize": row["code_search_launches"],
                        "fused": row["graph"]["launches"],
                        "unfused": row["unfused"]["launches"]}
                 for arch, row in dense_out.items()})
    # the families: each one's quantization, its fused (graph) and unfused
    # serve runs, and its lockstep graph run
    for arch, row in family_out.items():
        path = FAMILY_PATH[arch]
        runs[path] = {"quantize": row["code_search_launches"],
                      "fused": row["graph"]["launches"],
                      "unfused": row["unfused"]["launches"]}
        runs[f"lockstep_{path}"] = {
            "quantize": 0, "fused": row["lockstep"]["graph"]["launches"],
            "unfused": none}
    families = tuple(FAMILY_PATH.values())
    # qwen2-vl: its quantization, its graph and unfused serve runs and its
    # lockstep graph run; Whisper: its quantization and its fused and
    # unfused lockstep-step runs
    runs["qwen2_vl"] = {"quantize": qwen2_vl_out["code_search_launches"],
                        "fused": qwen2_vl_out["graph"]["launches"],
                        "unfused": qwen2_vl_out["unfused"]["launches"]}
    runs["qwen2_vl_lockstep"] = {
        "quantize": 0, "fused": qwen2_vl_out["lockstep"]["graph"]["launches"],
        "unfused": none}
    runs["whisper"] = {"quantize": whisper_out["code_search_launches"],
                       "fused": whisper_out["steps"]["fused"]["launches"],
                       "unfused": whisper_out["steps"]["unfused"]["launches"]}
    mw = ("qwen2_vl", "whisper")
    # the trained qwen3-0.6b: its quantization and its graph serve run; the
    # uniform RaanA model's quantization (4 bits) and graph serve run, and
    # GPTQ's reconstruction's graph serve run
    runs["qwen3_trained"] = {
        "quantize": train_out["quantize"]["code_search_launches"],
        "fused": train_out["serve"]["launches"], "unfused": none}
    base = train_out["baselines"]
    runs["qwen3_uniform"] = {
        "quantize": base["rows"]["uniform 4"]["code_search_launches"],
        "fused": base["serve"]["qwen3_uniform"]["launches"], "unfused": none}
    runs["qwen3_gptq"] = {"quantize": 0,
                          "fused": base["serve"]["qwen3_gptq"]["launches"],
                          "unfused": none}
    qwen3 = ("qwen3_trained", "qwen3_uniform")
    dense = tuple(dense_out)

    def by_path(kernel, run):
        if run == "quantize":
            return {path: r["quantize"] for path, r in runs.items()}
        if run == "serve":      # the fused and the unfused run together
            return {path: r["fused"][kernel] + r["unfused"][kernel]
                    for path, r in runs.items()}
        return {path: r[run][kernel] for path, r in runs.items()}
    spec = ("llama2_spec", "llama2_bf16", "mixtral_spec")
    tp_paths = ("llama2_tp", "llama2_tp_spec")
    lockstep = ("lockstep_llama2", "lockstep_mixtral")
    fam_lock = tuple(f"lockstep_{p}" for p in families)
    on_path = {  # kernel -> (run that counts it, paths that must launch it)
        "rht_qmatmul": ("fused", ("llama2", "mixtral", "llama2_prefix",
                                  *spec, *tp_paths, *dense, "llama2_gather",
                                  "frontdoor", *lockstep, *families,
                                  *fam_lock, *qwen3, *mw,
                                  "qwen2_vl_lockstep")),
        "paged_attention": ("fused", ("llama2", "mixtral", "llama2_prefix",
                                      *spec, *tp_paths, *dense, "frontdoor",
                                      "recurrentgemma", *qwen3, "qwen3_gptq",
                                      "qwen2_vl")),
        "qmatmul": ("unfused", ("llama2", "mixtral", "llama2_tp", *dense,
                                *families, "lockstep_llama2_unfused", *mw)),
        "rht": ("unfused", ("llama2", "mixtral", "llama2_tp", *dense,
                            *families, "lockstep_llama2_unfused", *mw)),
        "rabitq_quant": ("quantize", ("llama2", "mixtral", *dense,
                                      *families, *qwen3, *mw)),
        "grouped_rht_qmatmul": ("fused", ("mixtral", "mixtral_spec",
                                          "lockstep_mixtral", "deepseek_v2",
                                          "lockstep_deepseek_v2")),
        "grouped_qmatmul": ("unfused", ("mixtral", "deepseek_v2")),
        "flash_attention": ("fused", ()),
    }
    launches = {k: by_path(k, run) for k, (run, _) in on_path.items()}

    def on_path_of(path):
        return {k for k, (_, paths) in on_path.items() if path in paths}
    for k, (_, paths) in on_path.items():
        check(all(launches[k][p] > 0 for p in paths),
              f"{k}: not launched on every path that runs it: {launches[k]}")
    # the gather and lockstep paths read their KV without the paged kernel,
    # and MLA and RWKV6 hold no KV blocks
    check(not any(launches["paged_attention"][p] for p in (
        "llama2_gather", *lockstep, "lockstep_llama2_unfused", *fam_lock,
        "deepseek_v2", "rwkv6", "whisper", "qwen2_vl_lockstep")),
          f"paged attention launched off its paths: "
          f"{launches['paged_attention']}")
    # neither qwen2-vl nor Whisper has experts
    check(not any(launches[k][p] for k in ("grouped_rht_qmatmul",
                                           "grouped_qmatmul")
                  for p in (*mw, "qwen2_vl_lockstep")),
          f"the grouped GEMM launched on a path without experts: "
          f"{launches['grouped_rht_qmatmul']}, "
          f"{launches['grouped_qmatmul']}")
    # GPTQ's reconstruction is full precision (paged attention only), and
    # the uniform model serves fused and has no experts
    off_path = {f"{k} on {p}": by[p] for k, by in launches.items()
                for p in ("qwen3_gptq", "qwen3_uniform") if by[p]
                and k not in on_path_of(p)}
    check(not off_path, f"launched off their paths: {off_path}")
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
              lockstep_prefill={k: gemm_times[-1][k] for k in (
                  "n", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")},
              gemm_launches_by_run_and_phase=gemms,
              tp_shard_cols=tp_out["runs"]["fused"]["shard_cols"],
              mrope_whisper=[{k: t[k] for k in (
                  "n", "d", "c", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")} for t in mw_times],
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
                      ("llama2", serve_out), ("mixtral", moe_serve))},
              tp_arena_kv_heads=tp_out["runs"]["fused"]["arena_kv_heads"]),
        entry("qmatmul", "src/repro_torch/csrc/rht_qmatmul.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:66", unfused_err,
              decode_unfused, ("n", "d", "c", "bits"),
              mrope_whisper=[{k: t[k] for k in (
                  "n", "d", "c", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")} for t in mw_unfused_times]),
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
              uniform_check=search["uniform"],
              uniform_times=[{k: t[k] for k in (
                  "d", "c", "n_candidates", "ms", "plain_ms", "bound_ms")}
                  for t in uniform_search_times],
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
              "uniform_code_search_times": uniform_search_times,
              "attention_check": attn_check, "attention_times": attn_times,
              "quantize": quant_out,
              "serve": serve_out, "dryrun": dryrun_out, "tp": tp_out,
              "grouped_times": grouped_times,
              "grouped_unfused_times": grouped_unfused_times,
              "flash_times": flash_times,
              "gemm_check": gemm_worst, "grouped_check": grouped_check,
              "mixtral_quantize": moe_quant,
              "mixtral_serve": moe_serve, "prefix_cache": prefix_out,
              "speculation": spec_out, "mixtral_speculation": moe_spec,
              "gather": gather_out, "frontdoor": frontdoor_out,
              "lockstep": {"llama2": lockstep_out, "mixtral": moe_lockstep},
              "dense_configs": dense_out, "families": family_out,
              "qwen2_vl": qwen2_vl_out, "whisper": whisper_out,
              "mrope_whisper_gemm_times": mw_times,
              "mrope_whisper_unfused_gemm_times": mw_unfused_times,
              "train": train_out,
              "kernels": kernels,
              "phase_s": phase_s, "seconds": time.monotonic() - T_START}
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
