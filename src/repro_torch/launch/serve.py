"""Quantize-then-serve CLI for the port (the paged branch of
``repro/launch/serve.py:main``).

    python -m repro_torch.launch.serve --avg-bits 4.0            # on the card
    python -m repro_torch.launch.serve --device cpu --tiny --avg-bits 3.3 \\
        --requests 2 --gen 8                                       # on the host
    python -m repro_torch.launch.serve --arch mixtral-8x7b --tiny --device cpu \\
        --avg-bits 3.3                                # MoE + sliding window

Random weights from a seeded generator; with ``--avg-bits`` the model is
calibrated on the paper's zero-shot sentence, bit widths are allocated
(AllocateBits) and every linear is RaBitQ-H quantized before serving through
``PagedServer``.  ``--unfused`` serves with the unfused RHT + GEMM pair.
On the card the engine captures each serving step once as a CUDA graph and
replays it; the stats line reports the captures and the seconds they took.
Shared prompt prefixes are served from the content-addressed prefix cache
(on by default; ``--no-prefix-cache`` for a cold pool A/B).  The CLI's
prompts are identical, so with more requests than ``--slots`` the second
admission wave hits; the printed ``prefix_hit_rate`` is the share of
prompt tokens whose prefill the cache saved, and greedy tokens do not
depend on it.

Not ported yet, each under its ROADMAP Queue 1 item: ``--lockstep`` (7),
``--kv-dtype`` (5), ``--paged-kernel`` (5: the
kernel always runs on the card), ``--speculate`` / ``--draft-bits`` (4),
``--tp`` (8), ``--serve`` / ``--port`` / ``--slo-p95-ms`` /
``--max-tenant-share`` (9).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_tiny
from repro_torch.core import calibrate as cal
from repro_torch.core import pipeline as pipe
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import transformer as tf
from repro_torch.serve import PagedServer, PoolConfig, Request


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--avg-bits", type=float, default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--unfused", action="store_true",
                    help="disable RHT+qmatmul fusion (A/B baseline)")
    ap.add_argument("--slots", type=int, default=4,
                    help="paged engine: concurrent request slots")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged engine: tokens per KV block")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="paged engine: prompt tokens per scheduler turn")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="content-addressed KV prefix reuse (bypassed by "
                         "windowed archs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu runs the kernels' "
                         "plain versions on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)

    if args.avg_bits:
        print(f"calibrating + quantizing ({args.avg_bits} avg bits) ...")
        t0 = time.monotonic()
        toks = cal.zero_shot_tokens(cfg.vocab, 256)
        stats = cal.calibrate(
            lambda p, b, ctx: tf.loss_fn(cfg, p, b, ctx=ctx), params,
            [{"tokens": torch.from_numpy(toks).to(dev)}])
        _sync(dev)
        calibrate_s = time.monotonic() - t0
        params, rep = pipe.quantize_model(
            cfg, params, stats, args.avg_bits,
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        print(f"quantized {rep.n_layers} layers, achieved "
              f"{rep.avg_bits:.3f} bits in {calibrate_s + rep.wall_time_s:.1f}s"
              f" (calibrate_s={calibrate_s:.2f}, allocate_s="
              f"{rep.allocate_s:.2f}, quantize_s={rep.quantize_s:.2f})")

    tok = ByteTokenizer(cfg.vocab)
    prompt = tok.encode("the quick brown fox " * 8)[: args.prompt_len]
    pool = PoolConfig(max_slots=args.slots, block_size=args.block_size,
                      max_context=args.prompt_len + args.gen,
                      prefill_chunk=args.prefill_chunk,
                      prefix_cache=args.prefix_cache)
    engine = PagedServer(cfg, params, pool, fused=not args.unfused,
                         device=dev)
    t0 = time.monotonic()
    results = engine.run([Request(rid=i, prompt=np.asarray(prompt),
                                  max_new=args.gen)
                          for i in range(args.requests)])
    _sync(dev)
    dt = time.monotonic() - t0
    stats = engine.stats                # finalized by run()
    sample = results[0].tokens
    path = "unfused" if args.unfused else "fused"
    prefix = "prefix_cache=off"
    if engine.prefix_cache is not None:
        prefix = (f"prefix_cache=on, prefix_hit_rate="
                  f"{stats['prefix_hit_rate']:.2f}, prefill_tokens_saved="
                  f"{stats.get('prefill_tokens_saved', 0)}")
    print(f"served {args.requests} requests x {args.gen} tokens in {dt:.2f}s "
          f"({args.requests * args.gen / dt:.1f} tok/s, {path} decode path, "
          f"paged, occupancy={stats['mean_occupancy']:.2f}, "
          f"captures={stats['captures']} in {stats['capture_s']:.2f}s, "
          f"device={dev.type}, {prefix})")
    print("sample:", tok.decode(np.asarray(sample))[:80])


if __name__ == "__main__":
    main()
