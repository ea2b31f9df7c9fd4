"""Quantize-then-serve CLI for the port (``repro/launch/serve.py:main``).

    python -m repro_torch.launch.serve --avg-bits 4.0            # on the card
    python -m repro_torch.launch.serve --device cpu --tiny --avg-bits 3.3 \\
        --requests 2 --gen 8                                       # on the host
    python -m repro_torch.launch.serve --arch mixtral-8x7b --tiny --device cpu \\
        --avg-bits 3.3                                # MoE + sliding window
    python -m repro_torch.launch.serve --device cpu --tiny --avg-bits 3.3 \\
        --speculate 2 --draft-bits 2.2                # self-speculative
    python -m repro_torch.launch.serve --device cpu --tiny --lockstep
    python -m repro_torch.launch.serve --arch rwkv6-3b --tiny --device cpu \\
        --avg-bits 3.3          # also deepseek-v2-236b, recurrentgemma-2b,
                                # qwen2-vl-2b
    python -m repro_torch.launch.serve --device cpu --tiny --serve --port 8080
    python -m repro_torch.launch.serve --device cpu --tiny --tp 2
    python -m repro_torch.launch.serve --device cpu --tiny --tp 2 --serve \\
        --port 8080                           # the front door over 2 ranks

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
depend on it.  ``--kv-dtype bf16`` stores the KV arenas in bf16.
``--no-paged-kernel`` reads the paged KV through the reference's dense
gather instead of the flash-decode kernel (an A/B baseline; the stats line
prints ``attn=gather``, else ``attn=kernel``, which on the host is the
kernel's plain version); ``--paged-kernel`` pins the kernel, which needs
the card.

``--speculate K`` serves self-speculatively: the same calibration
quantizes a second, ``--draft-bits`` draft (with ``--avg-bits`` both come
from ``quantize_model_dual``; without it the target stays fp32), the
draft proposes K tokens a round and the target verifies them in one step.
Greedy tokens equal the ``--speculate 0`` run's; the report gives
``acceptance_rate``.

``--lockstep`` serves through ``BatchedServer`` instead, the baseline the
paged engine is measured against: the requests prefill together and decode
in lockstep until the last one finishes (its decode step captured once as
a CUDA graph on the card); its greedy sample equals the paged engine's.

``--serve`` boots the streaming front door (``serve/frontdoor``) on the
engine instead of the one-shot run: ``POST /v1/generate`` with per-token
SSE, ``GET /healthz``, ``GET /v1/stats``, per-tenant priority admission with
weighted fair sharing (``--max-tenant-share`` caps one tenant's share of
the slots while others wait), drop-and-replay preemption and, with
``--slo-p95-ms``, an SLO controller that holds chunked prefill while the
decode gap's p95 is past the target.  ``--prompt-len`` + ``--gen`` size
the pool's context.  It prints ``frontdoor listening on HOST:PORT``, and
on SIGINT / SIGTERM ``frontdoor shut down cleanly`` and exits 0; an engine
failure in its driver thread exits non-zero.

``--arch whisper-large-v3`` exits with an error on every path: the paged
engine refuses encoder-decoder archs (as the reference's does), and
``BatchedServer`` has no encoder frames to pass (the reference's takes
none either, so it fails there too); the port's refuses at construction.
Whisper serves through ``runtime/steps.make_prefill_step`` /
``make_serve_step`` with ``enc_embeds`` in the batch.

``--tp N`` serves tensor-parallel over N ranks, one process each
(``launch/mesh.spawn``; gloo on the host, NCCL with one card per rank,
which refuses a host with fewer cards): the model is built and quantized
here, each rank takes its column shard (``runtime/tp.py``), rank 0 drives
the engine (``serve_rank``) and its run is printed with ``tp=N``.  Greedy
tokens equal ``--tp 1``'s.  TP steps run eagerly (no CUDA graphs).  With
``--serve`` the ranks serve the front door for as long as it runs
(``frontdoor_rank``): rank 0 boots it over its engine and drives, the
other ranks mirror its device ops, and while it idles rank 0 sends them
heartbeats.  SIGINT / SIGTERM to this process go on to rank 0, whose
server shuts down cleanly and releases the workers (which ignore both);
a driver failure on rank 0 stops every rank and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import signal
import threading
import time

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.configs import get_config, get_tiny
from repro_torch.core import calibrate as cal
from repro_torch.core import pipeline as pipe
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.launch import mesh
from repro_torch.models import decode as decmod
from repro_torch.models import transformer as tf
from repro_torch.serve import PagedServer, PoolConfig, Request, graphs
from repro_torch.serve.frontdoor import FrontDoor, SchedConfig

ENC_DEC_LOCKSTEP = ("BatchedServer does not support encoder-decoder archs: "
                    "it takes no encoder frames (serve them through "
                    "runtime.steps.make_prefill_step with enc_embeds)")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lockstep_logits(cfg, params, caches, *, tokens, pos) -> torch.Tensor:
    return decmod.decode_step(cfg, params, caches, tokens, pos)[0]


class BatchedServer:
    """Lockstep batched server: aligned prefill, then every request decodes
    in lockstep until the batch's last one finishes (the reference's
    ``BatchedServer``), the baseline the paged engine is measured against.
    Greedy or temperature sampling; quantized models route every linear
    through ``QuantizedLinear.apply``.  Runs on ``device`` (CUDA unless
    ``"cpu"``) with ``fused`` fixed for its steps, as the engine's is.

    The reference jits its decode step; here it is captured once per batch
    size as a CUDA graph (``serve/graphs.py``, key ``("lockstep", fused,
    B)``) and replayed, ``pos`` a one-element device tensor and the tokens
    chosen on the card; ``graphs.eager()`` (or a kernel forced onto its
    plain version) runs it op by op.  Each batch size keeps one cache of
    ``max_context`` positions (a window's ring for windowed archs), zeroed
    per call; the step is captured before the prefill fills it, so the
    capture's warm-up write at position 0 is overwritten by the prompt's.
    ``stats`` holds the last call's ``prefill_s`` and ``decode_s`` (host
    clock, synced) and its ``decode_steps``."""

    def __init__(self, cfg, params, max_context: int = 512, *,
                 fused: bool = True, device=None):
        self.device = resolve_device(device)
        if cfg.enc_dec:
            raise ValueError(ENC_DEC_LOCKSTEP)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"server runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_context = max_context
        self.fused = fused
        self.graphs = graphs.StepGraphs(self.device)
        self.stats: dict = {}
        self._caches: dict[int, list] = {}

    @property
    def decode_trace_count(self) -> int:
        """Decode-step captures: one per batch size and fusion setting."""
        return self.graphs.captures["lockstep"]

    def _decode(self, caches: list, b: int):
        fn = functools.partial(_lockstep_logits, self.cfg, self.params,
                               caches)
        if graphs.eager_enabled() or (self.device.type == "cuda"
                                      and kernels.plain_forced()):
            return graphs.eager_call(fn, self.device)
        return self.graphs.get(
            ("lockstep", self.fused, b), fn,
            lambda: {"tokens": np.zeros((b, 1), np.int32),
                     "pos": np.zeros(1, np.int32)})

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> np.ndarray:
        """prompts (B, S) int32 -> (B, n_tokens) int32.  Sampling at
        ``temperature`` > 0 draws from ``generator`` (a fresh one seeded 0
        on the device if None); torch cannot replay ``jax.random``, so
        sampled tokens are not the reference's."""
        b, s = prompts.shape
        if s + n_tokens > self.max_context:
            raise ValueError(f"prompt + n_tokens = {s + n_tokens} exceeds "
                             f"max_context = {self.max_context}")
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with qops.fusion(self.fused), torch.no_grad():
            t0 = time.monotonic()
            caches = self._caches.get(b)
            if caches is None:
                caches = self._caches[b] = decmod.init_caches(
                    self.cfg, b, self.max_context, device=self.device)
            else:
                for cache in caches:
                    for t in decmod.cache_tensors(cache):
                        t.zero_()
            step = self._decode(caches, b)      # captured before the fill
            logits, _, _ = decmod.prefill(
                self.cfg, self.params,
                torch.from_numpy(np.array(prompts, np.int32)).to(
                    self.device), caches=caches)
            last = logits[:, -1]
            _sync(self.device)
            t1 = time.monotonic()
            out = []
            for t in range(n_tokens):
                if temperature > 0:
                    probs = torch.softmax(last.to(torch.float32)
                                          / temperature, dim=-1)
                    tok = torch.multinomial(probs, 1,
                                            generator=generator)[:, 0]
                else:
                    tok = torch.argmax(last, dim=-1)
                out.append(tok)
                last = step({"tokens": tok.to(torch.int32)[:, None],
                             "pos": np.array([s + t], np.int32)})
            tokens = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
            _sync(self.device)
        self.stats = {"prefill_s": t1 - t0,
                      "decode_s": time.monotonic() - t1,
                      "decode_steps": n_tokens}
        return tokens


def _to_device(node, dev):
    """A param tree with every tensor, quantized weights' too, on ``dev``
    (shared where it is already there)."""
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, dev) for v in node]
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _to_device(getattr(node, f.name), dev)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
    return node


def _rank_engine(group, job: dict) -> PagedServer:
    """``job``'s ``PagedServer`` on this rank of ``group``: a dict of
    ``cfg``, ``params`` (the full tree, on any device), ``pool`` and
    ``engine`` (``PagedServer`` keyword arguments, ``draft_params`` among
    them)."""
    kw = dict(job.get("engine", {}))
    if kw.get("draft_params") is not None:
        kw["draft_params"] = _to_device(kw["draft_params"], group.device)
    return PagedServer(job["cfg"], _to_device(job["params"], group.device),
                       job["pool"], device=group.device, group=group, **kw)


def serve_rank(group, jobs: list) -> list | None:
    """One rank's part of a tensor-parallel run (``launch.mesh.spawn``):
    each job (``_rank_engine``'s, with its ``requests``) is served by a
    ``PagedServer`` over ``group``.  Rank 0 drives and returns per job the
    tokens by rid, the engine's stats and the run's seconds; the other
    ranks mirror its device ops and return None."""
    out = []
    for job in jobs:
        engine = _rank_engine(group, job)
        if group.rank:
            engine.serve_worker()
            continue
        try:
            t0 = time.monotonic()
            results = engine.run(list(job["requests"]))
            _sync(group.device)
            seconds = time.monotonic() - t0
        finally:
            engine.close()
        out.append({"tokens": {rid: r.tokens.tolist()
                               for rid, r in results.items()},
                    "stats": engine.stats, "seconds": seconds})
    return None if group.rank else out


def serve_frontdoor(engine: PagedServer, sched: SchedConfig, *,
                    port: int = 8080, client=None):
    """The streaming front door over ``engine``.  At TP=1 and on rank 0
    of its group, a ``FrontDoor`` on ``port``: with no ``client`` it
    serves in this thread until ``stop``, SIGINT or SIGTERM and returns
    None; else it serves on a thread while ``client(door)`` runs here,
    stops after it and returns its result.  Rank 0 then stops the workers
    (``close``), and raises if its driver failed.  On a TP worker it
    mirrors rank 0's device ops until that ``close``, ignoring SIGINT and
    SIGTERM meanwhile (a terminal's Ctrl-C reaches every process: rank 0
    takes it, and a worker stopped inside a collective would leave rank 0
    waiting; so a worker calls it from its main thread), and returns
    None."""
    if engine.group is not None and engine.group.rank:
        old = {sig: signal.signal(sig, signal.SIG_IGN)
               for sig in (signal.SIGINT, signal.SIGTERM)}
        try:
            engine.serve_worker()
        finally:
            for sig, handler in old.items():
                signal.signal(sig, handler)
        return None
    door = FrontDoor(engine, sched, port=port)
    try:
        if client is None:
            door.serve_forever()
            return None
        failed: list = []

        def serve():
            try:
                door.serve_forever()
            except BaseException as exc:                  # noqa: BLE001
                failed.append(exc)
        server = threading.Thread(target=serve, name="frontdoor-server")
        server.start()
        try:
            if not door.ready.wait(120):
                raise RuntimeError("the front door did not start listening")
            result = client(door)
        finally:
            door.stop()
            server.join()
        if failed:
            raise failed[0]
        return result
    finally:
        engine.close()


def frontdoor_rank(group, job: dict, sched: SchedConfig, port: int,
                   client=None):
    """One rank of ``--serve --tp N`` (``launch.mesh.spawn``): ``job``'s
    engine (``_rank_engine``) behind ``serve_frontdoor``.  Rank 0 prints
    the ranks' process ids first."""
    import torch.distributed as dist
    engine = _rank_engine(group, job)
    pids = [None] * group.size
    dist.all_gather_object(pids, os.getpid(), group=group.ctrl)
    if not group.rank:
        print(f"frontdoor: {group.size} TP ranks, pids "
              f"{' '.join(map(str, pids))}", flush=True)
    return serve_frontdoor(engine, sched, port=port, client=client)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--avg-bits", type=float, default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--lockstep", action="store_true",
                    help="lockstep whole-batch server (A/B baseline)")
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
    ap.add_argument("--kv-dtype", choices=["f32", "bf16"], default="f32",
                    help="paged engine: KV arena dtype")
    ap.add_argument("--paged-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="read the paged KV with the flash-decode kernel "
                         "(the card only); --no-paged-kernel runs the dense "
                         "gather (A/B baseline); default: the kernel on the "
                         "card, its plain version on the host")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens a round "
                         "from a low-bit quantization of the same weights, "
                         "verify them in one target step")
    ap.add_argument("--draft-bits", type=float, default=2.2,
                    help="average bit budget of the speculative draft "
                         "(used when --speculate > 0)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: N ranks, one process "
                         "each (gloo on the host, one card per rank over "
                         "NCCL); greedy tokens equal --tp 1's")
    ap.add_argument("--serve", action="store_true",
                    help="boot the streaming HTTP/SSE front door on --port "
                         "instead of the one-shot run (POST /v1/generate, "
                         "GET /healthz, GET /v1/stats); --prompt-len + "
                         "--gen size the pool's max context")
    ap.add_argument("--port", type=int, default=8080,
                    help="front door listen port (0 binds an ephemeral "
                         "port; the chosen one is printed at boot)")
    ap.add_argument("--slo-p95-ms", type=float, default=None,
                    help="front door: decode-gap p95 target in ms; past it "
                         "the scheduler holds chunked prefill until the p95 "
                         "recovers (default: controller off)")
    ap.add_argument("--max-tenant-share", type=float, default=1.0,
                    help="front door: max share of the slots one tenant "
                         "may hold while others wait (default 1.0: no cap)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu runs the kernels' "
                         "plain versions on the host)")
    args = ap.parse_args(argv)
    if args.speculate and args.lockstep:
        ap.error("--speculate needs the paged engine (drop --lockstep)")
    if args.tp > 1 and args.lockstep:
        ap.error("--tp needs the paged engine (drop --lockstep)")
    if args.serve and args.lockstep:
        ap.error("--serve needs the paged engine (drop --lockstep)")
    if args.paged_kernel and torch.device(args.device).type != "cuda":
        ap.error("--paged-kernel needs the card: the flash-decode kernel "
                 "has no host version (drop it, or --device cpu)")

    dev = resolve_device(args.device)
    try:
        mesh.resolve_backend(args.tp, None, dev)
    except ValueError as e:
        ap.error(f"--tp {args.tp}: {e}")
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    if cfg.enc_dec:
        ap.error(f"{cfg.name}: "
                 + (ENC_DEC_LOCKSTEP if args.lockstep else
                    "PagedServer does not support encoder-decoder archs"))
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)

    draft_params = None
    if args.avg_bits or args.speculate:
        what = (f"{args.avg_bits} avg bits" if args.avg_bits
                else "fp32 target")
        if args.speculate:
            what += f", {args.draft_bits}-bit draft"
        print(f"calibrating + quantizing ({what}) ...")
        t0 = time.monotonic()
        toks = cal.zero_shot_tokens(cfg.vocab, 256)
        stats = cal.calibrate(
            lambda p, b, ctx: tf.loss_fn(cfg, p, b, ctx=ctx), params,
            [{"tokens": torch.from_numpy(toks).to(dev)}])
        _sync(dev)
        calibrate_s = time.monotonic() - t0
        gen = torch.Generator(device=dev).manual_seed(1)
        if args.avg_bits and args.speculate:
            params, rep, draft_params, drep = pipe.quantize_model_dual(
                cfg, params, stats, args.avg_bits, args.draft_bits,
                generator=gen, device=dev)
            print(f"quantized {rep.n_layers} layers, achieved "
                  f"{rep.avg_bits:.3f} target / {drep.avg_bits:.3f} draft "
                  f"bits in {calibrate_s + rep.wall_time_s + drep.wall_time_s:.1f}s"
                  f" (calibrate_s={calibrate_s:.2f}, allocate_s="
                  f"{rep.allocate_s:.2f} + {drep.allocate_s:.2f}, "
                  f"quantize_s={rep.quantize_s:.2f} + {drep.quantize_s:.2f})")
        elif args.avg_bits:
            params, rep = pipe.quantize_model(
                cfg, params, stats, args.avg_bits, generator=gen, device=dev)
            print(f"quantized {rep.n_layers} layers, achieved "
                  f"{rep.avg_bits:.3f} bits in "
                  f"{calibrate_s + rep.wall_time_s:.1f}s (calibrate_s="
                  f"{calibrate_s:.2f}, allocate_s={rep.allocate_s:.2f}, "
                  f"quantize_s={rep.quantize_s:.2f})")
        else:                       # fp32 target, quantized draft
            draft_params, drep = pipe.quantize_model(
                cfg, params, stats, args.draft_bits, generator=gen,
                device=dev)
            print(f"quantized draft: {drep.avg_bits:.3f} bits in "
                  f"{calibrate_s + drep.wall_time_s:.1f}s")

    tok = ByteTokenizer(cfg.vocab)
    prompt = tok.encode("the quick brown fox " * 8)[: args.prompt_len]
    path = "unfused" if args.unfused else "fused"
    if args.lockstep:
        server = BatchedServer(cfg, params,
                               max_context=args.prompt_len + args.gen,
                               fused=not args.unfused, device=dev)
        t0 = time.monotonic()
        out = server.generate(np.stack([prompt] * args.requests), args.gen)
        dt = time.monotonic() - t0
        print(f"served {args.requests} requests x {args.gen} tokens in "
              f"{dt:.2f}s ({args.requests * args.gen / dt:.1f} tok/s, {path} "
              f"decode path, lockstep, prefill_s="
              f"{server.stats['prefill_s']:.2f}, captures="
              f"{server.decode_trace_count}, device={dev.type})")
        print("sample:", tok.decode(np.asarray(out[0]))[:80])
        return
    pool = PoolConfig(max_slots=args.slots, block_size=args.block_size,
                      max_context=args.prompt_len + args.gen,
                      prefill_chunk=args.prefill_chunk,
                      prefix_cache=args.prefix_cache,
                      kv_dtype=(torch.bfloat16 if args.kv_dtype == "bf16"
                                else torch.float32))
    engine_kw = dict(fused=not args.unfused, paged_kernel=args.paged_kernel,
                     draft_params=draft_params, speculate=args.speculate)
    reqs = [Request(rid=i, prompt=np.asarray(prompt), max_new=args.gen)
            for i in range(args.requests)]
    sched = SchedConfig(slo_p95_ms=args.slo_p95_ms,
                        max_tenant_share=args.max_tenant_share)
    if args.tp > 1:
        # the ranks take host copies; each moves its shard to its device
        host = torch.device("cpu")
        engine_kw["draft_params"] = _to_device(draft_params, host)
        job = {"cfg": cfg, "params": _to_device(params, host), "pool": pool,
               "requests": reqs, "engine": engine_kw}
        if args.serve:
            # a server lives until it is stopped: no deadline
            mesh.spawn(frontdoor_rank, args.tp, job, sched, args.port,
                       device=dev, deadline_s=None,
                       forward_signals=(signal.SIGINT, signal.SIGTERM))
            return
        run = mesh.spawn(serve_rank, args.tp, [job], device=dev)[0][0]
        sample = np.asarray(run["tokens"][0])
        stats, dt = run["stats"], run["seconds"]
    else:
        engine = PagedServer(cfg, params, pool, device=dev, **engine_kw)
        if args.serve:
            serve_frontdoor(engine, sched, port=args.port)
            return
        t0 = time.monotonic()
        results = engine.run(reqs)
        _sync(dev)
        dt = time.monotonic() - t0
        stats = engine.stats                # finalized by run()
        sample = results[0].tokens
    with pops.paged_kernel(args.paged_kernel):
        attn = "kernel" if pops.kernel_enabled() else "gather"
    prefix = "prefix_cache=off"
    if "prefix_hit_rate" in stats:          # the engine's cache is on
        prefix = (f"prefix_cache=on, prefix_hit_rate="
                  f"{stats['prefix_hit_rate']:.2f}, prefill_tokens_saved="
                  f"{stats.get('prefill_tokens_saved', 0)}")
    if "acceptance_rate" in stats:          # the engine speculates
        prefix += (f", speculate={args.speculate}, acceptance_rate="
                   f"{stats['acceptance_rate']:.2f}, spec_rounds="
                   f"{stats.get('spec_rounds', 0)}")
    steps = (f"captures={stats['captures']} in {stats['capture_s']:.2f}s"
             if args.tp == 1 else f"steps={stats['tp_steps']}")
    print(f"served {args.requests} requests x {args.gen} tokens in {dt:.2f}s "
          f"({args.requests * args.gen / dt:.1f} tok/s, {path} decode path, "
          f"paged, occupancy={stats['mean_occupancy']:.2f}, {steps}, "
          f"device={dev.type}, tp={stats['tp']}, kv={args.kv_dtype}, "
          f"attn={attn}, {prefix})")
    print("sample:", tok.decode(np.asarray(sample))[:80])


if __name__ == "__main__":
    main()
