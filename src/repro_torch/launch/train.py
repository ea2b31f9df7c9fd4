"""Training driver for the port (``repro/launch/train.py``): the synthetic
corpus through ``LMBatchLoader``, the microbatched AdamW train step, and
with ``--ckpt-dir`` the fault-tolerant loop (checkpoints, resume, retries,
straggler watchdog).

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 100 \\
        --batch 8 --seq 256 --lr 2e-3                     # on the card
    python -m repro_torch.launch.train --device cpu --tiny --steps 20
    python -m repro_torch.launch.train --device cpu --tiny --steps 300 \\
        --batch 16 --seq 128 --ckpt-dir build/run1        # resumable

Params come from ``init_params`` with a ``torch.Generator`` seeded by
``seed`` (the reference's ``jax.random`` draws cannot be replayed, so
parity tests pass bridged params instead).  Every step's time ends in a
sync on the card.  It prints ``step N loss L gnorm G Tms`` every
``log_every`` steps and last ``trained <name>: loss a -> b in Ns``.
``--arch qwen2-vl-2b`` trains on its default positions (mrope's three
equal text streams); an encoder-decoder arch (whisper-large-v3) is
refused, as the reference's loop has no encoder frames for it either.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_tiny
from repro_torch.data import LMBatchLoader, make_corpus_tokens
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.runtime.fault import FaultTolerantLoop, LoopConfig
from repro_torch.runtime.steps import make_train_step
from repro_torch.tree import leaves


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(arch: str = "llama2-7b", tiny: bool = True, steps: int = 200,
          batch: int = 16, seq: int = 128, lr: float = 1e-3,
          warmup: int = 20, microbatches: int = 1, seed: int = 0,
          ckpt_dir: str | None = None, ckpt_every: int = 100,
          grad_compression: str | None = None, log_every: int = 20,
          params=None, corpus=None, inject_failure=None, device=None,
          on_step: Optional[Callable] = None, depth: int | None = None):
    """Train ``arch`` for ``steps`` steps -> (cfg, params, losses).

    ``depth``: the config cut to its first ``depth`` layers (published
    widths, fewer layers: a smoke run's cut); all of them when None.

    ``params``: the port's params on ``device`` (e.g. bridged from the
    reference); default ``init_params`` from a generator seeded ``seed``.
    ``device``: CUDA unless ``"cpu"`` (raises without a card).
    ``on_step(step, metrics, seconds)``: called after each step (metrics are
    device tensors; seconds end in a sync on the card)."""
    dev = resolve_device(device)
    cfg = get_tiny(arch) if tiny else get_config(arch)
    if depth is not None:
        cfg = cfg.with_(n_layers=depth,
                        mixer_pattern=cfg.mixer_pattern[:depth])
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name}: the training loop feeds token batches "
                         "only and has no encoder frames for an "
                         "encoder-decoder arch (train it through "
                         "runtime.steps.make_train_step with enc_embeds)")
    if params is None:
        params = tf.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    elif any(p.device != dev for p in leaves(params)):
        raise ValueError(f"params must live on {dev}, the training device")
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, microbatches=microbatches, peak_lr=lr,
                              warmup=warmup, total_steps=steps,
                              grad_compression=grad_compression)

    if corpus is None:
        corpus = make_corpus_tokens(cfg.vocab, n_sentences=20000, seed=seed)
    loader = LMBatchLoader(corpus, batch, seq, seed=seed)

    losses = []

    def wrapped(state, batch_np):
        p, o = state
        b = {"tokens": torch.from_numpy(batch_np).to(dev)}
        p, o, m = step_fn(p, o, b)
        return (p, o), m

    def on_metrics(step, m, dt):
        losses.append(float(m["loss"]))
        if step % log_every == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} {dt*1e3:.0f}ms",
                  flush=True)
        if on_step is not None:
            on_step(step, m, dt)

    state = (params, opt)
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2)
        loop = FaultTolerantLoop(wrapped, mgr, LoopConfig(
            ckpt_every=ckpt_every), inject_failure=inject_failure)
        state, start = loop.maybe_resume(state)
        state = loop.run(state, lambda s: loader_batch(loader, s), steps,
                         start_step=start, on_metrics=on_metrics)
    else:
        for s in range(steps):
            t0 = time.perf_counter()
            state, m = wrapped(state, loader_batch(loader, s))
            _sync(dev)
            on_metrics(s, m, time.perf_counter() - t0)
    params, opt = state
    return cfg, params, losses


def loader_batch(loader: LMBatchLoader, step: int):
    loader.step = step
    return loader.next_batch()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu: the host)")
    args = ap.parse_args(argv)
    t0 = time.time()
    cfg, params, losses = train(
        arch=args.arch, tiny=args.tiny, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        grad_compression=args.grad_compression, device=args.device)
    print(f"trained {cfg.name}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
