"""Fault tolerance & straggler mitigation for the training loop (port of
``repro/runtime/fault.py``).

The host-side control plane around the train step:

  * ``FaultTolerantLoop`` -- periodic checkpoints, resume from the latest
    one (``maybe_resume``), bounded retry of a failed step, and on a hard
    failure (retries exhausted) a restore from the latest checkpoint and a
    replay from its step; a straggler watchdog (a per-step deadline of
    ``straggler_factor`` x the trailing median; after
    ``straggler_patience`` violations in a row it checkpoints, so a
    scheduler can evict the slow host).  Tests inject failures with
    ``inject_failure``.
  * elasticity: checkpoints are host numpy (``checkpoint/ckpt.py``) and
    the data loader keys batches by step, so a restored run replays the
    same batches.  A model-parallel run saves and restores through a
    ``ShardedCheckpointManager`` (in the one-device format, so a run
    resumes on a mesh of another shape), and ``agree`` makes the ranks take
    the straggler watchdog's checkpoint together: a rank's slow step is
    its own, and a save is collective.

On the card each step's time ends with ``torch.cuda.synchronize()``: the
port's step returns once its kernels are queued, and without the sync the
watchdog would time the launches, not the step.

The port's train step updates params and moments in place.  A failure
before the optimizer update (the forward, the backward, an injected one)
leaves the state as it was, so a retry replays the step exactly; a failure
inside the update leaves it part-updated, and only the restore from a
checkpoint after ``max_retries`` brings it back.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.fault")


@dataclass
class LoopConfig:
    ckpt_every: int = 50
    max_retries: int = 2
    straggler_factor: float = 3.0     # deadline = factor * trailing median
    straggler_window: int = 20
    straggler_patience: int = 3


@dataclass
class LoopStats:
    step_times: list = field(default_factory=list)
    straggler_events: int = 0
    retries: int = 0
    restores: int = 0
    resumed_from: Optional[int] = None


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class FaultTolerantLoop:
    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: LoopConfig = LoopConfig(),
                 inject_failure: Optional[Callable[[int], bool]] = None,
                 agree: Optional[Callable[[bool], bool]] = None):
        """``agree(flag)``: whether ``flag`` holds on any rank of a
        model-parallel run (called by every rank after every step)."""
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.stats = LoopStats()
        self.inject_failure = inject_failure
        self.agree = agree
        self._slow_streak = 0

    def maybe_resume(self, state: Any) -> tuple[Any, int]:
        """Restore (state, start_step) from the latest checkpoint if any."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        restored, extra = self.ckpt.restore(latest, state)
        self.stats.resumed_from = latest
        log.info("resumed from checkpoint step %d", latest)
        return restored, int(extra.get("next_step", latest))

    def _deadline(self) -> Optional[float]:
        times = self.stats.step_times[-self.cfg.straggler_window:]
        if len(times) < 5:
            return None
        med = sorted(times)[len(times) // 2]
        return self.cfg.straggler_factor * med

    def run(self, state: Any, batches: Callable[[int], Any], n_steps: int,
            start_step: int = 0, on_metrics: Optional[Callable] = None):
        """Run steps [start_step, n_steps) with checkpoint/restart/watchdog."""
        step = start_step
        while step < n_steps:
            batch = batches(step)
            t0 = time.perf_counter()
            attempt = 0
            while True:
                try:
                    if self.inject_failure and self.inject_failure(step):
                        raise RuntimeError(f"injected failure at step {step}")
                    state, metrics = self.step_fn(state, batch)
                    _sync()
                    break
                except Exception as e:  # transient failure path
                    attempt += 1
                    self.stats.retries += 1
                    log.warning("step %d failed (%s), retry %d", step, e,
                                attempt)
                    if attempt > self.cfg.max_retries:
                        # hard failure: resume from the latest checkpoint
                        latest = self.ckpt.latest_step()
                        if latest is None:
                            raise
                        state, extra = self.ckpt.restore(latest, state)
                        self.stats.restores += 1
                        step = int(extra.get("next_step", latest))
                        batch = batches(step)
                        attempt = 0
            dt = time.perf_counter() - t0
            deadline = self._deadline()
            evict = False
            if deadline is not None and dt > deadline:
                self.stats.straggler_events += 1
                self._slow_streak += 1
                log.warning("straggler: step %d took %.3fs (deadline %.3fs)",
                            step, dt, deadline)
                evict = self._slow_streak >= self.cfg.straggler_patience
            else:
                self._slow_streak = 0
            if self.agree is not None:
                evict = self.agree(evict)
            if evict:
                log.warning("straggler streak -- checkpointing for "
                            "eviction/reschedule")
                self.ckpt.save(step, state, {"next_step": step + 1})
                self._slow_streak = 0
            self.stats.step_times.append(dt)
            if on_metrics:
                on_metrics(step, metrics, dt)
            step += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, state, {"next_step": step})
        self.ckpt.save(n_steps, state, {"next_step": n_steps})
        self.ckpt.wait()
        return state
