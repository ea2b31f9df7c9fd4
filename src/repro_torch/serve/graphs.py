"""Compile-once serving steps: the port's counterpart of the reference's
``jax.jit`` of ``_step``, ``_chunk``, ``_cow`` and the speculative
``_draft_step``, ``_catchup`` and ``_verify``
(``repro/serve/engine.py:338-371``).

``StepGraphs`` keeps one ``Step`` per key: a step function over static
input buffers.  On the card the step is captured once as a CUDA graph, and
every later call copies its inputs into the static buffers and replays the
graph; the kernel wrappers' host checks and allocations then run at capture
only.  On the CPU nothing is captured: the step runs eagerly over the same
buffers, but it is keyed, warmed up and counted exactly as on the card, so
the CPU tests hold the keying and the warm-up.

What a capture needs, and what this module does about it:

  * Static shapes and no host reads.  The engine keys each step by what
    fixes its shapes and code path (decode and the draft's decode: the
    fusion setting and the slot count; the draft's catch-up: the same; the
    verify step: the same and its span k + 1; a prompt chunk, the target's
    or the draft's: the fusion setting and its length; the copy-on-write
    clone: nothing), and ``models/decode.py`` takes only tensors, reads
    nothing back to the host, and updates the arenas in place.
  * Arenas written in place, never rebound.  Every graph reads and writes
    the arena tensors it was captured on, so the copy-on-write clone
    (``clone_block``) copies into them with ``index_copy_``, over the
    target's and the draft's arenas in one capture when speculating.  The
    reference's functional ``.at[].set`` rebinds its caches; a port that
    rebound ``engine.caches`` (or wrote ``arena[dst]`` through a tensor
    index, which copies into a temporary) would leave every captured graph
    reading stale storage, and no CPU run would show it.
  * Inputs through static buffers.  Each input has a static device buffer
    and a pinned host copy; a call writes the host copy (after the previous
    call's copies have finished) and copies it in on the current stream.
    The output is the static tensor the graph rewrites on every replay.
  * One memory pool (``torch.cuda.graph_pool_handle()``) for all of an
    engine's graphs, since they replay one at a time on one stream: 64
    chunk lengths do not cost 64 pools.
  * A warm-up before capture, eagerly on a side stream: it loads the kernel
    libraries and makes each kernel's one-time ``cudaFuncSetAttribute``
    opt-in and cuBLAS's lazy set-up, none of which belongs in a graph.
  * Inert inputs.  Warm-up and capture see the inputs the engine calls
    inert (inactive slots, a block table of the null block 0, a chunk
    marked inactive), so the warm-up writes the null block only and leaves
    every per-slot MLA and recurrent row as it was: a chunk is first
    captured while other requests' rows are live.  A warm-up on real
    inputs would not be idempotent: a prompt chunk whose window ring wraps
    would write its K/V over ring slots the real chunk then reads as
    history.
  * Launch counters.  A capture records launches without running them and
    a replay runs them without the wrappers, so the counters are restored
    after warm-up and capture, and each replay credits the launches its
    capture recorded (``kernels.credit_launches``).  A graph run and an
    eager run of the same requests count the same.
  * No garbage collection during a capture.  Destroying another graph (an
    engine that only the cycle collector frees, its graphs with it) is not
    permitted while a stream captures, and invalidates the capture; the
    collector is paused for the capture's length.
  * A failed capture raises.  Nothing falls back to eager.

``eager()`` is the one scoped switch under which the engine runs its steps
op by op on the card, the port's ``jax.disable_jit()``.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import kernels

_EAGER: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_eager_steps", default=False)


@contextlib.contextmanager
def eager(enabled: bool = True):
    """Scoped switch: engine steps run op by op, captured nothing (the
    port's ``jax.disable_jit()``).  Nests and unwinds."""
    token = _EAGER.set(bool(enabled))
    try:
        yield
    finally:
        _EAGER.reset(token)


def eager_enabled() -> bool:
    """The innermost enclosing ``eager`` setting (off when none)."""
    return _EAGER.get()


@contextlib.contextmanager
def _no_gc():
    """Pause the cycle collector (``torch.cuda.graph`` collects on entry)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def clone_block(caches: list, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy physical block ``src`` into block ``dst`` in every layer's K
    and V arena, in place (the reference's ``_cow_core``).  ``src`` and
    ``dst`` are one-element int64 tensors, so one capture serves every
    pair of blocks.  Per-slot MLA and recurrent rows hold no blocks (and
    their archs bypass the prefix cache, the clone's one caller)."""
    for cache in caches:
        for key in ("k", "v"):
            if key in cache:
                cache[key].index_copy_(0, dst, cache[key].index_select(0, src))


class Step:
    """``fn(**inputs)`` over static input buffers, captured as a CUDA graph
    on the card (``graph``), run eagerly on the CPU.  ``fn`` returns a
    tensor (a step's logits) or None (the clone, which only writes)."""

    def __init__(self, fn: Callable[..., torch.Tensor],
                 inert: dict[str, np.ndarray], device: torch.device,
                 pool=None, side: torch.cuda.Stream | None = None):
        self.fn = fn
        self.static = {k: torch.from_numpy(np.array(a)).to(device)
                       for k, a in inert.items()}
        on_card = device.type == "cuda"
        self._host = ({k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for k, t in self.static.items()} if on_card else None)
        self._copied = torch.cuda.Event() if on_card else None
        self.graph = None
        self.out = None
        self.launches: dict[str, int] = {}    # per replay
        self.pool_bytes = 0                   # the pool's growth at capture
        before = kernels.launch_counts()
        try:
            if on_card:
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    fn(**self.static)
                torch.cuda.current_stream(device).wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                with _no_gc(), torch.cuda.graph(self.graph, pool=pool):
                    reserved = torch.cuda.memory_reserved(device)
                    at_capture = kernels.launch_counts()
                    self.out = fn(**self.static)
                    self.launches = kernels.launches_since(at_capture)
                self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            else:
                fn(**self.static)
        finally:
            kernels.set_launch_counts(before)

    def __call__(self, inputs: dict) -> torch.Tensor:
        """Run the step on ``inputs``, shaped as the inert ones: host arrays,
        or tensors already on the step's device (copied on the stream, so a
        token chosen on the card never visits the host).  On the card the
        result is the static output, rewritten by the next call."""
        if self.graph is None:
            for k, a in inputs.items():
                if isinstance(a, torch.Tensor):
                    self.static[k].copy_(a)
                else:
                    self.static[k].numpy()[...] = a
            return self.fn(**self.static)
        self._copied.synchronize()        # the host copies are free again
        for k, a in inputs.items():
            if isinstance(a, torch.Tensor):
                self.static[k].copy_(a)
                continue
            self._host[k].numpy()[...] = a
            self.static[k].copy_(self._host[k], non_blocking=True)
        self._copied.record()
        self.graph.replay()
        kernels.credit_launches(self.launches)
        return self.out


def eager_call(fn: Callable[..., torch.Tensor], device: torch.device):
    """``inputs -> fn(**inputs)`` op by op on fresh tensors (host arrays
    copied to ``device``, tensors as they are): the uncaptured twin of a
    ``Step``, for ``eager()`` and for runs with a kernel forced onto its
    plain version."""
    def call(inputs: dict) -> torch.Tensor:
        return fn(**{k: a if isinstance(a, torch.Tensor)
                     else torch.tensor(a, device=device)
                     for k, a in inputs.items()})
    return call


class StepGraphs:
    """An engine's steps by key (``key[0]`` names the kind: "decode",
    "chunk", "cow", "catchup", "draft", "verify" or "draft_chunk"; the
    lockstep server's "lockstep"), made at first use; ``captures`` counts
    them by kind and ``capture_s`` the host seconds spent warming up and
    capturing."""

    def __init__(self, device: torch.device):
        self.device = device
        on_card = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self._side = torch.cuda.Stream(device) if on_card else None
        self.steps: dict[tuple, Step] = {}
        self.captures: collections.Counter = collections.Counter()
        self.capture_s = 0.0

    def get(self, key: tuple, fn: Callable[..., torch.Tensor],
            inert: Callable[[], dict[str, np.ndarray]]) -> Step:
        """The step for ``key``, warmed up and captured on ``inert()``'s
        inputs the first time ``key`` is asked for."""
        step = self.steps.get(key)
        if step is None:
            t0 = time.monotonic()
            step = Step(fn, inert(), self.device, self.pool, self._side)
            self.capture_s += time.monotonic() - t0
            self.steps[key] = step
            self.captures[key[0]] += 1
        return step

    @property
    def pool_bytes(self) -> int:
        """Device memory the captures added to the shared pool."""
        return sum(s.pool_bytes for s in self.steps.values())
