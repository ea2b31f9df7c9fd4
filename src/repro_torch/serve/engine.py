"""Continuous-batching LM serving engine over the paged KV-cache pool.

Port of ``repro/serve/engine.py`` for attention decoders.  One scheduler
iteration admits queued requests while slots and blocks are free, runs ONE
prompt chunk for the oldest mid-prefill request, then ONE decode step over
the whole slot set.  Chunked prefill interleaves with decode, and a request
that finishes frees its slot and blocks at once, so queued requests join
mid-flight.

The decode step takes fixed-shape (tokens, pos, active, block_tables,
ring_cap) tensors, so batch churn changes contents only.  On the card every
quantized projection runs the fused RHT + dequant GEMM kernel (with
``fused=False`` the RHT kernel, then the unfused GEMM kernel) and every
decode attention read the paged flash-decode kernel; on the CPU their plain
versions run.

Not ported yet (ROADMAP Queue 1): the prefix cache with copy-on-write and
preemption/cancel (item 8), speculative decoding (item 10) and tensor
parallelism (item 13).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.models import decode as decmod
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported

from .pool import BlockAllocator, PoolConfig, init_pool_caches, request_blocks


@dataclasses.dataclass
class Request:
    """One generation request, admissible as soon as it is submitted
    (timed arrivals come with the front door, ROADMAP Queue 1)."""
    rid: int
    prompt: np.ndarray               # (plen,) int32
    max_new: int
    eos: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    """Completion record: generated tokens plus admission / first-token /
    completion timestamps (engine-clock seconds; every request arrives at
    0, so ``t_first`` is its time to first token, queueing included)."""
    rid: int
    tokens: np.ndarray
    t_admit: float
    t_first: float
    t_done: float


@dataclasses.dataclass
class _InFlight:
    req: Request
    slot: int
    blocks: list
    bt_row: np.ndarray               # (MB,) int32 physical block ids
    ring_cap: int                    # tokens
    served: np.ndarray               # prompt tokens fed
    filled: int = 0                  # prompt tokens prefilled so far
    out: list = dataclasses.field(default_factory=list)
    t_admit: float = 0.0
    t_first: float = 0.0

    @property
    def n_done(self) -> int:
        return len(self.out)


class PagedServer:
    """Continuous-batching engine over the paged KV pool; greedy or
    temperature sampling.  Runs on ``device`` (CUDA unless ``"cpu"``);
    ``params`` must already live there (see ``bridge.py`` or
    ``models.transformer.init_params``).  ``fused`` selects the RHT + GEMM
    fusion for every step of this engine (``qops.fusion``; False runs the
    unfused A/B pair).  Construct once per (model, PoolConfig); ``run``
    drains a workload to completion."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 pool: PoolConfig | None = None, *, fused: bool = True,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.fused = fused
        check_supported(cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.pool = pool or PoolConfig()
        self.temperature = temperature
        self.seed = seed
        self.caches = init_pool_caches(cfg, self.pool, self.device)
        self.allocator = BlockAllocator(self.pool.resolved_num_blocks(cfg))
        self.free_slots = list(range(self.pool.max_slots - 1, -1, -1))
        self.table_width = max(
            request_blocks(cfg, self.pool, self.pool.max_context), 1)
        self.stats: dict = {}
        self._pending: collections.deque[Request] = collections.deque()
        self._prefilling: collections.deque[_InFlight] = collections.deque()
        self._active: dict[int, _InFlight] = {}
        self._t0: float | None = None

    # ------------------------------------------------------------- plumbing

    def _sample(self, logits: np.ndarray, rid: int, step: int) -> int:
        """One token from ``logits``: greedy argmax at temperature 0, else
        Gumbel-max sampling with a per-(request, step) deterministic RNG."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        rng = np.random.default_rng((self.seed, rid, step))
        g = rng.gumbel(size=logits.shape)
        return int(np.argmax(logits / self.temperature + g))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _add_stat(self, key: str, value) -> None:
        self.stats[key] = self.stats.get(key, 0) + value

    # ------------------------------------------------------------ lifecycle

    def now(self) -> float:
        """Seconds since the engine clock started (starts it if needed)."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def validate(self, req: Request) -> None:
        """Raise ValueError unless the request can ever be served by this
        pool: non-empty prompt, at least one generated token, and a total
        footprint that fits ``max_context`` and the block arena."""
        if len(req.prompt) < 1 or req.max_new < 1:
            raise ValueError(
                f"request {req.rid}: needs a non-empty prompt and "
                f"max_new >= 1 (got {len(req.prompt)}, {req.max_new})")
        total = len(req.prompt) + req.max_new
        if total > self.pool.max_context:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {total} exceeds "
                f"max_context = {self.pool.max_context}")
        need = request_blocks(self.cfg, self.pool, total)
        if need > self.allocator.num_blocks - 1:
            raise ValueError(
                f"request {req.rid}: needs {need} blocks, pool has "
                f"{self.allocator.num_blocks - 1}")

    def submit(self, req: Request) -> None:
        """Queue a request for admission."""
        self.validate(req)
        self._pending.append(req)

    def can_admit(self, req: Request) -> bool:
        """Whether admitting ``req`` now would succeed: a free slot and
        enough free blocks for its full capacity."""
        if not self.free_slots:
            return False
        need = request_blocks(self.cfg, self.pool,
                              len(req.prompt) + req.max_new)
        return need <= self.allocator.free_blocks

    def _try_admit(self, now: float) -> None:
        # FIFO with head-of-line blocking on a slot and the request's blocks
        while self._pending:
            req = self._pending[0]
            if not self.free_slots:
                return
            need = request_blocks(self.cfg, self.pool,
                                  len(req.prompt) + req.max_new)
            blocks = self.allocator.alloc(need)
            if blocks is None:
                return
            self._pending.popleft()
            slot = self.free_slots.pop()
            bt_row = np.zeros(self.table_width, np.int32)
            bt_row[:need] = blocks
            ring_cap = len(blocks) * self.pool.block_size if blocks else 1
            self._prefilling.append(_InFlight(
                req=req, slot=slot, blocks=blocks, bt_row=bt_row,
                ring_cap=ring_cap, served=np.asarray(req.prompt, np.int32),
                t_admit=now))

    def _emit(self, st: _InFlight, tok: int, now: float) -> None:
        """One token leaves the engine: record it, and stamp the first
        token's time."""
        st.out.append(int(tok))
        if st.t_first == 0.0:
            st.t_first = now

    def _finish(self, st: _InFlight, now: float,
                results: dict[int, RequestResult]) -> None:
        self.allocator.free(list(reversed(st.blocks)))
        self.free_slots.append(st.slot)
        del self._active[st.slot]
        results[st.req.rid] = RequestResult(
            rid=st.req.rid, tokens=np.asarray(st.out, np.int32),
            t_admit=st.t_admit, t_first=st.t_first, t_done=now)

    def _done(self, st: _InFlight, tok: int) -> bool:
        return st.n_done >= st.req.max_new or tok == st.req.eos

    def _prefill_one(self, t0: float,
                     results: dict[int, RequestResult]) -> None:
        st = self._prefilling[0]
        plen = len(st.served)
        c = min(self.pool.prefill_chunk, plen - st.filled, st.ring_cap)
        toks = self._tensor(st.served[st.filled:st.filled + c])[None]
        t_start = time.monotonic()
        logits, self.caches = decmod.prefill_chunk_paged(
            self.cfg, self.params, self.caches, toks, st.filled,
            self._tensor(st.bt_row), st.ring_cap)
        logits = logits.to(torch.float32).cpu().numpy()  # waits for the chunk
        self._add_stat("prefill_s", time.monotonic() - t_start)
        st.filled += c
        self._add_stat("prefill_chunks", 1)
        self._add_stat("prefill_tokens", c)
        if st.filled == plen:
            self._prefilling.popleft()
            self._active[st.slot] = st
            tok = self._sample(logits[0], st.req.rid, st.n_done)
            now = time.monotonic() - t0
            self._emit(st, tok, now)
            if self._done(st, tok):
                self._finish(st, now, results)

    def _decode_once(self, t0: float,
                     results: dict[int, RequestResult]) -> None:
        s = self.pool.max_slots
        tokens = np.zeros((s, 1), np.int32)
        pos = np.zeros(s, np.int32)
        active = np.zeros(s, bool)
        bts = np.zeros((s, self.table_width), np.int32)
        ring = np.ones(s, np.int32)
        for slot, st in self._active.items():
            tokens[slot, 0] = st.out[-1]
            pos[slot] = len(st.served) + len(st.out) - 1
            active[slot] = True
            bts[slot] = st.bt_row
            ring[slot] = st.ring_cap
        t_start = time.monotonic()
        logits, self.caches = decmod.decode_step_paged(
            self.cfg, self.params, self.caches, self._tensor(tokens),
            self._tensor(pos), self._tensor(active), self._tensor(bts),
            self._tensor(ring))
        logits = logits.to(torch.float32).cpu().numpy()  # waits for the step
        self._add_stat("decode_s", time.monotonic() - t_start)
        now = time.monotonic() - t0
        self._add_stat("decode_steps", 1)
        self.stats.setdefault("occupancy", []).append(
            len(self._active) / self.pool.max_slots)
        for slot in list(self._active):
            st = self._active[slot]
            tok = self._sample(logits[slot], st.req.rid, st.n_done)
            self._emit(st, tok, now)
            if self._done(st, tok):
                self._finish(st, now, results)

    # ------------------------------------------------------------------ run

    def poll(self) -> bool:
        """Whether the engine has outstanding work."""
        return bool(self._pending or self._prefilling or self._active)

    def step(self) -> dict[int, RequestResult]:
        """ONE scheduler iteration: admit queued requests, run one prompt
        chunk, then one decode step over the slot set.  Returns the
        requests that finished during this call."""
        results: dict[int, RequestResult] = {}
        self._try_admit(self.now())
        with qops.fusion(self.fused):
            if self._prefilling:
                self._prefill_one(self._t0, results)
            if self._active:
                self._decode_once(self._t0, results)
        return results

    def finalize_stats(self) -> dict:
        """Fold per-step counters into summary numbers; returns ``stats``."""
        occ = self.stats.get("occupancy", [])
        self.stats["mean_occupancy"] = float(np.mean(occ)) if occ else 0.0
        return self.stats

    def run(self, requests: list[Request] | None = None
            ) -> dict[int, RequestResult]:
        """Serve until every submitted request completes.  Returns
        rid -> RequestResult; aggregate stats land in ``self.stats``."""
        for r in requests or []:
            self.submit(r)
        results: dict[int, RequestResult] = {}
        self._t0 = time.monotonic()       # each run() restarts the clock
        while self.poll():
            results.update(self.step())
        self.finalize_stats()
        return results
