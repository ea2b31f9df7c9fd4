"""Continuous-batching LM serving engine over the paged KV-cache pool.

Port of ``repro/serve/engine.py`` for attention decoders with dense or
MoE FFNs; a sliding-window model's requests hold at most a window of
blocks and reuse them as a ring.  One scheduler
iteration admits queued requests while slots and blocks are free, runs ONE
prompt chunk for the oldest mid-prefill request, then ONE decode step over
the whole slot set.  Chunked prefill interleaves with decode, and a request
that finishes frees its slot and blocks at once, so queued requests join
mid-flight.

The decode step takes fixed-shape (tokens, pos, active, block_tables,
ring_cap) tensors, so batch churn changes contents only; a prompt chunk's
shapes depend on its length alone.  On the card every quantized projection
runs the fused RHT + dequant GEMM kernel (with ``fused=False`` the RHT
kernel, then the unfused GEMM kernel) and every decode attention read the
paged flash-decode kernel; on the CPU their plain versions run.

Compile once, as the reference jits ``_step``, ``_chunk`` and ``_cow``: on
the card each step is captured as a CUDA graph the first time its key is
seen and replayed after (``serve/graphs.py``).  A decode step is keyed by
(fusion setting, slot count), a prompt chunk by (fusion setting, chunk
length); ``decode_trace_count``, ``chunk_trace_count`` and
``cow_trace_count`` count the captures.  The engine captures only when it
runs on the card and no kernel is forced onto its plain version
(``set_forced_path("ref")``: the plain paged attention reads its block
count back to the host, which a capture cannot hold); under
``graphs.eager()`` it runs every step op by op.  On the CPU the same steps
run eagerly over their static buffers, keyed and counted as on the card.

Admission consults the content-addressed prefix cache: the longest cached
prefix of the prompt is served from the pool (refcounts bumped, chunked
prefill starts at the first uncached token, a mid-block match is cloned
copy-on-write by one captured clone, keyed ``("cow",)``), and completed
requests release their blocks; fully written blocks stay cached on an LRU
that is evicted only under allocation pressure.  Pure-attention archs
without a window only: a window's ring blocks mutate in place, so Mixtral
bypasses the cache.  ``preempt`` drops a request's blocks (registered
first, so its replay walks them as hits) and keeps its emitted tokens to
re-feed as prompt when it is resubmitted; ``cancel`` aborts a request
wherever it is.

Self-speculative decoding: with ``draft_params`` (a low-bit quantization of
the same weights, ``core.pipeline.quantize_model_dual``) and
``speculate=k``, each decode turn is one round: a W = 2 catch-up step of
the draft (positions p - 1 and p; the write at p - 1 is masked unless the
slot has a hole, so shared prefix-cache blocks stay untouched), k - 1
single-token draft steps, then one W = k + 1 verify step of the target
(``decode_verify_paged``), and the acceptance rule on the host
(``speculative_accept``), emitting 1 to k + 1 tokens per slot.  The draft
has its own KV arena under the same block tables (prefilled in the same
chunks), and the pool reserves ``lookahead = k`` ring tokens per request.
Greedy speculation gives the tokens of plain decoding.  On the card the
catch-up, draft, verify and draft-chunk steps are captured like the
others, keyed ``("catchup", fused, S)``, ``("draft", fused, S)``,
``("verify", fused, S, k + 1)`` and ``("draft_chunk", fused, C)``, and the
copy-on-write clone copies the block in both arenas.

Not ported yet (ROADMAP Queue 1): tensor parallelism (item 8) and what
only the front door reads (item 9).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.models import decode as decmod
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported

from . import graphs
from .pool import (BlockAllocator, PoolConfig, PrefixCache, init_pool_caches,
                   request_blocks)


def _logits(step_fn, cfg: ModelConfig, params: dict, caches: list,
            **inputs) -> torch.Tensor:
    return step_fn(cfg, params, caches, **inputs)[0]


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is seconds after the engine
    clock's start; the engine does not admit the request earlier.  (The
    front door's scheduling metadata comes with ROADMAP Queue 1 item 9.)"""
    rid: int
    prompt: np.ndarray               # (plen,) int32
    max_new: int
    eos: Optional[int] = None
    arrival: float = 0.0


@dataclasses.dataclass
class RequestResult:
    """Completion record: generated tokens plus admission / first-token /
    completion timestamps (engine-clock seconds).  ``ttft_s`` is the time
    to first token from the request's arrival (queueing included),
    ``token_times`` the emission time of every generated token, and
    ``preemptions`` how often the request was preempted and replayed (its
    timestamps span incarnations: ``t_admit`` / ``t_first`` from the first,
    ``t_done`` from the last)."""
    rid: int
    tokens: np.ndarray
    t_admit: float
    t_first: float
    t_done: float
    ttft_s: float = 0.0
    token_times: Optional[np.ndarray] = None
    preemptions: int = 0


@dataclasses.dataclass
class _Replay:
    """Continuation of a preempted request, kept by rid until it is
    resubmitted: the tokens already emitted (re-fed as extra prompt) and
    the first incarnation's timestamps."""
    prior: list
    t_admit: float
    t_first: float
    token_times: list
    preemptions: int


@dataclasses.dataclass
class _InFlight:
    req: Request
    slot: int
    blocks: list
    bt_row: np.ndarray               # (MB,) int32 physical block ids
    ring_cap: int                    # tokens
    served: np.ndarray               # prompt + replayed tokens fed
    filled: int = 0                  # served tokens prefilled so far
    out: list = dataclasses.field(default_factory=list)
    prior: list = dataclasses.field(default_factory=list)  # pre-preemption
    token_times: list = dataclasses.field(default_factory=list)
    preemptions: int = 0
    t_admit: float = 0.0
    t_first: float = 0.0
    chain: object = None             # prefix-cache hash of last full block
    n_hashed: int = 0                # full blocks matched/registered so far
    draft_pos: int = 0               # positions with valid draft K/V

    @property
    def n_done(self) -> int:
        """Tokens emitted across all incarnations (the sampling step
        index, so a replay samples as the uninterrupted run would)."""
        return len(self.prior) + len(self.out)


def speculative_accept(target_logits: np.ndarray, draft_logits: np.ndarray,
                       draft_tokens: np.ndarray, temperature: float,
                       rng: np.random.Generator | None):
    """The speculative-sampling acceptance rule for one slot's round.

    ``target_logits`` (k+1, V) are the target's logits at the k + 1
    verified positions, ``draft_logits`` (k, V) those each
    ``draft_tokens[i]`` was sampled from.  Greedy (``temperature <= 0``):
    accept d_i while it equals the target's argmax, emit the argmax at the
    first mismatch, or the bonus argmax after k accepts, so every emitted
    token is a target argmax.  Sampling: accept d_i with probability
    min(1, p_t(d_i) / p_d(d_i)), on rejection sample the residual
    normalize(max(p_t - p_d, 0)), after k accepts sample the bonus from the
    target's last distribution; the emitted tokens are distributed as
    target-only sampling (Leviathan et al., 2023).  Returns ``(tokens,
    n_accepted)`` with ``len(tokens) == n_accepted + 1``."""
    k = len(draft_tokens)
    out: list[int] = []
    if temperature <= 0.0:
        for i in range(k):
            t_star = int(np.argmax(target_logits[i]))
            out.append(t_star)
            if int(draft_tokens[i]) != t_star:
                return out, i
        out.append(int(np.argmax(target_logits[k])))
        return out, k

    def dist(logits):
        z = logits.astype(np.float64) / temperature
        e = np.exp(z - z.max())
        return e / e.sum()

    for i in range(k):
        p_t, p_d = dist(target_logits[i]), dist(draft_logits[i])
        d = int(draft_tokens[i])
        if rng.random() < min(1.0, p_t[d] / max(p_d[d], 1e-300)):
            out.append(d)
            continue
        resid = np.maximum(p_t - p_d, 0.0)
        s = resid.sum()
        p = resid / s if s > 0.0 else p_t
        out.append(int(rng.choice(p.size, p=p)))
        return out, i
    p_t = dist(target_logits[k])
    out.append(int(rng.choice(p_t.size, p=p_t)))
    return out, k


class PagedServer:
    """Continuous-batching engine over the paged KV pool; greedy or
    temperature sampling.  Runs on ``device`` (CUDA unless ``"cpu"``);
    ``params`` must already live there (see ``bridge.py`` or
    ``models.transformer.init_params``).  ``fused`` selects the RHT + GEMM
    fusion for every step of this engine (``qops.fusion``; False runs the
    unfused A/B pair).  ``draft_params`` + ``speculate=k`` turn on
    self-speculative decoding (the module docstring); ``draft_params`` lives
    on ``device`` too.  Construct once per (model, PoolConfig); ``run``
    drains a workload to completion.  Each step is captured once per key
    and replayed (see the module docstring).  ``prefix_cache`` is the
    engine's ``PrefixCache``, or None where the pool turns it off or the
    arch bypasses it."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 pool: PoolConfig | None = None, *, fused: bool = True,
                 temperature: float = 0.0, seed: int = 0,
                 draft_params: dict | None = None, speculate: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.fused = fused
        check_supported(cfg)
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0 (got {speculate})")
        if speculate and draft_params is None:
            raise ValueError("speculate > 0 requires draft_params "
                             "(see core.pipeline.quantize_model_dual)")
        for what, p in (("params", params), ("draft_params", draft_params)):
            if p is not None and p["embed"].device != self.device:
                raise ValueError(f"{what} live on {p['embed'].device}, the "
                                 f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.pool = pool or PoolConfig()
        self.temperature = temperature
        self.seed = seed
        # rejected tokens are overwritten by position, which attention K/V
        # allows; the reference's bypass for sequential per-slot state has
        # nothing to bypass here (check_supported admits attention only)
        self.speculating = bool(speculate)
        self.speculate = speculate
        self.draft_params = draft_params if self.speculating else None
        if self.speculating and self.pool.lookahead < speculate:
            # verify writes reach k positions past the accepted frontier
            self.pool = dataclasses.replace(self.pool, lookahead=speculate)
        self.caches = init_pool_caches(cfg, self.pool, self.device)
        # the draft's own arenas, under the same block tables
        self.draft_caches = (init_pool_caches(cfg, self.pool, self.device)
                             if self.speculating else None)
        # the cache needs blocks that are immutable once written: a window's
        # ring reuses its blocks in place, so windowed archs bypass it
        self.cacheable = (self.pool.prefix_cache and cfg.window is None
                          and all(mx == "attn" for mx in cfg.pattern))
        self.prefix_cache = (PrefixCache(self.pool.block_size)
                             if self.cacheable else None)
        self.allocator = BlockAllocator(self.pool.resolved_num_blocks(cfg),
                                        cache=self.prefix_cache)
        self.free_slots = list(range(self.pool.max_slots - 1, -1, -1))
        self.table_width = max(
            request_blocks(cfg, self.pool, self.pool.max_context), 1)
        self.graphs = graphs.StepGraphs(self.device)
        self.stats: dict = {}
        self._pending: collections.deque[Request] = collections.deque()
        self._prefilling: collections.deque[_InFlight] = collections.deque()
        self._active: dict[int, _InFlight] = {}
        self._replay: dict[int, _Replay] = {}
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

    @property
    def decode_trace_count(self) -> int:
        """Decode-step captures (the reference's count of ``_step`` traces)."""
        return self.graphs.captures["decode"]

    @property
    def chunk_trace_count(self) -> int:
        """Prompt-chunk captures: one per chunk length and fusion setting."""
        return self.graphs.captures["chunk"]

    @property
    def cow_trace_count(self) -> int:
        """Copy-on-write clone captures: at most one per engine."""
        return self.graphs.captures["cow"]

    @property
    def catchup_trace_count(self) -> int:
        """Draft catch-up (W = 2) captures."""
        return self.graphs.captures["catchup"]

    @property
    def draft_trace_count(self) -> int:
        """Single-token draft step captures."""
        return self.graphs.captures["draft"]

    @property
    def verify_trace_count(self) -> int:
        """Target verify (W = k + 1) captures."""
        return self.graphs.captures["verify"]

    @property
    def draft_chunk_trace_count(self) -> int:
        """Draft prompt-chunk captures: one per chunk length."""
        return self.graphs.captures["draft_chunk"]

    def _compiled(self, key: tuple, fn, inert):
        """``inputs -> fn(**inputs)``: the step captured for ``key`` (made
        on ``inert()``'s inputs at first use), or under ``graphs.eager()``
        and with a kernel forced onto its plain version on the card, ``fn``
        op by op on fresh tensors.  ``fn`` holds the model and the arenas,
        not the engine, so an engine and its graphs are freed when it is
        dropped."""
        if graphs.eager_enabled() or (self.device.type == "cuda"
                                      and kernels.plain_forced()):
            return lambda inputs: fn(**{k: self._tensor(a)
                                        for k, a in inputs.items()})
        return self.graphs.get(key, fn, inert)

    def _step_fn(self, step_fn, draft: bool = False):
        """``step_fn`` (a ``decmod`` step) on this engine's target model and
        arenas, or with ``draft`` on the draft's, returning the logits."""
        if draft:
            return functools.partial(_logits, step_fn, self.cfg,
                                     self.draft_params, self.draft_caches)
        return functools.partial(_logits, step_fn, self.cfg, self.params,
                                 self.caches)

    def _cow(self, src: int, dst: int) -> None:
        """Clone physical block ``src`` into ``dst`` in every layer's arena,
        the draft's too (the reference's jitted ``_cow``): one captured
        clone, its blocks through static one-element buffers."""
        arenas = self.caches + (self.draft_caches or [])
        clone = self._compiled(
            ("cow",), functools.partial(graphs.clone_block, arenas),
            lambda: {"src": np.zeros(1, np.int64),
                     "dst": np.zeros(1, np.int64)})
        clone({"src": np.array([src], np.int64),
               "dst": np.array([dst], np.int64)})

    def _chunk_inputs(self, tokens: np.ndarray, pos0: int, bt_row: np.ndarray,
                      ring_cap: int) -> dict:
        return {"tokens": tokens[None], "pos0": np.int32(pos0),
                "bt_row": bt_row, "ring_cap": np.int32(ring_cap)}

    def _decode_inputs(self, active: dict) -> dict:
        """The decode step's inputs for the slots in ``active``; with none,
        the inert inputs (every slot inactive, tables on the null block)."""
        s = self.pool.max_slots
        arrays = {"tokens": np.zeros((s, 1), np.int32),
                  "pos": np.zeros(s, np.int32), "active": np.zeros(s, bool),
                  "block_tables": np.zeros((s, self.table_width), np.int32),
                  "ring_cap": np.ones(s, np.int32)}
        for slot, st in active.items():
            arrays["tokens"][slot, 0] = st.out[-1]
            arrays["pos"][slot] = len(st.served) + len(st.out) - 1
            arrays["active"][slot] = True
            arrays["block_tables"][slot] = st.bt_row
            arrays["ring_cap"][slot] = st.ring_cap
        return arrays

    def _add_stat(self, key: str, value) -> None:
        self.stats[key] = self.stats.get(key, 0) + value

    # ------------------------------------------------------------ lifecycle

    def start_clock(self, reset: bool = False) -> None:
        """Pin the engine clock's zero (idempotent unless ``reset``).
        ``run`` resets it per call; a caller that steps the engine itself
        pins it once, before the first ``Request.arrival`` counts."""
        if reset or self._t0 is None:
            self._t0 = time.monotonic()

    def now(self) -> float:
        """Seconds since the engine clock started (starts it if needed): the
        time base of ``Request.arrival`` and every result timestamp."""
        self.start_clock()
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
        """Queue a request for admission (not before ``req.arrival``); a
        preempted request's resubmission resumes its replay."""
        self.validate(req)
        self._pending.append(req)

    def can_admit(self, req: Request) -> bool:
        """Whether admitting ``req`` now would succeed: a free slot and
        enough allocatable blocks for its full capacity.  Conservative:
        prefix hits only lower the fresh-block need."""
        if not self.free_slots:
            return False
        need = request_blocks(self.cfg, self.pool,
                              len(req.prompt) + req.max_new)
        return need <= self.allocator.free_blocks

    def _try_admit(self, now: float) -> None:
        # FIFO with head-of-line blocking on a slot and the request's blocks
        while self._pending and self._pending[0].arrival <= now:
            req = self._pending[0]
            if not self.free_slots:
                return
            # a replayed (preempted) request re-feeds its emitted tokens as
            # extra prompt; its footprint is unchanged (prompt + max_new
            # counts every token once)
            rp = self._replay.get(req.rid)
            served = np.asarray(req.prompt, np.int32)
            if rp and rp.prior:
                served = np.concatenate([served,
                                         np.asarray(rp.prior, np.int32)])
            need = request_blocks(self.cfg, self.pool,
                                  len(req.prompt) + req.max_new)
            # the longest cached prefix: whole-block hits are shared (incref
            # before alloc, so pressure cannot evict them), a mid-block
            # match is cloned copy-on-write into the first fresh block;
            # capped at plen - 1, so one prompt token is always recomputed
            hits: list[int] = []
            parent, cached, cow_src = None, 0, None
            if self.prefix_cache is not None:
                hits, parent, cached, cow_src = self.prefix_cache.match(
                    served, len(served) - 1)
                for b in hits:
                    self.allocator.incref(b)
                if cow_src is not None:
                    self.allocator.incref(cow_src)
            fresh = self.allocator.alloc(need - len(hits))
            if fresh is None:
                if cow_src is not None:
                    self.allocator.decref(cow_src)
                for b in reversed(hits):      # leaf-first, like _finish
                    self.allocator.decref(b)
                return
            if cow_src is not None:
                # fresh[0] sits at logical index len(hits): where the
                # partially matching block's contents belong
                self._cow(cow_src, fresh[0])
                self.allocator.decref(cow_src)
                self._add_stat("prefix_cow", 1)
            blocks = hits + fresh
            self._pending.popleft()
            self._replay.pop(req.rid, None)
            slot = self.free_slots.pop()
            bt_row = np.zeros(self.table_width, np.int32)
            bt_row[:need] = blocks
            ring_cap = len(blocks) * self.pool.block_size if blocks else 1
            if self.prefix_cache is not None:
                self._add_stat("prompt_tokens", len(served))
                self._add_stat("prefill_tokens_saved", cached)
                if cached:
                    self._add_stat("prefix_hits", 1)
            if rp is not None:
                self._add_stat("replays", 1)
            self._prefilling.append(_InFlight(
                req=req, slot=slot, blocks=blocks, bt_row=bt_row,
                ring_cap=ring_cap, served=served, filled=cached,
                prior=list(rp.prior) if rp else [],
                token_times=list(rp.token_times) if rp else [],
                preemptions=rp.preemptions if rp else 0,
                t_admit=rp.t_admit if rp else now,
                t_first=rp.t_first if rp else 0.0,
                chain=parent, n_hashed=len(hits), draft_pos=cached))

    def _register_blocks(self, st: _InFlight, seq, upto: int) -> None:
        """Register st's fully written blocks covering positions < upto
        (their KV is in the arena) in the prefix cache."""
        bs = self.pool.block_size
        while (st.n_hashed + 1) * bs <= upto:
            k = st.n_hashed
            st.chain = self.prefix_cache.register(
                st.chain, seq[k * bs:(k + 1) * bs], int(st.bt_row[k]))
            st.n_hashed += 1

    def _written(self, st: _InFlight) -> np.ndarray:
        """The tokens whose KV a decoding request has written: its served
        tokens and every emitted one but the newest (never fed back)."""
        return np.concatenate([st.served, np.asarray(st.out[:-1], np.int32)])

    def _emit(self, st: _InFlight, tok: int, now: float) -> None:
        """One token leaves the engine: record it and its emission time,
        and stamp the request's very first token."""
        st.out.append(int(tok))
        st.token_times.append(now)
        if st.t_first == 0.0 and not st.prior:
            st.t_first = now

    def _finish(self, st: _InFlight, now: float,
                results: dict[int, RequestResult]) -> None:
        if self.prefix_cache is not None:
            # generated tokens extend the cached chain too, so a second
            # turn's prompt hits its history
            seq = self._written(st)
            self._register_blocks(st, seq, len(seq))
        # later blocks enter the idle LRU first, so pressure evicts leaves
        # before the prefixes they chain off
        self.allocator.free(list(reversed(st.blocks)))
        self.free_slots.append(st.slot)
        del self._active[st.slot]
        results[st.req.rid] = RequestResult(
            rid=st.req.rid, tokens=np.asarray(st.prior + st.out, np.int32),
            t_admit=st.t_admit, t_first=st.t_first, t_done=now,
            ttft_s=st.t_first - st.req.arrival,
            token_times=np.asarray(st.token_times, np.float64),
            preemptions=st.preemptions)

    def _done(self, st: _InFlight, tok: int) -> bool:
        return st.n_done >= st.req.max_new or tok == st.req.eos

    def _prefill_one(self, t0: float,
                     results: dict[int, RequestResult]) -> None:
        st = self._prefilling[0]
        plen = len(st.served)
        c = min(self.pool.prefill_chunk, plen - st.filled, st.ring_cap)
        step = self._compiled(
            ("chunk", qops.fused_enabled(), c),
            self._step_fn(decmod.prefill_chunk_paged),
            lambda: self._chunk_inputs(np.zeros(c, np.int32), 0,
                                       np.zeros(self.table_width, np.int32), 1))
        inputs = self._chunk_inputs(st.served[st.filled:st.filled + c],
                                    st.filled, st.bt_row, st.ring_cap)
        t_start = time.monotonic()
        logits = step(inputs)
        if self.speculating:
            # the draft's arena holds the prompt too; its logits are unused
            self._compiled(
                ("draft_chunk", qops.fused_enabled(), c),
                self._step_fn(decmod.prefill_chunk_paged, draft=True),
                lambda: self._chunk_inputs(
                    np.zeros(c, np.int32), 0,
                    np.zeros(self.table_width, np.int32), 1))(inputs)
        logits = logits.to(torch.float32).cpu().numpy()  # waits for both
        self._add_stat("prefill_s", time.monotonic() - t_start)
        st.filled += c
        st.draft_pos = st.filled
        self._add_stat("prefill_chunks", 1)
        self._add_stat("prefill_tokens", c)
        if self.prefix_cache is not None:
            # the blocks this chunk completed are fully written: publish
            # them, so requests sharing the prompt hit them at once
            self._register_blocks(st, st.served, st.filled)
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
        step = self._compiled(
            ("decode", qops.fused_enabled(), self.pool.max_slots),
            self._step_fn(decmod.decode_step_paged),
            lambda: self._decode_inputs({}))
        inputs = self._decode_inputs(self._active)
        t_start = time.monotonic()
        logits = step(inputs).to(torch.float32).cpu().numpy()  # waits for it
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

    # ---------------------------------------------------------- speculation

    def _draft_sample(self, logits: np.ndarray, rid: int, step: int,
                      i: int) -> int:
        """Draft proposal i of a round: the argmax, or a sample from
        softmax(logits / T), the distribution the acceptance rule divides
        by."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        rng = np.random.default_rng((self.seed, rid, step, i, 1))
        z = logits.astype(np.float64) / self.temperature
        e = np.exp(z - z.max())
        return int(rng.choice(e.size, p=e / e.sum()))

    def _span_inputs(self, tokens: np.ndarray, pos0: np.ndarray,
                     active: np.ndarray, bts: np.ndarray, ring: np.ndarray,
                     wmask: np.ndarray) -> dict:
        return {"tokens": tokens, "pos0": pos0, "active": active,
                "block_tables": bts, "ring_cap": ring, "write_mask": wmask}

    def _span_inert(self, w: int) -> dict:
        """A W-token span step's inert inputs (every slot inactive)."""
        s = self.pool.max_slots
        return self._span_inputs(
            np.zeros((s, w), np.int32), np.zeros(s, np.int32),
            np.zeros(s, bool), np.zeros((s, self.table_width), np.int32),
            np.ones(s, np.int32), np.zeros((s, w), bool))

    def _spec_decode_once(self, t0: float,
                          results: dict[int, RequestResult]) -> None:
        """One draft-propose / target-verify round over the slot set (the
        reference's ``_spec_decode_once``): the draft's W = 2 catch-up at
        p - 1, p (the write at p - 1 only where a hole is), k - 1 draft
        steps, the target's W = k + 1 verify from p, and acceptance on the
        host per slot."""
        s, k = self.pool.max_slots, self.speculate
        fused = qops.fused_enabled()
        catch = np.zeros((s, 2), np.int32)    # tokens at p - 1, p
        base = self._decode_inputs(self._active)
        pos, active = base["pos"], base["active"]
        bts, ring = base["block_tables"], base["ring_cap"]
        hole = np.zeros(s, bool)
        for slot, st in self._active.items():
            p = int(pos[slot])
            catch[slot, 0] = (st.out[-2] if len(st.out) >= 2
                              else st.served[-1])
            catch[slot, 1] = st.out[-1]
            # after an all-accept round the bonus token's predecessor d_k
            # was never fed to the draft: p - 1 is a hole to fill; else the
            # rewrite is masked, so shared prefix-cache blocks stay as they
            # are
            hole[slot] = st.draft_pos == p - 1
        wmask = np.ones((s, 2), bool)
        wmask[:, 0] = hole
        t_start = time.monotonic()
        catchup = self._compiled(
            ("catchup", fused, s),
            self._step_fn(decmod.decode_verify_paged, draft=True),
            lambda: self._span_inert(2))
        dl = catchup(self._span_inputs(catch, pos - 1, active, bts, ring,
                                       wmask))
        dl = dl[:, 1].to(torch.float32).cpu().numpy()    # logits at p
        draft_logits = np.zeros((s, k) + dl.shape[1:], np.float32)
        draft_tokens = np.zeros((s, k), np.int32)
        toks = np.zeros((s, 1), np.int32)
        for i in range(k):
            draft_logits[:, i] = dl
            for slot, st in self._active.items():
                d = self._draft_sample(dl[slot], st.req.rid, st.n_done, i)
                draft_tokens[slot, i] = d
                toks[slot, 0] = d
            if i < k - 1:
                draft = self._compiled(
                    ("draft", fused, s),
                    self._step_fn(decmod.decode_step_paged, draft=True),
                    lambda: self._decode_inputs({}))
                dl = draft(dict(base, tokens=toks, pos=pos + 1 + i))
                dl = dl.to(torch.float32).cpu().numpy()
        verify = self._compiled(
            ("verify", fused, s, k + 1),
            self._step_fn(decmod.decode_verify_paged),
            lambda: self._span_inert(k + 1))
        tokens = np.concatenate([catch[:, 1:2], draft_tokens], axis=1)
        tlog = verify(self._span_inputs(tokens, pos, active, bts, ring,
                                        np.ones((s, k + 1), bool)))
        tlog = tlog.to(torch.float32).cpu().numpy()      # waits for it
        self._add_stat("spec_s", time.monotonic() - t_start)
        now = time.monotonic() - t0
        self._add_stat("spec_rounds", 1)
        self.stats.setdefault("occupancy", []).append(
            len(self._active) / self.pool.max_slots)
        for slot in list(self._active):
            st = self._active[slot]
            # greedy needs no RNG
            rng = (np.random.default_rng(
                       (self.seed, st.req.rid, st.n_done, 7))
                   if self.temperature > 0.0 else None)
            emitted, n_acc = speculative_accept(
                tlog[slot], draft_logits[slot], draft_tokens[slot],
                self.temperature, rng)
            self._add_stat("spec_proposed", k)
            self._add_stat("spec_accepted", n_acc)
            p = int(pos[slot])
            # the draft's K/V is valid through the last accepted draft
            # position (the replacement or bonus token is never fed to it)
            st.draft_pos = min(p + n_acc + 1, p + k)
            for tok in emitted:
                self._emit(st, tok, now)
                if self._done(st, tok):
                    break
            if self._done(st, st.out[-1]):
                self._finish(st, now, results)

    # ----------------------------------------------------------- preemption

    def _evict_inflight(self, rid: int) -> Optional[_InFlight]:
        """Pull request ``rid`` out of the prefill or decode set: register
        its fully written blocks in the prefix cache (so they park on the
        LRU with their KV rather than being recomputed), release its block
        references and free its slot.  Returns the removed state, or None
        if ``rid`` is not in flight."""
        st = next((s for s in self._active.values() if s.req.rid == rid),
                  None)
        from_active = st is not None
        if st is None:
            st = next((s for s in self._prefilling if s.req.rid == rid),
                      None)
        if st is None:
            return None
        # mid-prefill, _prefill_one has registered every completed block
        if self.prefix_cache is not None and st.out:
            seq = self._written(st)
            self._register_blocks(st, seq, len(seq))
        self.allocator.free(list(reversed(st.blocks)))
        self.free_slots.append(st.slot)
        if from_active:
            del self._active[st.slot]
        else:
            self._prefilling.remove(st)
        return st

    def preempt(self, rid: int) -> Request | None:
        """Drop-and-replay preemption: release request ``rid``'s slot and
        blocks and return its ``Request`` for the caller to resubmit; None
        if ``rid`` is not in flight.  Its written blocks are registered in
        the prefix cache first, so on a cacheable engine the replay's
        prefill walks its own history as hits and recomputes at most one
        chunk (unless pressure evicted the blocks meanwhile).  The emitted
        tokens and first-incarnation timestamps are kept by rid and taken
        up when the same rid is resubmitted; the tokens are re-fed as
        prompt, so a greedy replay emits what an uninterrupted run
        would."""
        st = self._evict_inflight(rid)
        if st is None:
            return None
        self._replay[rid] = _Replay(
            prior=st.prior + st.out, t_admit=st.t_admit, t_first=st.t_first,
            token_times=list(st.token_times),
            preemptions=st.preemptions + 1)
        self._add_stat("preemptions", 1)
        return st.req

    def cancel(self, rid: int) -> bool:
        """Abort request ``rid`` wherever it is (queued, prefilling or
        decoding), freeing its resources and dropping any replay
        continuation.  Returns True if anything was removed."""
        for i, r in enumerate(self._pending):
            if r.rid == rid:
                del self._pending[i]
                self._replay.pop(rid, None)
                self._add_stat("cancelled", 1)
                return True
        had_replay = self._replay.pop(rid, None) is not None
        st = self._evict_inflight(rid)
        if st is not None or had_replay:
            self._add_stat("cancelled", 1)
        return st is not None or had_replay

    def inflight(self) -> list:
        """Every request holding or queued for resources, as ``(request,
        phase, tokens_done, t_admit)`` with phase "pending", "prefill" or
        "decode"; the last two hold a slot and blocks and are
        preemptible."""
        out = [(r, "pending", 0, r.arrival) for r in self._pending]
        out += [(s.req, "prefill", s.n_done, s.t_admit)
                for s in self._prefilling]
        out += [(s.req, "decode", s.n_done, s.t_admit)
                for s in self._active.values()]
        return out

    # ------------------------------------------------------------------ run

    def poll(self) -> bool:
        """Whether the engine has outstanding work (a preempted request not
        yet resubmitted is its caller's work, not the engine's)."""
        return bool(self._pending or self._prefilling or self._active)

    def step(self) -> dict[int, RequestResult]:
        """ONE scheduler iteration: admit queued requests, run one prompt
        chunk, then one decode step over the slot set.  Returns the
        requests that finished during this call."""
        results: dict[int, RequestResult] = {}
        self.start_clock()
        self._try_admit(self.now())
        with qops.fusion(self.fused):
            if self._prefilling:
                self._prefill_one(self._t0, results)
            if self._active and self.speculate:
                self._spec_decode_once(self._t0, results)
            elif self._active:
                self._decode_once(self._t0, results)
        return results

    def finalize_stats(self) -> dict:
        """Fold per-step counters into summary numbers; returns ``stats``."""
        occ = self.stats.get("occupancy", [])
        self.stats["mean_occupancy"] = float(np.mean(occ)) if occ else 0.0
        if self.speculate:
            prop = self.stats.get("spec_proposed", 0)
            self.stats["acceptance_rate"] = (
                self.stats.get("spec_accepted", 0) / prop if prop else 0.0)
        self.stats["captures"] = sum(self.graphs.captures.values())
        self.stats["capture_s"] = self.graphs.capture_s
        self.stats["graph_pool_bytes"] = self.graphs.pool_bytes
        if self.prefix_cache is not None:
            pt = self.stats.get("prompt_tokens", 0)
            self.stats["prefix_hit_rate"] = (
                self.stats.get("prefill_tokens_saved", 0) / pt if pt else 0.0)
            self.stats["prefix_evictions"] = self.prefix_cache.evictions
            self.stats["prefix_cached_blocks"] = len(self.prefix_cache)
        return self.stats

    def run(self, requests: list[Request] | None = None
            ) -> dict[int, RequestResult]:
        """Serve until every submitted request completes.  Returns
        rid -> RequestResult; aggregate stats land in ``self.stats``."""
        for r in requests or []:
            self.submit(r)
        self._pending = collections.deque(
            sorted(self._pending, key=lambda r: r.arrival))
        results: dict[int, RequestResult] = {}
        self.start_clock(reset=True)      # each run() restarts the clock
        while self.poll():
            results.update(self.step())
            if not self._active and not self._prefilling and self._pending:
                wait = self._pending[0].arrival - self.now()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        self.finalize_stats()
        return results
