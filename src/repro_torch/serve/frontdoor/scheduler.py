"""SLO-aware admission scheduler over the paged engine (port of
``repro/serve/frontdoor/scheduler.py``; host code, numpy only, with the
reference's behaviour decision for decision).

The engine (``PagedServer``) admits FIFO; this layer decides what reaches
that FIFO and when.  Three policies compose:

- **Priority admission with weighted fair sharing.**  Requests queue per
  tenant, ordered by ``Request.priority`` (higher first), then submit
  order.  Across tenants the next admission goes to the highest-priority
  queue head; ties go to the tenant with the smallest weighted load (slots
  held / weight), so two same-priority tenants with weights 2:1 converge
  to a 2:1 slot split.  ``max_tenant_share`` caps the share of slots one
  tenant may hold while others wait.

- **Preemption by drop and replay.**  When the best waiting request cannot
  be admitted (no slot or no blocks) and a strictly lower-priority request
  is in flight, or a tenant over its share cap holds slots while another
  waits below it, the scheduler calls ``engine.preempt`` on the victim
  (lowest priority first; among equals the most recently admitted, which
  has the least work to replay) and requeues it.  The engine registers the
  victim's written blocks in the prefix cache before dropping them, so the
  replay is a warm prefill, and a greedy replay emits the tokens of an
  uninterrupted run.

- **SLO control with hysteresis.**  The engine records the gap between
  consecutive decode steps (``decode_gaps``), the per-token latency a
  decoding request sees, inflated by interleaved prompt chunks.  When the
  windowed p95 of that gap exceeds ``slo_p95_ms``, the controller stops
  chunked prefill (``engine.step(prefill=False)``); prefill resumes only
  once the p95 falls below ``slo_resume_frac`` of the target, so the loop
  duty-cycles instead of flapping on every sample.  Prefill is never held
  while nothing decodes (there is no SLO to protect, and holding it would
  deadlock).

The scheduler owns no thread: ``tick()`` is one admission + preemption +
engine-step round, driven by whoever owns the serving thread (the HTTP
front door's driver, or a benchmark loop).  Requests are submitted when
due: ``Request.arrival`` is latency accounting, not a timer (a queue head
with a future arrival simply waits).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Front-door scheduling policy knobs.

    ``slo_p95_ms = None`` disables the SLO controller entirely (prefill is
    always admitted).  ``max_tenant_share = 1.0`` disables the share cap.
    """
    slo_p95_ms: float | None = None   # decode-gap p95 target (milliseconds)
    slo_window: int = 32              # gap samples in the p95 window
    slo_min_samples: int = 8          # don't judge p95 on fewer gaps
    slo_resume_frac: float = 0.7      # hysteresis: resume below frac*target
    max_tenant_share: float = 1.0     # max fraction of slots per tenant
    preemption: bool = True           # allow drop-and-replay eviction


class Scheduler:
    """Priority / fair-share / SLO admission layer over a ``PagedServer``.

    The engine surface it reads (and the tests' fake engine stubs):
    ``pool.max_slots``, ``active_count``, ``decode_gaps``, ``validate``,
    ``submit``, ``can_admit``, ``preempt``, ``cancel``, ``inflight``,
    ``step(prefill=)``, ``poll``, ``now``.
    """

    def __init__(self, engine, cfg: SchedConfig | None = None):
        self.engine = engine
        self.cfg = cfg or SchedConfig()
        if not (0.0 < self.cfg.max_tenant_share <= 1.0):
            raise ValueError("max_tenant_share must be in (0, 1]")
        # tenant -> heap of (-priority, seq, Request); seq keeps FIFO order
        # among equal priorities and makes heap entries totally ordered
        self._queues: dict[str, list] = {}
        self._weights: dict[str, float] = {}
        self._seq = 0
        self.throttled = False
        self.last_p95_ms: float | None = None
        self.stats: collections.Counter = collections.Counter()

    # ----------------------------------------------------------- submission

    def submit(self, req, weight: float = 1.0) -> None:
        """Queue ``req`` on its tenant's priority queue.  ``weight`` is the
        tenant's fair-share weight (last submit wins; default 1.0 —
        unweighted fair sharing)."""
        if weight <= 0.0:
            raise ValueError("tenant weight must be > 0")
        self.engine.validate(req)
        self._weights[req.tenant] = float(weight)
        heapq.heappush(self._queues.setdefault(req.tenant, []),
                       (-req.priority, self._seq, req))
        self._seq += 1

    def _requeue(self, req) -> None:
        """Put a preempted request back; it competes at its own priority
        behind already-queued equals (no starvation of the queue)."""
        heapq.heappush(self._queues.setdefault(req.tenant, []),
                       (-req.priority, self._seq, req))
        self._seq += 1

    def cancel(self, rid: int) -> bool:
        """Drop ``rid`` from the tenant queues or the engine (wherever it
        is); the front door calls this when a streaming client goes away."""
        for q in self._queues.values():
            for i, (_p, _s, r) in enumerate(q):
                if r.rid == rid:
                    q.pop(i)
                    heapq.heapify(q)
                    self.stats["cancelled"] += 1
                    return True
        return self.engine.cancel(rid)

    def has_work(self) -> bool:
        return any(self._queues.values()) or self.engine.poll()

    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ---------------------------------------------------------- fair share

    def _held(self) -> collections.Counter:
        """Slots (or imminent slots) held per tenant: everything the engine
        has accepted — pending admissions included, since they were already
        granted by a previous ``_admit`` round."""
        held = collections.Counter()
        for req, _phase, _done, _t in self.engine.inflight():
            held[req.tenant] += 1
        return held

    def share_cap(self) -> int:
        """Max slots one tenant may hold while another tenant waits."""
        return max(1, math.ceil(self.cfg.max_tenant_share
                                * self.engine.pool.max_slots))

    def _pick(self, now: float):
        """The next request admission should take: the highest-priority due
        queue head, ties broken by smallest weighted load then FIFO.
        Tenants at the share cap stand aside while any other tenant has
        due work.  Returns ``(tenant, request)`` or ``None``."""
        held = self._held()
        cap = self.share_cap()
        due = []
        for tenant, q in self._queues.items():
            if not q:
                continue
            neg_prio, seq, req = q[0]
            if req.arrival > now:
                continue
            due.append((tenant, neg_prio, seq, req))
        if not due:
            return None
        capped_out = [d for d in due if held[d[0]] < cap]
        if capped_out:
            due = capped_out        # cap binds only while others wait
        best = min(due, key=lambda d: (d[1],
                                       held[d[0]] / self._weights[d[0]],
                                       d[2]))
        return best[0], best[3]

    def _admit(self, now: float) -> None:
        while True:
            pick = self._pick(now)
            if pick is None:
                return
            tenant, req = pick
            if not self.engine.can_admit(req):
                return
            heapq.heappop(self._queues[tenant])
            self.engine.submit(req)
            self.stats["admitted"] += 1

    # ---------------------------------------------------------- preemption

    def _maybe_preempt(self, now: float) -> None:
        """Evict at most one victim per tick to make room for the best
        waiting request: a strictly-lower-priority in-flight request, or —
        when the waiter's tenant is under the share cap — an equal-or-lower
        priority request of a tenant over it."""
        if not self.cfg.preemption:
            return
        pick = self._pick(now)
        if pick is None:
            return
        tenant, req = pick
        if self.engine.can_admit(req):
            return                    # plain admission will take it
        held = self._held()
        cap = self.share_cap()
        running = [(r, done, t_admit)
                   for r, phase, done, t_admit in self.engine.inflight()
                   if phase in ("prefill", "decode")]
        victims = [v for v in running if v[0].priority < req.priority]
        if not victims and held[tenant] < cap:
            victims = [v for v in running
                       if held[v[0].tenant] > cap and v[0].tenant != tenant
                       and v[0].priority <= req.priority]
        if not victims:
            return
        # lowest priority first; among equals the most recently admitted
        # (least completed work to replay)
        victim = min(victims, key=lambda v: (v[0].priority, -v[2]))
        r = self.engine.preempt(victim[0].rid)
        if r is not None:
            self._requeue(r)
            self.stats["preempted"] += 1
            self.stats[f"preempted.{r.tenant}"] += 1

    # ------------------------------------------------------- SLO controller

    def _update_slo(self) -> None:
        cfg = self.cfg
        if cfg.slo_p95_ms is None:
            return
        gaps = self.engine.decode_gaps
        if len(gaps) < cfg.slo_min_samples:
            return
        window = list(gaps)[-cfg.slo_window:]
        p95_ms = float(np.percentile(window, 95)) * 1e3
        self.last_p95_ms = p95_ms
        if not self.throttled and p95_ms > cfg.slo_p95_ms:
            self.throttled = True
            self.stats["slo_throttle_on"] += 1
        elif self.throttled and p95_ms < cfg.slo_resume_frac * cfg.slo_p95_ms:
            self.throttled = False
            self.stats["slo_throttle_off"] += 1

    def allow_prefill(self) -> bool:
        """Chunked prefill runs unless the SLO controller is throttled —
        and always runs when nothing is decoding (nothing to protect;
        gating it then could only stall the pool)."""
        return not self.throttled or self.engine.active_count == 0

    # ------------------------------------------------------------------ tick

    def tick(self, now: float | None = None) -> dict:
        """One scheduling round: update the SLO controller, admit due
        requests (priority / fair-share order), preempt if the best waiter
        is blocked behind lower-priority work, then run one engine step
        (prefill gated by the controller).  Returns the requests that
        finished during the step (rid -> RequestResult)."""
        now = self.engine.now() if now is None else now
        self._update_slo()
        self._admit(now)
        self._maybe_preempt(now)
        finished = self.engine.step(prefill=self.allow_prefill())
        if self.throttled:
            self.stats["slo_throttled_ticks"] += 1
        self.stats["completed"] += len(finished)
        return finished
