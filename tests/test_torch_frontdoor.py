"""The port's streaming front door (``repro_torch/serve/frontdoor``) and the
engine surface it sits on, against the JAX reference on the host.

- The SSE codec writes the reference's bytes and parses as it does.
- The ``Scheduler`` makes the reference's decisions tick for tick: a seeded
  random sequence of submits, cancels and ticks (several tenants, weights
  and priorities, a share cap, the SLO controller fed seeded decode gaps)
  drives the reference's scheduler and the port's, each over its own copy
  of the deterministic fake engine of ``tests/test_frontdoor.py``;
  admission order, preemption victims, throttle state per tick and the
  counters must be equal.
- ``Scheduler.tick`` over the tiny torch engine, with two tenants and one
  forced preemption, gives the JAX engine's greedy tokens for llama2 and
  Mixtral; the ticks run on another thread with grad mode on and a
  parameter that requires grad (the engine enters ``no_grad`` itself)
  and inside ``paged_kernel(False)``, which the engine's own default
  overrides; ``on_token`` fires once per token, in order, with
  ``token_times``.
- ``step(prefill=False)`` sequences, both engines on the dense gather
  (``paged_kernel=False``), give the JAX engine's tokens, counters and
  number of decode gaps.
- The HTTP front door through the port's CLI (``--device cpu --tiny
  --serve --port 0``, fp32): one streamed generation, ``/healthz``,
  ``/v1/stats``, a 400 for a token outside the vocab, SIGTERM -> rc 0 and
  ``shut down cleanly``; and an engine failure in the driver thread, which
  streams an ``error`` event and makes the CLI exit non-zero.  The same
  under ``--tp 2`` (two gloo ranks, rank 0 serving): the stream's tokens
  are the ``--tp 1`` server's, and after SIGTERM or a driver failure no
  rank is left running.
"""
import collections
import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import mixed_requests, small_pool  # noqa: E402
from test_torch_prefix_cache import _pool  # noqa: E402
from test_torch_preempt import served  # noqa: E402,F401  (fixture)

from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve.frontdoor import SchedConfig as JaxSchedConfig  # noqa: E402
from repro.serve.frontdoor import Scheduler as JaxScheduler  # noqa: E402
from repro.serve.frontdoor.sse import encode_event as jax_encode  # noqa: E402
from repro.serve.frontdoor.sse import iter_events as jax_iter  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.serve import PagedServer, Request  # noqa: E402
from repro_torch.serve.frontdoor import SchedConfig, Scheduler  # noqa: E402
from repro_torch.serve.frontdoor.client import stream_generate  # noqa: E402
from repro_torch.serve.frontdoor.sse import encode_event, iter_events  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("prefill_chunks", "prefill_tokens", "decode_steps",
            "preemptions", "replays")


# ---------------------------------------------------------------- SSE codec


def test_sse_codec_matches_reference():
    frames = [("token", {"rid": 0, "token": 7, "text": "a", "t": 0.25}),
              ("token", {"rid": 0, "token": 9, "text": "\né"}),
              ("done", {"rid": 0, "tokens": [7, 9], "n_tokens": 2}),
              ("error", {"error": "engine failure"})]
    for event, data in frames:
        assert encode_event(event, data) == jax_encode(event, data)
    wire = b"".join(encode_event(e, d) for e, d in frames).decode()
    streams = [wire.splitlines(keepends=True), wire.splitlines(),
               [": keep-alive\n", "event: blob\n", "data: [1,\n",
                "data: 2]\n", "\n", "data: {}\n", "\n", "event: tail\n",
                'data: {"never": "terminated"}\n']]
    for lines in streams:
        got = list(iter_events(lines))
        assert got == list(jax_iter(lines))
    assert list(iter_events(streams[0])) == frames


# ------------------------------------------------------- scheduler decisions


class FakePool:
    def __init__(self, max_slots):
        self.max_slots = max_slots


class FakeEngine:
    """Deterministic engine stub exposing exactly the surface Scheduler
    consumes: every admitted request 'decodes' one token per step and
    finishes after ``gen`` steps.  (A copy of ``tests/test_frontdoor.py``'s
    stub; a step with requests running also appends the next of ``gaps``
    to ``decode_gaps``, so the SLO controller has samples to judge.)"""

    def __init__(self, max_slots=4, gen=100, gaps=()):
        self.pool = FakePool(max_slots)
        self.decode_gaps = collections.deque(maxlen=2048)
        self.gen = gen
        self.gaps = iter(gaps)
        self.running = {}           # rid -> [req, done, t_admit]
        self.order = []             # admission order
        self.preempted = []
        self._t = 0.0

    def now(self):
        return self._t

    def validate(self, req):
        pass

    def can_admit(self, req):
        return len(self.running) < self.pool.max_slots

    def submit(self, req):
        self.running[req.rid] = [req, 0, self._t]
        self.order.append(req.rid)

    def poll(self):
        return bool(self.running)

    @property
    def active_count(self):
        return len(self.running)

    def inflight(self):
        return [(v[0], "decode", v[1], v[2]) for v in self.running.values()]

    def preempt(self, rid):
        if rid not in self.running:
            return None
        self.preempted.append(rid)
        return self.running.pop(rid)[0]

    def cancel(self, rid):
        return self.running.pop(rid, None) is not None

    def step(self, prefill=True):
        self._t += 1.0
        finished = {}
        if self.running:
            self.decode_gaps.append(next(self.gaps))
        for rid in list(self.running):
            self.running[rid][1] += 1
            if self.running[rid][1] >= self.gen:
                req = self.running.pop(rid)[0]
                finished[rid] = types.SimpleNamespace(
                    rid=rid, tenant=req.tenant)
        return finished


def _trace(sched_cls, cfg_cls, req_cls, seed, cfg_kw, ticks=240):
    """Drive a scheduler over a fresh fake engine with the seeded event
    sequence; returns everything it decided, tick by tick."""
    rng = np.random.default_rng(seed)
    gaps = rng.choice([0.004, 0.009, 0.012, 0.030], size=ticks * 2)
    eng = FakeEngine(max_slots=4, gen=int(rng.integers(3, 9)), gaps=gaps)
    sched = sched_cls(eng, cfg_cls(**cfg_kw))
    weights = {"a": 1.0, "b": 2.0, "c": 0.5}
    trace, rid = [], 0
    for _ in range(ticks):
        for _ in range(int(rng.integers(0, 3))):
            tenant = str(rng.choice(list(weights)))
            sched.submit(req_cls(rid=rid, prompt=np.zeros(4, np.int32),
                                 max_new=4, tenant=tenant,
                                 priority=int(rng.integers(0, 3)),
                                 arrival=eng.now()),
                         weight=weights[tenant])
            rid += 1
        if rid and rng.random() < 0.15:
            sched.cancel(int(rng.integers(0, rid)))
        finished = sched.tick()
        trace.append((sorted(finished), sched.throttled, sched.last_p95_ms,
                      sorted(eng.running), sched.allow_prefill(),
                      sched.queued()))
    return trace, eng.order, eng.preempted, dict(sched.stats)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_kw", [
    {},
    {"max_tenant_share": 0.5, "slo_p95_ms": 10.0, "slo_min_samples": 4,
     "slo_window": 8},
    {"preemption": False, "slo_p95_ms": 20.0, "slo_resume_frac": 0.5},
], ids=["default", "cap+slo", "no-preemption"])
def test_scheduler_decisions_match_reference(seed, cfg_kw):
    got = _trace(Scheduler, SchedConfig, Request, seed, cfg_kw)
    want = _trace(JaxScheduler, JaxSchedConfig, JaxRequest, seed, cfg_kw)
    for tick, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"tick {tick}"
    assert got[1:] == want[1:]
    stats = got[3]
    assert stats["admitted"] > 0 and stats["completed"] > 0
    if cfg_kw.get("preemption", True):
        assert stats.get("preempted", 0) > 0
    if "slo_p95_ms" in cfg_kw:
        assert stats.get("slo_throttled_ticks", 0) > 0


# --------------------------------------------- the scheduler over the engine


def _port_requests(arch_cfg_reqs, hook):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                    tenant=f"t{r.rid % 2}", on_token=hook)
            for r in arch_cfg_reqs]


@pytest.mark.tier2
def test_scheduler_ticks_give_reference_tokens(served):
    """Requests 0-3 at priority 0 over two tenants (weights 2:1); once both
    slots decode, request 4 arrives at priority 2 and preempts one.  The
    ticks run on a driver thread with grad mode on while ``lm_head``
    requires grad."""
    arch, jcfg, jparams, cfg, params, want = served
    seen = collections.defaultdict(list)
    reqs = _port_requests(mixed_requests(jcfg),
                          lambda rid, tok, t: seen[rid].append((tok, t)))
    engine = PagedServer(cfg, params, _pool(small_pool()), device="cpu")
    sched = Scheduler(engine, SchedConfig(slo_p95_ms=1e6))
    results, errors = {}, []

    def drive():
        try:
            torch.set_grad_enabled(True)
            engine.start_clock()
            for r in reqs[:4]:
                sched.submit(r, weight=2.0 if r.tenant == "t0" else 1.0)
            late = dataclasses.replace(reqs[4], priority=2)
            # the engine's paged_kernel=None holds inside this scope
            with pops.paged_kernel(False):
                for _ in range(10_000):
                    if late is not None and engine.active_count == 2:
                        sched.submit(late)
                        late = None
                    if late is None and not sched.has_work():
                        break
                    results.update(sched.tick())
        except Exception as exc:                  # noqa: BLE001
            errors.append(exc)

    walk, walks = pops.paged_attention_ref, []

    def counted_walk(*a, **kw):
        walks.append(threading.current_thread().name)
        return walk(*a, **kw)

    params["lm_head"].requires_grad_(True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pops, "paged_attention_gather", None)  # never called
            mp.setattr(pops, "paged_attention_ref", counted_walk)
            thread = threading.Thread(target=drive, name="driver")
            thread.start()
            thread.join()
    finally:
        params["lm_head"].requires_grad_(False)
    assert not errors, errors
    # by device on the host: the kernel's plain walk, in the driver thread
    assert set(walks) == {"driver"}
    assert sched.stats["preempted"] >= 1
    assert sum(r.preemptions for r in results.values()) >= 1
    assert set(results) == set(want)
    for rid, r in want.items():
        res = results[rid]
        np.testing.assert_array_equal(res.tokens, r.tokens,
                                      err_msg=f"{arch}: rid={rid}")
        assert res.tenant == f"t{rid % 2}"
        # every token streamed once, in order, at its recorded time
        assert [tok for tok, _ in seen[rid]] == res.tokens.tolist()
        np.testing.assert_array_equal([t for _, t in seen[rid]],
                                      res.token_times)
    a = engine.allocator
    assert a.free_blocks == a.num_blocks - 1 and not a._ref


@pytest.mark.tier2
@pytest.mark.parametrize("served", ["llama2-7b"], indirect=True)
def test_steps_without_prefill_match_reference(served):
    """The same sequence of ``step(prefill=...)`` flags on both engines
    (tiny llama2: the throttle is host code): every third step skips its
    prompt chunk.  Both read the paged KV through the dense gather
    (``paged_kernel=False``); the port's engine holds its setting inside
    a caller's opposite scope."""
    arch, jcfg, jparams, cfg, params, want = served
    calls = collections.Counter()

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    runs = {}
    for name, engine, reqs in (
            ("ref", JaxServer(jcfg, jparams, small_pool(),
                              paged_kernel=False), mixed_requests(jcfg)),
            ("port", PagedServer(cfg, params, _pool(small_pool()),
                                 paged_kernel=False, device="cpu"),
             _port_requests(mixed_requests(jcfg), None))):
        engine.start_clock()
        for r in reqs:
            engine.submit(r)
        results, i = {}, 0
        with pytest.MonkeyPatch.context() as mp, pops.paged_kernel(None):
            for fn in ("paged_attention_gather", "paged_attention_ref"):
                mp.setattr(pops, fn, counted(fn, getattr(pops, fn)))
            while engine.poll():
                results.update(engine.step(prefill=i % 3 != 2))
                i += 1
        assert len(engine.decode_gaps) == len(engine.stats["decode_gap_s"])
        runs[name] = (engine, results, i)
    assert calls["paged_attention_gather"] and not calls["paged_attention_ref"]
    (ref, want_res, n_ref), (port, got, n_port) = runs["ref"], runs["port"]
    assert n_ref == n_port
    for rid, r in want_res.items():
        np.testing.assert_array_equal(got[rid].tokens, r.tokens)
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    assert ({k: port.stats.get(k) for k in COUNTERS}
            == {k: ref.stats.get(k) for k in COUNTERS})
    assert (len(port.stats["decode_gap_s"])
            == len(ref.stats["decode_gap_s"]) < port.stats["decode_steps"])
    assert port.active_count == 0


# ---------------------------------------------------------- HTTP, by the CLI

SERVE = ["--device", "cpu", "--tiny", "--serve", "--port", "0", "--slots",
         "2", "--prompt-len", "32", "--gen", "16"]


def _start(code: str):
    """Start ``python -c code`` (which boots the CLI's front door);
    returns (process, its output lines so far, filled as they come)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(
        iter(proc.stdout.readline, "")), daemon=True).start()
    return proc, lines


def _listening(proc, lines) -> int:
    """The port of ``proc``'s listening line, once it is printed."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        for line in list(lines):
            if "frontdoor listening on" in line:
                return int(line.rsplit(":", 1)[1])
        assert proc.poll() is None, "server died:\n" + "".join(lines)
        time.sleep(0.1)
    proc.kill()
    raise AssertionError("no listening line:\n" + "".join(lines))


def _boot(code: str):
    """Start ``code`` and wait for its listening line; returns (process,
    port, output lines)."""
    proc, lines = _start(code)
    return proc, _listening(proc, lines), lines


def _cli(*patch: str, extra=()) -> str:
    return textwrap.dedent("""
        from repro_torch.launch import serve
        {}
        serve.main({!r})
    """).format("\n".join(patch), SERVE + list(extra))


def _rank_pids(lines) -> list:
    """The ranks' process ids from the TP front door's ``pids`` line."""
    line = next(ln for ln in lines if "TP ranks, pids" in ln)
    return [int(p) for p in line.split("pids", 1)[1].split()]


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.tier2
def test_http_stream_stats_and_clean_shutdown():
    proc, port, lines = _boot(_cli())
    try:
        events = list(stream_generate("127.0.0.1", port,
                                      prompt="the quick brown fox",
                                      max_new=8, tenant="a", timeout=60.0))
        tokens = [d for e, d in events if e == "token"]
        dones = [d for e, d in events if e == "done"]
        assert len(tokens) == 8 and len(dones) == 1, events
        assert dones[0]["n_tokens"] == len(tokens)
        assert dones[0]["tokens"] == [t["token"] for t in tokens]
        assert dones[0]["tenant"] == "a" and dones[0]["preemptions"] == 0
        assert _get(port, "/healthz")[0] == 200
        status, body = _get(port, "/v1/stats")
        stats = json.loads(body)
        assert status == 200 and stats["scheduler"]["completed"] == 1
        assert stats["engine"]["decode_steps"] == 7
        with pytest.raises(RuntimeError, match="HTTP 400"):
            list(stream_generate("127.0.0.1", port, tokens=[1, 512]))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0, "".join(lines)
    assert any("frontdoor shut down cleanly" in ln for ln in lines)


@pytest.mark.tier2
def test_http_driver_failure_exits_non_zero():
    """An exception in an engine step (injected) reaches the stream as an
    ``error`` event, closes the listener and fails the CLI."""
    proc, port, lines = _boot(_cli(
        "def boom(self, *a):",
        "    raise RuntimeError('injected engine failure')",
        "serve.PagedServer._decode_once = boom"))
    try:
        events = list(stream_generate("127.0.0.1", port, prompt="fox",
                                      max_new=4, timeout=60.0))
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    # the first token comes from the prompt's chunk, then a decode fails
    assert [e for e, _ in events] == ["token", "error"], events
    assert rc != 0, "".join(lines)
    out = "".join(lines)
    assert "injected engine failure" in out
    assert "shut down cleanly" not in out


@pytest.mark.tier2
def test_http_tp2_stream_and_clean_shutdown():
    """``--tp 2``: rank 0's front door streams the ``--tp 1`` server's
    tokens and reports the TP engine; SIGTERM to the CLI reaches rank 0,
    whose server shuts down cleanly and releases the worker: rc 0, and
    no rank is left."""
    one, one_lines = _start(_cli())
    two, two_lines = _start(_cli(extra=("--tp", "2")))
    procs = (one, two)
    try:
        ports = [_listening(p, ln) for p, ln in ((one, one_lines),
                                                 (two, two_lines))]
        streams = [list(stream_generate("127.0.0.1", port,
                                        prompt="the quick brown fox",
                                        max_new=8, tenant="a", timeout=60.0))
                   for port in ports]
        tokens = [[d["token"] for e, d in ev if e == "token"]
                  for ev in streams]
        assert len(tokens[0]) == 8 and tokens[1] == tokens[0], streams
        assert [e for e, _ in streams[1]][-1] == "done"
        assert _get(ports[1], "/healthz")[0] == 200
        status, body = _get(ports[1], "/v1/stats")
        engine = json.loads(body)["engine"]
        assert status == 200 and engine["tp"] == 2
        assert engine["tp_steps"] == "eager" and engine["decode_steps"] == 7
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
    assert rcs == [0, 0], "".join(two_lines)
    out = "".join(two_lines)
    assert out.count("frontdoor shut down cleanly") == 1
    assert all(_gone(pid) for pid in _rank_pids(two_lines)), out


@pytest.mark.tier2
def test_http_tp2_driver_failure_stops_every_rank():
    """Under ``--tp 2`` an engine failure in rank 0's driver thread
    (injected in the spawned rank: ``_torch_tp_ranks``) streams an
    ``error`` event, fails the CLI and leaves no rank running."""
    proc, port, lines = _boot(_cli(
        "import sys",
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})",
        "import _torch_tp_ranks",
        "serve.frontdoor_rank = _torch_tp_ranks.failing_frontdoor_rank",
        extra=("--tp", "2")))
    try:
        events = list(stream_generate("127.0.0.1", port, prompt="fox",
                                      max_new=4, timeout=60.0))
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert [e for e, _ in events] == ["token", "error"], events
    out = "".join(lines)
    assert rc != 0, out
    assert "injected engine failure" in out and "rank 0 failed" in out
    assert "shut down cleanly" not in out
    assert all(_gone(pid) for pid in _rank_pids(lines)), out
