"""Drop-and-replay preemption and cancel in the port's engine, on the host
(``repro_torch/serve/engine.py``: ``preempt``, ``cancel``, ``inflight``).

The counterpart of
``tests/test_frontdoor.py::test_preempt_replay_greedy_parity``: a request
preempted mid-decode and resubmitted must emit exactly the tokens of the
reference engine's uninterrupted run, on tiny llama2 (the
cache is on, so the replay walks its own registered blocks and recomputes
at most one chunk) and on tiny Mixtral (window 16: the cache is bypassed
and the replay re-prefills its served tokens cold).  Its result counts one
preemption, and its token times never decrease.  A request preempted while
still prefilling replays the same way.  The reference engine, preempted at
the same step, must count the same prefill tokens, cache hits and saved
tokens.  The pool holds 64 blocks, so no admission evicts the victim's
parked blocks before its replay.  Then ``cancel`` in every phase
(queued, mid-prefill, mid-decode, and a preempted request's continuation):
the others' tokens stay the reference's and the blocks drain.  Last,
``Request.arrival``: requests submitted out of arrival order are admitted
in arrival order and never before their arrival, as the reference admits
them, and ``ttft_s`` counts from the arrival.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import PROMPT_LENS, mixed_requests, small_pool, tiny  # noqa: E402
from test_torch_engine import _moe_cfgs, to_numpy_tree  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

pytestmark = pytest.mark.tier2  # end-to-end serving runs

POOL = PoolConfig(max_slots=2, block_size=4, max_context=32, num_blocks=64,
                  prefill_chunk=4)
COUNTERS = ("prefill_tokens", "prefill_tokens_saved", "prefix_hits",
            "prompt_tokens", "preemptions", "replays")


@pytest.fixture(scope="module", params=["llama2-7b", "mixtral-8x7b"])
def served(request):
    """(arch, port cfg, port params, the reference's uninterrupted results
    on the churn workload): fp32 tiny weights from the reference's seed,
    no-drop MoE capacity."""
    arch = request.param
    jcfg = tiny(arch)
    tcfg = _moe_cfgs("nodrop")[1] if jcfg.moe is not None else get_tiny(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    want = JaxServer(jcfg, jparams, small_pool()).run(mixed_requests(jcfg))
    return (arch, jcfg, jparams, tcfg,
            bridge.params_from_reference(to_numpy_tree(jparams), "cpu"), want)


def _requests(cfg_arch):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in mixed_requests(tiny(cfg_arch))]


def _drain(engine, on_step, limit=10_000) -> dict:
    """Step ``engine`` until it is idle, calling ``on_step(engine)`` after
    each step; returns every finished request's result."""
    results = {}
    for _ in range(limit):
        if not engine.poll():
            break
        results.update(engine.step())
        on_step(engine)
    assert not engine.poll()
    return results


def _drained(engine):
    a = engine.allocator
    assert a.free_blocks == a.num_blocks - 1 and not a._ref
    assert not engine.inflight()


def _preempted_run(engine, requests, victim: int, phase: str):
    """Serve ``requests`` on ``engine`` (the port's or the reference's),
    preempting ``victim`` once: in decode after its third token, or in
    prefill once it has prefilled a chunk; the victim is resubmitted at
    once.  Returns the results."""
    engine.start_clock()
    for r in requests:
        engine.submit(r)
    done = []

    def preempt(eng):
        if done:
            return
        for req, ph, n, _t in eng.inflight():
            if req.rid != victim or ph != phase:
                continue
            if n >= 3 if ph == "decode" else any(
                    s.filled > 0 for s in eng._prefilling
                    if s.req.rid == victim):
                again = eng.preempt(victim)
                assert again is req and eng.preempt(victim) is None
                eng.submit(again)
                done.append(True)
                return

    results = _drain(engine, preempt)
    assert done, f"request {victim} finished before it could be preempted"
    return results


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_preempt_replay_matches_uninterrupted_reference(served, phase):
    arch, jcfg, jparams, cfg, params, want = served
    # rid 0 (prompt 5) in decode; rid 2 (prompt 16, four chunks) in prefill
    victim = 0 if phase == "decode" else 2
    engine = PagedServer(cfg, params, POOL, device="cpu")
    results = _preempted_run(engine, _requests(arch), victim, phase)
    ref = JaxServer(jcfg, jparams, small_pool(num_blocks=POOL.num_blocks))
    _preempted_run(ref, mixed_requests(jcfg), victim, phase)
    assert ({k: engine.stats.get(k) for k in COUNTERS}
            == {k: ref.stats.get(k) for k in COUNTERS})
    assert engine.stats["preemptions"] == engine.stats["replays"] == 1
    assert results[victim].preemptions == 1
    for rid, res in want.items():
        np.testing.assert_array_equal(
            results[rid].tokens, res.tokens,
            err_msg=f"{arch}: rid={rid} diverged after preempt+replay")
    for res in results.values():
        assert res.ttft_s > 0.0
        assert len(res.token_times) == len(res.tokens)
        assert np.all(np.diff(res.token_times) >= 0)
    # tokens prefilled beyond the prompts: what the replay recomputed
    recomputed = engine.stats["prefill_tokens"] - sum(PROMPT_LENS)
    if engine.prefix_cache is None:
        # cold: the prompt and the three emitted tokens, or the chunk
        assert recomputed == (PROMPT_LENS[victim] + 3 if phase == "decode"
                              else POOL.prefill_chunk)
    elif phase == "decode":
        # warm: the replay hits its registered block and recomputes the
        # rest of its history, one chunk at most
        assert engine.stats["prefix_hits"] == 1
        assert 0 < recomputed <= POOL.prefill_chunk
    else:
        # the prefilled chunk was registered: nothing is recomputed
        assert engine.stats["prefix_hits"] == 1 and recomputed == 0
    _drained(engine)


def test_cancel_in_every_phase(served):
    arch, _, _, cfg, params, want = served
    engine = PagedServer(cfg, params, POOL, device="cpu")
    engine.start_clock()
    for r in _requests(arch):
        engine.submit(r)
    engine.step()                     # rids 0, 1 hold the two slots
    assert [(r.rid, ph) for r, ph, *_ in engine.inflight()] == [
        (2, "pending"), (3, "pending"), (4, "pending"), (0, "prefill"),
        (1, "prefill")]
    assert engine.cancel(4)           # queued
    assert not engine.cancel(4) and not engine.cancel(99)
    cancelled = {4}

    def cancel(eng):
        for req, ph, n, _t in eng.inflight():
            if req.rid == 2 and ph == "prefill" and 2 not in cancelled and \
                    any(s.filled > 0 for s in eng._prefilling
                        if s.req.rid == 2):
                assert eng.cancel(2)          # mid-prefill
                cancelled.add(2)
            elif req.rid == 0 and ph == "decode" and n >= 2 \
                    and 0 not in cancelled:
                assert eng.cancel(0)          # mid-decode
                cancelled.add(0)
            elif req.rid == 3 and ph == "decode" and 3 not in cancelled:
                # a preempted request's continuation, never resubmitted
                assert eng.preempt(3) is req
                assert eng.cancel(3) and not eng.cancel(3)
                cancelled.add(3)

    results = _drain(engine, cancel)
    assert cancelled == {0, 2, 3, 4}
    assert engine.stats["cancelled"] == 4
    assert set(results) == {1}
    np.testing.assert_array_equal(results[1].tokens, want[1].tokens)
    _drained(engine)
    # the engine serves on after the cancellations
    again = engine.run([dataclasses.replace(r) for r in _requests(arch)])
    for rid, res in want.items():
        np.testing.assert_array_equal(again[rid].tokens, res.tokens)
    _drained(engine)


# seconds after the clock's start; submitted in rid order, so run() must
# sort them (rids 1 and 4 tie at 0 and keep their submission order)
ARRIVALS = [0.3, 0.0, 0.15, 0.45, 0.0]


def _arrival_run(engine, requests):
    results = engine.run([dataclasses.replace(r, arrival=t)
                          for r, t in zip(requests, ARRIVALS)])
    # rids 1 and 4 are admitted in one step, at one time
    order = sorted(results, key=lambda rid: (results[rid].t_admit, rid))
    return results, order


def test_arrival_orders_admission_like_reference(served):
    arch, jcfg, jparams, cfg, params, want = served
    engine = PagedServer(cfg, params, POOL, device="cpu")
    results, order = _arrival_run(engine, _requests(arch))
    ref = JaxServer(jcfg, jparams, small_pool(num_blocks=POOL.num_blocks))
    ref_results, ref_order = _arrival_run(ref, mixed_requests(jcfg))
    assert order == ref_order == [1, 4, 2, 0, 3]
    for rid, res in results.items():
        np.testing.assert_array_equal(res.tokens, want[rid].tokens)
        np.testing.assert_array_equal(res.tokens, ref_results[rid].tokens)
        assert res.t_admit >= ARRIVALS[rid]
        assert res.ttft_s == pytest.approx(res.t_first - ARRIVALS[rid])
        assert 0.0 < res.ttft_s <= res.t_done - ARRIVALS[rid]
        assert res.token_times[0] == res.t_first
    _drained(engine)
    # stepped by hand: a request whose arrival lies ahead stays queued
    engine = PagedServer(cfg, params, POOL, device="cpu")
    engine.start_clock()
    engine.submit(dataclasses.replace(_requests(arch)[0], arrival=3600.0))
    engine.step()
    assert [(r.rid, ph) for r, ph, *_ in engine.inflight()] == [
        (0, "pending")] and engine.poll()
    assert engine.cancel(0) and not engine.poll()
