"""The port's prefix cache (``repro_torch/serve/pool.py``: ``PrefixCache``
and the refcounted ``BlockAllocator``) and the engine's use of it
(longest-prefix admission, copy-on-write, registration, LRU eviction under
pressure) against the JAX reference, on the host.

  * Units: one seeded sequence of ``register`` / ``match`` / ``alloc`` /
    ``incref`` / ``decref`` calls, run on the port's classes and on the
    reference's, must return the same hits, parents, cached counts, COW
    blocks, chain hashes and blocks in the same eviction order; and the
    reference's own unit cases, on the port's classes.
  * The clone: ``graphs.clone_block`` writes into the arena tensors it is
    given (the captured steps read those), never into copies.
  * Engine (tier2): tiny llama2, fp32 and RaanA-quantized (the reference's
    codes, carried by ``repro_torch.bridge``), on the shared-prefix
    workload, a pressure pool whose admissions must evict idle cached
    blocks, and a prompt that diverges mid-block from a cached one (COW,
    then the original again).  With the cache on in both, the port's
    greedy tokens and its prefill_tokens, prefill_tokens_saved,
    prefix_hits, prefix_cow and prefix_evictions must equal the JAX
    engine's; the blocks drain; the decode step is captured once under
    hits and misses, the clone at most once.  Tiny Mixtral (window 16)
    bypasses the cache.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import shared_prefix_requests, small_pool, tiny  # noqa: E402
from test_torch_engine import (  # noqa: E402,F401
    _moe_cfgs, models, to_numpy_tree)

from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import pool as jpool  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.serve import pool as tpool  # noqa: E402

ARCH = "llama2-7b"
COUNTERS = ("prompt_tokens", "prefill_tokens", "prefill_tokens_saved",
            "prefix_hits", "prefix_cow", "prefix_evictions",
            "prefix_cached_blocks")


# ------------------------------------------------------------------- units


def _drive(mod, seed: int, steps: int = 400) -> list:
    """A seeded mix of admissions (match, incref the hits, alloc the rest,
    undo on failure, register the full blocks) and releases on ``mod``'s
    PrefixCache / BlockAllocator; returns everything the calls returned
    and the pool's state after each."""
    rng = np.random.default_rng(seed)
    bs = 4
    cache = mod.PrefixCache(block_size=bs)
    alloc = mod.BlockAllocator(14, cache=cache)
    bases = [rng.integers(0, 3, 24) for _ in range(3)]   # shared prefixes
    owners, log = [], []
    for _ in range(steps):
        if owners and rng.random() < 0.45:
            blocks = owners.pop(int(rng.integers(len(owners))))
            for b in reversed(blocks):
                alloc.decref(b)
            log.append(("release", blocks))
        else:
            base = bases[int(rng.integers(len(bases)))]
            n = int(rng.integers(2, 20))
            prompt = base[:n].copy()
            cut = int(rng.integers(0, n))
            prompt[cut:] = rng.integers(0, 3, n - cut)
            hits, parent, cached, cow = cache.match(prompt, n - 1)
            log.append(("match", list(hits), parent, cached, cow))
            for b in hits:
                alloc.incref(b)
            if cow is not None:
                alloc.incref(cow)
            fresh = alloc.alloc(-(-(n + 2) // bs) - len(hits))
            log.append(("alloc", fresh))
            if cow is not None:
                alloc.decref(cow)
            if fresh is None:
                for b in reversed(hits):
                    alloc.decref(b)
                continue
            blocks, chain = hits + fresh, parent
            for k in range(len(hits), n // bs):
                chain = cache.register(chain, prompt[k * bs:(k + 1) * bs],
                                       blocks[k])
                log.append(("register", chain))
            owners.append(blocks)
        log.append(("state", alloc.free_blocks, alloc.cached_idle_blocks,
                    len(cache), cache.evictions, list(alloc._lru)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_call_sequence_matches_reference(seed):
    got, want = _drive(tpool, seed), _drive(jpool, seed)
    assert got == want
    # the sequence reaches every path: hits, COW, failed allocs, releases
    # and evictions
    assert any(e[0] == "match" and e[1] for e in want)
    assert any(e[0] == "match" and e[4] is not None for e in want)
    assert any(e[0] == "alloc" and e[1] is None for e in want)
    assert any(e[0] == "release" for e in want)
    assert [e for e in want if e[0] == "state"][-1][4] > 0


def test_prefix_cache_match_and_partial():
    c = tpool.PrefixCache(block_size=4)
    toks = list(range(1, 13))                   # blocks [1..4] [5..8] [9..12]
    h0 = c.register(c.ROOT, toks[0:4], 3)
    h1 = c.register(h0, toks[4:8], 7)
    hits, parent, cached, cow = c.match(np.asarray(toks), 7)
    assert hits == [3] and parent == h0 and cached == 7 and cow == 7
    hits, parent, cached, cow = c.match(np.asarray(toks), 8)
    assert hits == [3, 7] and parent == h1 and cached == 8 and cow is None
    div = toks[:6] + [99, 98, 97, 96]
    hits, _, cached, cow = c.match(np.asarray(div), 9)
    assert hits == [3] and cached == 6 and cow == 7
    assert c.register(c.ROOT, toks[0:4], 11) == h0   # first content wins
    assert c.match(np.asarray(toks), 4)[0] == [3]


def test_match_rejects_hash_collisions():
    c = tpool.PrefixCache(block_size=4)
    c.chain_hash = lambda parent, tokens: 0     # everything collides
    c.register(c.ROOT, [1, 2, 3, 4], 5)
    hits, parent, cached, cow = c.match(np.asarray([9, 9, 9, 9, 9]), 4)
    assert hits == [] and cached == 0 and cow is None
    assert c.match(np.asarray([1, 2, 3, 4, 9]), 4)[0] == [5]


def test_refcounted_allocator_lru_eviction_order():
    cache = tpool.PrefixCache(block_size=4)
    a = tpool.BlockAllocator(6, cache=cache)
    got = a.alloc(5)
    assert a.alloc(1) is None
    h = cache.ROOT
    for i, b in enumerate(got):
        h = cache.register(h, [i] * 4, b)
    for b in got:
        a.decref(b)
    assert a.free_blocks == 5 and a.cached_idle_blocks == 5
    a.incref(got[0])                            # a hit revives, not evicts
    assert a.cached_idle_blocks == 4
    assert a.alloc(1) == [got[1]]               # LRU (insertion) order
    assert cache.evictions == 1 and not cache.contains_block(got[1])
    a.decref(got[1])                            # no longer cached: freed
    a.decref(got[0])
    assert a.free_blocks == 5 and a.cached_idle_blocks == 4


def test_pool_config_turns_the_cache_on_by_default():
    assert PoolConfig().prefix_cache
    assert jpool.PoolConfig().prefix_cache


def test_clone_block_writes_into_the_arenas_in_place():
    """The captured steps read the arena tensors they were captured on, so
    the clone must write into those very tensors."""
    gen = torch.Generator().manual_seed(0)
    caches = [{"k": torch.randn(5, 4, 2, 8, generator=gen),
               "v": torch.randn(5, 4, 2, 8, generator=gen)}
              for _ in range(3)]
    before = [{k: (t, t.data_ptr(), t.clone()) for k, t in c.items()}
              for c in caches]
    graphs.clone_block(caches, torch.tensor([3]), torch.tensor([1]))
    for c, b in zip(caches, before):
        for k, t in c.items():
            arena, ptr, old = b[k]
            assert t is arena and t.data_ptr() == ptr
            torch.testing.assert_close(t[1], old[3], rtol=0, atol=0)
            keep = [0, 2, 3, 4]
            torch.testing.assert_close(t[keep], old[keep], rtol=0, atol=0)


# ------------------------------------------------------------------ engine


def _port(reqs):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in reqs]


def _pool(jp):
    """The port's PoolConfig with the reference pool's sizing."""
    return PoolConfig(**{k: getattr(jp, k) for k in (
        "max_slots", "block_size", "max_context", "num_blocks",
        "prefill_chunk", "prefix_cache")})


def _assert_same(kind, got, want, port, ref):
    assert set(got) == set(want)
    for rid, r in want.items():
        np.testing.assert_array_equal(got[rid].tokens, r.tokens,
                                      err_msg=f"{kind}: rid={rid}")
    assert ({k: port.stats.get(k) for k in COUNTERS}
            == {k: ref.stats.get(k) for k in COUNTERS}), kind
    a = port.allocator
    assert a.free_blocks == a.num_blocks - 1 and not a._ref
    assert a.cached_idle_blocks == len(port.prefix_cache)


def _cow_prompts(cfg):
    """A prompt, one that diverges from it inside block 3, and it again."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    div = base.copy()
    div[14:] = (div[14:] + 1) % cfg.vocab
    return [base, div, base]


WORKLOADS = {  # name -> (reference pool, request count)
    "shared": (small_pool(), 4),
    "pressure": (small_pool(num_blocks=11), 6),
}


@pytest.mark.tier2
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_cache_on_matches_reference_cache_on(models, kind, workload):
    cfg = tiny(ARCH)
    jparams, tparams = models[kind]
    jp, n = WORKLOADS[workload]
    reqs = shared_prefix_requests(cfg, n=n)
    ref = JaxServer(cfg, jparams, jp)
    want = ref.run([dataclasses.replace(r) for r in reqs])
    port = PagedServer(get_tiny(ARCH), tparams, _pool(jp), device="cpu")
    got = port.run(_port(reqs))
    _assert_same(f"{kind} {workload}", got, want, port, ref)
    assert port.stats["prefill_tokens_saved"] > 0
    assert (port.stats["prefill_tokens"] + port.stats["prefill_tokens_saved"]
            == port.stats["prompt_tokens"])
    if workload == "pressure":
        assert port.stats["prefix_evictions"] > 0
    assert port.decode_trace_count == 1


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_cow_divergence_mid_block_matches_reference(models, kind):
    cfg = tiny(ARCH)
    jparams, tparams = models[kind]
    ref = JaxServer(cfg, jparams, small_pool())
    port = PagedServer(get_tiny(ARCH), tparams, _pool(small_pool()),
                       device="cpu")
    for rid, prompt in enumerate(_cow_prompts(cfg)):
        want = ref.run([JaxRequest(rid=rid, prompt=prompt, max_new=6)])
        got = port.run([Request(rid=rid, prompt=prompt, max_new=6)])
        _assert_same(f"{kind} rid {rid}", got, want, port, ref)
    # the divergent prompt clones block 3; so does the original's second
    # run, whose match stops one token short of block 3's end
    assert port.stats["prefix_cow"] == 2
    assert port.cow_trace_count == 1           # captured once


@pytest.mark.tier2
def test_decode_captured_once_under_hits_and_misses(models):
    cfg = get_tiny(ARCH)
    port = PagedServer(cfg, models["fp32"][1], _pool(small_pool()),
                       device="cpu")
    jcfg = tiny(ARCH)
    for seed in (3, 4, 3):                     # misses + hits, fresh, hits
        port.run(_port(shared_prefix_requests(jcfg, seed=seed)))
    for rid, p in enumerate(_cow_prompts(jcfg)):
        port.run([Request(rid=rid, prompt=p, max_new=6)])
    assert port.stats["prefill_tokens_saved"] > 0
    assert port.stats["prefix_cow"] >= 1
    assert port.decode_trace_count == 1
    assert port.cow_trace_count == 1


@pytest.mark.tier2
def test_windowed_mixtral_bypasses_the_cache():
    jcfg, tcfg = _moe_cfgs("nodrop")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    port = PagedServer(
        tcfg, bridge.params_from_reference(to_numpy_tree(jparams), "cpu"),
        _pool(small_pool()), device="cpu")
    assert not port.cacheable and port.prefix_cache is None
    reqs = shared_prefix_requests(jcfg)
    want = JaxServer(jcfg, jparams, small_pool()).run(
        [dataclasses.replace(r) for r in reqs])
    got = port.run(_port(reqs))
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)
    assert "prefix_hit_rate" not in port.stats
    assert port.allocator.free_blocks == port.allocator.num_blocks - 1
