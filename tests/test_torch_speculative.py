"""Self-speculative decoding in the port against the JAX reference, on the
host (``repro_torch/serve/engine.py``: ``speculative_accept``,
``_spec_decode_once``; ``repro_torch/models/decode.py``:
``decode_verify_paged``).

  * The acceptance rule: the same emitted tokens and accept counts as the
    reference's on seeded random logits, greedy and at T > 0 with the same
    numpy RNG; and the reference's total-variation test of the emitted
    distribution against target-only sampling.
  * The verify step on tiny llama2 and tiny Mixtral at W = 2 and 4, after
    chunked prefill into the reference's and the port's arenas: logits of
    the active slots within rtol 1e-4 (f32; the port's CPU read is the
    paged kernel's plain version over the arena after the writes, the
    reference's a dense gather), arenas within the same tolerance outside
    the null block, and positions whose write is masked untouched; the
    masked writes land on the null block's last offset, and offset 0,
    which an inactive slot reads, stays zero (the port's one departure
    from the reference's ``paged_multi_write_indices``: on the card the
    winner among several writers of one element is unspecified, and a
    Mixtral inactive slot reading it took MoE capacity differently from
    run to run).
  * The engine (tier2): greedy tokens and spec_rounds / spec_proposed /
    spec_accepted equal to the reference engine's, with a perfect and a
    noisy draft, on tiny llama2 and tiny Mixtral (no-drop capacity); EOS
    mid-round (tiny llama2, as the reference's test); captures once under
    churn; ``draft_params`` required;
    ``lookahead`` reserved; the prefix cache (the copy-on-write clone
    copies the draft arena's block too) and a preemption (tiny llama2),
    each against the reference engine run the same way.

The dual quantization and its pair served by the engine are in
``test_torch_dual_quant.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import (mixed_requests, noisy, shared_prefix_requests,  # noqa: E402
                     small_pool, tiny)
from test_torch_engine import _moe_cfgs, to_numpy_tree  # noqa: E402
from test_torch_preempt import POOL as PREEMPT_POOL  # noqa: E402
from test_torch_preempt import _preempted_run  # noqa: E402
from test_torch_prefix_cache import _cow_prompts, _pool  # noqa: E402

from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import speculative_accept as jax_accept  # noqa: E402
from repro.serve.pool import init_pool_caches as jax_pool_caches  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (PagedServer, PoolConfig, Request,  # noqa: E402
                               speculative_accept)
from repro_torch.serve.pool import init_pool_caches  # noqa: E402

ARCHS = ["llama2-7b", "mixtral-8x7b"]
SPEC = ("spec_rounds", "spec_proposed", "spec_accepted", "acceptance_rate")
K = 3


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch):
    """(reference cfg, port cfg): tiny, MoE at the no-drop capacity."""
    if arch == "mixtral-8x7b":
        return _moe_cfgs("nodrop")
    return tiny(arch), get_tiny(arch)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """fp32 tiny weights from the reference's seed and a noisy draft, as
    (arch, jcfg, tcfg, {"perfect"|"noisy": (jax target, jax draft, port
    target, port draft)})."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = noisy(jparams, 0.005)
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    tdraft = bridge.params_from_reference(to_numpy_tree(jdraft), "cpu")
    return arch, jcfg, tcfg, {"perfect": (jparams, jparams, tparams, tparams),
                              "noisy": (jparams, jdraft, tparams, tdraft)}


def _port(reqs):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                    eos=r.eos) for r in reqs]


def _same(what, got, want, port, ref, keys=SPEC):
    assert set(got) == set(want), what
    for rid, r in want.items():
        np.testing.assert_array_equal(got[rid].tokens, r.tokens,
                                      err_msg=f"{what}: rid={rid}")
    assert ({k: port.stats.get(k) for k in keys}
            == {k: ref.stats.get(k) for k in keys}), what
    a = port.allocator
    assert a.free_blocks == a.num_blocks - 1 and not a._ref, what


# ------------------------------------------------------- acceptance rule


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_accept_rule_matches_reference(temperature):
    gen = np.random.default_rng(11)
    for trial in range(300):
        k, v = int(gen.integers(1, 5)), int(gen.integers(2, 9))
        tl = gen.normal(scale=2.0, size=(k + 1, v)).astype(np.float32)
        dl = gen.normal(scale=2.0, size=(k, v)).astype(np.float32)
        if trial % 3 == 0:                      # draft close to the target
            dl = tl[:k] + gen.normal(scale=0.1, size=(k, v)).astype(
                np.float32)
        drafts = gen.integers(0, v, k).astype(np.int32)
        if trial % 2 == 0:                      # proposals the target likes
            drafts[:] = np.argmax(tl[:k], axis=1)
        got = speculative_accept(tl, dl, drafts, temperature,
                                 np.random.default_rng(trial))
        want = jax_accept(tl, dl, drafts, temperature,
                          np.random.default_rng(trial))
        assert got == want, (trial, got, want)


def test_accept_rule_preserves_target_distribution():
    """The reference's total-variation test
    (tests/test_speculative.py:165) on the port's rule: the emitted tokens
    at each of the first two positions are distributed as target-only
    sampling, within Monte-Carlo noise."""
    k, v, temp, trials = 2, 6, 0.8, 30000
    gen = np.random.default_rng(123)
    tl = gen.normal(scale=1.5, size=(k + 1, v))
    dl = gen.normal(scale=1.5, size=(k, v))

    def dist(logits):
        e = np.exp(logits / temp - (logits / temp).max())
        return e / e.sum()

    p_t = [dist(tl[i]) for i in range(k + 1)]
    p_d = [dist(dl[i]) for i in range(k)]
    rng = np.random.default_rng(7)
    counts = [np.zeros(v) for _ in range(2)]
    n_seen = [0, 0]
    for _ in range(trials):
        drafts = np.array([rng.choice(v, p=p_d[i]) for i in range(k)])
        toks, _ = speculative_accept(tl, dl, drafts, temp, rng)
        for pos in range(min(len(toks), 2)):
            counts[pos][toks[pos]] += 1
            n_seen[pos] += 1
    for pos in range(2):
        tv = 0.5 * np.abs(counts[pos] / n_seen[pos] - p_t[pos]).sum()
        assert tv < 0.02, f"position {pos}: TV {tv:.4f} (n={n_seen[pos]})"


# ----------------------------------------------------------- verify step


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("w", [2, 4])
def test_verify_step_matches_reference(model, w):
    """Slot 0 verifies W tokens after its 9-token prompt, slot 1 catches up
    from its prompt's last position (that write masked, as the engine
    masks it without a hole), slot 2 is inactive.  Mixtral's slot 1 has an
    18-token prompt in a 20-token ring under its 16-token window, so the
    span's writes wrap onto positions outside the window."""
    arch, jcfg, tcfg, drafts = model
    jparams, _, tparams, _ = drafts["noisy"]
    ring1 = 20 if tcfg.window else 24
    jpool = small_pool(max_slots=3, num_blocks=16, prefix_cache=False)
    tpool = PoolConfig(max_slots=3, block_size=4, max_context=32,
                       num_blocks=16, prefill_chunk=4)
    jc = jax_pool_caches(jcfg, jparams, jpool)
    tc = init_pool_caches(tcfg, tpool, "cpu")
    jchunk = jax.jit(lambda p, c, *a: jdec.prefill_chunk_paged(jcfg, p, c, *a))
    jverify = jax.jit(lambda p, c, *a: jdec.decode_verify_paged(jcfg, p, c,
                                                                *a))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (9, 18)]
    bts = np.zeros((3, 8), np.int32)
    bts[0], bts[1, :ring1 // 4] = np.arange(1, 9), np.arange(9, 9 + ring1 // 4)
    ring = np.array([32, ring1, 1], np.int32)
    for slot, prompt in enumerate(prompts):
        for s in range(0, len(prompt), 4):
            chunk = prompt[s:s + 4][None]
            _, jc = jchunk(jparams, jc, jnp.asarray(chunk), jnp.int32(s),
                           jnp.int32(slot), jnp.asarray(bts[slot]),
                           jnp.int32(ring[slot]))
            tdec.prefill_chunk_paged(
                tcfg, tparams, tc, torch.from_numpy(chunk),
                torch.tensor(s, dtype=torch.int32),
                torch.from_numpy(bts[slot]),
                torch.tensor(int(ring[slot]), dtype=torch.int32))
    tokens = rng.integers(0, jcfg.vocab, (3, w)).astype(np.int32)
    tokens[1, 0] = prompts[1][-1]
    pos0 = np.array([9, 17, 0], np.int32)
    active = np.array([True, True, False])
    wmask = np.ones((3, w), bool)
    wmask[1, 0] = False
    before = [{k: a.clone() for k, a in c.items()} for c in tc]
    jl, jc = jverify(jparams, jc, jnp.asarray(tokens), jnp.asarray(pos0),
                     jnp.asarray(active), jnp.asarray(bts),
                     jnp.asarray(ring), jnp.asarray(wmask))
    tl, tc = tdec.decode_verify_paged(
        tcfg, tparams, tc, torch.from_numpy(tokens), torch.from_numpy(pos0),
        torch.from_numpy(active), torch.from_numpy(bts),
        torch.from_numpy(ring), torch.from_numpy(wmask))
    assert tl.shape == (3, w, tcfg.vocab)
    _close(tl.numpy()[:2], np.asarray(jl)[:2])
    # slot 1's masked position 17 sits in its ring slot 17 % ring1
    pb, off = bts[1, (17 % ring1) // 4], (17 % ring1) % 4
    for i, (cache, old) in enumerate(zip(tc, before)):
        for name in ("k", "v"):
            _close(cache[name][1:].numpy(), np.asarray(jc[0][name])[i, 1:])
            assert torch.equal(cache[name][pb, off], old[name][pb, off])
            changed = (cache[name] != old[name]).flatten(2).any(-1)
            written = {(int(b), int(o)) for b, o in
                       zip(*torch.nonzero(changed[1:], as_tuple=True))}
            assert len(written) <= 2 * w - 1      # the unmasked span only
            assert not cache[name][0, 0].any()    # see the next test


def test_masked_writes_spare_what_inactive_slots_read(model):
    """An inactive slot (ring of one token) reads the null block's offset
    0 back after writing its own K/V there (zeros), whatever a chunk
    graph's warm-up left (here: values put there first).  A catch-up
    whose first write is masked must not land there: its K/V is real, and
    on the card several writers of one element leave an unspecified
    winner.  Slot 0 is inactive and slot 1 masks its first position, so
    on the host (whose scatter keeps the last writer) a masked write to
    offset 0 would leave slot 1's K/V there.  The inactive slot's logits
    must be those of a clean null block."""
    arch, _, tcfg, drafts = model
    tparams = drafts["noisy"][2]
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                      prefill_chunk=4)
    tc = init_pool_caches(tcfg, pool, "cpu")
    bts = np.zeros((2, 8), np.int32)
    bts[1] = np.arange(1, 9)
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab, 8).astype(
        np.int32)
    for s in (0, 4):
        tdec.prefill_chunk_paged(
            tcfg, tparams, tc, torch.from_numpy(prompt[s:s + 4][None]),
            torch.tensor(s, dtype=torch.int32), torch.from_numpy(bts[1]),
            torch.tensor(32, dtype=torch.int32))
    clean = [{k: a.clone() for k, a in c.items()} for c in tc]
    gen = torch.Generator().manual_seed(7)
    for c in tc:
        for a in c.values():
            a[0].copy_(torch.randn(a[0].shape, generator=gen))
    before = [{k: a.clone() for k, a in c.items()} for c in tc]
    tokens = np.array([[0, 0], [prompt[-1], 5]], np.int32)
    args = (torch.from_numpy(tokens), torch.tensor([-1, 7], dtype=torch.int32),
            torch.tensor([False, True]), torch.from_numpy(bts),
            torch.tensor([1, 32], dtype=torch.int32),
            torch.tensor([[True, True], [False, True]]))
    want, _ = tdec.decode_verify_paged(tcfg, tparams, clean, *args)
    tl, tc = tdec.decode_verify_paged(tcfg, tparams, tc, *args)
    assert torch.isfinite(tl).all()
    torch.testing.assert_close(tl, want, rtol=0, atol=0)
    for cache, old in zip(tc, before):
        for name in ("k", "v"):
            assert not cache[name][0, 0].any(), arch
            assert cache[name][0, -1].any()         # the masked writes
            assert torch.equal(cache[name][2, 3], old[name][2, 3])
            assert not torch.equal(cache[name][3, 0], old[name][3, 0])


# ---------------------------------------------------------------- engine


@pytest.mark.tier2
@pytest.mark.parametrize("draft_kind", ["perfect", "noisy"])
def test_engine_matches_reference(model, draft_kind):
    arch, jcfg, tcfg, drafts = model
    jparams, jdraft, tparams, tdraft = drafts[draft_kind]
    reqs = mixed_requests(jcfg)
    ref = JaxServer(jcfg, jparams, small_pool(), draft_params=jdraft,
                    speculate=K)
    want = ref.run([dataclasses.replace(r) for r in reqs])
    port = PagedServer(tcfg, tparams, _pool(small_pool()),
                       draft_params=tdraft, speculate=K, device="cpu")
    got = port.run(_port(reqs))
    _same(f"{arch} {draft_kind}", got, want, port, ref)
    rate = port.stats["acceptance_rate"]
    assert rate == 1.0 if draft_kind == "perfect" else 0.0 < rate < 1.0
    # each speculative step captured once under churn and mixed accept
    # lengths; the prompt chunks of 4, 1 and 3 tokens, for each model
    assert (port.catchup_trace_count, port.draft_trace_count,
            port.verify_trace_count, port.decode_trace_count) == (1, 1, 1, 0)
    assert port.chunk_trace_count == port.draft_chunk_trace_count == 3


@pytest.fixture(scope="module")
def llama2():
    """(jcfg, tcfg, jax target, jax noisy draft, port target, port draft)
    on tiny llama2."""
    jcfg, tcfg = _cfgs("llama2-7b")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = noisy(jparams, 0.005)
    return (jcfg, tcfg, jparams, jdraft,
            bridge.params_from_reference(to_numpy_tree(jparams), "cpu"),
            bridge.params_from_reference(to_numpy_tree(jdraft), "cpu"))


@pytest.mark.tier2
def test_eos_mid_round_and_pool_drained(llama2):
    """As tests/test_speculative.py:62 (tiny llama2, a noisy draft)."""
    jcfg, tcfg, jparams, jdraft, tparams, tdraft = llama2
    arch = "llama2-7b"
    reqs = mixed_requests(jcfg)
    plain = PagedServer(tcfg, tparams, _pool(small_pool()), device="cpu")
    base = plain.run(_port(reqs))[0].tokens
    eos = int(base[2])
    n_stop = int(np.argmax(base == eos)) + 1
    reqs = [dataclasses.replace(r, eos=eos if r.rid == 0 else None)
            for r in reqs]
    ref = JaxServer(jcfg, jparams, small_pool(), draft_params=jdraft,
                    speculate=K)
    want = ref.run([dataclasses.replace(r) for r in reqs])
    port = PagedServer(tcfg, tparams, _pool(small_pool()),
                       draft_params=tdraft, speculate=K, device="cpu")
    got = port.run(_port(reqs))
    _same(f"{arch} eos", got, want, port, ref)
    assert int(got[0].tokens[-1]) == eos and len(got[0].tokens) == n_stop
    np.testing.assert_array_equal(got[0].tokens, base[:n_stop])


def test_requires_draft_params_and_reserves_lookahead():
    cfg = get_tiny("llama2-7b")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        PagedServer(cfg, params, PoolConfig(), speculate=2, device="cpu")
    with pytest.raises(ValueError, match="speculate"):
        PagedServer(cfg, params, PoolConfig(), draft_params=params,
                    speculate=-1, device="cpu")
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32)
    eng = PagedServer(cfg, params, pool, draft_params=params, speculate=3,
                      device="cpu")
    assert eng.speculating and eng.pool.lookahead == 3
    assert eng.table_width == 9 and eng.draft_caches[0]["k"].shape == \
        eng.caches[0]["k"].shape
    base = PagedServer(cfg, params, pool, device="cpu")
    assert base.pool.lookahead == 0 and base.draft_caches is None
    assert base.table_width == 8


# ------------------------------------------- prefix cache and preemption


@pytest.mark.tier2
def test_cow_clones_both_arenas_in_place():
    cfg = get_tiny("llama2-7b")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = PagedServer(cfg, params, PoolConfig(max_slots=2, block_size=4,
                                              max_context=32),
                      draft_params=params, speculate=2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    arenas = [a for c in eng.caches + eng.draft_caches for a in c.values()]
    for a in arenas:
        a.copy_(torch.randn(a.shape, generator=gen))
    before = [(a, a.clone()) for a in arenas]
    eng._cow(3, 5)
    after = [a for c in eng.caches + eng.draft_caches for a in c.values()]
    for (a, old), now in zip(before, after):
        assert now is a
        assert torch.equal(a[5], old[3])
        keep = [i for i in range(a.shape[0]) if i != 5]
        assert torch.equal(a[keep], old[keep])
    assert eng.cow_trace_count == 1


@pytest.mark.tier2
def test_prefix_cache_with_speculation_matches_reference():
    """The shared-prefix workload, then a prompt diverging mid-block from a
    cached one (a copy-on-write clone of both arenas) and the first again:
    tokens, cache and spec counters equal to the reference engine's."""
    cfg = tiny("llama2-7b")
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    jdraft = noisy(jparams, 0.005)
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    tdraft = bridge.params_from_reference(to_numpy_tree(jdraft), "cpu")
    ref = JaxServer(cfg, jparams, small_pool(), draft_params=jdraft,
                    speculate=K)
    port = PagedServer(get_tiny("llama2-7b"), tparams, _pool(small_pool()),
                       draft_params=tdraft, speculate=K, device="cpu")
    keys = SPEC + ("prefill_tokens", "prefill_tokens_saved", "prefix_hits",
                   "prefix_cow")
    reqs = shared_prefix_requests(cfg)
    want = ref.run([dataclasses.replace(r) for r in reqs])
    _same("shared", port.run(_port(reqs)), want, port, ref, keys)
    for rid, prompt in enumerate(_cow_prompts(cfg)):
        want = ref.run([JaxRequest(rid=rid, prompt=prompt, max_new=6)])
        got = port.run([Request(rid=rid, prompt=prompt, max_new=6)])
        _same(f"cow {rid}", got, want, port, ref, keys)
    assert port.stats["prefill_tokens_saved"] > 0
    assert port.stats["prefix_cow"] == 2 and port.cow_trace_count == 1
    assert 0.0 < port.stats["acceptance_rate"] < 1.0


@pytest.mark.tier2
def test_preempted_replay_with_speculation_matches_reference(llama2):
    """Request 0 preempted after its third token and resubmitted, on the
    port's and the reference's speculating engines (tiny llama2, a noisy
    draft; the plain engines' preemption is held on both archs in
    test_torch_preempt.py)."""
    jcfg, tcfg, jparams, jdraft, tparams, tdraft = llama2
    arch = "llama2-7b"
    jpool = dataclasses.replace(small_pool(), num_blocks=64)
    ref = JaxServer(jcfg, jparams, jpool, draft_params=jdraft, speculate=K)
    want = _preempted_run(ref, mixed_requests(jcfg), 0, "decode")
    port = PagedServer(tcfg, tparams, PREEMPT_POOL, draft_params=tdraft,
                       speculate=K, device="cpu")
    got = _preempted_run(port, _port(mixed_requests(jcfg)), 0, "decode")
    _same(f"{arch} preempt", got, want, port, ref,
          SPEC + ("preemptions", "replays", "prefill_tokens"))
    assert got[0].preemptions == 1
