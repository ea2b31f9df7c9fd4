"""The port's bf16 KV arenas (``PoolConfig.kv_dtype``) against the JAX
reference's, on the host.

  * The pool: arenas in the configured dtype (f32 by default, as the
    reference's), ``lookahead`` added to a request's blocks, another dtype
    refused.
  * Step logits on tiny llama2, two requests prefilled in chunks into bf16
    arenas, then three decode steps and a W = 3 verify step: within one
    bf16 ulp of the largest |logit| (2^-8 of it) of the reference's.  Both
    round K/V to bf16 on the write, and the chunk's attention rounds q and
    its probabilities to bf16; the two packages' f32 projections differ in
    the last bits (1e-6 here), which flips a few of those roundings, and
    each flip moves the logits by up to a bf16 ulp of an input (2e-3 of
    3.1 when this was written).  With f32 arenas the same steps agree
    within 1e-4 (``test_torch_engine.py``).
  * The engine (tier2): greedy tokens on the churn workload identical to
    the reference's bf16 engine, speculation off and on (a noisy draft,
    k = 3, both arenas bf16), with equal spec counters; on = off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import mixed_requests, noisy, small_pool, tiny  # noqa: E402
from test_torch_engine import to_numpy_tree  # noqa: E402
from test_torch_prefix_cache import _pool  # noqa: E402
from test_torch_speculative import SPEC, _port, _same  # noqa: E402

from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve import pool as jpool  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig  # noqa: E402
from repro_torch.serve.pool import init_pool_caches, request_blocks  # noqa: E402

ARCH = "llama2-7b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def weights():
    cfg = tiny(ARCH)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    jdraft = noisy(jparams, 0.005)
    return (cfg, jparams, jdraft,
            bridge.params_from_reference(to_numpy_tree(jparams), "cpu"),
            bridge.params_from_reference(to_numpy_tree(jdraft), "cpu"))


def _bf16_pool(jp):
    return dataclasses.replace(_pool(jp), kv_dtype=torch.bfloat16)


def test_pool_dtype_and_lookahead():
    cfg = get_tiny(ARCH)
    assert PoolConfig().kv_dtype == torch.float32
    assert jpool.PoolConfig().kv_dtype == jnp.float32
    for dtype in (torch.float32, torch.bfloat16):
        pool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                          kv_dtype=dtype)
        caches = init_pool_caches(cfg, pool, "cpu")
        assert len(caches) == cfg.n_layers
        assert all(a.dtype == dtype for c in caches for a in c.values())
    with pytest.raises(ValueError, match="kv_dtype"):
        PoolConfig(kv_dtype=torch.float16)
    jcfg = tiny("mixtral-8x7b")                 # window 16: capped, + 3
    for c, j in ((cfg, tiny(ARCH)), (get_tiny("mixtral-8x7b"), jcfg)):
        for total in (5, 16, 30):
            got = request_blocks(c, PoolConfig(block_size=4, lookahead=3),
                                 total)
            want = jpool.request_blocks(
                j, jpool.PoolConfig(block_size=4, lookahead=3), total)
            assert got == want


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_step_logits_match_reference_on_bf16_arenas(weights):
    cfg, jparams, _, tparams, _ = weights
    tcfg = get_tiny(ARCH)
    jp = small_pool(prefix_cache=False, kv_dtype=jnp.bfloat16)
    jc = jpool.init_pool_caches(cfg, jparams, jp)
    tc = init_pool_caches(tcfg, _bf16_pool(jp), "cpu")
    assert jc[0]["k"].dtype == jnp.bfloat16
    jchunk = jax.jit(lambda p, c, *a: jdec.prefill_chunk_paged(cfg, p, c, *a))
    jstep = jax.jit(lambda p, c, *a: jdec.decode_step_paged(cfg, p, c, *a))
    jverify = jax.jit(lambda p, c, *a: jdec.decode_verify_paged(cfg, p, c,
                                                                *a))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 5)]
    bts = np.zeros((2, 8), np.int32)
    bts[0], bts[1] = np.arange(1, 9), np.arange(9, 17)
    ring = np.array([32, 32], np.int32)
    last = []
    for slot, prompt in enumerate(prompts):
        for s in range(0, len(prompt), 4):
            chunk = prompt[s:s + 4][None]
            jl, jc = jchunk(jparams, jc, jnp.asarray(chunk), jnp.int32(s),
                            jnp.int32(slot), jnp.asarray(bts[slot]),
                            jnp.int32(32))
            tl, tc = tdec.prefill_chunk_paged(
                tcfg, tparams, tc, torch.from_numpy(chunk),
                torch.tensor(s, dtype=torch.int32),
                torch.from_numpy(bts[slot]),
                torch.tensor(32, dtype=torch.int32))
            _close(tl.numpy(), jl)
        last.append(int(np.argmax(np.asarray(jl)[0])))
    pos = np.array([len(p) for p in prompts], np.int32)
    active = np.array([True, True])
    toks = np.array(last, np.int32)[:, None]
    for _ in range(3):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(active), jnp.asarray(bts),
                       jnp.asarray(ring))
        tl, tc = tdec.decode_step_paged(
            tcfg, tparams, tc, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(bts),
            torch.from_numpy(ring))
        _close(tl.numpy(), jl)
        toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        pos = pos + 1
    span = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
    wmask = np.ones((2, 3), bool)
    jl, jc = jverify(jparams, jc, jnp.asarray(span), jnp.asarray(pos),
                     jnp.asarray(active), jnp.asarray(bts), jnp.asarray(ring),
                     jnp.asarray(wmask))
    tl, tc = tdec.decode_verify_paged(
        tcfg, tparams, tc, torch.from_numpy(span), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(bts),
        torch.from_numpy(ring), torch.from_numpy(wmask))
    _close(tl.numpy(), jl)
    assert all(a.dtype == torch.bfloat16 for c in tc for a in c.values())


@pytest.mark.tier2
def test_engine_matches_reference_bf16_engine(weights):
    cfg, jparams, jdraft, tparams, tdraft = weights
    reqs = mixed_requests(cfg)
    jp = small_pool(kv_dtype=jnp.bfloat16)
    out = {}
    for spec in (0, 3):
        draft = dict(draft_params=jdraft, speculate=spec) if spec else {}
        ref = JaxServer(cfg, jparams, jp, **draft)
        want = ref.run([dataclasses.replace(r) for r in reqs])
        port = PagedServer(get_tiny(ARCH), tparams, _bf16_pool(jp),
                           device="cpu",
                           **(dict(draft_params=tdraft, speculate=spec)
                              if spec else {}))
        out[spec] = port.run(_port(reqs))
        _same(f"bf16 speculate={spec}", out[spec], want, port, ref,
              SPEC if spec else ())
        arenas = port.caches + (port.draft_caches or [])
        assert all(a.dtype == torch.bfloat16 for c in arenas
                   for a in c.values())
    assert 0.0 < port.stats["acceptance_rate"] < 1.0
    for rid, r in out[0].items():
        np.testing.assert_array_equal(out[3][rid].tokens, r.tokens)
