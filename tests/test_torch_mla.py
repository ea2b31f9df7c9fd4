"""Port parity, MLA with shared experts: ``repro_torch.models.mla`` against
``repro.models.mla`` on seeded numpy inputs (the expanded ``mla_full``,
qk width qk_nope + qk_rope against v width v_head; the lockstep
``mla_decode``; the paged engine's ``mla_decode_paged`` with an inactive
slot, whose row must keep its values; ``mla_prefill_chunk`` into one slot's
row, f32 and bf16 latents), and DeepSeek-V2's shared experts in
``moe_ffn`` at top-k 2 and 6.  Then tiny deepseek-v2-236b through the
port's pipeline and engine against the reference's
(``test_torch_families``), at the no-drop capacity the reference's own
paged-vs-lockstep test uses (``tests/helpers.py:nodrop``), and the paged
engines at the published 1.25, where both drop the same tokens.

Tolerance: rtol 1e-4 on f32 (summation order differs); bf16 latents are
rounded at the same places in both, so the same tolerance holds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import mixed_requests, small_pool, tiny  # noqa: E402
from test_torch_families import (check_allocation, check_engine,  # noqa: E402
                                 family_models)
from test_torch_families import one_torch_thread  # noqa: E402,F401 autouse

from repro.configs import registry as jreg  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

ARCH = "deepseek-v2-236b"
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _params(seed=0):
    cfg = jreg.get_tiny(ARCH)
    p = {k: np.asarray(v) for k, v in jtf._init_mla(
        cfg, jax.random.PRNGKey(seed), jnp.float32).items()}
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):
        p[k] = rng.uniform(0.5, 1.5, size=p[k].shape).astype(np.float32)
    return cfg, p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_mla_full_matches_reference():
    cfg, p = _params()
    m = cfg.mla
    assert m.qk_nope + m.qk_rope != m.v_head      # q/k and v widths differ
    x = np.random.default_rng(1).normal(size=(2, 11, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    want = jax.jit(lambda p, x, pos: jmla.mla_full(p, x, m, pos))(
        _j(p), jnp.asarray(x), jnp.asarray(pos))
    got = tmla.mla_full(_t(p), torch.from_numpy(x), m,
                        torch.from_numpy(np.array(pos)))
    _close(got, want)


def _cache(rng, b, cap, m, dtype):
    c = rng.normal(size=(b, cap, m.kv_lora)).astype(np.float32)
    r = rng.normal(size=(b, cap, m.qk_rope)).astype(np.float32)
    j = jmla.MLACache(c_kv=jnp.asarray(c).astype(dtype[0]),
                      k_rope=jnp.asarray(r).astype(dtype[0]))
    t = tmla.MLACache(c_kv=torch.from_numpy(c).to(dtype[1]),
                      k_rope=torch.from_numpy(r).to(dtype[1]))
    return j, t


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _same_cache(tc, jc):
    for f in ("c_kv", "k_rope"):
        _close(getattr(tc, f).to(torch.float32),
               np.asarray(getattr(jc, f), np.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_decode_paths_match_reference(dt):
    """Lockstep decode at pos 5 of a 12-row cache; the paged decode of 3
    slots at positions 4, 9, 0 with the last inactive; a 5-token prompt
    chunk from position 3 into slot 1."""
    cfg, p = _params(2)
    m = cfg.mla
    rng = np.random.default_rng(3)
    jp, tp = _j(p), _t(p)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    jc, tc = _cache(rng, 3, 12, m, DTYPES[dt])
    jy, jc2 = jax.jit(lambda p, x, c, pos: jmla.mla_decode(p, x, m, c, pos))(
        jp, jnp.asarray(x), jc, jnp.int32(5))
    ty, tc2 = tmla.mla_decode(tp, torch.from_numpy(x), m, tc,
                              torch.tensor([5], dtype=torch.int32))
    assert tc2 is tc
    _close(ty, jy)
    _same_cache(tc, jc2)

    jc, tc = _cache(rng, 3, 12, m, DTYPES[dt])
    pos = np.array([4, 9, 0], np.int32)
    active = np.array([True, True, False])
    before = tc.c_kv[2].clone()
    jy, jc2 = jax.jit(lambda p, x, c, pos, act: jmla.mla_decode_paged(
        p, x, m, c, pos, act))(jp, jnp.asarray(x), jc, jnp.asarray(pos),
                               jnp.asarray(active))
    ty, _ = tmla.mla_decode_paged(tp, torch.from_numpy(x), m, tc,
                                  torch.from_numpy(pos),
                                  torch.from_numpy(active))
    _close(ty[:2], np.asarray(jy)[:2])
    _same_cache(tc, jc2)
    assert torch.equal(tc.c_kv[2], before)

    xc = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32)
    jc, tc = _cache(rng, 3, 12, m, DTYPES[dt])
    jy, jc2 = jax.jit(lambda p, x, c, pos0, slot: jmla.mla_prefill_chunk(
        p, x, m, c, pos0, slot))(jp, jnp.asarray(xc), jc, jnp.int32(3),
                                 jnp.int32(1))
    ty, _ = tmla.mla_prefill_chunk(tp, torch.from_numpy(xc), m, tc,
                                   torch.tensor(3, dtype=torch.int32),
                                   torch.tensor(1, dtype=torch.int32))
    _close(ty, jy)
    _same_cache(tc, jc2)


@pytest.mark.parametrize("top_k,n_shared", [(2, 1), (6, 2)])
def test_shared_experts_match_reference(top_k, n_shared):
    """moe_ffn with DeepSeek-V2's shared experts at the published capacity
    factor (tokens dropped), top-k 2 and 6 of 16 experts; one all-zero row
    (an inactive decode slot)."""
    e, d, f = 16, 32, 24
    rng = np.random.default_rng(top_k)
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * d ** -0.5,
         "wi": rng.normal(size=(e, d, 2 * f)).astype(np.float32) * d ** -0.5,
         "wo": rng.normal(size=(e, f, d)).astype(np.float32) * f ** -0.5,
         "swi": rng.normal(size=(d, 2 * f * n_shared)).astype(np.float32)
         * d ** -0.5,
         "swo": rng.normal(size=(f * n_shared, d)).astype(np.float32)
         * (f * n_shared) ** -0.5}
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    x[1, 4] = 0.0
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, n_experts=e,
                                                  top_k=top_k))(
        _j(p), jnp.asarray(x))
    ty, taux = tmoe.moe_ffn(_t(p), torch.from_numpy(x), n_experts=e,
                            top_k=top_k)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.fixture(scope="module")
def models():
    return family_models(tiny(ARCH), _nodrop(get_tiny(ARCH)))


def _nodrop(cfg):
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=tiny(ARCH).moe.capacity_factor))


def test_allocation_matches_reference(models):
    check_allocation(models)
    names = set(models["trep"].per_layer_bits)
    assert {"L0.mla.wq_a", "L0.mla.wq_b", "L0.mla.wkv_a", "L0.mla.wo",
            "L1.moe.swi", "L1.moe.swo", "L1.moe.wi", "L1.moe.wo"} <= names
    assert not any(n.endswith("wkv_b") for n in names)   # decode reshapes it


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_engine_tokens_identical_to_reference(models, kind):
    jparams, tparams = models[kind]
    check_engine(tiny(ARCH), _nodrop(get_tiny(ARCH)), jparams, tparams, kind)


@pytest.mark.tier2
def test_engine_at_published_capacity_identical_to_reference(models):
    """At the published 1.25 four slots' decode and a chunk of 4 drop
    tokens; an inactive slot's zero hidden state ties its routing, and the
    port breaks ties as the reference does."""
    jcfg, tcfg = jreg.get_tiny(ARCH), get_tiny(ARCH)
    jparams, tparams = models["fp32"]
    jreqs = mixed_requests(jcfg)
    want = JaxServer(jcfg, jparams, small_pool(
        prefix_cache=False, max_slots=4)).run(jreqs)
    engine = PagedServer(tcfg, tparams, PoolConfig(
        max_slots=4, block_size=4, max_context=32, prefill_chunk=4),
        device="cpu")
    got = engine.run([Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                      for r in jreqs])
    for r in jreqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens,
                                      err_msg=f"rid={r.rid}")
