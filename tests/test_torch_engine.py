"""Port parity, serving: the port's paged decode/prefill steps and its
``PagedServer`` against the JAX reference on tiny llama2, with fp32 weights
and with RaanA-quantized weights (calibrate + AllocateBits at 4.3 average
bits, as tests/test_decode.py:81 builds them: mixed widths including
one-code-per-byte, outlier splits and non-power-of-2 d_keep), carried
across by ``repro_torch.bridge``.  Then tiny mixtral (MoE top-2, GQA,
window 16), fp32 and quantized with grouped experts, on the churn workload
plus a request whose window ring wraps, at a no-drop capacity and at the
published 1.25 with four slots, where inactive slots' tied routing decides
which active tokens the capacity drops.

Step logits must agree within rtol 1e-4 (f32 everywhere; summation order
differs, and the port's CPU attention read is the online-softmax block walk
where the reference's is a dense softmax).  Greedy tokens on the
mixed-length churn workload must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import mixed_requests, small_pool, tiny  # noqa: E402

from repro.core import calibrate as cal  # noqa: E402
from repro.core import pipeline as pipe  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.qlinear import QuantizedGrouped as JaxQuantizedGrouped  # noqa: E402
from repro.core.qlinear import QuantizedLinear as JaxQuantizedLinear  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve.pool import init_pool_caches as jax_pool_caches  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402
from repro_torch.serve.pool import init_pool_caches  # noqa: E402

pytestmark = pytest.mark.tier2  # slow end-to-end serving suite

ARCH = "llama2-7b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_numpy_tree(node):
    """A JAX param tree as the bridge's plain containers of numpy arrays."""
    for cls, tensors, static in (
            (JaxQuantizedLinear, bridge.QL_TENSORS, bridge.QL_STATIC),
            (JaxQuantizedGrouped, bridge.QG_TENSORS, bridge.QG_STATIC)):
        if isinstance(node, cls):
            out = {k: (None if getattr(node, k) is None
                       else np.asarray(getattr(node, k))) for k in tensors}
            out.update({k: getattr(node, k) for k in static})
            return out
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy_tree(v) for v in node]
    return None if node is None else np.asarray(node)


@pytest.fixture(scope="module")
def models():
    """{"fp32": (jax params, port params), "quant": (...)} on tiny llama2."""
    cfg = tiny(ARCH)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    toks = cal.zero_shot_tokens(cfg.vocab, 64)
    stats = cal.calibrate(
        lambda p, b, ctx: jtf.loss_fn(cfg, p, b, ctx=ctx, scan=False),
        params, [{"tokens": jnp.asarray(toks)}])
    qparams, _ = pipe.quantize_model(cfg, params, stats, 4.3,
                                     jax.random.PRNGKey(3))
    return {name: (p, bridge.params_from_reference(to_numpy_tree(p), "cpu"))
            for name, p in (("fp32", params), ("quant", qparams))}


def test_quantized_tree_carries_mixed_widths(models):
    layers = models["quant"][1]["layers"]
    qls = [lp[g][k] for lp in layers for g, ks in
           (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wo")))
           for k in ks]
    bits = {q.bits for q in qls}
    assert bits & {3, 5, 6, 7} and bits & {1, 2, 4, 8}
    assert any(q.out_idx is not None for q in qls)
    assert any(q.d_keep & (q.d_keep - 1) for q in qls)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_step_logits_match_reference(models, kind):
    """Two requests prefilled in chunks into disjoint blocks, then three
    decode steps over both slots, fed the reference's greedy tokens."""
    cfg = tiny(ARCH)
    jparams, tparams = models[kind]
    jpool = small_pool(prefix_cache=False)
    tpool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                       prefill_chunk=4)
    jc = jax_pool_caches(cfg, jparams, jpool)
    jchunk = jax.jit(lambda p, c, *a: jdec.prefill_chunk_paged(cfg, p, c, *a))
    jstep = jax.jit(lambda p, c, *a: jdec.decode_step_paged(cfg, p, c, *a))
    tc = init_pool_caches(cfg, tpool, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 5)]
    bts = np.zeros((2, 8), np.int32)
    bts[0], bts[1] = np.arange(1, 9), np.arange(9, 17)
    ring = np.array([32, 32], np.int32)
    last = []
    for slot, prompt in enumerate(prompts):
        for s in range(0, len(prompt), 4):
            chunk = prompt[s:s + 4][None]
            jl, jc = jchunk(
                jparams, jc, jnp.asarray(chunk), jnp.int32(s),
                jnp.int32(slot), jnp.asarray(bts[slot]), jnp.int32(32))
            tl, tc = tdec.prefill_chunk_paged(
                cfg, tparams, tc, torch.from_numpy(chunk), s,
                torch.from_numpy(bts[slot]), 32)
            _close(tl.numpy(), jl)
        last.append(int(np.argmax(np.asarray(jl)[0])))
    pos = np.array([len(p) for p in prompts], np.int32)
    active = np.array([True, True])
    toks = np.array(last, np.int32)[:, None]
    for _ in range(3):
        jl, jc = jstep(
            jparams, jc, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(bts), jnp.asarray(ring))
        tl, tc = tdec.decode_step_paged(
            cfg, tparams, tc, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(bts),
            torch.from_numpy(ring))
        _close(tl.numpy(), jl)
        toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_engine_greedy_tokens_identical_to_reference(models, kind):
    cfg = tiny(ARCH)
    jparams, tparams = models[kind]
    jreqs = mixed_requests(cfg)
    want = JaxServer(cfg, jparams, small_pool(prefix_cache=False)).run(jreqs)
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                      prefill_chunk=4)
    engine = PagedServer(get_tiny(ARCH), tparams, pool, device="cpu")
    got = engine.run([Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                      for r in jreqs])
    assert set(got) == set(want)
    for r in jreqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens,
                                      err_msg=f"{kind}: rid={r.rid}")
    assert engine.stats["decode_steps"] > 0
    assert engine.allocator.free_blocks == engine.allocator.num_blocks - 1


def test_prefix_cache_is_refused_until_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        PoolConfig(prefix_cache=True)


MOE_ARCH = "mixtral-8x7b"


@pytest.fixture(scope="module")
def moe_models():
    """Tiny mixtral, fp32 and quantized (grouped experts included), as
    (jax params, port params); calibrated at the no-drop capacity."""
    cfg = tiny(MOE_ARCH)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    toks = cal.zero_shot_tokens(cfg.vocab, 64)
    stats = cal.calibrate(
        lambda p, b, ctx: jtf.loss_fn(cfg, p, b, ctx=ctx, scan=False),
        params, [{"tokens": jnp.asarray(toks)}])
    qparams, _ = pipe.quantize_model(cfg, params, stats, 4.3,
                                     jax.random.PRNGKey(3))
    return {name: (p, bridge.params_from_reference(to_numpy_tree(p), "cpu"))
            for name, p in (("fp32", params), ("quant", qparams))}


def _moe_cfgs(capacity):
    """(reference cfg, port cfg) at the no-drop or the published capacity."""
    jcfg, tcfg = jreg.get_tiny(MOE_ARCH), get_tiny(MOE_ARCH)
    if capacity == "nodrop":
        jcfg = tiny(MOE_ARCH)
        tcfg = tcfg.with_(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=jcfg.moe.capacity_factor))
    return jcfg, tcfg


def test_moe_tree_carries_grouped_experts(moe_models):
    from repro_torch.core.qlinear import QuantizedGrouped
    for lp in moe_models["quant"][1]["layers"]:
        assert isinstance(lp["moe"]["wi"], QuantizedGrouped)
        assert isinstance(lp["moe"]["wo"], QuantizedGrouped)
        assert lp["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("capacity,slots", [("nodrop", 2), ("published", 4)])
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_moe_engine_greedy_tokens_identical_to_reference(moe_models, kind,
                                                         capacity, slots):
    jcfg, tcfg = _moe_cfgs(capacity)
    jparams, tparams = moe_models[kind]
    rng = np.random.default_rng(7)
    long_req = JaxRequest(rid=99, prompt=rng.integers(0, jcfg.vocab, 20).astype(
        np.int32), max_new=10)      # 30 tokens through a 16-token ring
    jreqs = mixed_requests(jcfg) + [long_req]
    want = JaxServer(jcfg, jparams, small_pool(
        prefix_cache=False, max_slots=slots)).run(jreqs)
    pool = PoolConfig(max_slots=slots, block_size=4, max_context=32,
                      prefill_chunk=4)
    engine = PagedServer(tcfg, tparams, pool, device="cpu")
    got = engine.run([Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                      for r in jreqs])
    assert set(got) == set(want)
    for r in jreqs:
        np.testing.assert_array_equal(
            got[r.rid].tokens, want[r.rid].tokens,
            err_msg=f"{kind} {capacity}: rid={r.rid}")
    assert engine.allocator.free_blocks == engine.allocator.num_blocks - 1
