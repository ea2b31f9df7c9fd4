"""Port parity for the four dense GQA configs the port's registry adds
(internlm2-1.8b, llama3.2-3b, qwen3-0.6b, yi-34b), at their tiny sizes on
the host.  Their tiny variants keep the published GQA groups (G = 2, 3, 2
and 7 query heads per KV head); qwen3 adds qk-norm, held here with norm
weights drawn away from 1 and, in a second case, with 4 heads of 32 on a
64-wide model, since at full width n_heads * head_dim (2048) is not
d_model (1024).

The port's ``prefill_chunk_paged`` and ``decode_step_paged`` logits must
agree with the reference's within rtol 1e-4 (f32; summation order differs,
and the port's host attention read is the online-softmax block walk), over
chunks that start off a block boundary (as a prefix-cache hit makes them)
and three decode steps.  Then, for qwen3 quantized (calibrate + AllocateBits
at 4.3 bits + RaBitQ-H, carried across by ``repro_torch.bridge``), the
port's engine must give the JAX engine's greedy tokens on the churn
workload.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import mixed_requests, small_pool, tiny  # noqa: E402
from test_torch_engine import to_numpy_tree  # noqa: E402

from repro.core import calibrate as cal  # noqa: E402
from repro.core import pipeline as pipe  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve.pool import init_pool_caches as jax_pool_caches  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402
from repro_torch.serve.pool import init_pool_caches  # noqa: E402

DENSE = ("internlm2-1.8b", "llama3.2-3b", "qwen3-0.6b", "yi-34b")
# (arch, head_dim override): qwen3 once more with n_heads * hd != d_model
CASES = [(arch, None) for arch in DENSE] + [("qwen3-0.6b", 32)]
GROUPS = {"internlm2-1.8b": 2, "llama3.2-3b": 3, "qwen3-0.6b": 2,
          "yi-34b": 7}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch, head_dim):
    jcfg, tcfg = tiny(arch), get_tiny(arch)
    if head_dim:
        jcfg = jcfg.with_(head_dim=head_dim)
        tcfg = tcfg.with_(head_dim=head_dim)
    return jcfg, tcfg


def _params(jcfg):
    """Reference params from a seed; qk-norm weights drawn around 1, so the
    norm's scale is exercised too."""
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qk_norm:
        attn = params["layers"][0]["attn"]
        for i, k in enumerate(("q_norm", "k_norm")):
            noise = jax.random.normal(jax.random.PRNGKey(10 + i),
                                      attn[k].shape)
            attn[k] = attn[k] + 0.5 * noise
    return params


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_tiny_variants_keep_the_published_gqa_groups():
    for arch in DENSE:
        full, small = get_config(arch), get_tiny(arch)
        assert full.n_heads // full.n_kv == small.n_heads // small.n_kv \
            == GROUPS[arch]
    qwen = get_config("qwen3-0.6b")
    assert qwen.qk_norm and qwen.n_heads * qwen.hd != qwen.d_model


@pytest.mark.parametrize("arch,head_dim", CASES,
                         ids=[f"{a}-hd{h}" if h else a for a, h in CASES])
def test_step_logits_match_reference(arch, head_dim):
    """Two requests prefilled into disjoint blocks, the first in chunks of
    4, the second in chunks of 3 (so chunks start mid-block), then three
    decode steps over both slots fed the reference's greedy tokens."""
    jcfg, tcfg = _cfgs(arch, head_dim)
    jparams = _params(jcfg)
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    jc = jax_pool_caches(jcfg, jparams, small_pool(prefix_cache=False))
    jchunk = jax.jit(lambda p, c, *a: jdec.prefill_chunk_paged(jcfg, p, c, *a))
    jstep = jax.jit(lambda p, c, *a: jdec.decode_step_paged(jcfg, p, c, *a))
    tc = init_pool_caches(tcfg, PoolConfig(max_slots=2, block_size=4,
                                           max_context=32), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (9, 8)]
    bts = np.zeros((2, 8), np.int32)
    bts[0], bts[1] = np.arange(1, 9), np.arange(9, 17)
    ring = np.array([32, 32], np.int32)
    last = []
    for slot, (prompt, chunk) in enumerate(zip(prompts, (4, 3))):
        for s in range(0, len(prompt), chunk):
            toks = prompt[s:s + chunk][None]
            jl, jc = jchunk(jparams, jc, jnp.asarray(toks), jnp.int32(s),
                            jnp.int32(slot), jnp.asarray(bts[slot]),
                            jnp.int32(32))
            tl, tc = tdec.prefill_chunk_paged(
                tcfg, tparams, tc, torch.from_numpy(toks),
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


@pytest.mark.tier2
def test_quantized_qwen3_engine_tokens_identical_to_reference():
    jcfg, tcfg = _cfgs("qwen3-0.6b", None)
    params = _params(jcfg)
    toks = cal.zero_shot_tokens(jcfg.vocab, 64)
    stats = cal.calibrate(
        lambda p, b, ctx: jtf.loss_fn(jcfg, p, b, ctx=ctx, scan=False),
        params, [{"tokens": jnp.asarray(toks)}])
    qparams, _ = pipe.quantize_model(jcfg, params, stats, 4.3,
                                     jax.random.PRNGKey(3))
    jreqs = mixed_requests(jcfg)
    want = JaxServer(jcfg, qparams, small_pool()).run(jreqs)
    engine = PagedServer(
        tcfg, bridge.params_from_reference(to_numpy_tree(qparams), "cpu"),
        PoolConfig(max_slots=2, block_size=4, max_context=32,
                   prefill_chunk=4), device="cpu")
    got = engine.run([Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                      for r in jreqs])
    assert set(got) == set(want)
    for r in jreqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens,
                                      err_msg=f"rid={r.rid}")
    assert engine.allocator.free_blocks == engine.allocator.num_blocks - 1
