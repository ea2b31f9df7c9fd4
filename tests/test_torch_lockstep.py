"""The port's lockstep path against the JAX reference on the host: the dense
ring KV cache (``models/attention.py``: ``KVCache``, ``cache_insert``,
``decode_attention``), the whole-sequence ``prefill`` and the one-token
``decode_step`` (``models/decode.py``), and ``launch/serve.BatchedServer``.

Tiny llama2 (cut to 2 layers) and tiny mixtral (MoE top-2 at the no-drop
capacity, window 16: the 20-token prompts fill the 16-slot ring past its
end in prefill and the decode steps keep wrapping it), fp32 and on the
reference's own quantized codes carried across by ``repro_torch.bridge``.
Logits agree within rtol 1e-4 (f32; summation orders differ), and the
greedy tokens of the port's ``BatchedServer`` equal the reference
``BatchedServer``'s.  The quantized weights come from the reference's
``quantize_linear`` (llama2's attention projections, at every width 1-8
with random activation norms: outlier columns split off, non-power-of-2
``d_keep``) and ``quantize_grouped`` (Mixtral's experts), not from the
calibrated pipeline, and the reference's steps run jitted, to keep the
file's cost down; neither changes the path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import tiny  # noqa: E402
from test_torch_engine import _moe_cfgs, to_numpy_tree  # noqa: E402

from repro.core.qlinear import quantize_grouped, quantize_linear  # noqa: E402
from repro.launch.serve import BatchedServer as JaxBatchedServer  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402

ARCHS = ["llama2-7b", "mixtral-8x7b"]
WIDTHS = (3, 4, 5, 2, 8, 6, 7, 1)
PROMPT, GEN, CONTEXT = 20, 6, 32


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _quantize(params, groups, seed: int = 3):
    """The reference's quantizers over every linear (or expert stack) of
    ``groups`` in ``params`` (stacked fp tree), as the unrolled per-layer
    list ``quantize_model`` builds."""
    key, rng = jax.random.PRNGKey(seed), np.random.default_rng(seed)
    stack = params["layers"][0]
    layers, i = [], 0
    for layer in range(jax.tree.leaves(stack)[0].shape[0]):
        lp = jax.tree.map(lambda a: a[layer], stack)
        for group in groups:
            sub = dict(lp[group])
            for k in ("wq", "wk", "wv", "wo", "wi"):
                if k not in sub:
                    continue
                key, kk = jax.random.split(key)
                bits = WIDTHS[i % len(WIDTHS)]
                i += 1
                sub[k] = (quantize_grouped(sub[k], bits, kk) if group == "moe"
                          else quantize_linear(
                              sub[k], bits, kk,
                              x_col_norms=rng.random(sub[k].shape[0])))
            lp = dict(lp, **{group: sub})
        layers.append(lp)
    return dict(params, layers=[layers])


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, jax cfg, port cfg, {"fp32" | "quant": (jax params, port
    params)})."""
    arch = request.param
    jcfg, tcfg = (_moe_cfgs("nodrop") if arch == "mixtral-8x7b"
                  else (tiny(arch).with_(n_layers=2),
                        get_tiny(arch).with_(n_layers=2)))
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    # llama2's attention projections take every width (two layers of
    # four, WIDTHS cycled); Mixtral's quantized experts are its own path
    # (grouped codes).  Each further shape costs the reference a compile
    groups = ("moe",) if jcfg.moe is not None else ("attn",)
    kinds = {"fp32": params, "quant": _quantize(params, groups)}
    return arch, jcfg, tcfg, {
        k: (p, bridge.params_from_reference(to_numpy_tree(p), "cpu"))
        for k, p in kinds.items()}


def _prompts(cfg, b: int = 2) -> np.ndarray:
    return np.random.default_rng(5).integers(
        0, cfg.vocab, (b, PROMPT)).astype(np.int32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_prefill_and_decode_logits_match_reference(model, kind):
    """Prefill two prompts, then three decode steps fed the reference's
    greedy tokens; ``pos`` goes in as a one-element tensor.  The port's
    ``BatchedServer`` must choose the reference's greedy chain (the
    reference ``BatchedServer``'s algorithm: prefill, argmax, decode step,
    argmax, ...)."""
    arch, jcfg, tcfg, kinds = model
    jparams, tparams = kinds[kind]
    prompts = _prompts(jcfg)
    jprefill = jax.jit(lambda p, t: jdec.prefill(jcfg, p, t, context=CONTEXT,
                                                 scan=False)[:2])
    jstep = jax.jit(lambda p, c, t, pos: jdec.decode_step(jcfg, p, c, t, pos,
                                                          scan=False))
    jl, jc = jprefill(jparams, jnp.asarray(prompts))
    with torch.no_grad():
        tl, tc, pos = tdec.prefill(tcfg, tparams, torch.from_numpy(prompts),
                                   context=CONTEXT)
    assert pos == PROMPT
    _close(tl.numpy(), jl)
    cap = tc[0]["kv"].k.shape[1]
    assert cap == (16 if jcfg.window else CONTEXT)
    assert (tdec.caches_context(tc, tcfg) == jdec.caches_context(jc, jcfg)
            == 2048)
    for layer, cache in enumerate(tc):       # the ring holds the reference's
        _close(cache["kv"].k.numpy(), jc[0]["kv"].k[layer])
    toks = np.argmax(np.asarray(jl[:, -1]), axis=-1).astype(np.int32)[:, None]
    chain = [toks]
    for t in range(3):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks), jnp.int32(PROMPT + t))
        with torch.no_grad():
            tl, tc = tdec.decode_step(
                tcfg, tparams, tc, torch.from_numpy(toks),
                torch.tensor([PROMPT + t], dtype=torch.int32))
        _close(tl.numpy(), jl)
        toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        chain.append(toks)
    got = BatchedServer(tcfg, tparams, max_context=CONTEXT,
                        device="cpu").generate(prompts, len(chain))
    np.testing.assert_array_equal(got, np.concatenate(chain, axis=1))


@pytest.mark.parametrize("model", ["llama2-7b"], indirect=True)
def test_batched_server_greedy_tokens_match_reference(model):
    """The port's ``BatchedServer`` (its decode step keyed and run as on the
    card) against the reference ``BatchedServer``, fp32 tiny llama2; a
    second call on the same server reuses the step and its zeroed cache,
    and eager gives the same tokens."""
    arch, jcfg, tcfg, kinds = model
    jparams, tparams = kinds["fp32"]
    prompts = _prompts(jcfg)
    want = JaxBatchedServer(jcfg, jparams, max_context=CONTEXT).generate(
        prompts, GEN)
    server = BatchedServer(tcfg, tparams, max_context=CONTEXT, device="cpu")
    got = server.generate(prompts, GEN)
    np.testing.assert_array_equal(got, want, err_msg=arch)
    np.testing.assert_array_equal(server.generate(prompts, GEN), want)
    assert server.decode_trace_count == 1
    assert server.stats["decode_steps"] == GEN
    with graphs.eager():
        eager = BatchedServer(tcfg, tparams, max_context=CONTEXT,
                              device="cpu")
        np.testing.assert_array_equal(eager.generate(prompts, GEN), want)
    assert eager.decode_trace_count == 0


def test_batched_server_refuses_what_the_port_cannot_serve():
    cfg = get_tiny("llama2-7b")
    params = bridge.params_from_reference(to_numpy_tree(
        jtf.init_params(tiny("llama2-7b"), jax.random.PRNGKey(0))), "cpu")
    server = BatchedServer(cfg, params, max_context=16, device="cpu")
    with pytest.raises(ValueError, match="max_context"):
        server.generate(np.zeros((1, 12), np.int32), 8)
    # sampling draws from the given generator: same seed, same tokens
    prompts = np.zeros((2, 4), np.int32)
    a, b = (server.generate(prompts, 4, temperature=0.8,
                            generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown mixer"):
        tdec.init_layer_cache(cfg, "xattn", 1, 8)
    # Whisper has no encoder frames to pass here (nor in the reference's
    # BatchedServer): refused at construction
    with pytest.raises(ValueError, match="encoder-decoder"):
        BatchedServer(get_tiny("whisper-large-v3"), params, device="cpu")
