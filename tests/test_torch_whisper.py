"""Port parity, Whisper (tiny whisper-large-v3, encoder-decoder) against
the JAX reference on the host, with seeded random frames (B, T, d)
standing in for the audio stub: ``sinusoidal_positions`` (the reference's
divisor max(d/2 - 1, 1)), ``encode``, ``forward`` / ``loss_fn`` with
``enc_embeds``, ``prefill`` + ``decode_step`` against the full forward
(the reference's ``tests/test_decode.py`` check), ``make_prefill_step`` /
``make_serve_step`` logits and their cache dtypes (the self-attention
cache in ``cache_dtype``, the cross K/V in f32), one train step (int8
gradient compression over both layer stacks, two microbatches), the
pipeline's allocation over the ``L`` and ``enc`` scopes, and the lockstep
steps' greedy tokens (fp32 and the reference's codes).  The paged engine,
its pool, ``BatchedServer``, the serve CLI and the train CLI refuse the
arch with the encoder-decoder error.

Tolerance: rtol 1e-4 of the largest |value| (f32; summation order
differs); a train step's loss rtol 1e-5 and its params 1e-3 of each
leaf's largest |value| (``test_torch_train``'s bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_engine import to_numpy_tree  # noqa: E402
from test_torch_families import jax_init, jax_loss_with_ctx  # noqa: E402
from test_torch_families import one_torch_thread  # noqa: E402,F401 autouse
from test_torch_train import _close_by_leaf_scale, _to_port  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.qlinear import QuantizedLinear as JaxLinear  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw_init as jadam  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig  # noqa: E402
from repro_torch.serve.pool import init_pool_caches  # noqa: E402

ARCH = "whisper-large-v3"
RTOL = 1e-4
AVG_BITS = 4.3
ENC_DEC = "encoder-decoder"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def frames(b: int, cfg, seed: int = 1) -> np.ndarray:
    """Seeded stand-in encoder frames (b, n_audio_ctx, d)."""
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """(reference cfg, port cfg, reference params, port params, tokens,
    frames)."""
    jcfg, tcfg = jreg.get_tiny(ARCH), get_tiny(ARCH)
    jparams = jax_init(jcfg, 0)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 17)).astype(np.int32)
    return jcfg, tcfg, jparams, _to_port(jparams), tokens, frames(2, jcfg)


@pytest.mark.parametrize("n,d", [(30, 64), (1500, 1280), (7, 2), (5, 9)])
def test_sinusoidal_positions_match_reference(n, d):
    """Each entry is sin or cos of an f32 angle of up to n - 1 radians,
    which the two frameworks' ``pow`` round differently by an ulp or two
    (at n = 1500, 2 ulps of 1499 = 2.4e-4 measured): the bound is rtol 1e-4
    or 4 ulps of the largest angle, whichever is larger."""
    want = np.asarray(jcommon.sinusoidal_positions(n, d))
    got = tcommon.sinusoidal_positions(n, d).numpy()
    atol = max(RTOL * np.abs(want).max(), 4 * np.spacing(np.float32(n - 1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the divisor is max(d/2 - 1, 1): the last frequency is 1 / 10000
    if d >= 4:
        np.testing.assert_allclose(got[1, d // 2 - 1], np.sin(1e-4),
                                   rtol=1e-6)


def test_bridge_carries_the_encoder(setup):
    jcfg, tcfg, jparams, tparams, _, _ = setup
    assert len(tparams["enc_layers"]) == jcfg.n_enc_layers
    for i, lp in enumerate(tparams["enc_layers"]):
        want = np.asarray(jparams["enc_layers"][0]["attn"]["wq"][i])
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(), want)
        assert "xattn" not in lp
    for lp in tparams["layers"]:
        assert {"ln_x", "xattn"} <= set(lp) and "q_norm" not in lp["xattn"]
    np.testing.assert_array_equal(tparams["enc_norm"]["bias"].numpy(),
                                  np.asarray(jparams["enc_norm"]["bias"]))


def test_encode_forward_and_loss_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens, enc = setup
    jenc = jax.jit(lambda p, e: jtf.encode(jcfg, p, e))(jparams,
                                                        jnp.asarray(enc))
    tenc = ttf.encode(tcfg, tparams, torch.from_numpy(enc))
    _close(tenc.numpy(), jenc)
    jl, _ = jax.jit(lambda p, t, e: jtf.forward(jcfg, p, t, enc_embeds=e))(
        jparams, jnp.asarray(tokens), jnp.asarray(enc))
    tl, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens),
                        enc_embeds=torch.from_numpy(enc))
    _close(tl.numpy(), jl)
    # the encoder's output is live: other frames, other logits
    other, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens),
                           encoder_out=tenc.flip(0))
    assert not torch.allclose(other, tl, atol=1e-3)
    batch = {"tokens": tokens, "enc_embeds": enc}
    jloss = jax.jit(lambda p, b: jtf.loss_fn(jcfg, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = ttf.loss_fn(tcfg, tparams,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    with pytest.raises(ValueError, match="enc_embeds"):
        ttf.forward(tcfg, tparams, torch.from_numpy(tokens))


def test_prefill_then_decode_equals_the_full_forward(setup):
    jcfg, tcfg, jparams, tparams, tokens, enc = setup
    s = 12
    jlog, _, _ = jax.jit(lambda p, t, e: jdec.prefill(
        jcfg, p, t, enc_embeds=e, context=32, scan=False))(
            jparams, jnp.asarray(tokens[:, :s]), jnp.asarray(enc))
    tlog, caches, _ = tdec.prefill(tcfg, tparams,
                                   torch.from_numpy(tokens[:, :s]),
                                   enc_embeds=torch.from_numpy(enc),
                                   context=32)
    _close(tlog.numpy(), jlog)
    assert [list(c) for c in caches] == [["kv", "xk", "xv"]] * tcfg.n_layers
    # the sinusoidal table spans the self-attention ring, not the frames
    assert tdec.caches_context(caches, tcfg) == 2048
    full, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens),
                          enc_embeds=torch.from_numpy(enc))
    for t in range(3):
        step, caches = tdec.decode_step(
            tcfg, tparams, caches,
            torch.from_numpy(tokens[:, s + t:s + t + 1]),
            torch.tensor([s + t], dtype=torch.int32))
        _close(step.numpy(), full[:, s + t].numpy())


def _lockstep_greedy(steps, params, batch, n_tokens, pos0, to_in, to_np):
    """The reference's serving loop on either side: the prefill step, then
    ``n_tokens`` greedy serve steps -> (tokens (B, n), the logits)."""
    prefill, serve = steps
    last, caches = prefill(params, batch)
    out, logits = [], []
    for t in range(n_tokens):
        logits.append(to_np(last))
        tok = np.argmax(logits[-1], -1).astype(np.int32)[:, None]
        out.append(tok[:, 0])
        last, caches = serve(params, caches, to_in(tok), pos0 + t)
    return np.stack(out, 1), logits


def _jax_steps(jcfg, context, cache_dtype=jnp.float32):
    pre = jax.jit(jsteps.make_prefill_step(jcfg, context, cache_dtype))
    serve = jax.jit(jsteps.make_serve_step(jcfg))
    return pre, lambda p, c, t, pos: serve(p, c, t, jnp.int32(pos))


def test_prefill_and_serve_steps_match_reference(setup):
    """Logits of ``make_prefill_step`` (frames in the batch) and four
    greedy ``make_serve_step`` calls against the reference's, f32 caches;
    by default the self-attention cache is bf16 and the cross K/V f32."""
    jcfg, tcfg, jparams, tparams, tokens, enc = setup
    s = 12
    jw, jlogits = _lockstep_greedy(
        _jax_steps(jcfg, 32), jparams,
        {"tokens": jnp.asarray(tokens[:, :s]), "enc_embeds": jnp.asarray(enc)},
        4, s, jnp.asarray, np.asarray)
    tw, tlogits = _lockstep_greedy(
        (tsteps.make_prefill_step(tcfg, 32, cache_dtype=torch.float32),
         tsteps.make_serve_step(tcfg)), tparams,
        {"tokens": torch.from_numpy(tokens[:, :s]),
         "enc_embeds": torch.from_numpy(enc)},
        4, s, torch.from_numpy, lambda t: t.numpy())
    for got, want in zip(tlogits, jlogits):
        _close(got, want)
    np.testing.assert_array_equal(tw, jw)
    _, caches = tsteps.make_prefill_step(tcfg, 32)(
        tparams, {"tokens": torch.from_numpy(tokens[:, :s]),
                  "enc_embeds": torch.from_numpy(enc)})
    assert caches[0]["kv"].k.dtype == torch.bfloat16
    assert caches[0]["xk"].dtype == caches[0]["xv"].dtype == torch.float32
    assert caches[0]["xk"].shape == (2, jcfg.n_audio_ctx, jcfg.n_kv, jcfg.hd)


def test_train_step_with_frames_int8_two_microbatches(setup):
    jcfg, tcfg, jparams, tparams, tokens, _ = setup
    batch = {"tokens": np.concatenate([tokens, tokens[::-1]]),
             "enc_embeds": frames(4, jcfg, seed=5)}
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=5, microbatches=2,
              grad_compression="int8")
    jp, _, jm = jax.jit(jsteps.make_train_step(jcfg, remat=False, **kw))(
        jparams, jadam(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = _to_port(jparams)     # the step updates params in place
    tp, _, tm = tsteps.make_train_step(tcfg, **kw)(
        tparams, adamw_init(tparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    _close_by_leaf_scale(tp, jp, 1e-3, off_share=5e-3, max_move=1e-2)


def _signs(jq: dict) -> dict:
    """name -> (signs1, signs2) of the reference's quantized weights, the
    decoder's (``L{i}``) and the encoder's (``enc{i}``)."""
    out = {}
    for scope, key in (("L", "layers"), ("enc", "enc_layers")):
        for i, lp in enumerate(jq[key][0]):
            def walk(node, path):
                if isinstance(node, JaxLinear):
                    out[f"{scope}{i}." + ".".join(path)] = (
                        torch.tensor(np.asarray(node.signs1)),
                        None if node.signs2 is None
                        else torch.tensor(np.asarray(node.signs2)))
                elif isinstance(node, dict):
                    for k, v in node.items():
                        walk(v, path + (k,))
            walk(lp, ())
    return out


@pytest.fixture(scope="module")
def models(setup):
    """Both pipelines on a batch of zero-shot tokens + frames: the
    reference's 4.3-bit quantization (carried across) and the port's own
    with the reference's signs."""
    jcfg, tcfg, jparams, tparams, _, _ = setup
    batch = {"tokens": jcal.zero_shot_tokens(jcfg.vocab, 24),
             "enc_embeds": frames(1, jcfg, seed=7)}
    jstats = jcal.calibrate(jax_loss_with_ctx(jcfg), jparams,
                            [{k: jnp.asarray(v) for k, v in batch.items()}])
    jq, jrep = jpipe.quantize_model(jcfg, jparams, jstats, AVG_BITS,
                                    jax.random.PRNGKey(3))
    tstats = tcal.calibrate(
        lambda p, b, ctx: ttf.loss_fn(tcfg, p, b, ctx=ctx), tparams,
        [{k: torch.from_numpy(v) for k, v in batch.items()}])
    tq, trep = tpipe.quantize_model(tcfg, tparams, tstats, AVG_BITS,
                                    signs=_signs(jq), device="cpu")
    return {"jstats": jstats, "tstats": tstats, "jrep": jrep, "trep": trep,
            "jq": jq, "tq": tq}


def test_allocation_over_both_scopes_equals_reference(models):
    jstats, tstats = models["jstats"], models["tstats"]
    assert set(tstats) == set(jstats)
    assert {"enc0.attn.wq", "L1.xattn.wk", "enc1.mlp.wo"} <= set(tstats)
    for name, js in jstats.items():
        ts = tstats[name]
        assert (ts.d, ts.c, ts.m) == (js.d, js.c, js.m), name
        np.testing.assert_allclose(ts.alpha, js.alpha, rtol=1e-4,
                                   err_msg=name)
    jrep, trep = models["jrep"], models["trep"]
    assert list(trep.per_layer_bits) == list(jrep.per_layer_bits)
    assert trep.per_layer_bits == jrep.per_layer_bits
    assert (trep.n_layers, trep.total_param_bits, trep.overhead_bits) == (
        jrep.n_layers, jrep.total_param_bits, jrep.overhead_bits)
    assert trep.avg_bits == jrep.avg_bits
    assert trep.objective == pytest.approx(jrep.objective, rel=1e-4)
    names = list(trep.per_layer_bits)
    # the encoder's weights come after every decoder weight
    last = get_tiny(ARCH).n_layers - 1
    assert names.index("enc0.attn.wk") > names.index(f"L{last}.xattn.wv")
    assert isinstance(models["tq"]["enc_layers"][1]["mlp"]["wi"],
                      tpipe.QuantizedLinear)


def test_dual_quantization_covers_the_encoder(setup, models):
    """``quantize_model_dual`` quantizes the encoder in both halves, and
    the draft's encoder weights share the target's sign tensors."""
    jcfg, tcfg, _, tparams, _, _ = setup
    tq, _, dq, drep = tpipe.quantize_model_dual(
        tcfg, tparams, models["tstats"], AVG_BITS, 2.2, device="cpu",
        signs=_signs(models["jq"]))
    assert sum(n.startswith("enc") for n in drep.per_layer_bits) == \
        6 * jcfg.n_enc_layers
    for t, d in zip(tq["enc_layers"], dq["enc_layers"]):
        for g, k in (("attn", "wq"), ("mlp", "wo")):
            assert d[g][k].signs1 is t[g][k].signs1
            assert d[g][k].bits <= t[g][k].bits
    assert dq["enc_norm"]["scale"] is tq["enc_norm"]["scale"]


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_lockstep_greedy_tokens_identical_to_reference(setup, models, kind):
    """16 greedy tokens after a 6-token prompt, the port's steps against
    the reference's (bf16 self-attention caches, as the steps default)."""
    jcfg, tcfg, jparams, tparams, tokens, enc = setup
    if kind == "quant":
        jparams = models["jq"]
        tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    jw, _ = _lockstep_greedy(
        _jax_steps(jcfg, 24, jnp.bfloat16), jparams,
        {"tokens": jnp.asarray(tokens[:, :6]), "enc_embeds": jnp.asarray(enc)},
        16, 6, jnp.asarray, np.asarray)
    tw, _ = _lockstep_greedy(
        (tsteps.make_prefill_step(tcfg, 24), tsteps.make_serve_step(tcfg)),
        tparams, {"tokens": torch.from_numpy(tokens[:, :6]),
                  "enc_embeds": torch.from_numpy(enc)},
        16, 6, torch.from_numpy, lambda t: t.numpy())
    np.testing.assert_array_equal(tw, jw)


def test_serving_paths_refuse_the_encoder_decoder(setup):
    _, tcfg, _, tparams, _, _ = setup
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32)
    with pytest.raises(ValueError, match=ENC_DEC):
        PagedServer(tcfg, tparams, pool, device="cpu")
    with pytest.raises(ValueError, match=ENC_DEC):
        init_pool_caches(tcfg, pool, "cpu")
    with pytest.raises(ValueError, match=ENC_DEC):
        BatchedServer(tcfg, tparams, device="cpu")
    one = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=ENC_DEC):
        tdec.decode_step_paged(tcfg, tparams, [], one, one[0], one[0] > 0,
                               one, one[0])
    with pytest.raises(ValueError, match="encoder frames"):
        ttrain.train(arch=ARCH, steps=1, device="cpu")


@pytest.mark.parametrize("extra", [(), ("--lockstep",)],
                         ids=["paged", "lockstep"])
def test_serve_cli_refuses_whisper(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_main(["--arch", ARCH, "--tiny", "--device", "cpu", *extra])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert ENC_DEC in out.err and "sample:" not in out.out
