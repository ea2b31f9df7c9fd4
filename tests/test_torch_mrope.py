"""Port parity, mrope (tiny qwen2-vl-2b) against the JAX reference on the
host: ``apply_mrope`` with three distinct position streams (with three
equal ones it is ``apply_rope``, which is all the engine and the CLI ever
feed), then the model on a vision-grid position batch -- a 4x4 patch grid
(temporal 0, height i // 4, width i % 4) followed by text whose positions
continue from the grid's largest + 1, as the vision stub would emit them:
``forward`` / ``loss_fn``, ``prefill(positions=)`` + ``decode_step``
against the full forward (the reference's ``tests/test_decode.py``
check), ``make_prefill_step`` / ``make_serve_step`` logits, and one train
step (int8 gradient compression, two microbatches).  Then the pipeline's
allocation, and the port's ``PagedServer`` against the JAX ``PagedServer``
on the churn workload (fp32 and the reference's codes), with the same
tokens from lockstep, speculation (k = 2, a real draft), the prefix cache
and a preempted and replayed request; and the serve CLI.

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

from helpers import (mixed_requests, shared_prefix_requests,  # noqa: E402
                     small_pool)
from test_torch_families import (check_allocation, family_models,  # noqa: E402
                                 jax_init)
from test_torch_families import one_torch_thread  # noqa: E402,F401 autouse
from test_torch_preempt import _preempted_run  # noqa: E402
from test_torch_train import _close_by_leaf_scale, _to_port  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw_init as jadam  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

ARCH = "qwen2-vl-2b"
RTOL = 1e-4
GRID = 4                     # a GRID x GRID patch grid, then text


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def grid_positions(b: int, s: int) -> np.ndarray:
    """(3, b, s) int32: GRID * GRID vision patches (temporal 0, height
    i // GRID, width i % GRID), then text at max + 1, max + 2, ... on all
    three streams."""
    n = GRID * GRID
    pos = np.zeros((3, s), np.int32)
    i = np.arange(min(n, s))
    pos[1, :len(i)], pos[2, :len(i)] = i // GRID, i % GRID
    text = np.arange(s - len(i)) + GRID
    pos[:, len(i):] = text[None]
    return np.broadcast_to(pos[:, None], (3, b, s)).copy()


@pytest.fixture(scope="module")
def setup():
    """(reference cfg, port cfg, reference params, port params, tokens)."""
    jcfg, tcfg = jreg.get_tiny(ARCH), get_tiny(ARCH)
    jparams = jax_init(jcfg, 0)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 25)).astype(np.int32)
    return jcfg, tcfg, jparams, _to_port(jparams), tokens


def test_apply_mrope_distinct_streams_and_the_equal_stream_case():
    cfg = get_tiny(ARCH)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 20, 4, cfg.hd)).astype(np.float32)
    pos = grid_positions(2, 20)
    pos[0] += rng.integers(0, 7, size=pos[0].shape).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                               cfg.mrope_sections, cfg.rope_theta)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              cfg.mrope_sections, cfg.rope_theta)
    _close(got.numpy(), want)
    # the streams differ, so the result is not plain RoPE on any of them
    for stream in range(3):
        rope = tcommon.apply_rope(torch.from_numpy(x),
                                  torch.from_numpy(pos[stream]),
                                  cfg.rope_theta)
        assert not torch.allclose(rope, got, atol=1e-3)
    # three equal streams: exactly apply_rope's half-split rotation
    equal = np.broadcast_to(pos[1][None], pos.shape).copy()
    torch.testing.assert_close(
        tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(equal),
                            cfg.mrope_sections, cfg.rope_theta),
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[1]),
                           cfg.rope_theta), rtol=0, atol=0)


def test_forward_and_loss_on_vision_grid_positions(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    pos = grid_positions(2, tokens.shape[1])
    jl, _ = jax.jit(lambda p, t, q: jtf.forward(jcfg, p, t, positions=q))(
        jparams, jnp.asarray(tokens), jnp.asarray(pos))
    tl, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens),
                        positions=torch.from_numpy(pos))
    _close(tl.numpy(), jl)
    # the grid positions change the logits: the streams are live
    plain, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens))
    assert not torch.allclose(plain, tl, atol=1e-3)
    batch = {"tokens": tokens, "positions": pos}
    jloss = jax.jit(lambda p, b: jtf.loss_fn(jcfg, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = ttf.loss_fn(tcfg, tparams,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_prefill_then_decode_equals_the_full_forward(setup):
    """A vision-grid prefix prefilled (logits equal to the reference's
    prefill), then two decode steps at pos S and S + 1 (all three streams,
    as the reference's step takes them), equal to one forward over the
    whole sequence with those positions."""
    jcfg, tcfg, jparams, tparams, tokens = setup
    s = 20
    pos = grid_positions(2, s)
    jlog, _, _ = jax.jit(lambda p, t, q: jdec.prefill(
        jcfg, p, t, positions=q, context=32, scan=False))(
            jparams, jnp.asarray(tokens[:, :s]), jnp.asarray(pos))
    tlog, caches, n = tdec.prefill(tcfg, tparams,
                                   torch.from_numpy(tokens[:, :s]),
                                   positions=torch.from_numpy(pos),
                                   context=32)
    assert n == s
    _close(tlog.numpy(), jlog)
    full_pos = np.concatenate(
        [pos, np.broadcast_to(np.arange(s, s + 2, dtype=np.int32),
                              (3, 2, 2))], axis=-1)
    full, _ = ttf.forward(tcfg, tparams, torch.from_numpy(tokens[:, :s + 2]),
                          positions=torch.from_numpy(full_pos))
    for t in range(2):
        step, caches = tdec.decode_step(
            tcfg, tparams, caches,
            torch.from_numpy(tokens[:, s + t:s + t + 1]),
            torch.tensor([s + t], dtype=torch.int32))
        _close(step.numpy(), full[:, s + t].numpy())


def test_prefill_and_serve_steps_match_reference(setup):
    """``make_prefill_step`` with a (3, B, S) grid batch and
    ``make_serve_step``: the last position's logits and two greedy decode
    steps against the reference's steps (f32 caches), and the bf16 caches
    the steps keep by default."""
    jcfg, tcfg, jparams, tparams, tokens = setup
    s = 20
    pos = grid_positions(2, s)
    jpre = jsteps.make_prefill_step(jcfg, 32, cache_dtype=jnp.float32)
    jlast, jc = jax.jit(jpre)(jparams, {"tokens": jnp.asarray(tokens[:, :s]),
                                        "positions": jnp.asarray(pos)})
    tlast, tc = tsteps.make_prefill_step(tcfg, 32, cache_dtype=torch.float32)(
        tparams, {"tokens": torch.from_numpy(tokens[:, :s]),
                  "positions": torch.from_numpy(pos)})
    _close(tlast.numpy(), jlast)
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    tserve = tsteps.make_serve_step(tcfg)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    for t in range(2):
        jlog, jc = jserve(jparams, jc, jnp.asarray(nxt), jnp.int32(s + t))
        tlog, tc = tserve(tparams, tc, torch.from_numpy(nxt), s + t)
        _close(tlog.numpy(), jlog)
        nxt = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    _, bf = tsteps.make_prefill_step(tcfg, 32)(
        tparams, {"tokens": torch.from_numpy(tokens[:, :s]),
                  "positions": torch.from_numpy(pos)})
    assert bf[0]["kv"].k.dtype == torch.bfloat16


def test_train_step_with_grid_positions_int8_two_microbatches(setup):
    """One train step on a (3, B, S + 1) grid batch, split in two
    microbatches (the positions on their second axis), int8 gradient
    compression: loss, grad norm and the updated params against the
    reference's jitted step."""
    jcfg, tcfg, jparams, tparams, tokens = setup
    batch = {"tokens": np.concatenate([tokens, tokens[::-1]]),
             "positions": grid_positions(4, tokens.shape[1])}
    batch["positions"][:, 2:] += 3          # the two halves differ
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


@pytest.fixture(scope="module")
def models():
    """The reference's 4.3-bit quantization of tiny qwen2-vl and the
    port's own, with the reference's signs (``family_models``)."""
    return family_models(jreg.get_tiny(ARCH), get_tiny(ARCH))


def test_allocation_equals_reference(models):
    check_allocation(models)


def _requests(jreqs):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in jreqs]


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for rid, res in want.items():
        tokens = got[rid] if isinstance(got[rid], np.ndarray) else got[
            rid].tokens
        np.testing.assert_array_equal(tokens, res.tokens,
                                      err_msg=f"{what}: rid={rid}")


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_engine_tokens_identical_to_reference(models, kind):
    """The churn workload through the port's engine (prefix cache on, no
    hit: the prompts share nothing) against the JAX engine's tokens; the
    same tokens from lockstep (one request a batch), from speculation
    (k = 2, the other of the two models as the draft: a real mix of
    accepted and rejected proposals) and from a request preempted
    mid-decode and replayed.  Then (fp32) shared-prefix requests, whose
    cache hits change no token."""
    jcfg, tcfg = jreg.get_tiny(ARCH), get_tiny(ARCH)
    jparams, tparams = models[kind]
    draft = models["quant" if kind == "fp32" else "fp32"][1]
    jreqs = mixed_requests(jcfg)
    want = JaxServer(jcfg, jparams, small_pool(prefix_cache=False)).run(jreqs)
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                      prefill_chunk=4)
    engine = PagedServer(tcfg, tparams, pool, device="cpu")
    _same(engine.run(_requests(jreqs)), want, f"{kind} paged")
    assert engine.prefix_cache is not None
    lock = {r.rid: BatchedServer(tcfg, tparams,
                                 max_context=len(r.prompt) + r.max_new,
                                 device="cpu").generate(r.prompt[None],
                                                        r.max_new)[0]
            for r in jreqs}
    _same(lock, want, f"{kind} lockstep")
    spec = PagedServer(tcfg, tparams, pool, draft_params=draft, speculate=2,
                       device="cpu")
    _same(spec.run(_requests(jreqs)), want, f"{kind} speculate=2")
    assert spec.stats["spec_rounds"] > 0
    assert 0 < spec.stats["acceptance_rate"] < 1
    pre = PagedServer(tcfg, tparams, pool, device="cpu")
    _same(_preempted_run(pre, _requests(jreqs), 0, "decode"), want,
          f"{kind} preempt + replay")
    assert pre.stats["preemptions"] == pre.stats["replays"] == 1
    if kind != "fp32":
        return
    shared = shared_prefix_requests(jcfg)
    jshared = JaxServer(jcfg, jparams, small_pool()).run(shared)
    cached = PagedServer(tcfg, tparams, pool, device="cpu")
    _same(cached.run(_requests(shared)), jshared, f"{kind} prefix cache")
    assert cached.stats["prefix_hits"] > 0


@pytest.mark.tier2
def test_cli_fused_unfused_and_lockstep_samples_identical(capsys):
    """The serve CLI in this process: calibrate, allocate and quantize
    tiny qwen2-vl at 3.3 bits, then serve it fused, unfused and lockstep;
    the three ``sample:`` lines are the same."""
    samples = []
    for extra in ((), ("--unfused",), ("--lockstep",)):
        serve_main(["--arch", ARCH, "--tiny", "--device", "cpu",
                    "--avg-bits", "3.3", "--requests", "2", "--gen", "8",
                    *extra])
        out = capsys.readouterr().out
        assert "quantized 12 layers" in out
        lines = [ln for ln in out.splitlines() if ln.startswith("sample:")]
        assert len(lines) == 1
        samples.append(lines[0])
    assert samples[0] == samples[1] == samples[2]
