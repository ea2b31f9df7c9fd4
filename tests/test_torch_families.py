"""Port parity for the MLA, RWKV6 and RG-LRU families as a whole: the
bridge at scan period 3 (recurrentgemma's (rglru, rglru, attn) over 5
layers, a full period and a remainder of 2) and the CLI on tiny rwkv6-3b
(calibrate + AllocateBits + RaBitQ-H, fused and unfused samples
byte-identical).

The per-arch engine suites (``test_torch_mla.py``, ``test_torch_rwkv6.py``,
``test_torch_rglru.py``) share ``family_models`` and ``check_engine``
from here: the reference's tiny model, calibrated and quantized at 4.3
bits by the JAX pipeline, carried across by ``repro_torch.bridge``; the
port's own calibration and quantization with the reference's signs (its
allocation must equal the reference's); then the port's ``PagedServer``
against the JAX ``PagedServer`` on the mixed churn workload, greedy
tokens identical, and the port's lockstep ``BatchedServer``, a requested
speculation (bypassed: no round), the prefix cache (bypassed: no hit) and
a preempted and replayed request, each with the same tokens.  The
calibration's alphas (a forward and a backward of each tiny model) agree
with the reference's within rtol 1e-4.  The port runs on one CPU thread
here: tiny tensors gain nothing from more, and the suite's other workers
share the cores.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import mixed_requests, small_pool  # noqa: E402
from test_torch_engine import to_numpy_tree  # noqa: E402
from test_torch_preempt import _preempted_run  # noqa: E402

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.qlinear import QuantizedGrouped as JaxGrouped  # noqa: E402
from repro.core.qlinear import QuantizedLinear as JaxLinear  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

AVG_BITS = 4.3
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _signs(jq: dict) -> dict:
    """name -> (signs1, signs2) of every quantized weight of the
    reference's unrolled tree (``layers``: one list per scan position)."""
    out = {}
    period = len(jq["layers"])
    for j, stack in enumerate(jq["layers"]):
        for idx, lp in enumerate(stack):
            i = idx * period + j

            def walk(node, path):
                if isinstance(node, (JaxLinear, JaxGrouped)):
                    out[f"L{i}." + ".".join(path)] = (
                        torch.tensor(np.asarray(node.signs1)),
                        None if node.signs2 is None
                        else torch.tensor(np.asarray(node.signs2)))
                elif isinstance(node, dict):
                    for k, v in node.items():
                        walk(v, path + (k,))
            walk(lp, ())
    return out


def jax_init(jcfg, seed: int):
    """``jtf.init_params`` under ``jax.jit`` (the same draws, compiled once
    instead of op by op)."""
    return jax.jit(jtf.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def jax_loss_with_ctx(jcfg):
    """A ``loss_with_ctx`` for the reference's ``calibrate`` that runs
    ``jtf.loss_fn`` (unrolled) compiled: the collecting pass returns its
    taps' arrays from the compiled function and takes their static fields
    from the trace; the perturbed pass is differentiated through a jit.
    The same functions as eager calls, compiled once instead of op by op
    (a test-time saving; the reference is unchanged)."""
    static: dict = {}

    def collect(p, b):
        ctx = jcal.LinearCtx(collect=True)
        loss = jtf.loss_fn(jcfg, p, b, ctx=ctx, scan=False)
        arrays = {}
        for name, tap in ctx.taps.items():
            arrays[name] = {k: v for k, v in tap.items()
                            if isinstance(v, jax.Array)}
            static[name] = {k: v for k, v in tap.items()
                            if not isinstance(v, jax.Array)}
        return loss, arrays

    collect_jit = jax.jit(collect)
    perturbed = jax.jit(lambda p, b, pert: jtf.loss_fn(
        jcfg, p, b, ctx=jcal.LinearCtx(perturb=pert), scan=False))

    def loss_with_ctx(p, b, ctx):
        if ctx.collect:
            loss, arrays = collect_jit(p, b)
            for name, tap in arrays.items():
                ctx.taps[name] = {**static[name], **tap}
            return loss
        return perturbed(p, b, ctx.perturb)
    return loss_with_ctx


def family_models(jcfg, tcfg) -> dict:
    """The tiny arch's JAX params (seed 0), the JAX pipeline's 4.3-bit
    quantization and report, both carried across, and the port's own
    pipeline on the carried fp params with the reference's signs."""
    jparams = jax_init(jcfg, 0)
    toks = jcal.zero_shot_tokens(jcfg.vocab, 64)
    jstats = jcal.calibrate(jax_loss_with_ctx(jcfg), jparams,
                            [{"tokens": jnp.asarray(toks)}])
    jq, jrep = jpipe.quantize_model(jcfg, jparams, jstats, AVG_BITS,
                                    jax.random.PRNGKey(3))
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    tstats = tcal.calibrate(
        lambda p, b, ctx: ttf.loss_fn(tcfg, p, b, ctx=ctx), tparams,
        [{"tokens": torch.from_numpy(toks)}])
    _, trep = tpipe.quantize_model(tcfg, tparams, tstats, AVG_BITS,
                                   signs=_signs(jq), device="cpu")
    return {"fp32": (jparams, tparams),
            "quant": (jq, bridge.params_from_reference(to_numpy_tree(jq),
                                                       "cpu")),
            "jstats": jstats, "tstats": tstats, "jrep": jrep, "trep": trep}


def check_allocation(models) -> None:
    """The port's calibration names the reference's linears, and its
    allocation (AllocateBits on its own stats) equals the reference's."""
    jstats, tstats = models["jstats"], models["tstats"]
    assert set(tstats) == set(jstats)
    for name, js in jstats.items():
        ts = tstats[name]
        assert (ts.d, ts.c, ts.m, ts.grouped) == (js.d, js.c, js.m,
                                                  js.grouped), name
        np.testing.assert_allclose(ts.alpha, js.alpha, rtol=1e-4,
                                   err_msg=name)
    jrep, trep = models["jrep"], models["trep"]
    assert trep.per_layer_bits == jrep.per_layer_bits
    assert (trep.n_layers, trep.total_param_bits, trep.overhead_bits) == (
        jrep.n_layers, jrep.total_param_bits, jrep.overhead_bits)
    assert trep.avg_bits == jrep.avg_bits
    assert trep.objective == pytest.approx(jrep.objective, rel=1e-4)


def _port_requests(jreqs):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in jreqs]


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for rid, res in want.items():
        tokens = got[rid] if isinstance(got[rid], np.ndarray) else got[
            rid].tokens
        np.testing.assert_array_equal(tokens, res.tokens,
                                      err_msg=f"{what}: rid={rid}")


def check_engine(jcfg, tcfg, jparams, tparams, what: str) -> None:
    """The port's engine against the JAX engine on the churn workload,
    then the port's lockstep, requested speculation, prefix cache and a
    preempted request against the same tokens."""
    jreqs = mixed_requests(jcfg)
    want = JaxServer(jcfg, jparams, small_pool(prefix_cache=False)).run(jreqs)
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                      prefill_chunk=4)
    engine = PagedServer(tcfg, tparams, pool, device="cpu")
    _same(engine.run(_port_requests(jreqs)), want, f"{what} paged")
    # the prefix cache is on by default and bypassed: nothing to name
    assert engine.prefix_cache is None and "prefix_hits" not in engine.stats
    assert engine.allocator.free_blocks == engine.allocator.num_blocks - 1
    # speculation requested with a draft: bypassed, plain decode loop
    spec = PagedServer(tcfg, tparams, pool, draft_params=tparams,
                       speculate=2, device="cpu")
    _same(spec.run(_port_requests(jreqs)), want, f"{what} speculate=2")
    assert (spec.speculate, spec.draft_caches) == (0, None)
    assert "spec_rounds" not in spec.stats and spec.stats["decode_steps"]
    # lockstep, one request a batch (the reference's own ground truth)
    lock = {r.rid: BatchedServer(tcfg, tparams,
                                 max_context=len(r.prompt) + r.max_new,
                                 device="cpu").generate(r.prompt[None],
                                                        r.max_new)[0]
            for r in jreqs}
    _same(lock, want, f"{what} lockstep")
    # a request preempted mid-decode and replayed
    pre = PagedServer(tcfg, tparams, pool, device="cpu")
    got = _preempted_run(pre, _port_requests(jreqs), 0, "decode")
    _same(got, want, f"{what} preempt + replay")
    assert pre.stats["preemptions"] == pre.stats["replays"] == 1


def test_bridge_unrolls_period_three_in_execution_order():
    """recurrentgemma's tiny variant: 5 layers in 3 stacks (layers 0, 3 |
    1, 4 | 2), fp and quantized, come out as layers 0..4 with the mixer
    of ``cfg.pattern[i]``."""
    from repro.configs import registry as jreg
    jcfg = jreg.get_tiny("recurrentgemma-2b")
    assert jcfg.scan_period == 3 and jcfg.n_layers == 5
    jparams = jax_init(jcfg, 2)
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    assert len(tparams["layers"]) == 5
    for i, (mixer, lp) in enumerate(zip(jcfg.pattern, tparams["layers"])):
        key = {"attn": "attn", "rglru": "rglru"}[mixer]
        assert key in lp and {"ln1", "ln2", "mlp"} <= set(lp), i
        j, idx = i % 3, i // 3
        want = np.asarray(jparams["layers"][j][key]["wo"][idx])
        np.testing.assert_array_equal(lp[key]["wo"].numpy(), want)
    # block-diagonal gates stay 3-D fp tensors
    assert tparams["layers"][0]["rglru"]["wa"].ndim == 3


def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6-3b", "--tiny", "--device", "cpu", "--avg-bits", "3.3",
         "--requests", "2", "--gen", "8", *extra],
        cwd=ROOT, env=env, capture_output=True, timeout=600)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(b"sample:")]
    assert len(lines) == 1
    return res.stdout.decode(errors="replace"), lines[0]


@pytest.mark.tier2
def test_cli_rwkv6_fused_and_unfused_samples_identical():
    out, fused = _cli()
    _, unfused = _cli("--unfused")
    assert fused == unfused
    assert "calibrating + quantizing (3.3 avg bits)" in out
    assert "prefix_cache=off" in out        # bypassed: per-slot state
