"""Compile-once serving steps (``repro_torch/serve/graphs.py``), on the host.

On the card the port's engine captures each serving step as a CUDA graph
once per key and replays it, as the reference jits ``_step`` and ``_chunk``
(``repro/serve/engine.py:338-371``).  On the CPU nothing is captured, but
the same ``StepGraphs`` object keys, warms up and counts every step as on
the card, so these tests hold:

  * the keying: one decode capture under batch churn (the counterpart of
    ``tests/test_paged_engine.py::test_decode_step_compiles_once_under_churn``)
    and one prompt-chunk capture per distinct chunk length, per fusion
    setting; none under ``graphs.eager()``;
  * parity: greedy tokens identical to the JAX engine's for RaanA-quantized
    tiny llama2 and tiny mixtral, fused and unfused (both held to one
    reference run per model: the reference's greedy tokens on this
    workload are the same fused and unfused).  Mixtral's 38-token
    request wraps its window-16 ring, and its last chunk (6 tokens, at
    position 32) is the first of its length, so it is warmed up while the
    ring holds history the real chunk reads: a warm-up on the real inputs
    instead of the inert ones would overwrite it;
  * the launch counters: a capture's own launches are not counted, and the
    helper credits k replays x the launches of one capture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import PROMPT_LENS, mixed_requests, small_pool, tiny  # noqa: E402

from repro.core import calibrate as cal  # noqa: E402
from repro.core import pipeline as pipe  # noqa: E402
from repro.core.qlinear import QuantizedGrouped as JaxQuantizedGrouped  # noqa: E402
from repro.core.qlinear import QuantizedLinear as JaxQuantizedLinear  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch import bridge, kernels  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402

CHUNK = 8


def _port_requests(jreqs):
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in jreqs]


def _chunk_lengths(prompt_lens, chunk):
    """Every prompt chunk's length when prompts are cut into ``chunk``s
    (no ring is shorter than a chunk here)."""
    return {min(chunk, n - s) for n in prompt_lens for s in range(0, n, chunk)}


# ------------------------------------------------------------------ keying


@pytest.mark.parametrize("fused", [True, False])
def test_one_decode_capture_under_churn_and_one_per_chunk_length(fused):
    """2 slots, 5 mixed-length requests, queued joins and completions: the
    decode step is captured once, a prompt chunk once per length."""
    jcfg = tiny("llama2-7b")
    cfg = get_tiny("llama2-7b")
    params = tf.init_params(cfg, device="cpu")
    pool = PoolConfig(**{k: getattr(small_pool(prefill_chunk=CHUNK), k)
                         for k in ("max_slots", "block_size", "max_context",
                                   "prefill_chunk")})
    engine = PagedServer(cfg, params, pool, fused=fused, device="cpu")
    results = engine.run(_port_requests(mixed_requests(jcfg)))
    assert len(results) == len(PROMPT_LENS)
    assert engine.stats["decode_steps"] > 1
    assert engine.decode_trace_count == 1, (
        f"decode step captured {engine.decode_trace_count} times")
    lengths = _chunk_lengths(PROMPT_LENS, CHUNK)
    assert engine.chunk_trace_count == len(lengths) == 4
    assert set(engine.graphs.steps) == (
        {("decode", fused, pool.max_slots)}
        | {("chunk", fused, c) for c in lengths})
    assert engine.stats["captures"] == 1 + len(lengths)

    with graphs.eager():
        eager = PagedServer(cfg, params, pool, fused=fused, device="cpu")
        again = eager.run(_port_requests(mixed_requests(jcfg)))
    assert eager.decode_trace_count == eager.chunk_trace_count == 0
    for rid, r in results.items():
        np.testing.assert_array_equal(again[rid].tokens, r.tokens)


def test_steps_are_keyed_warmed_up_on_inert_inputs_and_reused():
    """A key's step is made once, its warm-up sees the inert inputs, and
    each call then runs on the caller's inputs; the fusion setting is part
    of the key."""
    seen = []

    def fn(x, n):
        seen.append((x.clone(), int(n)))
        return x * n

    steps = graphs.StepGraphs(torch.device("cpu"))
    inert = {"x": np.zeros(3, np.float32), "n": np.int32(0)}
    for fused in (True, False):
        step = steps.get(("chunk", fused, 3), fn, lambda: inert)
        assert steps.get(("chunk", fused, 3), fn, lambda: inert) is step
        out = step({"x": np.arange(3, dtype=np.float32), "n": np.int32(2)})
        np.testing.assert_array_equal(out.numpy(), [0.0, 2.0, 4.0])
    assert steps.captures == {"chunk": 2}
    assert [n for _, n in seen] == [0, 2, 0, 2]       # warm-up, call, ...
    assert all(not x.any() for x, n in seen if n == 0)


# ------------------------------------------------------------------ parity


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


@pytest.fixture(scope="module", params=["llama2-7b", "mixtral-8x7b"])
def quantized(request):
    """(arch, reference cfg, port cfg, JAX params, port params): tiny,
    RaanA-quantized at 4.3 bits (no-drop MoE capacity)."""
    arch = request.param
    jcfg = tiny(arch)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    toks = cal.zero_shot_tokens(jcfg.vocab, 64)
    stats = cal.calibrate(
        lambda p, b, ctx: jtf.loss_fn(jcfg, p, b, ctx=ctx, scan=False),
        params, [{"tokens": jnp.asarray(toks)}])
    qparams, _ = pipe.quantize_model(jcfg, params, stats, 4.3,
                                     jax.random.PRNGKey(3))
    tcfg = get_tiny(arch)
    if tcfg.moe is not None:
        tcfg = tcfg.with_(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=jcfg.moe.capacity_factor))
    return (arch, jcfg, tcfg, qparams,
            bridge.params_from_reference(to_numpy_tree(qparams), "cpu"))


@pytest.fixture(scope="module")
def reference(quantized):
    """(requests, the JAX engine's results) for ``quantized``'s model: the
    churn workload plus a 38-token request, one fused run."""
    _, jcfg, _, jparams, _ = quantized
    rng = np.random.default_rng(11)
    long_req = JaxRequest(rid=99, prompt=rng.integers(
        0, jcfg.vocab, 38).astype(np.int32), max_new=6)
    jreqs = mixed_requests(jcfg) + [long_req]
    jpool = small_pool(prefix_cache=False, max_context=48,
                       prefill_chunk=CHUNK)
    return jreqs, JaxServer(jcfg, jparams, jpool).run(jreqs)


@pytest.mark.tier2
@pytest.mark.parametrize("fused", [True, False])
def test_engine_tokens_identical_to_reference(quantized, reference, fused):
    arch, jcfg, tcfg, jparams, tparams = quantized
    jreqs, want = reference
    long_req = jreqs[-1]
    pool = PoolConfig(max_slots=2, block_size=4, max_context=48,
                      prefill_chunk=CHUNK)
    engine = PagedServer(tcfg, tparams, pool, fused=fused, device="cpu")
    got = engine.run(_port_requests(jreqs))
    assert set(got) == set(want)
    for r in jreqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens,
                                      err_msg=f"{arch} fused={fused}: "
                                              f"rid={r.rid}")
    # the long request's last chunk (6 tokens) is the only one of its length
    assert engine.chunk_trace_count == len(
        _chunk_lengths([len(r.prompt) for r in jreqs], CHUNK)) == 5
    assert engine.decode_trace_count == 1
    if jcfg.window:
        assert len(long_req.prompt) > jcfg.window   # the ring wraps


# ---------------------------------------------------------------- counters


def test_credit_adds_k_replays_of_one_capture():
    before = kernels.launch_counts()
    try:
        qops.launches += 3              # what one capture recorded
        pops.launches += 2
        per_replay = kernels.launches_since(before)
        assert per_replay == {**{k: 0 for k in before},
                              "rht_qmatmul": 3, "paged_attention": 2}
        kernels.set_launch_counts(before)   # a capture runs nothing
        for k in range(1, 5):
            kernels.credit_launches(per_replay)
            assert kernels.launches_since(before) == {
                n: k * per_replay[n] for n in before}
        kernels.credit_launches(per_replay, times=10)
        assert kernels.launches_since(before)["rht_qmatmul"] == 3 * 14
    finally:
        kernels.set_launch_counts(before)


def test_warm_up_and_capture_launches_are_not_counted():
    """A step's making (warm-up, and capture on the card) leaves the
    counters as they were; on the CPU each call then runs the step, whose
    wrappers count as they launch."""
    def fn(x):
        qops.launches += 1              # as a kernel wrapper counts
        return x + 1

    before = kernels.launch_counts()
    try:
        steps = graphs.StepGraphs(torch.device("cpu"))
        step = steps.get(("decode", True, 2), fn,
                         lambda: {"x": np.zeros(2, np.int32)})
        assert kernels.launches_since(before)["rht_qmatmul"] == 0
        for _ in range(3):
            step({"x": np.ones(2, np.int32)})
        assert kernels.launches_since(before)["rht_qmatmul"] == 3
    finally:
        kernels.set_launch_counts(before)


def test_plain_forced_reads_every_serving_kernels_switch():
    assert not kernels.plain_forced()
    for mod in (qops, pops):
        mod.set_forced_path("ref")
        try:
            assert kernels.plain_forced()
        finally:
            mod.set_forced_path(None)
    # paged_kernel(False) selects the dense gather, which a graph captures
    with pops.paged_kernel(False):
        assert not kernels.plain_forced()
    assert not kernels.plain_forced()
