"""Tensor-parallel serving in the port (``repro_torch/runtime/tp.py``,
``launch/mesh.py``, ``runtime/compression.int8_psum``) against the JAX
reference (``repro/runtime/tp.py``, ``tests/test_tp_serving.py``), on the
host.

In process: ``plan_for`` equal to the reference's for every registry
config (tiny and published) at TP 1, 2, 4 and 8; ``_glu_perm`` equal to
the reference's; each rank's weights from ``prepare_params`` equal to
numpy slices of the reference's permuted leaves (its ``_decision`` and
``_glu_perm``), quantized fields included, with the full static ``c``
kept; the gathers are shape-driven no-ops at full width and raise on a
slice outside a group; ``make_host_mesh`` validates its degree and
backend; a sliced ``QuantizedLinear`` hands the GEMM its full width to
plan from, and the engine names the model's KV heads to the paged read.

Spawned: one run of two gloo ranks (``mesh.spawn``, a ``file://``
rendezvous) serves the scenarios of ``tests/test_tp_serving.py`` on the
tiny configs, ``small_pool`` and the churn workload; each case reads its
scenario's result.  llama2's weights are the reference's, bridged; the
quantized scenarios serve the port's quantization of them (the port's
quantizer is held to the reference's elsewhere, and the reference's
compiles would double this file's time).  TP=2 greedy tokens must equal
the port's TP=1 tokens, and for llama2 fp32 the JAX engine's too.  The
same ranks run ``int8_psum``, which must equal the reference's under
``jax.vmap`` with an axis name (the reference's ``pmax`` / ``psum`` over
the mapped axis).  Then they serve the streaming front door
(``launch.serve.frontdoor_rank``) over llama2 fp32 and its quantization:
rank 0's clients stream the churn workload from two tenants over the two
slots, a late priority-2 request preempts a decoding one, and every
stream's tokens must equal TP=1's ``run``; after the last run's traffic
the server idles for twice the ranks' lowered ctrl timeout, kept alive by
rank 0's heartbeats, and serves one more request.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_tp_ranks  # noqa: E402
from helpers import (mixed_requests, shared_prefix_requests,  # noqa: E402
                     small_pool, tiny)
from test_torch_engine import to_numpy_tree  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro.runtime import tp as jtp  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_tiny  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.qlinear import (QuantizedGrouped,  # noqa: E402
                                      QuantizedLinear, draw_signs,
                                      quantize_grouped)
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import tp  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

ARCH = {"llama2": "llama2-7b", "llama2_quant": "llama2-7b",
        "mixtral": "mixtral-8x7b", "gqa": "llama3.2-3b", "yi": "yi-34b",
        "prefix": "llama2-7b", "speculative": "llama2-7b",
        "deepseek": "deepseek-v2-236b"}
SCENARIOS = ("llama2", "llama2_quant", "mixtral", "gqa", "yi", "prefix",
             "speculative")
PSUM_SCALES = ((1.0, 1.0), (1.0, 40.0))   # per rank: shared and unequal
DOORS = ("llama2", "llama2_quant")        # served through the front door
CTRL_TIMEOUT_S = 3.0     # the ranks' ctrl timeout: the idle outlasts it
AFTER_RID = 5            # the request served after the idle (rid 0's)
TENANTS = ("t0", "t1", "t0", "t1", "t1")  # the front door's, by rid


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch):
    """(reference cfg, port cfg), tiny, MoE at the no-drop capacity."""
    jcfg = tiny(arch)
    tcfg = get_tiny(arch)
    if tcfg.moe is not None:
        tcfg = tcfg.with_(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=jcfg.moe.capacity_factor))
    return jcfg, tcfg


def _pool(**kw) -> PoolConfig:
    """``helpers.small_pool`` as the port's PoolConfig."""
    ref = small_pool(**kw)
    return PoolConfig(max_slots=ref.max_slots, block_size=ref.block_size,
                      max_context=ref.max_context,
                      prefill_chunk=ref.prefill_chunk,
                      prefix_cache=ref.prefix_cache)


def _port_requests(reqs) -> list:
    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                    eos=r.eos) for r in reqs]


def _quantize_dual(tcfg, tparams):
    """The port's ``quantize_model_dual`` at 4.0 / 2.2 bits with the
    choices ``tests/test_tp_serving.py`` gives the reference's: (target,
    draft).  The target is the quantized and prefix scenarios' model too.
    The port's quantizer is held to the reference's by
    ``tests/test_torch_pipeline.py`` and ``test_torch_dual_quant.py``;
    here it only supplies quantized weights, in 2 s where the reference's
    takes 35 s of compiles on this file's critical path."""
    toks = torch.from_numpy(tcal.zero_shot_tokens(tcfg.vocab, 32))
    stats = tcal.calibrate(
        lambda p, b, ctx: ttf.loss_fn(tcfg, p, b, ctx=ctx), tparams,
        [{"tokens": toks}])
    target, _, draft, _ = tpipe.quantize_model_dual(
        tcfg, tparams, stats, 4.0, 2.2,
        generator=torch.Generator().manual_seed(1), device="cpu",
        bit_choices=(1, 2, 3, 4, 5), n_candidates=2)
    return target, draft


def _grouped_experts(params: dict) -> dict:
    """``params`` with every layer's expert ``wi`` / ``wo`` quantized at 3
    bits by the port's grouped quantizer (the slicing check needs
    ``QuantizedGrouped`` nodes)."""
    gen = torch.Generator().manual_seed(0)
    layers = []
    for lp in params["layers"]:
        moe = dict(lp["moe"])
        for key in ("wi", "wo"):
            s1, s2 = draw_signs(moe[key].shape[1], gen)
            moe[key] = quantize_grouped(moe[key], 3, s1, s2, n_candidates=2,
                                        device="cpu")
        layers.append(dict(lp, moe=moe))
    return dict(params, layers=layers)


@pytest.fixture(scope="module")
def models():
    """name -> (reference cfg, port cfg, JAX params or None, port params,
    port draft or None).  llama2's weights are the reference's, bridged
    (its fp32 scenario is held against the JAX engine); the other archs,
    held TP=2 against TP=1, take the port's seeded init.  The quantized,
    prefix and speculative scenarios serve llama2's quantization and its
    draft; ``mixtral_quant`` has grouped experts."""
    out = {}
    for arch in sorted(set(ARCH.values()) - {"llama2-7b"}):
        jcfg, tcfg = _cfgs(arch)
        tparams = ttf.init_params(tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        out.update({name: (jcfg, tcfg, None, tparams, None)
                    for name, a in ARCH.items() if a == arch})
    jcfg, tcfg = _cfgs("llama2-7b")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    out["llama2"] = (jcfg, tcfg, jparams, tparams, None)
    target, draft = _quantize_dual(tcfg, tparams)
    for name in ("llama2_quant", "prefix"):
        out[name] = (jcfg, tcfg, jparams, target, None)
    out["speculative"] = (jcfg, tcfg, jparams, target, draft)
    jcfg, tcfg, jparams, tparams, _ = out["mixtral"]
    out["mixtral_quant"] = (jcfg, tcfg, jparams, _grouped_experts(tparams),
                            None)
    return out


# ---------------------------------------------------------------- spawned


def _scenario(models, name):
    """(reference cfg, port cfg, JAX params, port params, pool, requests,
    engine kwargs) of one scenario of ``tests/test_tp_serving.py``."""
    jcfg, tcfg, jparams, tparams, draft = models[name]
    pool, reqs, kw = _pool(), mixed_requests(jcfg), {}
    if name == "prefix":
        pool = _pool(prefix_cache=True)
        reqs = shared_prefix_requests(jcfg)
    if name == "speculative":
        kw = dict(draft_params=draft, speculate=2)
    return jcfg, tcfg, jparams, tparams, pool, reqs, kw


def _tokens(results) -> dict:
    return {rid: r.tokens.tolist() for rid, r in results.items()}


def _door(models, name: str, after: bool) -> dict:
    """Scenario ``name``'s traffic through the front door over two slots
    (``_torch_tp_ranks._traffic``): requests 0 and 2 first (tenant t0),
    then request 4 at priority 2, which preempts one of them, and 1 and 3
    (tenant t1: t0 holds every slot, so the share cap would pass over a
    t0 waiter); with ``after``, an idle of twice the ctrl timeout, then
    rid 0's prompt again as AFTER_RID."""
    _, tcfg, _, tparams, pool, reqs, kw = _scenario(models, name)
    spec = [{"rid": r.rid, "prompt": r.prompt.tolist(), "max_new": r.max_new,
             "tenant": TENANTS[r.rid], "priority": 0} for r in reqs]
    door = {"job": {"cfg": tcfg, "params": tparams, "pool": pool,
                    "engine": kw},
            "early": [spec[0], spec[2]], "late": dict(spec[4], priority=2),
            "rest": [spec[1], spec[3]]}
    if after:
        door.update(after=dict(spec[0], rid=AFTER_RID),
                    idle_s=2 * CTRL_TIMEOUT_S + 0.5)
    return door


@pytest.fixture(scope="module")
def tp_runs(models):
    """Every scenario at TP=2 in one spawn of two gloo ranks and, while the
    ranks run, at TP=1 in this process; the llama2 fp32 scenario in the JAX
    engine too, and on the ranks ``int8_psum`` and the front door's runs
    (DOORS)."""
    scen = {name: _scenario(models, name) for name in SCENARIOS}
    doors = [_door(models, name, name == DOORS[-1]) for name in DOORS]
    jobs = [{"cfg": tcfg, "params": tparams, "pool": pool,
             "requests": _port_requests(reqs), "engine": kw}
            for _, tcfg, _, tparams, pool, reqs, kw in scen.values()]
    rng = np.random.default_rng(5)
    psum_cases = [np.stack([s * rng.standard_normal(96).astype(np.float32)
                            for s in scales]) for scales in PSUM_SCALES]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(mesh.spawn, _torch_tp_ranks.rank_main, 2, jobs,
                            psum_cases, doors, device="cpu", threads=1,
                            timeout_s=CTRL_TIMEOUT_S)
        tp1 = {}
        for name, (_, tcfg, _, tparams, pool, reqs, kw) in scen.items():
            engine = PagedServer(tcfg, tparams, pool, device="cpu", **kw)
            tp1[name] = (_tokens(engine.run(_port_requests(reqs))),
                         engine.stats)
        jcfg, _, jparams, _, _, reqs, _ = scen["llama2"]
        jax_tokens = _tokens(JaxServer(jcfg, jparams,
                                       small_pool()).run(reqs))
        ranks = spawned.result()
    assert ranks[1]["served"] is None            # a worker returns nothing
    assert ranks[1]["frontdoor"] is None
    tp2 = {name: (r["tokens"], r["stats"])
           for name, r in zip(SCENARIOS, ranks[0]["served"])}
    return {"tp1": tp1, "tp2": tp2, "jax": jax_tokens,
            "psum_cases": psum_cases,
            "psum": [r["int8_psum"] for r in ranks],
            "doors": dict(zip(DOORS, ranks[0]["frontdoor"]))}


@pytest.mark.parametrize("name", SCENARIOS)
def test_tp2_tokens_equal_tp1(models, tp_runs, name):
    (want, stats1), (got, stats2) = tp_runs["tp1"][name], tp_runs["tp2"][name]
    assert got == want and len(got) > 0
    assert stats1["tp"] == 1 and "tp_steps" not in stats1
    assert stats2["tp"] == 2 and stats2["tp_steps"] == "eager"
    assert stats2["captures"] == 0
    plan = tp.plan_for(models[name][1], 2)
    if name == "llama2":
        assert got == tp_runs["jax"]          # and the JAX engine's tokens
        assert plan.asdict() == dict(tp=2, attn=True, ffn=True, moe=False,
                                     shared=False, lm_head=True)
    if name == "mixtral":
        assert plan.moe and plan.attn and not plan.ffn
    if name == "gqa":
        assert plan.attn                      # 6 / 2 heads: 3 / 1 a rank
    if name == "yi":
        assert not plan.attn and plan.ffn     # 7 / 1 heads replicate
        assert tp.local_kv_heads(models[name][1], plan) == 1
    if name == "prefix":
        assert stats2["prefix_hit_rate"] > 0.0
        assert stats2["prefix_hit_rate"] == stats1["prefix_hit_rate"]
    if name == "speculative":
        assert 0.0 <= stats2["acceptance_rate"] <= 1.0
        assert stats2["acceptance_rate"] == stats1["acceptance_rate"]


@pytest.mark.parametrize("case", range(len(PSUM_SCALES)))
def test_int8_psum_matches_reference(tp_runs, case):
    xs = tp_runs["psum_cases"][case]
    want = jax.vmap(lambda x: jcomp.int8_psum(x, "model"),
                    axis_name="model")(jnp.asarray(xs))
    for rank in range(2):
        np.testing.assert_array_equal(tp_runs["psum"][rank][case],
                                      np.asarray(want[rank]))


def _streamed(events) -> tuple:
    """A stream's token ids and its done event; its events must be token
    events, then one done, each token once."""
    assert isinstance(events, list), events           # the client failed
    kinds = [e for e, _ in events]
    assert kinds[-1] == "done" and set(kinds[:-1]) == {"token"}, kinds
    tokens = [d["token"] for e, d in events if e == "token"]
    assert events[-1][1]["tokens"] == tokens
    return tokens, events[-1][1]


@pytest.mark.parametrize("name", DOORS)
def test_tp2_frontdoor_streams_equal_tp1(tp_runs, name):
    """Every stream's tokens are TP=1's (those are held to the JAX engine
    by ``test_tp2_tokens_equal_tp1``), the late request preempted one of
    the decoding two, and /v1/stats reports the TP engine."""
    door, want = tp_runs["doors"][name], tp_runs["tp1"][name][0]
    dones = {}
    for rid in want:
        tokens, dones[rid] = _streamed(door["record"][rid])
        assert tokens == want[rid], f"{name}: rid={rid}"
        assert dones[rid]["tenant"] == TENANTS[rid]
    assert sum(d["preemptions"] for d in dones.values()) >= 1
    assert dones[4]["preemptions"] == 0          # the late one preempts
    stats = door["stats"]
    assert stats["engine"]["tp"] == 2 and stats["engine"]["tp_steps"] == "eager"
    assert stats["engine"]["captures"] == 0
    assert stats["scheduler"]["preempted"] >= 1
    assert stats["scheduler"]["completed"] == len(want)


def test_tp2_frontdoor_serves_after_an_idle_past_the_ctrl_timeout(tp_runs):
    """After twice the ctrl timeout with nothing to serve (the workers
    would have timed out waiting for rank 0's next op), rank 0's
    heartbeats have kept them: one more request streams TP=1's tokens."""
    door = tp_runs["doors"][DOORS[-1]]
    assert door["idle_s"] >= 2 * CTRL_TIMEOUT_S
    tokens, done = _streamed(door["record"][AFTER_RID])
    assert tokens == tp_runs["tp1"][DOORS[-1]][0][0]
    before, after = door["stats"]["engine"], door["stats_after"]["engine"]
    beats = after["tp_heartbeats"] - before.get("tp_heartbeats", 0)
    # one every tenth of the timeout, so about 20 in the idle
    assert beats >= door["idle_s"] / CTRL_TIMEOUT_S * 2
    assert door["stats_after"]["scheduler"]["completed"] == 6


# ------------------------------------------------------------- in process


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_for_matches_reference(arch, degree):
    for mine, ref in ((get_tiny(arch), jreg.get_tiny(arch)),
                      (get_config(arch), jreg.get_config(arch))):
        assert (tp.plan_for(mine, degree).asdict()
                == jtp.plan_for(ref, degree).asdict())


@pytest.mark.parametrize("two_f,degree", [(24, 2), (768, 2), (768, 4),
                                          (22016, 2), (28672, 8)])
def test_glu_perm_matches_reference(two_f, degree):
    np.testing.assert_array_equal(tp._glu_perm(two_f, degree),
                                  jtp._glu_perm(two_f, degree))


def _nodes(node, names=()):
    """(path names, node) of every leaf node of a port param tree (a
    quantized weight is one node)."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _nodes(v, names + (str(k),))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _nodes(v, names + (str(i),))
    else:
        yield list(names), node


def _ref_slice(jplan, names, field, full, rank, degree, glu_arch):
    """What the reference places on ``rank`` for one leaf: its
    ``_decision`` and ``_leaf_spec`` (replicated fields, dims that do not
    divide), the gate|up permutation, then the rank's block of columns."""
    want = np.asarray(full)
    shard, glu = jtp._decision(jplan, names + [field])
    if (not shard or want.ndim == 0 or field in jtp._REPLICATED_FIELDS
            or want.shape[-1] % degree):
        return want
    c = want.shape[-1]
    if glu and glu_arch:
        want = np.take(want, jtp._glu_perm(c, degree), axis=-1)
    return want[..., rank * (c // degree):(rank + 1) * (c // degree)]


@pytest.mark.parametrize("name,degree", [
    ("llama2_quant", 2), ("llama2_quant", 4), ("mixtral_quant", 2),
    ("deepseek", 2), ("yi", 2), ("speculative", 2)])
def test_prepare_params_slices_like_reference(models, name, degree):
    jcfg, tcfg, _, full, draft = models[name]
    jplan = jtp.plan_for(jcfg, degree)
    glu_arch = jcfg.ffn_kind() != "gelu"
    sliced = 0
    for tree in (full,) if draft is None else (full, draft):
        for rank in range(degree):
            got = list(_nodes(tp.prepare_params(tcfg, tree, rank, degree)))
            for (names, whole), (_, part) in zip(_nodes(tree), got):
                if isinstance(whole, (QuantizedLinear, QuantizedGrouped)):
                    assert type(part) is type(whole)
                    assert part.c == whole.c and part.d == whole.d
                    for f in dataclasses.fields(whole):
                        v = getattr(whole, f.name)
                        if isinstance(v, torch.Tensor):
                            want = _ref_slice(jplan, names, f.name, v, rank,
                                              degree, glu_arch)
                            np.testing.assert_array_equal(
                                getattr(part, f.name).numpy(), want,
                                err_msg=f"{names} {f.name}")
                            sliced += want.shape != tuple(v.shape)
                elif isinstance(whole, torch.Tensor):
                    want = _ref_slice(jplan, names, "", whole, rank, degree,
                                      glu_arch)
                    np.testing.assert_array_equal(part.numpy(), want,
                                                  err_msg=str(names))
                    sliced += want.shape != tuple(whole.shape)
    assert sliced        # something sharded


def test_gathers_are_shape_driven_noops():
    x = torch.zeros(3, 1, 4, 8)
    assert tp.gather_heads(x, 4) is x
    y = torch.zeros(3, 16)
    assert tp.gather_cols(y, 16) is y
    with pytest.raises(RuntimeError, match="outside a TP group"):
        tp.gather_cols(y, 32)            # a slice with no group to gather


def test_heartbeat_and_close_on_rank_0(models, monkeypatch):
    """Rank 0's messages with the sends recorded: a heartbeat only once a
    tenth of the ctrl timeout has passed since the last message, none at
    TP=1; after an op that failed on rank 0 (its workers wait in the op's
    collectives) ``close`` sends nothing, and nothing follows it."""
    _, tcfg, _, full, _ = models["llama2"]
    sent = []
    monkeypatch.setattr(tp, "send_op",
                        lambda group, key, inputs: sent.append(key))
    PagedServer(tcfg, full, _pool(), device="cpu").keepalive()
    assert sent == []
    group = tp.TPGroup(rank=0, size=2, backend="gloo",
                       device=torch.device("cpu"), ctrl_timeout_s=2.0)
    engine = PagedServer(tcfg, full, _pool(), device="cpu", group=group)
    assert engine.heartbeat_s == pytest.approx(0.2)
    engine.keepalive()                    # a message went 0 s ago
    engine._last_sent -= 0.3
    engine.keepalive()
    engine.keepalive()
    assert sent == [tp.HEARTBEAT] and engine.stats["tp_heartbeats"] == 1

    def failing(**inputs):
        raise RuntimeError("a step failed on rank 0")
    monkeypatch.setattr(engine, "_op", lambda kind: failing)
    with pytest.raises(RuntimeError, match="failed on rank 0"):
        engine._compiled(("decode",), None)({})
    engine.close()
    engine._last_sent -= 1.0
    engine.keepalive()
    assert sent == [tp.HEARTBEAT, ("decode",)]


def test_make_host_mesh_validates_tp_and_backend():
    g = mesh.make_host_mesh(device="cpu")
    assert (g.rank, g.size, g.backend, g.pg) == (0, 1, None, None)
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh.make_host_mesh(tp=0, device="cpu")
    with pytest.raises(ValueError, match="needs init_method"):
        mesh.make_host_mesh(tp=2, device="cpu")
    assert mesh.resolve_backend(2, None, torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="needs CUDA"):
        mesh.resolve_backend(2, "nccl", torch.device("cpu"))
    # nccl puts one rank on each card: a host with fewer cards refuses
    with pytest.raises(ValueError, match="needs 2 cards"):
        mesh.resolve_backend(2, "nccl", torch.device("cuda"))
    with pytest.raises(ValueError, match="rank 2"):
        mesh.make_host_mesh(tp=2, rank=2, init_method="file:///x",
                            device="cpu")


def test_slices_plan_from_the_full_widths(models, monkeypatch):
    """A rank's QuantizedLinear keeps the layer's c and hands it to the
    GEMM as its planning width; at llama2-7b's decode shapes the plan of a
    half-width slice would split d differently (so columns would sum in
    another order).  The engine names the model's KV heads to the paged
    read, whose split plan would change with half of them."""
    _, tcfg, _, full, _ = models["llama2_quant"]
    wq = full["layers"][0]["attn"]["wq"]
    part = tp.prepare_params(tcfg, full, 1, 2)["layers"][0]["attn"]["wq"]
    assert part.c == wq.c == 2 * part.rescale.shape[-1]
    seen = []
    real = qops.rht_quantized_matmul

    def spy(*a, plan_c=None, **kw):
        seen.append(plan_c)
        return real(*a, plan_c=plan_c, **kw)
    monkeypatch.setattr(qops, "rht_quantized_matmul", spy)
    x = torch.randn(3, wq.d)
    np.testing.assert_array_equal(part.apply(x).numpy(),
                                  wq.apply(x)[:, wq.c // 2:].numpy())
    assert seen == [wq.c, wq.c]
    assert qops.split_plan(8, 4083, 4096, 132) != qops.split_plan(
        8, 4083, 2048, 132)
    assert pops.kv_splits(8, 32, 128, 16, 132) != pops.kv_splits(
        8, 16, 128, 16, 132)
    engine = PagedServer(tcfg, full, _pool(), device="cpu")
    with engine._kernel_scope():
        assert pops._PLAN_KV.get() == tcfg.n_kv
    assert pops._PLAN_KV.get() is None
