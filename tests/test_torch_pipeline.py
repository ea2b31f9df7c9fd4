"""Port parity, the quantization pipeline on tiny llama2 (fp32 params carried
across by ``repro_torch.bridge``): the port's ``loss_fn``, ``calibrate``,
``allocate_bits`` and ``quantize_model`` against the JAX package's, then
greedy tokens served from each pipeline's output, fused and unfused.

Tolerances: the loss within 1e-5 relative (f32, summation order differs);
alphas rtol 1e-4 (three f32 norms multiplied) and column energies rtol
1e-5; AllocateBits identical (the same numpy code); per-layer bit widths
and outlier splits identical; codes within the reference kernel test's tie
tolerance (tests/test_kernels.py:65-69), except in the few columns whose
grid-step choice is a near-tie (``OBJ_TIE``), which are counted.  Served from each pipeline's own
quantized model, the two engines' logits agree within ``LOGIT_TOL`` up to a
request's first differing greedy token, which may differ only at a top-2
near-tie within that agreement.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import mixed_requests, small_pool, tiny  # noqa: E402

from repro.core import allocate as jalloc  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.qlinear import QuantizedLinear as JaxQuantizedLinear  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.core import allocate as talloc  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import hadamard as thadamard  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.tricks import centralize as tcentral  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import PagedServer, PoolConfig, Request  # noqa: E402

ARCH = "llama2-7b"
AVG_BITS = 4.3
# The two pipelines' quantized models differ in the near-tie columns above,
# each a different code vector of equal quality, so their logits differ by
# more than f32 reassociation (1e-4): up to 8.6e-3 of the largest |logit|
# on this workload, fused and unfused alike, when this was written.  A greedy token may differ only where the reference's
# top-2 gap is within that agreement.
LOGIT_TOL = 1e-2
# A column may choose another grid step than the reference's only where the
# two steps' objectives tie this closely: the candidate scales differ from
# jnp.geomspace's by up to one f32 ulp (ROADMAP Queue 3), which moves a
# step's objective by about 1e-5 relative.
OBJ_TIE = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_numpy_tree(node):
    """A JAX param tree as the bridge's plain containers of numpy arrays."""
    if isinstance(node, JaxQuantizedLinear):
        out = {k: (None if getattr(node, k) is None
                   else np.asarray(getattr(node, k)))
               for k in bridge.QL_TENSORS}
        out.update({k: getattr(node, k) for k in bridge.QL_STATIC})
        return out
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy_tree(v) for v in node]
    return None if node is None else np.asarray(node)


def _quantized(layers):
    """name -> QuantizedLinear of an unrolled per-layer list."""
    return {f"L{i}.{g}.{k}": lp[g][k] for i, lp in enumerate(layers)
            for g in ("attn", "mlp") for k in lp[g]
            if hasattr(lp[g][k], "packed")}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny(ARCH)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    toks = jcal.zero_shot_tokens(cfg.vocab, 64)
    jstats = jcal.calibrate(
        lambda p, b, ctx: jtf.loss_fn(cfg, p, b, ctx=ctx, scan=False),
        jparams, [{"tokens": jnp.asarray(toks)}])
    tstats = tcal.calibrate(
        lambda p, b, ctx: ttf.loss_fn(get_tiny(ARCH), p, b, ctx=ctx),
        tparams, [{"tokens": torch.from_numpy(toks)}])
    jq, jrep = jpipe.quantize_model(cfg, jparams, jstats, AVG_BITS,
                                    jax.random.PRNGKey(3))
    jql = _quantized(jq["layers"][0])
    signs = {name: (torch.tensor(np.asarray(q.signs1)),
                    None if q.signs2 is None
                    else torch.tensor(np.asarray(q.signs2)))
             for name, q in jql.items()}
    tq, trep = tpipe.quantize_model(get_tiny(ARCH), tparams, tstats, AVG_BITS,
                                    signs=signs, device="cpu")
    return dict(cfg=cfg, toks=toks, jparams=jparams, tparams=tparams,
                jstats=jstats, tstats=tstats, jq=jq, jrep=jrep, tq=tq,
                trep=trep)


def test_loss_matches_reference(setup):
    batch = setup["toks"]
    want = float(jtf.loss_fn(setup["cfg"], setup["jparams"],
                             {"tokens": jnp.asarray(batch)}, scan=False))
    got = float(ttf.loss_fn(get_tiny(ARCH), setup["tparams"],
                            {"tokens": torch.from_numpy(batch)}))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_calibrate_matches_reference(setup):
    jstats, tstats = setup["jstats"], setup["tstats"]
    assert set(tstats) == set(jstats)
    for name, js in jstats.items():
        ts = tstats[name]
        assert (ts.d, ts.c, ts.m) == (js.d, js.c, js.m), name
        np.testing.assert_allclose(ts.alpha, js.alpha, rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(ts.x_col_sq, js.x_col_sq, rtol=1e-5,
                                   err_msg=name)


def _fields(res):
    return dataclasses.asdict(res)


@pytest.mark.parametrize("seed", range(4))
def test_allocate_bits_identical_exact_path(seed):
    """Layer sizes and a budget sharing the factor 4096: the divide-by-GCD
    trick leaves a small exact DP."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 40, 24)
    m = [int(x) * 4096 for x in k]
    alphas = rng.lognormal(0.0, 1.5, 24)
    bits = (1, 2, 3, 4, 5, 6, 7, 8)
    budget = 4096 * int(3.7 * k.sum())
    want = jalloc.allocate_bits(alphas, m, budget, bits)
    got = talloc.allocate_bits(alphas, m, budget, bits)
    assert want.gcd % 4096 == 0
    assert _fields(got) == _fields(want)


def test_allocate_bits_identical_coarsened_and_repaired(monkeypatch):
    """A tiny slot cap forces the coarsened budget unit in both modules;
    some of these adversarial (coprime-ish) cases overrun the true budget
    under round-to-nearest costs and take the ceiling-cost repair."""
    monkeypatch.setattr(jalloc, "_MAX_SLOTS", 50)
    monkeypatch.setattr(talloc, "_MAX_SLOTS", 50)
    bits = [1, 2, 3, 4, 6, 8]
    repaired = 0
    for seed in range(200):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 6))
        m = [int(x) for x in rng.integers(3, 4001, n)]
        alphas = rng.uniform(0.1, 20.0, n)
        budget = max(int(rng.uniform(1.5, 6.0) * sum(m)), sum(m))
        want = jalloc.allocate_bits(alphas, m, budget, bits)
        got = talloc.allocate_bits(alphas, m, budget, bits)
        assert _fields(got) == _fields(want), seed
        # did round-to-nearest costs overrun (the repair path)?
        ma = np.asarray(m, np.int64)[:, None]
        g = want.gcd
        costs = (ma * np.asarray(bits)[None, :] + g // 2) // g
        err = np.asarray(alphas)[:, None] * np.exp2(-np.asarray(bits, float))
        first = jalloc._dp_solve(err, costs, bits, want.n_slots)
        if first is None or int(np.dot(first[0], m)) > budget:
            repaired += 1
    assert repaired > 0


def test_quantize_model_matches_reference(setup):
    jrep, trep = setup["jrep"], setup["trep"]
    assert trep.per_layer_bits == jrep.per_layer_bits
    assert trep.n_layers == jrep.n_layers
    assert (trep.total_param_bits, trep.overhead_bits) == (
        jrep.total_param_bits, jrep.overhead_bits)
    assert trep.avg_bits == jrep.avg_bits
    assert trep.objective == pytest.approx(jrep.objective, rel=1e-4)
    jql = _quantized(setup["jq"]["layers"][0])
    tql = _quantized(setup["tq"]["layers"])
    assert set(tql) == set(jql)
    diffs, total, flipped = 0, 0, 0
    for name, jq in jql.items():
        tq = tql[name]
        assert (tq.bits, tq.d, tq.d_keep, tq.c) == (jq.bits, jq.d, jq.d_keep,
                                                    jq.c), name
        for k in ("out_idx", "keep_idx"):
            np.testing.assert_array_equal(getattr(tq, k).numpy(),
                                          np.asarray(getattr(jq, k)))
        want = np.asarray(jpacking.unpack_codes(jq.packed, jq.bits, jq.d_keep))
        got = tpacking.unpack_codes(tq.packed, tq.bits, tq.d_keep).numpy()
        diff = got.astype(int) - want.astype(int)
        # a column whose codes moved by more than one chose another grid
        # step: allowed only where the two steps' objectives tie
        flip = np.abs(diff).max(axis=0) > 1
        if flip.any():
            w_rot = _rotated(setup["tparams"], name, tq).numpy()
            c_b = ((1 << tq.bits) - 1) / 2.0
            for j in np.flatnonzero(flip):
                e_port = _objective(w_rot[:, j], got[:, j] - c_b)
                e_ref = _objective(w_rot[:, j], want[:, j] - c_b)
                assert abs(e_ref - e_port) <= OBJ_TIE * abs(e_port), (name, j)
            flipped += int(flip.sum())
        keep = ~flip
        assert np.abs(diff[:, keep]).max(initial=0) <= 1, name
        diffs += int((diff[:, keep] != 0).sum())
        total += diff[:, keep].size
        np.testing.assert_allclose(
            tq.rescale.numpy().astype(np.float32)[keep],
            np.asarray(jq.rescale, np.float32)[keep], rtol=5e-3, atol=1e-5,
            err_msg=name)
    assert diffs / total < 5e-3
    assert flipped <= 0.01 * sum(q.c for q in tql.values())
    # the port's tree keeps fp leaves and quantizes only the projections
    assert torch.equal(setup["tq"]["lm_head"], setup["tparams"]["lm_head"])


def _rotated(params, name, q):
    """The port's rotated, centralized, outlier-free weight for ``name``."""
    i, group, key = name.split(".")
    w = params["layers"][int(i[1:])][group][key]
    if q.keep_idx is not None:
        w = w[q.keep_idx]
    w, _ = tcentral(w)
    return thadamard.practical_rht(w, q.signs1, q.signs2, axis=0)


def _objective(w, v):
    """The code search's objective -<w,v>^2/<v,v> in float64."""
    w, v = w.astype(np.float64), v.astype(np.float64)
    return -np.dot(w, v) ** 2 / max(np.dot(v, v), 1e-30)


class _Recording:
    """Records the logits each greedy step samples from."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits = {}

    def _sample(self, logits, rid, step):
        self.logits[(rid, step)] = np.array(logits, np.float32)
        return super()._sample(logits, rid, step)


class _JaxRecording(_Recording, JaxServer):
    pass


class _PortRecording(_Recording, PagedServer):
    pass


@pytest.mark.tier2
@pytest.mark.parametrize("fused", [True, False])
def test_served_tokens_match_reference_pipeline(setup, fused):
    """Each pipeline's own quantized model, served by its own engine.  Up to
    and including a request's first differing token both runs saw the same
    tokens, so their logits must agree within LOGIT_TOL of the step's
    largest |logit|; a token may differ only where the reference's top-2
    gap is within that agreement."""
    cfg = setup["cfg"]
    jreqs = mixed_requests(cfg)
    ref = _JaxRecording(cfg, setup["jq"], small_pool(prefix_cache=False),
                        fused=fused)
    want = ref.run(jreqs)
    pool = PoolConfig(max_slots=2, block_size=4, max_context=32,
                      prefill_chunk=4)
    engine = _PortRecording(get_tiny(ARCH), setup["tq"], pool, fused=fused,
                            device="cpu")
    got = engine.run([Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                      for r in jreqs])
    assert set(got) == set(want)
    for r in jreqs:
        a, b = got[r.rid].tokens, want[r.rid].tokens
        last = int(np.argmax(a != b)) if not np.array_equal(a, b) else len(b) - 1
        for step in range(last + 1):
            lr, lp = ref.logits[(r.rid, step)], engine.logits[(r.rid, step)]
            scale = float(np.abs(lr).max())
            assert float(np.abs(lp - lr).max()) <= LOGIT_TOL * scale, (
                f"rid {r.rid} step {step}: the two quantized models' logits "
                f"differ by more than {LOGIT_TOL} x {scale}")
        if last < len(b) - 1 or a[last] != b[last]:
            top2 = np.partition(ref.logits[(r.rid, last)], -2)[-2:]
            gap = float(top2[1] - top2[0])
            assert gap <= 2 * LOGIT_TOL * scale, (r.rid, last, gap)
