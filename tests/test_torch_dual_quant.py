"""The port's dual quantization for self-speculative decoding against the
JAX reference, on the host (``repro_torch/core/pipeline.py``:
``quantize_model_dual``, ``_alias_rotation``; ``repro_torch/bridge.py``:
``draft_from_reference``).

  * ``quantize_model_dual`` from the reference's signs, on the port's own
    calibration of tiny llama2: per-layer bits of target and draft equal to
    the reference's dual (4.0 / 2.2 bits), every sign tensor of the draft
    the target's by identity, full-precision leaves shared, the draft's
    bits below the target's; with the signs drawn by the port, drawn once.
  * The reference's own pair carried across by ``draft_from_reference``
    (the rotation aliased, fp leaves shared; a draft that is not a dual
    quantization of the target refused), served by the port's speculating
    engine: greedy tokens and spec counters equal to the reference
    engine's on the same pair.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import mixed_requests, noisy, small_pool, tiny  # noqa: E402
from test_torch_engine import to_numpy_tree  # noqa: E402
from test_torch_prefix_cache import _pool  # noqa: E402
from test_torch_speculative import _port, _same  # noqa: E402

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import PagedServer  # noqa: E402

pytestmark = pytest.mark.tier2  # the reference's quantization and engine


@pytest.fixture(scope="module")
def dual():
    """Tiny llama2 calibrated by each package, and the reference's
    ``quantize_model_dual`` pair at 4.0 / 2.2 bits."""
    cfg = tiny("llama2-7b")
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    toks = jcal.zero_shot_tokens(cfg.vocab, 32)
    jstats = jcal.calibrate(
        lambda p, b, ctx: jtf.loss_fn(cfg, p, b, ctx=ctx, scan=False),
        jparams, [{"tokens": jnp.asarray(toks)}])
    tstats = tcal.calibrate(
        lambda p, b, ctx: ttf.loss_fn(get_tiny("llama2-7b"), p, b, ctx=ctx),
        tparams, [{"tokens": torch.from_numpy(toks)}])
    pair = jpipe.quantize_model_dual(cfg, jparams, jstats, 4.0, 2.2,
                                     jax.random.PRNGKey(1), **DUAL_OPTS)
    return cfg, jparams, tparams, tstats, pair


DUAL_OPTS = dict(bit_choices=(1, 2, 3, 4, 5), n_candidates=2)


def test_engine_with_reference_dual_quantization(dual):
    """The reference's own (target, draft) pair, carried across by
    ``bridge.draft_from_reference``: the rotation aliased, the fp leaves
    shared, and the port's speculating engine gives the reference
    engine's tokens and counters."""
    cfg, jparams, _, _, (jt, _, jd, _) = dual
    tt = bridge.params_from_reference(to_numpy_tree(jt), "cpu")
    td = bridge.draft_from_reference(tt, to_numpy_tree(jd), "cpu")
    assert td["embed"] is tt["embed"] and td["lm_head"] is tt["lm_head"]
    assert td["layers"][0]["ln1"]["scale"] is tt["layers"][0]["ln1"]["scale"]
    q_t, q_d = tt["layers"][1]["attn"]["wq"], td["layers"][1]["attn"]["wq"]
    assert q_d.signs1 is q_t.signs1 and q_d.bits <= q_t.bits
    with pytest.raises(ValueError, match="dual quantization"):
        bridge.draft_from_reference(
            tt, to_numpy_tree(noisy(jparams, 0.005)), "cpu")
    reqs = mixed_requests(cfg, n=2)
    ref = JaxServer(cfg, jt, small_pool(), draft_params=jd, speculate=2)
    want = ref.run([dataclasses.replace(r) for r in reqs])
    port = PagedServer(get_tiny("llama2-7b"), tt, _pool(small_pool()),
                       draft_params=td, speculate=2, device="cpu")
    _same("dual", port.run(_port(reqs)), want, port, ref)


def test_quantize_model_dual_matches_reference(dual):
    _, _, tparams, tstats, (jt, jtr, jd, jdr) = dual
    signs = {}
    for i, lp in enumerate(jt["layers"][0]):
        for g in ("attn", "mlp"):
            for k, q in lp[g].items():
                if hasattr(q, "signs1"):
                    signs[f"L{i}.{g}.{k}"] = (
                        torch.tensor(np.asarray(q.signs1)),
                        None if q.signs2 is None
                        else torch.tensor(np.asarray(q.signs2)))
    tt, ttr, td, tdr = tpipe.quantize_model_dual(
        get_tiny("llama2-7b"), tparams, tstats, 4.0, 2.2, signs=signs,
        device="cpu", **DUAL_OPTS)
    assert ttr.per_layer_bits == jtr.per_layer_bits
    assert tdr.per_layer_bits == jdr.per_layer_bits
    assert tdr.avg_bits < ttr.avg_bits
    assert td["embed"] is tt["embed"] and td["lm_head"] is tt["lm_head"]
    n = 0
    for lt, ld in zip(tt["layers"], td["layers"]):
        assert ld["ln1"]["scale"] is lt["ln1"]["scale"]
        assert ld["ln2"]["scale"] is lt["ln2"]["scale"]
        for g in ("attn", "mlp"):
            for k, q in lt[g].items():
                assert ld[g][k].signs1 is q.signs1
                assert ld[g][k].signs2 is q.signs2
                n += 1
    assert n == len(signs)
    # drawn by the port: once, so both trees hold the same rotation
    tt2, _, td2, _ = tpipe.quantize_model_dual(
        get_tiny("llama2-7b"), tparams, tstats, 4.0, 2.2, device="cpu",
        generator=torch.Generator().manual_seed(3), **DUAL_OPTS)
    q_t, q_d = tt2["layers"][0]["attn"]["wo"], td2["layers"][0]["attn"]["wo"]
    assert q_d.signs1 is q_t.signs1 and q_d.bits <= q_t.bits
