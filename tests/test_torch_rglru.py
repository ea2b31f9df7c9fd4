"""Port parity, RG-LRU: ``repro_torch.models.rglru`` against
``repro.models.rglru`` on seeded numpy inputs: the prefix scan (the port
writes out ``jax.lax.associative_scan``'s recursion), the causal conv with
and without a previous chunk's ``hist``, the conv tail, ``rglru_block``
resuming from a state and ``rglru_decode``; a sequence in chunks then
decode steps equals one pass.  Then tiny recurrentgemma-2b (Griffin: two
RG-LRU layers then one local-attention layer, window 16, so the churn
workload's longer requests wrap the KV ring; scan period 3 over 5 layers)
through the port's pipeline and engine against the reference's
(``test_torch_families``).

Tolerance: rtol 1e-4 on f32.  The scan pairs the same elements in the
same order as the reference's, with the same f32 products and sums: the
worst relative error measured against ``jax.lax.associative_scan`` on the
CPU was 0 (bitwise equal at lengths 1, 2, 16, 37, 64 and 256, three seeds
each); ``test_scan_matches_associative_scan`` holds it under 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_families import (check_allocation, check_engine,  # noqa: E402
                                 family_models)
from test_torch_families import one_torch_thread  # noqa: E402,F401 autouse

from repro.configs import registry as jreg  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

ARCH = "recurrentgemma-2b"
RTOL = 1e-4
SCAN_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _params(seed=0):
    cfg = jreg.get_tiny(ARCH)
    p = {k: np.asarray(v) for k, v in jtf._init_rglru(
        cfg, jax.random.PRNGKey(seed), jnp.float32).items()}
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32) * 0.1
    p["bx"] = rng.normal(size=p["bx"].shape).astype(np.float32) * 0.1
    return cfg, p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("s", [1, 2, 16, 37])
def test_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 24)).astype(np.float32)
    b = rng.normal(size=(2, s, 24)).astype(np.float32)
    ja, jh = jax.lax.associative_scan(
        lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, th = trg.associative_scan((torch.from_numpy(a), torch.from_numpy(b)))
    _close(ta, ja, SCAN_RTOL)
    _close(th, jh, SCAN_RTOL)


def test_conv_and_tail_match_reference():
    cfg, p = _params(1)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 7, cfg.rglru_width)).astype(np.float32)
    hist = rng.normal(size=(2, trg.CONV_WIDTH - 1,
                            cfg.rglru_width)).astype(np.float32)
    for hi in (None, hist):
        want = jrg._conv1d_seq(_j(p), jnp.asarray(h),
                               None if hi is None else jnp.asarray(hi))
        got = trg._conv1d_seq(_t(p), torch.from_numpy(h),
                              None if hi is None else torch.from_numpy(hi))
        _close(got, want)
    for s in (2, 7):
        np.testing.assert_array_equal(
            trg.conv_tail(torch.from_numpy(h[:, :s])).numpy(),
            np.asarray(jrg.rglrumod_conv_tail(jnp.asarray(h[:, :s]))))


def test_block_with_state_and_decode_match_reference():
    cfg, p = _params(3)
    rng = np.random.default_rng(4)
    b, d, dr = 2, cfg.d_model, cfg.rglru_width
    x = rng.normal(size=(b, 13, d)).astype(np.float32)
    st = dict(h=rng.normal(size=(b, dr)).astype(np.float32),
              conv=rng.normal(size=(b, trg.CONV_WIDTH - 1, dr)).astype(
                  np.float32))
    block = jax.jit(lambda p, x, state=None: jrg.rglru_block(
        p, x, return_state=True, state=state))
    for state in (None, st):
        jy, jst = block(
            _j(p), jnp.asarray(x),
            None if state is None else jrg.RGLRUState(**_j(state)))
        ty, tst = trg.rglru_block(
            _t(p), torch.from_numpy(x), return_state=True,
            state=None if state is None else trg.RGLRUState(**_t(state)))
        _close(ty, jy)
        _close(tst.h, jst.h)
        _close(tst.conv, jst.conv)
    xt = rng.normal(size=(b, d)).astype(np.float32)
    jy, jst = jax.jit(jrg.rglru_decode)(_j(p), jnp.asarray(xt),
                                        jrg.RGLRUState(**_j(st)))
    ty, tst = trg.rglru_decode(_t(p), torch.from_numpy(xt),
                               trg.RGLRUState(**_t(st)))
    _close(ty, jy)
    _close(tst.h, jst.h)
    _close(tst.conv, jst.conv)


def test_chunks_then_decode_equal_one_pass():
    cfg, p = _params(5)
    x = np.random.default_rng(6).normal(size=(2, 30, cfg.d_model)).astype(
        np.float32)
    jy = jax.jit(jrg.rglru_block)(_j(p), jnp.asarray(x))
    tp = _t(p)
    outs, st = [], None
    for a, z in ((0, 2), (2, 17), (17, 24)):        # a chunk shorter than
        y, st = trg.rglru_block(tp, torch.from_numpy(x[:, a:z]),  # the conv
                                return_state=True, state=st)
        outs.append(y)
    for t in range(24, 30):
        y, st = trg.rglru_decode(tp, torch.from_numpy(x[:, t]), st)
        outs.append(y[:, None])
    _close(torch.cat(outs, dim=1), jy)


@pytest.fixture(scope="module")
def models():
    return family_models(jreg.get_tiny(ARCH), get_tiny(ARCH))


def test_allocation_matches_reference(models):
    check_allocation(models)
    names = set(models["trep"].per_layer_bits)
    assert {"L0.rglru.wi", "L1.rglru.wg", "L2.attn.wq", "L4.rglru.wo",
            "L3.mlp.wi"} <= names
    assert not any(n.endswith((".wa", ".wx", "conv_w")) for n in names)


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_engine_tokens_identical_to_reference(models, kind):
    jparams, tparams = models[kind]
    check_engine(jreg.get_tiny(ARCH), get_tiny(ARCH), jparams, tparams, kind)
