"""Port parity, RWKV6: ``repro_torch.models.rwkv6`` against
``repro.models.rwkv6`` on seeded numpy inputs (the weights of the JAX
init with the decay, bonus and lerp vectors drawn at random, so every term
is live): the chunked ``time_mix`` (the same chunk and ``exp(cumsum)``
order), its state handoff, ``time_mix_decode`` and ``channel_mix``;
prefill in chunks then decode equals one pass over the sequence.  Then
tiny rwkv6-3b (attention-free: no KV blocks at all) through the port's
pipeline and engine against the reference's (``test_torch_families``).

Tolerance: rtol 1e-4 on f32 (summation order differs).
"""
import dataclasses

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
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.serve.pool import PoolConfig, request_blocks  # noqa: E402

ARCH = "rwkv6-3b"
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _params(seed=0):
    """(numpy tm, numpy cm) of the tiny arch, vectors randomised."""
    cfg = jreg.get_tiny(ARCH)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    tm = {k: np.asarray(v) for k, v in jtf._init_rwkv_tm(
        cfg, key, jnp.float32).items()}
    cm = {k: np.asarray(v) for k, v in jtf._init_rwkv_cm(
        cfg, jax.random.fold_in(key, 1), jnp.float32).items()}
    d = cfg.d_model
    tm["w0"] = rng.normal(size=(d,)).astype(np.float32)
    tm["u"] = rng.normal(size=tm["u"].shape).astype(np.float32) * 0.5
    tm["mu_x"] = rng.uniform(size=(d,)).astype(np.float32)
    tm["mu_rkvwg"] = rng.uniform(size=(5, d)).astype(np.float32)
    tm["ln_x"] = rng.uniform(0.5, 1.5, size=(d,)).astype(np.float32)
    cm["mu_k"] = rng.uniform(size=(d,)).astype(np.float32)
    return cfg, tm, cm


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _time_mix(cfg, **kw):
    """The reference's ``time_mix`` with ``kw`` fixed, compiled once."""
    return jax.jit(lambda p, x, state=None: jrwkv.time_mix(
        p, x, n_heads=cfg.n_heads, head_dim=cfg.hd, state=state, **kw))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s", [16, 37])
def test_time_mix_matches_reference(s):
    cfg, tm, _ = _params()
    x = _x(2, s, cfg.d_model)
    jy, js = _time_mix(cfg, return_state=True)(_j(tm), jnp.asarray(x))
    ty, ts = trwkv.time_mix(_t(tm), torch.from_numpy(x), n_heads=cfg.n_heads,
                            head_dim=cfg.hd, return_state=True)
    _close(ty, jy)
    _close(ts, js)


def test_time_mix_resumes_from_a_state():
    cfg, tm, _ = _params(2)
    b, d, h, dk = 2, cfg.d_model, cfg.n_heads, cfg.hd
    rng = np.random.default_rng(3)
    st = dict(s=rng.normal(size=(b, h, dk, dk)).astype(np.float32),
              x_prev_tm=rng.normal(size=(b, d)).astype(np.float32),
              x_prev_cm=rng.normal(size=(b, d)).astype(np.float32))
    x = _x(b, 21, d, seed=4)
    jy, js = _time_mix(cfg, return_state=True)(
        _j(tm), jnp.asarray(x), jrwkv.RWKVState(**_j(st)))
    ty, ts = trwkv.time_mix(_t(tm), torch.from_numpy(x), n_heads=h,
                            head_dim=dk, return_state=True,
                            state=trwkv.RWKVState(**_t(st)))
    _close(ty, jy)
    _close(ts, js)


def test_decode_and_channel_mix_match_reference():
    cfg, tm, cm = _params(5)
    b, d, h, dk = 3, cfg.d_model, cfg.n_heads, cfg.hd
    rng = np.random.default_rng(6)
    st = dict(s=rng.normal(size=(b, h, dk, dk)).astype(np.float32),
              x_prev_tm=rng.normal(size=(b, d)).astype(np.float32),
              x_prev_cm=rng.normal(size=(b, d)).astype(np.float32))
    x = rng.normal(size=(b, d)).astype(np.float32)
    jy, jst = jax.jit(lambda p, x, st: jrwkv.time_mix_decode(
        p, x, st, n_heads=h, head_dim=dk))(_j(tm), jnp.asarray(x),
                                           jrwkv.RWKVState(**_j(st)))
    ty, tst = trwkv.time_mix_decode(_t(tm), torch.from_numpy(x),
                                    trwkv.RWKVState(**_t(st)), n_heads=h,
                                    head_dim=dk)
    _close(ty, jy)
    for f in dataclasses.fields(tst):
        _close(getattr(tst, f.name), getattr(jst, f.name))
    xs = _x(b, 9, d, seed=7)
    for prev in (None, st["x_prev_cm"]):
        want = jrwkv.channel_mix(_j(cm), jnp.asarray(xs),
                                 None if prev is None else jnp.asarray(prev))
        got = trwkv.channel_mix(_t(cm), torch.from_numpy(xs),
                                None if prev is None
                                else torch.from_numpy(prev))
        _close(got, want)
    _close(trwkv.channel_mix(_t(cm), torch.from_numpy(x),
                             torch.from_numpy(st["x_prev_cm"])),
           jrwkv.channel_mix(_j(cm), jnp.asarray(x),
                             jnp.asarray(st["x_prev_cm"])))


def test_prefill_chunks_then_decode_equal_one_pass():
    """The port's time mix over 40 tokens in one pass, and over chunks of
    16 + 13 (state handed on) then 11 decode steps, give the same outputs
    and final state as the reference's one pass."""
    cfg, tm, _ = _params(8)
    b, d, h, dk = 2, cfg.d_model, cfg.n_heads, cfg.hd
    x = _x(b, 40, d, seed=9)
    jy, js = _time_mix(cfg, return_state=True)(_j(tm), jnp.asarray(x))
    p = _t(tm)
    st = trwkv.RWKVState.init(b, h, dk, d)
    outs = []
    for a, z in ((0, 16), (16, 29)):
        xc = torch.from_numpy(x[:, a:z])
        y, s_new = trwkv.time_mix(p, xc, n_heads=h, head_dim=dk,
                                  return_state=True,
                                  state=None if a == 0 else st)
        st = trwkv.RWKVState(s=s_new, x_prev_tm=xc[:, -1],
                             x_prev_cm=st.x_prev_cm)
        outs.append(y)
    for t in range(29, 40):
        y, st = trwkv.time_mix_decode(p, torch.from_numpy(x[:, t]), st,
                                      n_heads=h, head_dim=dk)
        outs.append(y[:, None])
    _close(torch.cat(outs, dim=1), jy)
    _close(st.s, js)


@pytest.fixture(scope="module")
def models():
    return family_models(jreg.get_tiny(ARCH), get_tiny(ARCH))


def test_allocation_matches_reference(models):
    check_allocation(models)
    names = set(models["trep"].per_layer_bits)
    assert {"L0.tm.wr", "L0.tm.wg", "L1.cm.ck", "L1.cm.cv"} <= names
    assert not any(n.endswith(("tm_w1", "dw_a", "u")) for n in names)


@pytest.mark.tier2
@pytest.mark.parametrize("kind", ["fp32", "quant"])
def test_engine_tokens_identical_to_reference(models, kind):
    cfg = get_tiny(ARCH)
    assert request_blocks(cfg, PoolConfig(), 512) == 0    # no KV blocks
    jparams, tparams = models[kind]
    check_engine(jreg.get_tiny(ARCH), cfg, jparams, tparams, kind)
