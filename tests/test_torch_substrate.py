"""The port's training substrate against the JAX reference on the host: the
synthetic corpus and the batch loader (byte for byte), the learning-rate
schedules, AdamW on identical gradients, int8 gradient compression and
error feedback -- the loader, optimizer, schedule and compression units of
``tests/test_substrate.py`` (not its mesh tests), and its behavioural tests
run again on the port.

Tolerances: the corpus, the batches and the int8 codes are identical; the
schedules, AdamW's params, moments and grad norm agree within rtol 1e-6
(both compute in f32), elementwise and, with the clip active, with an
absolute floor of 1e-6 of the leaf's largest value: the global norm sums
in another order, so the clip's scale can differ by an ulp, and a first
moment that sums three steps' terms of opposite sign can lose most of its
leading digits (up to 1.0e-5 relative on such elements, measured); error
feedback's residuals within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.data import LMBatchLoader as JLoader  # noqa: E402
from repro.data import make_corpus_tokens as jcorpus  # noqa: E402
from repro.data.synthetic import generate_text as jtext  # noqa: E402
from repro.optim import adamw_init as jinit  # noqa: E402
from repro.optim import adamw_update as jupdate  # noqa: E402
from repro.optim.schedule import cosine_schedule as jcos  # noqa: E402
from repro.optim.schedule import linear_warmup as jwarm  # noqa: E402
from repro.runtime.compression import ErrorFeedback as JEF  # noqa: E402
from repro.runtime.compression import (  # noqa: E402
    compress_decompress_grads as jcompress)
from repro_torch import tree  # noqa: E402
from repro_torch.data import LMBatchLoader, make_corpus_tokens  # noqa: E402
from repro_torch.data.synthetic import generate_text  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: E402
from repro_torch.runtime.compression import (  # noqa: E402
    ErrorFeedback, compress_decompress_grads)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs: the tiny tensors gain nothing
    from more, and spinning threads slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree_):
    """A port tree (tensors) or a JAX tree as numpy leaves, flat."""
    return [np.asarray(x) for x in tree.leaves(tree_)]


def _jax_leaves(t):
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(t)]


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_identical_to_reference(seed):
    assert generate_text(300, seed) == jtext(300, seed)
    for vocab in (256, 64, 151936):
        a = make_corpus_tokens(vocab, 400, seed=seed)
        b = jcorpus(vocab, 400, seed=seed)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2)])
def test_loader_identical_to_reference(hosts):
    """Batches at the same (seed, step, host) are the reference's; so are a
    resumed loader's and the eval windows."""
    index, count = hosts
    toks = make_corpus_tokens(256, 2000)
    port = LMBatchLoader(toks, 4, 32, host_index=index, host_count=count,
                         seed=5)
    ref = JLoader(toks, 4, 32, host_index=index, host_count=count, seed=5)
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert a.dtype == np.int32 and a.shape == (4, 33)
        np.testing.assert_array_equal(a, b)
    assert port.state_dict() == ref.state_dict() == {"step": 3}
    resumed = LMBatchLoader(toks, 4, 32, host_index=index, host_count=count,
                            seed=5)
    resumed.load_state_dict({"step": 3})
    np.testing.assert_array_equal(resumed.next_batch(), ref.next_batch())
    for a, b in zip(port.eval_batches(3, batch=2), ref.eval_batches(3, batch=2)):
        np.testing.assert_array_equal(a, b)


def test_loader_deterministic_and_resumable():
    toks = make_corpus_tokens(256, 2000)
    l1 = LMBatchLoader(toks, 4, 32)
    b0, b1 = l1.next_batch(), l1.next_batch()
    l2 = LMBatchLoader(toks, 4, 32)
    l2.load_state_dict({"step": 1})
    np.testing.assert_array_equal(l2.next_batch(), b1)
    assert not np.array_equal(b0, b1)


def test_loader_host_sharding_disjoint_streams():
    toks = make_corpus_tokens(256, 2000)
    a = LMBatchLoader(toks, 4, 32, host_index=0, host_count=2).next_batch()
    b = LMBatchLoader(toks, 4, 32, host_index=1, host_count=2).next_batch()
    assert not np.array_equal(a, b)


def test_corpus_learnable():
    toks = make_corpus_tokens(256, 500)
    assert len(toks) > 5000
    assert toks.max() < 256


def test_loader_refuses_a_short_corpus():
    with pytest.raises(ValueError, match="corpus too small"):
        LMBatchLoader(np.arange(10, dtype=np.int32), 2, 16)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("warmup,total", [(10, 100), (20, 100), (1, 5)])
def test_schedules_match_reference(warmup, total):
    for step in (0, warmup - 1, warmup, total):
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = cosine_schedule(s, 2e-3, warmup, total)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                float(got), float(jcos(jnp.int32(step), 2e-3, warmup, total)),
                rtol=RTOL)
            np.testing.assert_allclose(
                float(linear_warmup(s, 2e-3, warmup)),
                float(jwarm(jnp.int32(step), 2e-3, warmup)), rtol=RTOL)


def test_cosine_schedule_shape():
    lrs = [float(cosine_schedule(s, 1.0, 10, 100)) for s in range(100)]
    assert lrs[0] < lrs[9]                  # warmup
    assert max(lrs) <= 1.0 + 1e-6
    assert lrs[-1] < 0.2                    # decayed to floor


# ---------------------------------------------------------------- AdamW


def _param_tree(rng):
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "nested": {"b": rng.standard_normal(5).astype(np.float32),
                       "norm": np.ones(4, np.float32)},
            "lst": [rng.standard_normal(3).astype(np.float32),
                    rng.standard_normal((2, 2)).astype(np.float32)]}


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map(fn, v) for v in t]
    return fn(t)


@pytest.mark.parametrize("grad_scale", [10.0, 0.01], ids=["clip", "noclip"])
def test_adamw_matches_reference_on_identical_grads(grad_scale):
    """Three steps fed the same numpy gradients: params, moments, the step
    and the grad norm agree within rtol 1e-6, with the clip active (global
    norm ~ 100 > 1) and inactive (~ 0.1)."""
    rng = np.random.default_rng(0)
    p0 = _param_tree(rng)
    jp = _map(jnp.asarray, p0)
    tp = _map(torch.from_numpy, _map(np.copy, p0))
    jo, to = jinit(jp), adamw_init(tp)
    for step in range(3):
        g = _map(lambda x: (rng.standard_normal(x.shape) * grad_scale
                            ).astype(np.float32), p0)
        lr = float(jcos(jnp.int32(step), 1e-2, 2, 10))
        jp, jo, jg = jupdate(jp, _map(jnp.asarray, g), jo, lr)
        tp, to, tg = adamw_update(tp, _map(torch.from_numpy, g), to,
                                  cosine_schedule(to.step, 1e-2, 2, 10))
        np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL)
        assert (float(jg) > 1.0) == (grad_scale > 1.0)
    assert int(to.step) == int(jo.step) == 3
    for got, want in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        for a, b in zip(_np(got), _jax_leaves(want)):
            floor = RTOL * np.abs(b).max() if grad_scale > 1 else 0.0
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=floor)


def test_clip_by_global_norm_leaves_input_alone():
    g = {"w": torch.full((4,), 3.0), "v": [torch.full((2,), 4.0)]}
    clipped, gn = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(gn), np.sqrt(4 * 9 + 2 * 16), rtol=RTOL)
    norm = np.sqrt(sum(float((x ** 2).sum()) for x in tree.leaves(clipped)))
    np.testing.assert_allclose(norm, 1.0, rtol=1e-6)
    assert float(g["w"][0]) == 3.0


def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    loss = lambda p: torch.sum(p["w"] ** 2)  # noqa: E731
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, opt, _ = adamw_update(params, {"w": g}, opt, lr=0.1,
                                      weight_decay=0.0)
    assert float(loss(params)) < 1e-2


# ----------------------------------------------------------- compression


def _grads_with_ties(rng):
    """Leaves whose scaled values land on x.5 (max |g| = 127: scale 1), so
    round-half-to-even decides, plus random leaves and an integer leaf."""
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                     3.49999, 0.0], np.float32)
    return {"ties": ties,
            "w": rng.standard_normal((32, 8)).astype(np.float32),
            "tiny": (rng.standard_normal(6) * 1e-30).astype(np.float32),
            "zero": np.zeros(3, np.float32),
            "ids": np.arange(5, dtype=np.int32)}


def test_int8_compression_exact_against_reference():
    g = _grads_with_ties(np.random.default_rng(1))
    got = compress_decompress_grads(_map(torch.from_numpy, g))
    want = jcompress(_map(jnp.asarray, g))
    for k in g:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert got["ids"].dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(got["ties"])[1:7],
                                  [0.0, 2.0, 2.0, -0.0, -2.0, -2.0])


def test_int8_compression_keeps_bf16_dtype():
    g = {"w": torch.randn(16, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)}
    out = compress_decompress_grads(g)["w"]
    assert out.dtype == torch.bfloat16
    want = jcompress({"w": jnp.asarray(g["w"].float().numpy()
                                       ).astype(jnp.bfloat16)})["w"]
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_int8_compression_small_error():
    g = {"w": torch.randn((256, 64), generator=torch.Generator().manual_seed(0))}
    gc = compress_decompress_grads(g)
    rel = float(torch.linalg.norm(gc["w"] - g["w"]) / torch.linalg.norm(g["w"]))
    assert rel < 0.01


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(2)
    g = {"w": (rng.standard_normal(64) * 1e-3 + 1e-5).astype(np.float32),
         "m": [rng.standard_normal((4, 4)).astype(np.float32)]}
    port, ref = ErrorFeedback(_map(torch.from_numpy, g)), JEF(_map(jnp.asarray, g))
    for _ in range(5):
        a = port.apply(_map(torch.from_numpy, g))
        b = ref.apply(_map(jnp.asarray, g))
        for x, y in zip(_np(a), _jax_leaves(b)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
        for x, y in zip(_np(port.residual), _jax_leaves(ref.residual)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def test_error_feedback_reduces_bias():
    gen = torch.Generator().manual_seed(1)
    g = {"w": torch.randn((64,), generator=gen) * 1e-3 + 1e-5}
    ef = ErrorFeedback(g)
    total_naive = torch.zeros(64)
    total_ef = torch.zeros(64)
    for _ in range(50):
        total_naive += compress_decompress_grads(g)["w"]
        total_ef += ef.apply(g)["w"]
    true = g["w"] * 50
    assert float(torch.linalg.norm(total_ef - true)) <= \
        float(torch.linalg.norm(total_naive - true)) + 1e-6
