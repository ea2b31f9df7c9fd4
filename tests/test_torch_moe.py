"""Port parity, MoE: ``repro_torch.models.moe.moe_ffn`` against
``repro.models.moe.moe_ffn`` with x and the weights carried across as numpy.

Cases: a no-drop capacity; the published capacity factor 1.25, where tokens
are dropped; and batches with all-zero rows (an inactive decode slot's
hidden state), whose router probabilities tie exactly, so the tie order of
top-k decides which experts they take and which active tokens the capacity
then drops.  Expert ids, keep masks and the capacity must be identical (a
mismatch would route a token to another expert, not perturb it); outputs
and the aux loss agree to 1e-5 relative (f32, summation order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

E, K, D, F = 4, 2, 32, 48
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _params(seed=0):
    """Expert 0's router column leans on the inputs' common offset (see
    ``_x``), so it is in most tokens' top-2 and overflows at factor 1.25."""
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(D, E)).astype(np.float32) * D ** -0.5
    router[:, 0] += 2.0 / D
    return {"router": router,
            "wi": rng.normal(size=(E, D, 2 * F)).astype(np.float32) * D ** -0.5,
            "wo": rng.normal(size=(E, F, D)).astype(np.float32) * F ** -0.5}


def _x(b, s, zero_rows=(), seed=1):
    x = np.random.default_rng(seed).normal(size=(b, s, D)).astype(np.float32)
    x += 1.0
    for r in zero_rows:
        x.reshape(b * s, D)[r] = 0.0
    return x


def _routing_jax(p, x, capacity_factor):
    """The reference's expert ids, keep mask and capacity (moe.py:57-79)."""
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(t, D)) @ p["router"], -1)
    _, ids = jax.lax.top_k(probs, K)
    cap = int(max(K, capacity_factor * t * K / E))
    flat = ids.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    e_sorted = flat[order]
    counts = jnp.zeros((E,), jnp.int32).at[e_sorted].add(1)
    rank = jnp.arange(t * K) - (jnp.cumsum(counts) - counts)[e_sorted]
    return np.asarray(ids), np.asarray(order), np.asarray(rank < cap), cap


def _routing_torch(p, x, capacity_factor):
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x.reshape(t, D))
                          @ torch.from_numpy(p["router"]), -1)
    _, ids = tmoe.top_k_lowest_index(probs, K)
    cap = int(max(K, capacity_factor * t * K / E))
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    e_sorted = flat[order]
    counts = torch.bincount(e_sorted, minlength=E)
    rank = torch.arange(t * K) - (torch.cumsum(counts, 0) - counts)[e_sorted]
    return ids.numpy(), order.numpy(), (rank < cap).numpy(), cap


CASES = [  # name, (b, s), capacity factor, zero rows
    ("no-drop", (2, 12), 64.0, ()),
    ("published-1.25-drops", (3, 16), 1.25, ()),
    ("inert-slot-ties-decode", (8, 1), 1.25, (0, 2, 3, 5, 6)),
    ("inert-slot-ties-prefill", (1, 20), 1.25, (1, 4, 7, 8, 13)),
]


@pytest.mark.parametrize("name,shape,cf,zero_rows", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_ffn_matches_reference(name, shape, cf, zero_rows):
    p = _params()
    x = _x(*shape, zero_rows=zero_rows)
    jr = _routing_jax(p, x, cf)
    tr = _routing_torch(p, x, cf)
    for what, a, b in zip(("expert ids", "dispatch order", "keep mask",
                           "capacity"), tr, jr):
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: {what}")
    if cf < 64:
        assert not jr[2].all(), f"{name}: the case must drop tokens"
    want_y, want_aux = jmoe.moe_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        n_experts=E, top_k=K, capacity_factor=cf)
    got_y, got_aux = tmoe.moe_ffn(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        n_experts=E, top_k=K, capacity_factor=cf)
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=RTOL,
                               atol=RTOL * np.abs(want_y).max())
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    for r in zero_rows:                     # an inert row's FFN output is 0
        assert not got_y.numpy().reshape(-1, D)[r].any()


def test_zero_rows_take_the_lowest_experts_first():
    """All-equal probabilities: jax.lax.top_k and the port take experts 0
    and 1, and an inert row sorts ahead of later active rows."""
    probs = torch.full((3, E), 1.0 / E)
    _, ids = tmoe.top_k_lowest_index(probs, K)
    _, jids = jax.lax.top_k(jnp.full((3, E), 1.0 / E), K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy(), [[0, 1]] * 3)


def test_expert_matmul_taps_match_reference():
    """The grouped calibration taps (x_col_sq over experts and capacity,
    zero rows included; n_rows = E*C) and the perturbation hook."""
    from repro.models.common import LinearCtx as JCtx
    from repro_torch.models.common import LinearCtx as TCtx
    p = _params()
    xbuf = np.random.default_rng(3).normal(size=(E, 5, D)).astype(np.float32)
    xbuf[1, 3:] = 0.0
    jctx, tctx = JCtx(collect=True), TCtx(collect=True)
    jy = jmoe._expert_matmul(jnp.asarray(p["wi"]), jnp.asarray(xbuf), jctx,
                             "m.wi")
    ty = tmoe._expert_matmul(torch.from_numpy(p["wi"]), torch.from_numpy(xbuf),
                             tctx, "m.wi")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=RTOL)
    jt, tt = jctx.taps["m.wi"], tctx.taps["m.wi"]
    for k in ("x_fro_sq", "x_col_sq", "w_fro", "n_rows"):
        np.testing.assert_allclose(np.asarray(tt[k]), np.asarray(jt[k]),
                                   rtol=RTOL, err_msg=k)
    for k in ("d", "c", "h_shape", "grouped", "n_groups"):
        assert tuple(np.atleast_1d(tt[k])) == tuple(np.atleast_1d(jt[k])), k
    pert = TCtx(perturb={"m.wi": torch.ones(ty.shape)})
    y2 = tmoe._expert_matmul(torch.from_numpy(p["wi"]),
                             torch.from_numpy(xbuf), pert, "m.wi")
    np.testing.assert_allclose(y2.numpy(), ty.numpy() + 1.0, rtol=RTOL)
