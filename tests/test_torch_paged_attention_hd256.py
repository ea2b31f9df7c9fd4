"""Port parity, paged attention at head_dim 256 (recurrentgemma's local
attention: MQA, 10 query heads over 1 KV head, a window over a ring that
wraps): the plain block walk (what the CUDA kernel is held against on the
card) and the walk of the kernel's launch plan against the reference's
dense oracle ``repro/kernels/paged_attention/ref.py``, f32 and bf16
arenas; and the split plan's resident CTAs per SM by head dim and arena
dtype (one at hd 256 with an f32 arena, whose K/V ring is 192 KB).

Tolerances: rtol 1e-4 for f32 arenas, 2e-2 for bf16 (as
``test_torch_paged_attention.py``: the dense oracle rounds q to bf16 where
the kernel keeps it f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pref  # noqa: E402

HD = 256


def _state(seed, b, w, h, bs, ring_blocks, mb, pos):
    """Disjoint rings of ``ring_blocks`` blocks per request, one KV head."""
    rng = np.random.default_rng(seed)
    n_phys = 1 + b * ring_blocks
    q = rng.normal(size=(b, w, h, HD)).astype(np.float32)
    k = rng.normal(size=(n_phys, bs, 1, HD)).astype(np.float32)
    v = rng.normal(size=(n_phys, bs, 1, HD)).astype(np.float32)
    bt = np.zeros((b, mb), np.int32)
    bt[:, :ring_blocks] = np.arange(1, n_phys, dtype=np.int32).reshape(
        b, ring_blocks)
    ring = np.full(b, ring_blocks * bs, np.int32)
    return q, k, v, bt, np.asarray(pos, np.int32), ring


CASES = {  # name: (b, w, h, bs, ring blocks, table width, pos, window)
    # decode, G = 10: the window (24) is the ring (6 blocks of 4); the
    # first request has not filled it, the others wrapped it once or more
    "decode G=10 window 24, ring wrapped": (3, 1, 10, 4, 6, 6,
                                            [13, 31, 70], 24),
    # a window shorter than the ring, inside a tile
    "decode G=10 window 9": (2, 1, 10, 4, 6, 6, [22, 40], 9),
    # no window, a table wider than the ring (engine tables are)
    "decode G=2 full": (2, 1, 2, 8, 3, 5, [20, 9], None),
}


def _inputs(name, dtype):
    b, w, h, bs, rb, mb, pos, window = CASES[name]
    q, k, v, bt, pos, ring = _state(len(name), b, w, h, bs, rb, mb, pos)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    targs = (torch.from_numpy(q), torch.from_numpy(k).to(tdt),
             torch.from_numpy(v).to(tdt), torch.from_numpy(bt),
             torch.from_numpy(pos), torch.from_numpy(ring))
    want = jax.jit(paged_attention_ref, static_argnames="window")(
        jnp.asarray(q), jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(ring), window=window)
    return targs, np.asarray(want.astype(jnp.float32)), window


def _hold(got, want, dtype):
    tol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_and_plan_walk_match_reference_at_hd256(name, dtype):
    targs, want, window = _inputs(name, dtype)
    _hold(pops.paged_attention(*targs, window=window), want, dtype)
    for splits, min_keys in ((1, pref.MIN_SPLIT_KEYS), (3, 8)):
        got = pref.paged_attention_plan_walk(*targs, window=window,
                                             splits=splits,
                                             min_split_keys=min_keys)
        _hold(got, want, dtype)


@pytest.mark.parametrize("hd,bf16,per_sm", [(64, False, 2), (128, False, 2),
                                            (128, True, 2), (256, True, 2),
                                            (256, False, 1)])
def test_split_plan_ctas_per_sm_by_head_dim_and_dtype(hd, bf16, per_sm):
    """Two K/V rings fit in an SM's shared memory up to 96 KB a ring; an
    f32 ring at hd 256 is 192 KB, so the grid plans one CTA per SM there.
    recurrentgemma's decode (B 8, KV 1, a 128-block table of 2048 keys)
    gets as many splits as keep its CTAs resident on 132 SMs, at most one
    per MIN_SPLIT_KEYS keys."""
    assert pops.ctas_per_sm(hd, bf16) == per_sm
    ring = pops.STAGES * 2 * pref.TILE_KEYS * hd * (2 if bf16 else 4)
    assert per_sm * ring <= pops.SMEM_PER_SM
    s = pops.kv_splits(8, 1, 128, 16, 132, per_sm)
    assert s == min(per_sm * 132 // 8, 2048 // pref.MIN_SPLIT_KEYS)


def test_kernel_takes_hd256_and_refuses_cpu_tensors():
    """hd 256 passes the wrapper's head-dim check; CPU tensors are refused
    by the CUDA entry (the kernel runs only on the card)."""
    assert 256 in pops.HEAD_DIMS
    targs, _, window = _inputs("decode G=10 window 9", "f32")
    with pytest.raises(ValueError) as err:
        pops.paged_attention_cuda(*targs, window=window)
    assert "CUDA device" in str(err.value) and "head_dim" not in str(
        err.value)
