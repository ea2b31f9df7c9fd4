"""Port parity, paged flash-decode attention: the plain block-walking PyTorch
version (what the CUDA kernel is held against on the card) against the
reference's Pallas kernel in interpret mode and its dense-gather oracle,
over batch, span width W, GQA ratio G, block size, sliding windows and
post-wraparound ring states, with f32 and bf16 arenas.

Tolerances: rtol 1e-4 for f32 arenas (online vs dense softmax differ only
in summation order), 2e-2 for bf16 (tests/test_kernels.py:29,44; the dense
oracle rounds q to bf16 where the kernel keeps it f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention.paged import paged_attention_pallas  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402


def _pool_state(seed, b, w, kv, g, hd, bs, mb, wrapped):
    """A reachable pool state: whole-block ring capacities, disjoint
    block-table rows, pos covering partial-final-block and wrapped rings."""
    rng = np.random.default_rng(seed)
    ring_blocks = rng.integers(1, mb + 1, size=b)
    n_phys = 1 + int(ring_blocks.sum())
    q = rng.normal(size=(b, w, kv * g, hd)).astype(np.float32)
    k = rng.normal(size=(n_phys, bs, kv, hd)).astype(np.float32)
    v = rng.normal(size=(n_phys, bs, kv, hd)).astype(np.float32)
    bt = np.zeros((b, mb), np.int32)
    nxt = 1
    for i in range(b):
        for j in range(int(ring_blocks[i])):
            bt[i, j] = nxt
            nxt += 1
    ring = (ring_blocks * bs).astype(np.int32)
    pos = np.array([rng.integers(max(int(c) + 1 if wrapped else w, w),
                                 max(3 * int(c) if wrapped else int(c), w) + 1)
                    for c in ring], np.int32)
    return q, k, v, bt, pos, ring


CASES = [  # b, w, kv, g, hd, bs, mb, window, wrapped
    (1, 1, 2, 1, 16, 4, 4, None, False),
    (3, 1, 2, 2, 16, 4, 4, None, False),
    (2, 3, 1, 4, 32, 8, 3, None, False),
    (3, 1, 2, 1, 16, 4, 4, 6, True),
    (2, 2, 2, 2, 16, 4, 3, 5, True),
    (2, 3, 2, 1, 16, 8, 2, None, True),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_pallas_and_dense_oracle(case, dtype):
    b, w, kv, g, hd, bs, mb, window, wrapped = CASES[case]
    q, k, v, bt, pos, ring = _pool_state(case, b, w, kv, g, hd, bs, mb,
                                         wrapped)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    got = pops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(bt),
        torch.from_numpy(pos), torch.from_numpy(ring), window=window)
    jargs = (jnp.asarray(q), jnp.asarray(k).astype(jdt),
             jnp.asarray(v).astype(jdt), jnp.asarray(bt), jnp.asarray(pos),
             jnp.asarray(ring))
    tol = 1e-4 if dtype == "f32" else 2e-2
    for want in (paged_attention_pallas(*jargs, window=window, interpret=True),
                 paged_attention_ref(*jargs, window=window)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_inactive_slot_reads_null_block_and_stays_finite():
    """Inactive engine slots carry pos 0, ring 1 and an all-zero table:
    they read only null block 0 and must give finite output."""
    q, k, v, bt, pos, ring = _pool_state(9, 2, 1, 2, 1, 16, 4, 3, False)
    bt[1] = 0
    pos[1] = 0
    ring[1] = 1
    got = pops.paged_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, bt, pos, ring)))
    assert torch.isfinite(got).all()
    # only slot 0 of the null block is live: the output is its value row
    np.testing.assert_allclose(got[1, 0].numpy(), v[0, 0], rtol=1e-6)


def test_slot_positions_and_write_indices_match_reference():
    from repro.models import attention as jattn
    pos = np.array([0, 5, 17, 40], np.int32)
    ring = np.array([1, 8, 16, 12], np.int32)
    want = np.asarray(jattn.paged_slot_positions(jnp.asarray(pos),
                                                 jnp.asarray(ring), 16))
    got = tattn.paged_slot_positions(torch.from_numpy(pos),
                                     torch.from_numpy(ring), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    bt = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    active = np.array([False, True, True, True])
    jw = jattn.paged_write_indices(jnp.asarray(pos), jnp.asarray(ring),
                                   jnp.asarray(bt), 4, jnp.asarray(active))
    tw = tattn.paged_write_indices(torch.from_numpy(pos),
                                   torch.from_numpy(ring), torch.from_numpy(bt),
                                   4, torch.from_numpy(active))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dispatch_plain_on_cpu_and_kernel_refuses_cpu():
    args = [torch.from_numpy(a) for a in
            _pool_state(3, 2, 1, 2, 1, 16, 4, 3, False)]
    before = pops.launches
    pops.paged_attention(*args)
    assert pops.launches == before
    with pops.paged_kernel(True), pytest.raises(RuntimeError):
        pops.paged_attention(*args)
    with pytest.raises(ValueError):
        pops.paged_attention_cuda(*args)


@pytest.mark.parametrize("window", [0, -3])
def test_window_below_one_is_refused_on_both_paths(window):
    """The kernel reads window <= 0 as "no window" while the plain version
    would mask every key, so both entry points refuse such a window."""
    args = [torch.from_numpy(a) for a in
            _pool_state(3, 2, 1, 2, 1, 16, 4, 3, False)]
    with pytest.raises(ValueError, match="window"):
        pops.paged_attention(*args, window=window)
    with pytest.raises(ValueError, match="window"):
        pops.paged_attention_cuda(*args, window=window)


@pytest.mark.parametrize("b,kv,mb", [(8, 32, 64), (8, 8, 34), (1, 4, 2),
                                     (64, 32, 64)])
def test_kv_split_plan(b, kv, mb):
    """The flash-decoding split count the wrapper hands the kernel: at
    least one, never more than the table width, and enough CTAs to give
    each of 132 SMs work whenever the table allows it."""
    s = pops.kv_splits(b, kv, mb, n_sm=132)
    assert 1 <= s <= mb
    assert b * kv * s >= 132 or s == mb
