"""Port parity, paged flash-decode attention: the plain block-walking PyTorch
version (what the CUDA kernel is held against on the card) and the walk of
the kernel's launch plan (splits, 32-key tiles, per-warp key slices, fixed-
order merges) against the reference's Pallas kernel in interpret mode and
its dense-gather oracle, over batch, span width W, GQA ratio G, block size,
sliding windows and post-wraparound ring states, with f32 and bf16 arenas.

Tolerances: rtol 1e-4 for f32 arenas (online vs dense softmax differ only
in summation order), 2e-2 for bf16 (tests/test_kernels.py:29,44; the dense
oracle rounds q to bf16 where the kernel keeps it f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.kernels.paged_attention.paged import paged_attention_pallas  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pref  # noqa: E402
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
    least one; more only while every (request, KV head, split) CTA stays
    resident (CTAS_PER_SM on each of 132 SMs) and each split of a full
    table holds MIN_SPLIT_KEYS keys; and as many as those two limits
    allow."""
    bs, n_sm = 16, 132
    slots = pops.CTAS_PER_SM * n_sm
    s = pops.kv_splits(b, kv, mb, bs, n_sm=n_sm)
    assert s >= 1
    assert s == 1 or (b * kv * s <= slots
                      and s * pref.MIN_SPLIT_KEYS <= mb * bs)
    assert (b * kv * (s + 1) > slots
            or (s + 1) * pref.MIN_SPLIT_KEYS > mb * bs)


def _tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _hold(got, q, k, v, bt, pos, ring, window, dtype, oracle=True):
    """got against the reference's Pallas kernel (interpret mode) and, with
    ``oracle``, its dense oracle, at the file's tolerance for the arena
    dtype."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jargs = (jnp.asarray(q), jnp.asarray(k).astype(jdt),
             jnp.asarray(v).astype(jdt), jnp.asarray(bt), jnp.asarray(pos),
             jnp.asarray(ring))
    tol = 1e-4 if dtype == "f32" else 2e-2
    wants = [paged_attention_pallas(*jargs, window=window, interpret=True)]
    if oracle:
        wants.append(paged_attention_ref(*jargs, window=window))
    for want in wants:
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def _walk_and_plain(q, k, v, bt, pos, ring, window, dtype, splits,
                    min_split_keys):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tq, tk, tv, tbt, tpos, tring = _tensors(q, k, v, bt, pos, ring)
    tk, tv = tk.to(tdt), tv.to(tdt)
    walk = pref.paged_attention_plan_walk(
        tq, tk, tv, tbt, tpos, tring, window=window, splits=splits,
        min_split_keys=min_split_keys)
    plain = pref.paged_attention_ref(tq, tk, tv, tbt, tpos, tring,
                                     window=window)
    tol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), rtol=tol,
                               atol=tol * plain.abs().max().item())
    return walk


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plan_walk_matches_pallas_and_plain(case, dtype):
    """The kernel's plan, walked on the host over the file's CASES: one
    split, and three splits of at least 8 keys (the CASES' tables hold 16-32
    keys, so later splits are empty and the first may write directly)."""
    b, w, kv, g, hd, bs, mb, window, wrapped = CASES[case]
    args = _pool_state(case, b, w, kv, g, hd, bs, mb, wrapped)
    for splits, min_keys in ((1, pref.MIN_SPLIT_KEYS), (3, 8)):
        got = _walk_and_plain(*args, window, dtype, splits, min_keys)
        _hold(got, *args, window, dtype)


def _long_state(seed, b, w, kv, g, hd, bs, ring_blocks, mb, pos):
    """Disjoint rings of ``ring_blocks`` blocks (a longer table than the
    CASES', so a request spans several 32-key tiles), positions given."""
    rng = np.random.default_rng(seed)
    n_phys = 1 + b * ring_blocks
    q = rng.normal(size=(b, w, kv * g, hd)).astype(np.float32)
    k = rng.normal(size=(n_phys, bs, kv, hd)).astype(np.float32)
    v = rng.normal(size=(n_phys, bs, kv, hd)).astype(np.float32)
    bt = np.zeros((b, mb), np.int32)
    bt[:, :ring_blocks] = np.arange(1, n_phys, dtype=np.int32).reshape(
        b, ring_blocks)
    ring = np.full(b, ring_blocks * bs, np.int32)
    return q, k, v, bt, np.asarray(pos, np.int32), ring


PLAN_CASES = {  # name: (state args, window, splits, min_split_keys)
    # 96-key rings, 3 tiles: four splits of >= 16 keys give one tile each
    # and leave split 3 empty; the 24-key request keeps one split and
    # writes directly under the same grid
    "empty split": ((1, 3, 1, 2, 2, 16, 8, 12, 12, [96, 90, 24]), None, 4,
                    16),
    # a 40-key ring over two tiles (one per split), wrapped: the newest
    # slot (pos - 1) % 40 lies inside tile 0 (16, 9) or tile 1 (34)
    "ring wraps inside a tile": ((2, 3, 1, 2, 1, 16, 8, 5, 6,
                                  [57, 75, 130]), None, 2, 16),
    # window 50 over 100 unwrapped keys: the first visible key, 50, lies
    # inside tile 1
    "window starts inside a tile": ((3, 2, 1, 2, 2, 16, 4, 30, 30,
                                     [100, 77]), 50, 3, 32),
    # R = W * G = 35 rows (a verify span of 5 over G = 7)
    "R=35: W=5, G=7": ((4, 2, 5, 1, 7, 16, 8, 10, 10, [80, 45]), None, 2,
                       32),
    # an inactive engine slot beside a live one: pos 0, ring 1, null block
    # (the Pallas kernel's semantics: only slot 0 of block 0 is live; the
    # reference's dense oracle reads such a slot otherwise, so it is left
    # out here)
    "inactive slot": ((5, 2, 1, 2, 1, 16, 8, 8, 8, [64, 0]), None, 2, 16),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_walk_corner_cases(name, dtype):
    state, window, splits, min_keys = PLAN_CASES[name]
    q, k, v, bt, pos, ring = _long_state(*state)
    inactive = name == "inactive slot"
    if inactive:
        bt[1], ring[1] = 0, 1
    got = _walk_and_plain(q, k, v, bt, pos, ring, window, dtype, splits,
                          min_keys)
    _hold(got, q, k, v, bt, pos, ring, window, dtype, oracle=not inactive)
    if inactive:                # slot 0 of the null block is its only key
        want = torch.from_numpy(v[0, 0])
        if dtype == "bf16":
            want = want.to(torch.bfloat16).float()
        np.testing.assert_allclose(got[1, 0].numpy(), want.numpy(),
                                   rtol=1e-6)


def test_split_plan_partitions_every_tile_once():
    """split_plan: the S splits' tile ranges tile [0, tiles) with no gap or
    overlap, no more splits are used than s_eff, whose splits average at
    least min_split_keys keys unless it is 1 (tiles round the last split
    down), and a split past s_eff (or past the last tile) is empty."""
    bs, mb, min_keys = 16, 40, 128
    pos = torch.arange(1, mb * bs + 50, 7)
    cnt = pos.clamp(min=1)
    cap = torch.full_like(pos, mb * bs)
    for splits in (1, 2, 3, 5, 8):
        nkeys, s_eff, tiles, per = pref.split_plan(cnt, cap, bs, mb, splits,
                                                   min_keys)
        assert bool(((1 <= s_eff) & (s_eff <= splits)).all())
        for i in range(len(pos)):
            ranges = [(s * int(per[i]), min((s + 1) * int(per[i]),
                                            int(tiles[i])))
                      for s in range(splits)]
            covered = [t for t0, t1 in ranges for t in range(t0, t1)]
            assert covered == list(range(int(tiles[i])))
            used = [(t0, t1) for t0, t1 in ranges if t0 < t1]
            assert len(used) <= int(s_eff[i])
            if int(s_eff[i]) > 1:
                assert int(nkeys[i]) // int(s_eff[i]) >= min_keys


def test_kernel_refuses_head_dims_it_is_not_compiled_for():
    """The kernel is compiled for head_dim 64 and 128 only (every full-width
    config has 128); the plain version takes any."""
    q, k, v, bt, pos, ring = _tensors(
        *_pool_state(3, 2, 1, 2, 1, 16, 4, 3, False))
    with pytest.raises(ValueError, match="head_dim 16"):
        pops.paged_attention_cuda(q, k, v, bt, pos, ring)
    assert torch.isfinite(pops.paged_attention(q, k, v, bt, pos, ring)).all()
