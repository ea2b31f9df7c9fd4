"""Port parity, flash attention: the port's dispatcher
``repro_torch.kernels.flash_attention.ops.attention`` on CPU tensors (its
plain version, what the CUDA kernel is held against on the card) against
the reference's Pallas kernel in interpret mode and its jnp oracle
``attention_ref``, on the same numpy inputs.

Cases: causal (MHA and GQA with G = 2), a sliding window with S a few
windows long and not a multiple of the kernel's block (padded keys and
queries), non-causal with ragged S, and bf16 inputs.  Tolerance: the
reference kernel test's own (tests/test_flash_kernel.py): 2e-4 in f32, and
2e-2 relative in bf16, where the two frameworks round the bf16 output at
different places.

The CUDA kernel's tiling (128-query CTAs of 16-row warps, 64-key tiles,
band skips, base-2 online softmax, P rounded to bf16 for bf16 inputs) is
held the same way through its host twin ``ref.flash_tile_walk``, at
sequence lengths that span several query and key tiles: causal, a window
without the causal mask, windows that fully mask the early tiles of a
CTA's later rows, ragged S and GQA.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.kernels.flash_attention.flash import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_tile_walk  # noqa: E402


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


CASES = [  # name, (b, s, h, kv, hd), causal, window
    ("causal-mha", (1, 128, 4, 4, 32), True, None),
    ("causal-gqa-g2", (2, 96, 4, 2, 16), True, None),
    ("window-16-padded", (1, 100, 4, 2, 32), True, 16),
    ("window-50-s3w", (2, 150, 2, 1, 16), True, 50),
    ("noncausal-ragged", (2, 80, 2, 2, 16), False, None),
]


@pytest.mark.parametrize("name,shape,causal,window", CASES,
                         ids=[c[0] for c in CASES])
def test_dispatcher_matches_pallas_interpret_and_oracle(name, shape, causal,
                                                        window):
    q, k, v = _qkv(*shape, seed=len(name))
    before = fops.launches
    got = fops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=causal, window=window)
    assert fops.launches == before and got.dtype == torch.float32
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    pallas = flash_attention_pallas(*jargs, causal=causal, window=window,
                                    bq=32, bk=32, interpret=True)
    oracle = attention_ref(*jargs, causal=causal, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_bf16_matches_pallas_interpret():
    q, k, v = _qkv(1, 128, 4, 2, 32, seed=9)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fops.attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jargs = tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = flash_attention_pallas(*jargs, causal=True, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_cuda_entry_refuses_cpu_and_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 16, seed=1))
    with pytest.raises(ValueError):
        fops.flash_attention_cuda(q, k, v)
    fops.set_forced_path("kernel")
    try:
        with pytest.raises(RuntimeError):
            fops.attention(q, k, v)
    finally:
        fops.set_forced_path(None)
    fops.set_forced_path("ref")
    try:
        np.testing.assert_array_equal(fops.attention(q, k, v).numpy(),
                                      fops.attention_ref(q, k, v).numpy())
    finally:
        fops.set_forced_path(None)


WALK_CASES = [  # name, (b, s, h, kv, hd), causal, window
    ("causal-gqa-g4", (1, 300, 8, 2, 16), True, None),
    ("causal-mha-ragged", (2, 203, 2, 2, 32), True, None),
    ("window-only-ragged", (1, 271, 4, 2, 16), False, 50),
    ("window-16-masks-early-tiles", (1, 330, 4, 1, 16), True, 16),
    ("window-70-gqa", (2, 257, 4, 2, 16), True, 70),
    ("noncausal-ragged", (1, 190, 2, 1, 32), False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", WALK_CASES,
                         ids=[c[0] for c in WALK_CASES])
def test_tile_walk_matches_pallas_interpret(name, shape, causal, window,
                                            dtype):
    """The kernel's tile walk on the host against the reference's Pallas
    kernel in interpret mode: f32 rtol/atol 2e-4, bf16 2e-2."""
    q, k, v = _qkv(*shape, seed=len(name) + 3)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_tile_walk(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jargs = tuple(jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (tq, tk, tv))
    want = flash_attention_pallas(*jargs, causal=causal, window=window,
                                  interpret=True)
    tol = 2e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
