"""The dense gather behind ``paged_kernel(False)`` (the CLI's
``--no-paged-kernel``) against the JAX reference on the host.

``kernels/paged_attention/ref.paged_attention_gather`` is the reference's
``paged_attention_ref`` ported as it is; it is held against that function
and against the port's block walk (the kernel's yardstick) at W = 1, 2 and
4, with f32 and bf16 arenas, windows and wrapped rings: rtol 1e-4 for f32,
2e-2 for bf16 (tests/test_kernels.py:29,44; the block walk keeps q in
f32).  The engine on the gather is held against the JAX engine's gather
where a JAX engine already runs: without speculation in
``tests/test_torch_frontdoor.py::test_steps_without_prefill_match_reference``,
with it (the verify's gather branch) in
``tests/test_torch_speculative.py::test_engine_matches_reference``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_paged_attention import _pool_state  # noqa: E402

from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pref  # noqa: E402

CASES = [  # b, kv, g, hd, bs, mb, window, wrapped
    (3, 2, 2, 16, 4, 4, None, False),
    (2, 1, 4, 32, 8, 3, 5, True),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w,case", [(1, 0), (2, 1), (4, 1)])
def test_gather_matches_reference_and_block_walk(w, case, dtype):
    b, kv, g, hd, bs, mb, window, wrapped = CASES[case]
    q, k, v, bt, pos, ring = _pool_state(case + 10 * w, b, w, kv, g, hd, bs,
                                         mb, wrapped)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = (torch.from_numpy(q), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(bt),
            torch.from_numpy(pos), torch.from_numpy(ring))
    got = pref.paged_attention_gather(*args, window=window)
    before = pops.launches
    with pops.paged_kernel(False):
        assert not pops.kernel_enabled()
        assert torch.equal(pops.paged_attention(*args, window=window), got)
    assert pops.launches == before
    jdt = jax.numpy.float32 if dtype == "f32" else jax.numpy.bfloat16
    want = jax.jit(paged_attention_ref, static_argnames="window")(
        q, jax.numpy.asarray(k).astype(jdt), jax.numpy.asarray(v).astype(jdt),
        bt, pos, ring, window=window)
    tol = 1e-4 if dtype == "f32" else 2e-2
    for ref in (np.asarray(want.astype(jax.numpy.float32)),
                pref.paged_attention_ref(*args, window=window).numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())


def test_engine_refuses_the_kernel_on_the_host():
    from repro_torch.configs import get_tiny
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import PagedServer, PoolConfig
    cfg = get_tiny("llama2-7b")
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs the card"):
        PagedServer(cfg, params, PoolConfig(max_context=64),
                    paged_kernel=True, device="cpu")
    engine = PagedServer(cfg, params, PoolConfig(max_context=64),
                         paged_kernel=False, device="cpu")
    assert engine.paged_kernel is False
