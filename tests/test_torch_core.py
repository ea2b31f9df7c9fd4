"""Port parity, core: the PyTorch practical RHT, code packing, RaBitQ-H and
QuantizedLinear against the JAX reference on shared numpy inputs.

Tolerances: the RHT is f32 matmuls in both frameworks (summation order
differs), so 1e-5 absolute on unit-scale inputs; codes must be equal up to
the off-by-one round-half ties the reference's own kernel test tolerates
(tests/test_kernels.py:65-69).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.core import hadamard as jh  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.core import rabitq as jrq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import hadamard as th  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core import rabitq as trq  # noqa: E402


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _signs(rng, d):
    return rng.choice([-1.0, 1.0], size=d).astype(np.float32)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_registry_matches_reference(arch):
    for get_t, get_j in ((treg.get_config, jreg.get_config),
                         (treg.get_tiny, jreg.get_tiny)):
        assert (dataclasses.asdict(get_t(arch))
                == dataclasses.asdict(get_j(arch)))


@pytest.mark.parametrize("d", [64, 128, 100, 1000])
def test_practical_rht_and_inverse(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(3, d)).astype(np.float32)
    dh = th.largest_pow2_leq(d)
    s1 = _signs(rng, dh)
    s2 = _signs(rng, dh) if dh != d else None
    j = jh.practical_rht(jnp.asarray(x), jnp.asarray(s1),
                         None if s2 is None else jnp.asarray(s2))
    t = th.practical_rht(torch.from_numpy(x), torch.from_numpy(s1),
                         None if s2 is None else torch.from_numpy(s2))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    back = th.practical_rht_inverse(t, torch.from_numpy(s1),
                                    None if s2 is None else torch.from_numpy(s2))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    # along axis 0, the layout quantize_linear rotates weights in
    t0 = th.practical_rht(torch.from_numpy(x.T.copy()), torch.from_numpy(s1),
                          None if s2 is None else torch.from_numpy(s2), axis=0)
    np.testing.assert_allclose(t0.numpy().T, np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_unpack_matches_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, size=(37, 5)).astype(np.uint8)
    jp = np.asarray(jpack.pack_codes(jnp.asarray(codes), bits))
    tp = tpack.pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert tp.shape[0] == tpack.packed_rows(37, bits)
    np.testing.assert_array_equal(tpack.unpack_codes(tp, bits, 37).numpy(),
                                  codes)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_rabitq_quantize_matches_reference(bits):
    rng = np.random.default_rng(10 + bits)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    jq = jrq.quantize(jnp.asarray(w), bits)
    tq = trq.quantize(torch.from_numpy(w), bits)
    diff = tq.codes.numpy().astype(int) - np.asarray(jq.codes).astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 5e-3
    np.testing.assert_allclose(tq.rescale.numpy(), np.asarray(jq.rescale),
                               rtol=5e-3, atol=1e-6)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    np.testing.assert_allclose(
        trq.estimate_matmul(torch.from_numpy(x), tq).numpy(),
        np.asarray(jrq.estimate_matmul(jnp.asarray(x), jq)),
        rtol=1e-2, atol=1e-2)


def _ql_dict(q) -> dict:
    out = {k: (None if getattr(q, k) is None else np.asarray(getattr(q, k)))
           for k in bridge.QL_TENSORS}
    out.update({k: getattr(q, k) for k in bridge.QL_STATIC})
    return out


@pytest.mark.parametrize("bits,d,c", [(4, 128, 48), (3, 200, 40), (2, 256, 32)])
def test_quantize_linear_with_reference_signs(bits, d, c):
    rng = np.random.default_rng(bits * 100 + d)
    w = rng.normal(size=(d, c)).astype(np.float32)
    norms = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    jq = jql.quantize_linear(jnp.asarray(w), bits, jax.random.PRNGKey(7),
                             x_col_norms=norms, outlier_frac=0.02)
    tq = tql.quantize_linear(
        torch.from_numpy(w), bits, torch.from_numpy(np.array(jq.signs1)),
        None if jq.signs2 is None else torch.from_numpy(np.array(jq.signs2)),
        x_col_norms=norms, outlier_frac=0.02, device="cpu")
    assert (tq.bits, tq.d, tq.d_keep, tq.c) == (jq.bits, jq.d, jq.d_keep, jq.c)
    np.testing.assert_array_equal(tq.out_idx.numpy(), np.asarray(jq.out_idx))
    np.testing.assert_array_equal(tq.w_out.numpy(), np.asarray(jq.w_out))
    np.testing.assert_allclose(tq.mean_col.numpy().astype(np.float32),
                               np.asarray(jq.mean_col).astype(np.float32),
                               atol=1e-3)
    tc = tpack.unpack_codes(tq.packed, bits, tq.d_keep).numpy().astype(int)
    jc = np.asarray(jpack.unpack_codes(jq.packed, bits, jq.d_keep)).astype(int)
    assert np.abs(tc - jc).max() <= 1 and (tc != jc).mean() < 5e-3
    np.testing.assert_allclose(tq.rescale.numpy().astype(np.float32),
                               np.asarray(jq.rescale).astype(np.float32),
                               rtol=5e-3)


@pytest.mark.parametrize("bits,d,c", [(4, 128, 48), (3, 200, 40), (8, 256, 16)])
def test_apply_and_reconstruct_match_reference(bits, d, c):
    """The reference's quantized layer, carried across by the bridge: the
    port's apply and reconstruct_weight agree with JAX's, and apply equals
    x @ reconstruct_weight."""
    rng = np.random.default_rng(bits + d)
    w = rng.normal(size=(d, c)).astype(np.float32)
    norms = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    jq = jql.quantize_linear(jnp.asarray(w), bits, jax.random.PRNGKey(3),
                             x_col_norms=norms, outlier_frac=0.02)
    tq = bridge._quantized(_ql_dict(jq), torch.device("cpu"))
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    jy = np.asarray(jq.apply(jnp.asarray(x)))
    ty = tq.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4 * np.abs(jy).max())
    w_hat = tql.reconstruct_weight(tq)
    np.testing.assert_allclose(w_hat.numpy(),
                               np.asarray(jql.reconstruct_weight(jq)),
                               atol=1e-5)
    np.testing.assert_allclose(ty, (torch.from_numpy(x) @ w_hat).numpy(),
                               rtol=1e-4, atol=1e-4 * np.abs(jy).max())


def test_draw_signs_fit_quantize_linear():
    gen = torch.Generator().manual_seed(0)
    s1, s2 = tql.draw_signs(100, gen)
    assert s1.shape == (64,) and s2.shape == (64,)
    assert set(np.unique(s1.numpy())) <= {-1.0, 1.0}
    assert tql.draw_signs(128, gen)[1] is None
    w = torch.randn(100, 8, generator=gen)
    q = tql.quantize_linear(w, 4, s1, s2, device="cpu")
    assert q.d_keep == 100 and q.packed.shape == (50, 8)
    with pytest.raises(ValueError):
        tql.quantize_linear(w, 4, s1, None, device="cpu")
