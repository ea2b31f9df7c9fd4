"""Port parity, the grouped (MoE) dequant GEMM and its quantizer: the plain
PyTorch ``grouped_rht_quantized_matmul`` (what the CUDA kernel is held
against on the card) against the reference's vmap over experts, on its jnp
oracles and on its Pallas kernels in interpret mode, fused and under
``fusion(False)``; then ``quantize_grouped`` with the reference's signs
against ``repro.core.qlinear.quantize_grouped``, and ``QuantizedGrouped``
carried across by the bridge.

Sweep: bits {1, 2, 3, 4, 8} x d {256 (one RHT block), 300 (overlapped Alg.
5)} x C {1, 5} rows per expert, 3 experts.  At a prefill chunk's capacity
(C = 20): the GEMM per expert built as the tensor-core kernel builds it
(three bf16 planes) against the reference; the kernel's plan at Mixtral's
decode and prefill shapes.  Tolerance: rtol 1e-4 in f32
(the reference kernel's own, tests/test_kernels.py:29); codes within the
off-by-one round-half ties that tests/test_torch_core.py's
``test_rabitq_quantize_matches_reference`` tolerates.  TF32 is off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import packing as jpack  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.kernels.hadamard import ops as jhops  # noqa: E402
from repro.kernels.qmatmul import ops as jqops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import hadamard, packing  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.kernels.qmatmul import ref as tref  # noqa: E402

BITS = [1, 2, 3, 4, 8]
DIMS = [256, 300]
E, C_OUT = 3, 40


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(bits, d, cap, seed=0):
    rng = np.random.default_rng(seed + 100 * bits + d + cap)
    rows = packing.packed_rows(d, bits)
    hi = 256 if packing.codes_per_byte(bits) > 1 or bits == 8 else 1 << bits
    packed = rng.integers(0, hi, size=(E, rows, C_OUT)).astype(np.uint8)
    rescale = rng.uniform(0.01, 0.1, size=(E, C_OUT)).astype(np.float16)
    dh = 1 << (d.bit_length() - 1)
    s1 = rng.choice([-1.0, 1.0], size=dh).astype(np.float32)
    s2 = rng.choice([-1.0, 1.0], size=dh).astype(np.float32) if dh != d else None
    x = rng.normal(size=(E, cap, d)).astype(np.float32)
    x[1, -1] = 0.0                  # an empty capacity row, as dispatch leaves
    return x, packed, rescale, s1, s2


def _torch(*args):
    return tuple(None if a is None else torch.from_numpy(a) for a in args)


def _jax(*args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("cap", [1, 5])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_reference_oracle(bits, d, cap, fused):
    args = _inputs(bits, d, cap)
    with jqops.fusion(fused):
        want = jqops.grouped_rht_quantized_matmul(*_jax(*args), bits=bits,
                                                  d=d)
    before = (qops.grouped_launches, qops.grouped_unfused_launches)
    with qops.fusion(fused):
        got = qops.grouped_rht_quantized_matmul(*_torch(*args), bits=bits,
                                                d=d)
    assert got.shape == (E, cap, C_OUT)
    assert (qops.grouped_launches, qops.grouped_unfused_launches) == before
    _close(got.numpy(), want)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("bits", [1, 3, 4])
def test_plain_matches_pallas_interpret(bits, d, fused):
    args = _inputs(bits, d, 5, seed=1)
    jqops.set_forced_path("pallas")
    jhops.set_forced_path("pallas")
    try:
        with jqops.fusion(fused):
            want = jqops.grouped_rht_quantized_matmul(*_jax(*args), bits=bits,
                                                      d=d)
    finally:
        jqops.set_forced_path(None)
        jhops.set_forced_path(None)
    with qops.fusion(fused):
        got = qops.grouped_rht_quantized_matmul(*_torch(*args), bits=bits,
                                                d=d)
    _close(got.numpy(), want)


def test_cuda_entries_refuse_cpu_tensors():
    x, packed, rescale, s1, s2 = _torch(*_inputs(4, 300, 2))
    with pytest.raises(ValueError):
        qops.grouped_rht_quantized_matmul_cuda(x, packed, rescale, s1, s2,
                                               bits=4, d=300)
    with pytest.raises(ValueError):
        qops.grouped_quantized_matmul_cuda(x, packed, rescale, bits=4, d=300)
    qops.set_forced_path("kernel")
    try:
        with pytest.raises(RuntimeError):
            qops.grouped_rht_quantized_matmul(x, packed, rescale, s1, s2,
                                              bits=4, d=300)
    finally:
        qops.set_forced_path(None)


@pytest.mark.parametrize("e,cap,d,c,bits", [
    (8, 2, 4096, 28672, 4), (8, 2, 14336, 4096, 3), (8, 20, 4096, 28672, 2),
    (4, 3, 128, 256, 8)])
def test_grouped_split_plan_fills_the_card(e, cap, d, c, bits):
    """The plan the grouped launch uses: every packed row in one split, and
    at Mixtral's decode and prefill shapes expert x column x split CTAs for
    every one of 132 SMs."""
    nt, cps, splits = qops.split_plan(cap, d, c, n_sm=132, groups=e)
    chunks = -(-d // qops.K_CHUNK)
    assert (chunks * qops.K_CHUNK) // packing.codes_per_byte(bits) >= \
        packing.packed_rows(d, bits)
    assert (splits - 1) * cps < chunks <= splits * cps
    assert nt in qops.N_TILES and 8 * nt >= cap
    if d >= 4096:
        assert e * -(-c // qops.COLS_PER_CTA) * splits >= 132


@pytest.mark.parametrize("bits,d,c", [(4, 128, 48), (3, 200, 40), (2, 256, 32),
                                      (8, 96, 24)])
def test_quantize_grouped_with_reference_signs(bits, d, c):
    rng = np.random.default_rng(bits * 100 + d)
    w = rng.normal(size=(E, d, c)).astype(np.float32)
    jq = jql.quantize_grouped(jnp.asarray(w), bits, jax.random.PRNGKey(5))
    tq = tql.quantize_grouped(
        torch.from_numpy(w), bits, torch.from_numpy(np.array(jq.signs1)),
        None if jq.signs2 is None else torch.from_numpy(np.array(jq.signs2)),
        device="cpu")
    assert (tq.bits, tq.d, tq.c, tq.shape) == (jq.bits, jq.d, jq.c, jq.shape)
    assert tq.overhead_bits() == jq.overhead_bits()
    for i in range(E):
        tc = packing.unpack_codes(tq.packed[i], bits, d).numpy().astype(int)
        jc = np.asarray(jpack.unpack_codes(jq.packed[i], bits, d)).astype(int)
        assert np.abs(tc - jc).max() <= 1 and (tc != jc).mean() < 5e-3, i
    np.testing.assert_allclose(tq.rescale.numpy().astype(np.float32),
                               np.asarray(jq.rescale).astype(np.float32),
                               rtol=5e-3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bridged_grouped_apply_matches_reference(fused):
    """The reference's QuantizedGrouped carried across by the bridge: the
    port's apply agrees with JAX's on the reference's own codes."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(E, 300, 64)).astype(np.float32)
    jq = jql.quantize_grouped(jnp.asarray(w), 3, jax.random.PRNGKey(2))
    node = {k: None if getattr(jq, k) is None else np.asarray(getattr(jq, k))
            for k in bridge.QG_TENSORS}
    node.update({k: getattr(jq, k) for k in bridge.QG_STATIC})
    tq = bridge._convert(node, torch.device("cpu"))
    assert isinstance(tq, tql.QuantizedGrouped)
    x = rng.normal(size=(E, 4, 300)).astype(np.float32)
    with jqops.fusion(fused):
        want = jq.apply(jnp.asarray(x))
    with qops.fusion(fused):
        got = tq.apply(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("bits", list(range(1, 9)))
def test_planes_gemm_per_expert_matches_reference_at_prefill_capacity(bits,
                                                                      d):
    """C = 20 rows per expert (a 64-token prefill chunk's capacity): the
    rotation, then each expert's GEMM built from the three bf16 planes, as
    the tensor-core route computes it, against the reference's vmap."""
    args = _inputs(bits, d, 20, seed=7)
    want = jqops.grouped_rht_quantized_matmul(*_jax(*args), bits=bits, d=d)
    x, packed, rescale, s1, s2 = _torch(*args)
    xr = hadamard.practical_rht(x, s1, s2, axis=-1)
    got = torch.stack([tref.quantized_matmul_planes_ref(
        xr[e], packed[e], rescale[e], bits=bits, d=d) for e in range(E)])
    assert not got[1, -1].any()                 # the empty capacity row
    _close(got.numpy(), want)


@pytest.mark.parametrize("e,cap,d,c", [
    (8, 2, 4096, 28672), (8, 2, 14336, 4096), (8, 20, 4096, 28672),
    (8, 20, 14336, 4096)])
def test_grouped_plan_covers_each_expert_in_one_row_block(e, cap, d, c):
    """One CTA covers all rows of an expert: decode capacity (C = 2) in one
    n-tile, a prefill chunk's (C = 20) in three; every d chunk in exactly
    one split."""
    nt, cps, splits = qops.split_plan(cap, d, c, n_sm=132, groups=e)
    assert nt == (1 if cap <= 8 else 3)
    chunks = -(-d // qops.K_CHUNK)
    assert (splits - 1) * cps < chunks <= splits * cps
