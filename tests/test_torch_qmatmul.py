"""Port parity, dequant GEMMs: the plain PyTorch versions (what the CUDA
kernels are held against on the card) against the reference's Pallas
kernels in interpret mode and their pure-jnp oracles.  The fused RHT + GEMM
over bits {1,2,3,4,8} x d {power of 2, not a power of 2, a d_keep whose last
packed byte holds pad codes} x n {1, batched}; the unfused GEMM on an
already-rotated X over the reference kernel test's sweep
(tests/test_kernels.py:16-20); the unfused A/B composition under
``fusion(False)`` against the reference's under its own ``fusion(False)``.
The tensor-core kernel's arithmetic: the plain twin of its x split into
three bf16 planes rebuilds every f32 value bit for bit, and the GEMM built
from the planes' products matches the f32 plain GEMM and the reference's
``quantized_matmul_ref`` at bits 1-8 and the prefill row counts; its
tiling plan covers every packed row and column with one CTA per group of
up to 64 rows.

Tolerance: rtol 1e-4 in f32 (the reference kernel's own, tests/
test_kernels.py:29); the products are f32 in every version (each plane's
product with a code is exact in f32), only the summation order differs.
TF32 is off.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.qmatmul import ops as jqops  # noqa: E402
from repro.kernels.qmatmul.qmatmul import (  # noqa: E402
    quantized_matmul_pallas, rht_quantized_matmul_pallas)
from repro.kernels.qmatmul.ref import (  # noqa: E402
    quantized_matmul_ref, rht_quantized_matmul_ref)
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.kernels.qmatmul import ref as tref  # noqa: E402
from repro_torch.kernels.qmatmul.ref import (  # noqa: E402
    rht_quantized_matmul_ref as torch_ref)

BITS = [1, 2, 3, 4, 8]
# 256: power of 2; 300: overlapped Alg. 5; 301: d_keep whose last packed
# byte holds pad codes at b in {1, 2, 4} (code 0 - c_b is not 0)
DIMS = [256, 300, 301]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(bits, d, n, c=40, seed=0):
    rng = np.random.default_rng(seed + 100 * bits + d + n)
    rows = packing.packed_rows(d, bits)
    hi = 256 if packing.codes_per_byte(bits) > 1 or bits == 8 else 1 << bits
    packed = rng.integers(0, hi, size=(rows, c)).astype(np.uint8)
    rescale = rng.uniform(0.01, 0.1, size=c).astype(np.float16)
    dh = 1 << (d.bit_length() - 1)
    s1 = rng.choice([-1.0, 1.0], size=dh).astype(np.float32)
    s2 = rng.choice([-1.0, 1.0], size=dh).astype(np.float32) if dh != d else None
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, packed, rescale, s1, s2


def _torch_args(x, packed, rescale, s1, s2):
    return (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(rescale), torch.from_numpy(s1),
            None if s2 is None else torch.from_numpy(s2))


def _jax_args(x, packed, rescale, s1, s2):
    return (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(rescale),
            jnp.asarray(s1), None if s2 is None else jnp.asarray(s2))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_reference_oracle(bits, d, n):
    args = _inputs(bits, d, n)
    want = rht_quantized_matmul_ref(*_jax_args(*args), bits=bits, d=d)
    got = qops.rht_quantized_matmul(*_torch_args(*args), bits=bits, d=d)
    _close(got.numpy(), want)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_pallas_interpret(bits, d):
    args = _inputs(bits, d, 5, seed=1)
    want = rht_quantized_matmul_pallas(*_jax_args(*args), bits=bits, d=d,
                                       interpret=True)
    got = torch_ref(*_torch_args(*args), bits=bits, d=d)
    _close(got.numpy(), want)


def test_cpu_tensor_takes_plain_path_and_kernel_path_refuses_cpu():
    args = _torch_args(*_inputs(4, 300, 3))
    before = qops.launches
    y = qops.rht_quantized_matmul(*args, bits=4, d=300)
    assert y.shape == (3, 40) and qops.launches == before
    qops.set_forced_path("kernel")
    try:
        with pytest.raises(RuntimeError):
            qops.rht_quantized_matmul(*args, bits=4, d=300)
    finally:
        qops.set_forced_path(None)
    with pytest.raises(ValueError):
        qops.rht_quantized_matmul_cuda(*args, bits=4, d=300)


@pytest.mark.parametrize("n,d,c,bits", [(1, 4083, 4096, 4), (8, 4083, 4096, 4),
                                        (64, 4083, 22016, 4),
                                        (8, 10974, 4096, 3), (3, 301, 40, 2),
                                        (3, 301, 48, 2)])
def test_split_plan_covers_every_packed_row(n, d, c, bits):
    """The split-K plan the wrapper hands the kernel: every 64-value d chunk
    (and so every packed row) in exactly one split, one n-tile of 8 rows
    per 8 rows of the group, and enough column x split CTAs to give each of
    132 SMs work at the main path's shapes.  The kernel reads code rows in
    16-byte chunks, so a c that is not a multiple of 16 is refused (the
    plain versions take any c)."""
    if c % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            qops.split_plan(n, d, c, n_sm=132)
        return
    nt, cps, splits = qops.split_plan(n, d, c, n_sm=132)
    chunks = -(-d // qops.K_CHUNK)
    assert chunks * qops.K_CHUNK >= d
    assert (chunks * qops.K_CHUNK) // packing.codes_per_byte(bits) >= \
        packing.packed_rows(d, bits)
    assert (splits - 1) * cps < chunks <= splits * cps
    assert nt in qops.N_TILES and 8 * nt >= n
    ctas = -(-c // qops.COLS_PER_CTA) * splits
    if d >= 4096:
        assert ctas >= 132


@pytest.mark.parametrize("bits,n,d,c", [
    (1, 5, 256, 33), (2, 33, 700, 130), (3, 9, 300, 50),
    (4, 64, 512, 96), (4, 1, 4096, 16), (8, 17, 1024, 64),
])
def test_quantized_matmul_matches_pallas_interpret(bits, n, d, c):
    x, packed, rescale, _, _ = _inputs(bits, d, n, c=c, seed=2)
    want = quantized_matmul_pallas(jnp.asarray(x), jnp.asarray(packed),
                                   jnp.asarray(rescale), bits=bits, d=d,
                                   interpret=True)
    before = qops.unfused_launches
    got = qops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(rescale), bits=bits, d=d)
    assert qops.unfused_launches == before        # CPU: the plain version
    _close(got.numpy(), want)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("bits", BITS + [5, 6, 7])
def test_unfused_composition_matches_reference(bits, d):
    args = _inputs(bits, d, 3, seed=3)
    with jqops.fusion(False):
        want = jqops.rht_quantized_matmul(*_jax_args(*args), bits=bits, d=d)
    x = torch.from_numpy(args[0]).reshape(1, 3, d)
    with qops.fusion(False):
        got = qops.rht_quantized_matmul(x, *_torch_args(*args)[1:], bits=bits,
                                        d=d)
    assert got.shape == (1, 3, 40)
    _close(got.reshape(3, 40).numpy(), want)


def test_fusion_scope_nests_and_unwinds():
    assert qops.fused_enabled()
    with qops.fusion(False):
        assert not qops.fused_enabled()
        with qops.fusion(True):
            assert qops.fused_enabled()
        assert not qops.fused_enabled()
        with pytest.raises(KeyError):
            with qops.fusion(True):
                raise KeyError("unwinds on error")
        assert not qops.fused_enabled()
    assert qops.fused_enabled()


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7.0, 1e4, 1e30])
def test_split_planes_rebuild_every_f32_value(scale):
    """hi + mid + lo == x bit for bit, each plane exact in bf16, over seeded
    normal values at magnitudes from 1e-20 to 1e30, where every part is a
    normal f32 value (near 2^-110 lo would fall among the subnormals)."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = torch.from_numpy((rng.normal(size=(64, 517)) * scale)
                         .astype(np.float32))
    hi, mid, lo = tref.split_planes(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    rebuilt = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(rebuilt.view(torch.int32), x.view(torch.int32))
    # hi is x truncated to bf16: its low 16 bits are x's, cleared
    assert torch.equal(hi.float().view(torch.int32),
                       x.view(torch.int32) & -65536)


@pytest.mark.parametrize("n", [16, 20, 64])
@pytest.mark.parametrize("d", [256, 300])
@pytest.mark.parametrize("bits", list(range(1, 9)))
def test_planes_gemm_matches_plain_and_reference(bits, d, n):
    """The GEMM as the tensor-core route builds it (three bf16 planes'
    products, f32 sums, f32 row sum) against the f32 plain GEMM and the
    reference's ``quantized_matmul_ref``."""
    x, packed, rescale, _, _ = _inputs(bits, d, n, c=48, seed=5)
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(rescale))
    got = tref.quantized_matmul_planes_ref(*args, bits=bits, d=d)
    plain = tref.quantized_matmul_ref(*args, bits=bits, d=d)
    want = quantized_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                                jnp.asarray(rescale), bits=bits, d=d)
    _close(got.numpy(), plain.numpy())
    _close(got.numpy(), want)


@pytest.mark.parametrize("n,d,c,groups", [
    (16, 4083, 4096, 1), (20, 4096, 28672, 8), (20, 14336, 4096, 8),
    (32, 4083, 22016, 1), (64, 4083, 4096, 1), (64, 10974, 4096, 1),
    (64, 301, 48, 1), (100, 700, 256, 2), (130, 4096, 4096, 1)])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_split_plan_covers_every_packed_row_and_column(n, d, c, groups,
                                                       bits):
    """The plan at prefill and MoE shapes: the d chunks cover every packed
    row (the last chunk's pad codes meet zero x), each chunk is in exactly
    one split, the CTA's columns cover c, and one CTA covers all n <= 64
    rows of a group (wider groups take blocks of 64)."""
    nt, cps, splits = qops.split_plan(n, d, c, n_sm=132, groups=groups)
    chunks = -(-d // qops.K_CHUNK)
    per = packing.codes_per_byte(bits)
    assert chunks * qops.K_CHUNK // per >= packing.packed_rows(d, bits)
    assert (splits - 1) * cps < chunks <= splits * cps
    assert -(-c // qops.COLS_PER_CTA) * qops.COLS_PER_CTA >= c
    assert nt in qops.N_TILES
    if n <= 64:
        assert 8 * nt >= n and (nt == 1 or 8 * (nt - 1) < n)
    else:
        assert nt == 8
    row_blocks = -(-n // (8 * nt))
    assert row_blocks == max(1, -(-n // 64))
    if d >= 4096 and c >= 4096:     # the main path's shapes fill the card
        ctas = -(-c // qops.COLS_PER_CTA) * groups * row_blocks * splits
        assert ctas >= 132
