"""Port parity, RaBitQ code search: the port's plain version (what the CUDA
kernel ``csrc/rabitq_quant.cu`` is held against on the card) against the
reference's Pallas kernel in interpret mode and its oracle
``repro.core.rabitq.quantize``, over bits 1-8 x three (d, c).

Tolerance: the reference kernel test's own (tests/test_kernels.py:65-69):
codes differ by at most one and in under 0.5% of entries (round-half ties
under different f32 arithmetic, and the candidate scales' one-ulp
difference, ROADMAP Queue 3), rescale rtol 5e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rabitq as jrabitq  # noqa: E402
from repro.kernels.rabitq_quant.quantize import quantize_pallas  # noqa: E402
from repro_torch.kernels.rabitq_quant import ops as rq_ops  # noqa: E402

SHAPES = [(777, 91), (2048, 16), (300, 40)]


def _weights(bits, d, c):
    rng = np.random.default_rng(1000 * bits + d + c)
    # columns of different scale, as rotated weights have
    return (rng.normal(size=(d, c))
            * rng.uniform(0.1, 2.0, size=(1, c))).astype(np.float32)


def _close(codes, rescale, want_codes, want_rescale):
    diff = codes.astype(int) - np.asarray(want_codes).astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 5e-3
    np.testing.assert_allclose(rescale, np.asarray(want_rescale), rtol=5e-3,
                               atol=1e-5)


def _port(w, bits):
    q = rq_ops.quantize(torch.from_numpy(w), bits)
    assert q.bits == bits and q.codes.dtype == torch.uint8
    return q.codes.numpy(), q.rescale.numpy()


@pytest.mark.parametrize("d,c", SHAPES)
@pytest.mark.parametrize("bits", range(1, 9))
def test_plain_matches_pallas_interpret(bits, d, c):
    w = _weights(bits, d, c)
    codes, rescale = quantize_pallas(jnp.asarray(w), bits=bits,
                                     interpret=True)
    _close(*_port(w, bits), codes, rescale)


@pytest.mark.parametrize("d,c", SHAPES)
@pytest.mark.parametrize("bits", range(1, 9))
def test_plain_matches_reference_oracle(bits, d, c):
    w = _weights(bits, d, c)
    q = jrabitq.quantize(jnp.asarray(w), bits)
    _close(*_port(w, bits), q.codes, q.rescale)


def test_cpu_tensor_takes_plain_path_and_kernel_path_refuses_cpu():
    w = torch.from_numpy(_weights(4, 64, 8))
    before = rq_ops.launches
    q = rq_ops.quantize(w, 4)
    assert q.codes.shape == (64, 8) and rq_ops.launches == before
    rq_ops.set_forced_path("kernel")
    try:
        with pytest.raises(RuntimeError):
            rq_ops.quantize(w, 4)
    finally:
        rq_ops.set_forced_path(None)
    with pytest.raises(ValueError):
        rq_ops.quantize_cuda(w, 4)
