"""Port parity, RaBitQ code search: the port's plain version (what the CUDA
kernel ``csrc/rabitq_quant.cu`` is held against on the card) and the
kernel's split of d walked on the host (``ref.search_walk``, P row slices
combined in rank order) against the reference's Pallas kernel in interpret
mode and its oracle ``repro.core.rabitq.quantize``, over bits 1-8 x three
(d, c); and the kernel's division (from the correctly rounded reciprocal)
against IEEE division in exact arithmetic.

Tolerance: the reference kernel test's own (tests/test_kernels.py:65-69):
codes differ by at most one and in under 0.5% of entries (round-half ties
under different f32 arithmetic, and the candidate scales' one-ulp
difference, ROADMAP Queue 3), rescale rtol 5e-3.
"""
import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rabitq as jrabitq  # noqa: E402
from repro.kernels.rabitq_quant.quantize import quantize_pallas  # noqa: E402
from repro_torch.kernels.rabitq_quant import ops as rq_ops  # noqa: E402
from repro_torch.kernels.rabitq_quant import ref as rq_ref  # noqa: E402

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


@functools.lru_cache(maxsize=None)
def _oracle(bits, d, c):
    """The reference oracle's codes and rescale for ``_weights(bits, d,
    c)``, computed once per case for every test that reads them."""
    q = jrabitq.quantize(jnp.asarray(_weights(bits, d, c)), bits)
    return np.asarray(q.codes), np.asarray(q.rescale)


@functools.lru_cache(maxsize=None)
def _plain(bits, d, c):
    """The port's plain code search on ``_weights(bits, d, c)``, once per
    case."""
    return rq_ops.quantize(torch.from_numpy(_weights(bits, d, c)), bits)


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
    _close(*_port(w, bits), *_oracle(bits, d, c))


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


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("d,c", SHAPES)
@pytest.mark.parametrize("bits", range(1, 9))
def test_search_walk_matches_reference_oracle(bits, d, c, slices):
    """The kernel's decomposition (P row slices, warps' interleaved rows,
    rank-order combine; d a multiple of P or not) against the oracle within
    the file's tolerance, and against the port's plain version: identical
    codes wherever the two choose the same step, a near-tie (objective gap
    1e-5, as on the card) wherever they do not."""
    w = _weights(bits, d, c)
    codes, rescale, choice = rq_ref.search_walk(torch.from_numpy(w), bits,
                                                slices=slices)
    _close(codes.numpy(), rescale.numpy(), *_oracle(bits, d, c))
    plain = _plain(bits, d, c)
    levels = (1 << bits) - 1
    wt = torch.from_numpy(w)
    delta0 = (wt.abs().amax(0).clamp(min=1e-30)
              / torch.full((c,), levels / 2.0))
    scales = torch.from_numpy(rq_ops.candidate_scales(12))
    errs = []
    for s in scales:
        v = torch.clamp(torch.round(wt / (delta0 * s) + levels / 2.0), 0.0,
                        float(levels)) - levels / 2.0
        wv, vv = (wt * v).sum(0), (v * v).sum(0)
        errs.append(-(wv * wv) / vv.clamp(min=1e-30))
    errs = torch.stack(errs)
    same = choice == errs.argmin(0)
    assert torch.equal(codes[:, same], plain.codes[:, same])
    if not same.all():
        gap = ((errs.gather(0, choice[None])[0] - errs.min(0).values).abs()
               / errs.min(0).values.abs())[~same]
        assert float(gap.max()) <= 1e-5
    np.testing.assert_allclose(rescale.numpy()[same.numpy()],
                               plain.rescale.numpy()[same.numpy()],
                               rtol=1e-5)


def test_search_plan_splits_d_into_up_to_eight_slices():
    """Slices per cluster: d split as far as the portable cluster of 8
    allows, never below 128 rows a slice (the pipeline's weights all take
    8)."""
    plan = {d: rq_ops.search_plan(d)
            for d in (4083, 10974, 4096, 14336, 1024, 1023, 300, 255, 1)}
    assert plan == {4083: 8, 10974: 8, 4096: 8, 14336: 8, 1024: 8,
                    1023: 4, 300: 2, 255: 1, 1: 1}


def _rn32(v: Fraction) -> np.float32:
    """The exact value v rounded to the nearest f32, ties to even."""
    f = np.float32(float(v))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda g: (abs(Fraction(float(g)) - v),
                                     int(g.view(np.uint32)) & 1))


def _kernel_division(x: np.float32, delta: np.float32) -> np.float32:
    """csrc/rabitq_quant.cu:div_by in exact arithmetic: rcp = RN(1/delta),
    q0 = RN(x * rcp), rem = RN(x - q0 * delta) (one fma), RN(q0 + rem * rcp)
    (one fma)."""
    rcp = _rn32(1 / Fraction(float(delta)))
    q0 = _rn32(Fraction(float(x)) * Fraction(float(rcp)))
    rem = _rn32(Fraction(float(x)) - Fraction(float(q0))
                * Fraction(float(delta)))
    return _rn32(Fraction(float(q0)) + Fraction(float(rem))
                 * Fraction(float(rcp)))


def test_kernel_division_is_ieee_division():
    """The code search divides by way of the correctly rounded reciprocal;
    it must give IEEE division's bits.  Random mantissa pairs, quotients
    placed within an ulp of a rounding midpoint (the hard cases), and the
    pipeline's own operands (unit-normal w over absmax / c_b times each
    candidate scale).  (On the card, chip_smoke.py sweeps every mantissa
    pair.)"""
    rng = np.random.default_rng(17)

    def mant(k):
        return (np.float32(1.0) + rng.integers(0, 1 << 23, size=k).astype(
            np.float32) * np.float32(2.0 ** -23)).astype(np.float32)
    pairs = list(zip(mant(1500), mant(1500)))
    for delta in mant(1500):
        m = (np.float64(rng.integers(1 << 23, 1 << 24)) + 0.5) * 2.0 ** -23
        x = np.float32(m * np.float64(delta))           # x / delta ~ midpoint
        pairs.append((x, delta))
    w = rng.normal(size=(200, 8)).astype(np.float32)
    delta0 = np.abs(w).max(0) / np.float32(7.5)
    for s in rq_ops.candidate_scales(12)[::3]:
        pairs += list(zip(w[:, 0], np.full(200, np.float32(delta0[0] * s))))
    bad = [(x, d) for x, d in pairs
           if _kernel_division(x, d) != np.float32(x) / np.float32(d)]
    assert not bad, bad[:5]
