"""Port parity, randomized Hadamard transform: the port's
``kernels/hadamard/ops.practical_rht`` (its plain version on the CPU, what
the CUDA kernel ``csrc/hadamard.cu`` is held against on the card) against
``repro.kernels.hadamard.ops.practical_rht`` with the Pallas kernel forced
(interpret mode), over the reference kernel test's power-of-2 sweep
(tests/test_kernels.py:49) and non-power-of-2 d, where Alg. 5 transforms
the overlap twice.  Tolerance atol 2e-4, the reference kernel test's own.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hadamard import ops as jhops  # noqa: E402
from repro_torch.kernels.hadamard import ops as hops  # noqa: E402

CASES = [(16, 1024), (7, 4096), (3, 256), (1, 16384),
         (5, 300), (4, 700), (2, 1000)]


def _inputs(n, d):
    rng = np.random.default_rng(n * 100003 + d)
    dh = 1 << (d.bit_length() - 1)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s1 = rng.choice([-1.0, 1.0], size=dh).astype(np.float32)
    s2 = rng.choice([-1.0, 1.0], size=dh).astype(np.float32) if dh != d else None
    return x, s1, s2


@pytest.fixture
def pallas_path():
    jhops.set_forced_path("pallas")
    yield
    jhops.set_forced_path(None)


@pytest.mark.parametrize("n,d", CASES)
def test_practical_rht_matches_pallas_interpret(pallas_path, n, d):
    x, s1, s2 = _inputs(n, d)
    want = jhops.practical_rht(jnp.asarray(x), jnp.asarray(s1),
                               None if s2 is None else jnp.asarray(s2))
    got = hops.practical_rht(torch.from_numpy(x), torch.from_numpy(s1),
                             None if s2 is None else torch.from_numpy(s2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_leading_axes_and_cpu_path():
    x, s1, s2 = _inputs(6, 300)
    xt = torch.from_numpy(x).reshape(2, 3, 300)
    before = hops.launches
    y = hops.practical_rht(xt, torch.from_numpy(s1), torch.from_numpy(s2))
    assert y.shape == (2, 3, 300) and hops.launches == before
    flat = hops.practical_rht(torch.from_numpy(x), torch.from_numpy(s1),
                              torch.from_numpy(s2))
    np.testing.assert_array_equal(y.reshape(6, 300).numpy(), flat.numpy())
    hops.set_forced_path("kernel")
    try:
        with pytest.raises(RuntimeError):
            hops.practical_rht(xt, torch.from_numpy(s1), torch.from_numpy(s2))
    finally:
        hops.set_forced_path(None)
    with pytest.raises(ValueError):
        hops.rht_cuda(torch.from_numpy(x), torch.from_numpy(s1),
                      torch.from_numpy(s2))
