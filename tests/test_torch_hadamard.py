"""Port parity, randomized Hadamard transform: the port's
``kernels/hadamard/ops.practical_rht`` (its plain version on the CPU, what
the CUDA kernel ``csrc/hadamard.cu`` is held against on the card) against
``repro.kernels.hadamard.ops.practical_rht`` with the Pallas kernel forced
(interpret mode), over the reference kernel test's power-of-2 sweep
(tests/test_kernels.py:49) and non-power-of-2 d, where Alg. 5 transforms
the overlap twice; and the CUDA kernel's own decomposition
(``ref.rotate_walk`` under ``ops.rotate_plan``: register, lane and warp
stages, the transpose, the overlap through the row buffer, the padded rows
and row sums) at every block width from 2 to 16384 and at the pipeline's
kept widths, and the plan's coverage of every projection width of the
reference's registry.  Tolerance atol 2e-4, the reference kernel test's
own.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hadamard import ops as jhops  # noqa: E402
from repro_torch.kernels.hadamard import ops as hops  # noqa: E402
from repro_torch.kernels.hadamard import ref as href  # noqa: E402

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


# --- the CUDA kernel's decomposition (ref.rotate_walk) under its launch plan

# 8191: the widest row of plan (256, 16), whose shared memory on the card
# passes the 48 KB that a launch takes without opting in
PLAN_DIMS = ([1 << k for k in range(1, 15)]
             + [300, 4083, 8191, 10974, 14336, 20480])


def _registry_widths():
    """Input width of every projection of every reference config (full and
    tiny), and the width kept after the default 0.3% outlier split."""
    from repro.configs import ARCH_IDS, get_config, get_tiny
    widths = set()
    for arch in ARCH_IDS + ("llama2-7b",):
        for cfg in (get_config(arch), get_tiny(arch)):
            hd = cfg.head_dim or cfg.d_model // cfg.n_heads
            ws = [cfg.d_model, cfg.d_ff, cfg.n_heads * hd]
            if cfg.moe is not None:
                ws.append(cfg.moe.d_ff_expert)
            if cfg.mla is not None:
                ws += [cfg.mla.q_lora, cfg.mla.kv_lora,
                       cfg.mla.n_heads * cfg.mla.v_head]
            if cfg.rglru_width:
                ws.append(cfg.rglru_width)
            widths.update(ws)
            widths.update(w - int(np.ceil(0.003 * w)) for w in ws)
    return sorted(widths)


@pytest.mark.parametrize("d", PLAN_DIMS)
def test_rotate_walk_matches_pallas_interpret(pallas_path, d):
    """The kernel's stages (slot butterflies, lane shuffles, transpose, warp
    butterflies, Alg. 5's overlap through the row buffer) under the plan the
    wrappers launch, against the reference within atol 2e-4; rows padded
    with exact zeros, and the row sum within the same limit of the f64 sum
    of the rotated row."""
    n = 1 + d % 3
    x, s1, s2 = _inputs(n, d)
    want = np.asarray(jhops.practical_rht(
        jnp.asarray(x), jnp.asarray(s1), None if s2 is None
        else jnp.asarray(s2)))
    threads, per_thread = hops.rotate_plan(d)
    out_ld = -(-d // 64) * 64 + 64
    got, rowsum = href.rotate_walk(
        torch.from_numpy(x), torch.from_numpy(s1),
        None if s2 is None else torch.from_numpy(s2), threads, per_thread,
        out_ld=out_ld)
    got = got.numpy()
    np.testing.assert_allclose(got[:, :d], want, atol=2e-4)
    assert (got[:, d:] == 0).all()
    np.testing.assert_allclose(rowsum.numpy(),
                               got[:, :d].astype(np.float64).sum(axis=1),
                               atol=2e-4)


def test_rotate_plan_takes_every_registry_width_and_refuses_the_rest():
    for d in _registry_widths():
        threads, per_thread = hops.rotate_plan(d)
        d_hat = 1 << (d.bit_length() - 1)
        assert threads * per_thread == max(d_hat, 32), d
        assert 32 <= threads <= hops.MAX_THREADS and per_thread <= 32, d
        assert per_thread >= threads // 32, d    # warp bits fit registers
    assert max(_registry_widths()) == 20480
    assert hops.rotate_plan(32767) == (512, 32)
    for d in (0, 32768, 65536):
        with pytest.raises(ValueError):
            hops.rotate_plan(d)
