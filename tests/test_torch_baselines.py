"""Port parity, the paper's baselines and the uniform-bit quantizer against
the JAX reference on the host: RTN, AWQ and GPTQ per weight
(``repro_torch.baselines`` against ``repro.baselines``, bit for bit: the
port follows numpy 2's dtypes, and on the host GPTQ factors with the
reference's own numpy), ``LinearCtx(collect_hessian=True)`` through
``collect_hessians`` on tiny llama2 (Hessians rtol 1e-4 and column norms
rtol 1e-5: f32 products summed in another order), ``apply_baseline``
(the reference's reconstructions bit for bit from its own Hessians and
norms, the same average bits, losses within 1e-4), the layers the
baselines leave alone on tiny mixtral and tiny whisper, and
``quantize_params_uniform`` on tiny mixtral and tiny whisper with the
reference's signs (codes within one step at round-half ties, as
``test_torch_core.py::test_rabitq_quantize_matches_reference`` allows;
the loss within ``test_torch_pipeline.LOGIT_TOL``), which also carries the
reference's stacked quantized tree across the bridge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import tiny  # noqa: E402
from test_torch_engine import to_numpy_tree  # noqa: E402
from test_torch_families import jax_init  # noqa: E402
from test_torch_families import one_torch_thread  # noqa: E402,F401 autouse
from test_torch_pipeline import LOGIT_TOL  # noqa: E402
from test_torch_whisper import frames  # noqa: E402

from repro.baselines import apply as japply  # noqa: E402
from repro.baselines import quant_baselines as jqb  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.baselines import apply as tapply  # noqa: E402
from repro_torch.baselines import quant_baselines as tqb  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.qlinear import QuantizedGrouped, QuantizedLinear  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.common import LinearCtx, linear  # noqa: E402

SHAPES = [(256, 64), (300, 40)]     # (300, 40): a last group of 44 rows
BITS = [2, 3, 4, 8]
GROUP = 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _weight(d, c, seed):
    return np.random.default_rng(seed).normal(size=(d, c)).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d,c", SHAPES)
def test_rtn_matches_reference(d, c, bits):
    w = _weight(d, c, bits)
    want, want_bits = jqb.rtn_quantize(w, bits, GROUP)
    got, got_bits = tqb.rtn_quantize(_t(w), bits, GROUP, device="cpu")
    assert got.dtype == torch.float32 and got_bits == want_bits
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d,c", SHAPES)
def test_awq_matches_reference(d, c, bits):
    """Column norms with a few salient inputs, so that alpha > 0 wins; the
    grid, the division by the scales and the error are f64 in both."""
    rng = np.random.default_rng(100 + bits)
    w = _weight(d, c, bits)
    norms = rng.uniform(0.2, 2.0, size=d).astype(np.float32)
    norms[rng.choice(d, 4, replace=False)] *= 40.0
    want, want_bits, want_alpha = jqb.awq_quantize(w, norms, bits, GROUP)
    got, got_bits, got_alpha = tqb.awq_quantize(_t(w), _t(norms), bits,
                                                GROUP, device="cpu")
    assert (got_bits, got_alpha) == (want_bits, want_alpha)
    assert got_alpha > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_awq_at_unit_norms_keeps_the_first_alpha():
    """Every alpha scales by 1: the errors tie and the strict ``<`` keeps
    alpha 0, whose f64 grid is still not RTN's f32 one."""
    w = _weight(300, 40, 7)
    want, _, want_alpha = jqb.awq_quantize(w, np.ones(300), 3, GROUP)
    got, _, got_alpha = tqb.awq_quantize(_t(w), torch.ones(300), 3, GROUP,
                                         device="cpu")
    assert got_alpha == want_alpha == 0.0
    np.testing.assert_array_equal(got.numpy(), want)


def _correlated_hessian(d, seed, dead=5):
    """X^T X (f32) of correlated inputs, input ``dead`` never active."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(512, 8)) @ rng.normal(size=(8, d))
         + 0.1 * rng.normal(size=(512, d)))
    x[:, dead] = 0.0
    return (x.T @ x).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d,c", [(128, 32), (300, 40)])
def test_gptq_matches_reference(d, c, bits):
    """Bit for bit, dead input included: its row zeroed and its diagonal
    set to 1 before damping."""
    h = _correlated_hessian(d, d + bits)
    assert h[5, 5] == 0
    w = _weight(d, c, d + bits)
    want, want_bits = jqb.gptq_quantize(w, h, bits, GROUP)
    got, got_bits = tqb.gptq_quantize(_t(w), _t(h), bits, GROUP,
                                      device="cpu")
    assert got_bits == want_bits
    np.testing.assert_array_equal(got.numpy(), want)


def test_gptq_factor_and_row_loop():
    """The factor is upper triangular, marks the dead input and inverts the
    damped Hessian (dead diagonal set to 1); the row loop given it is
    ``gptq_quantize``, codes included."""
    d, c, bits = 300, 40, 3
    h = _t(_correlated_hessian(d, 11))
    u_host, dead_host = tqb._gptq_factor_host(h, 0.01)
    assert dead_host.nonzero().flatten().tolist() == [5]
    assert torch.equal(u_host, torch.triu(u_host))
    hd = h.double()
    hd[5, 5] = 1.0
    hd += 0.01 * torch.diagonal(hd).mean() * torch.eye(d, dtype=hd.dtype)
    np.testing.assert_allclose((hd @ u_host.T @ u_host).numpy(), np.eye(d),
                               atol=1e-8)
    w = _t(_weight(d, c, 11))
    want, _ = tqb.gptq_quantize(w, h, bits, GROUP, device="cpu")
    w0 = w.clone()
    w0[dead_host] = 0.0
    codes = torch.zeros((d, c), dtype=torch.uint8)
    got = tqb._gptq_rows(w0, u_host, bits, GROUP, codes=codes)
    assert torch.equal(got, want)
    assert int(codes.max()) <= (1 << bits) - 1 and codes.float().std() > 0


def test_linear_ctx_sums_hessians_and_keeps_the_last_taps():
    """Hessians add up over calls; ``collect``'s taps are overwritten by
    each call (the reference's semantics, which AWQ's norms inherit)."""
    w = torch.randn(6, 3)
    xs = [torch.randn(2, 4, 6), torch.randn(1, 5, 6)]
    ctx = LinearCtx(collect_hessian=True, collect=True)
    for x in xs:
        linear(w, x, ctx, "a")
    rows = [x.reshape(-1, 6) for x in xs]
    torch.testing.assert_close(ctx.hessians["a"],
                               sum(r.T @ r for r in rows), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(ctx.taps["a"]["x_col_sq"],
                               (rows[-1] ** 2).sum(0))
    assert ctx.hessians["a"].dtype == torch.float32


@pytest.fixture(scope="module")
def llama():
    """Tiny llama2 in both packages, two calibration batches, and the
    reference's Hessians, norms and 4-bit baselines (with the loss of each
    on an evaluation batch)."""
    cfg = tiny("llama2-7b")
    jparams = jax_init(cfg, 0)
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
               for _ in range(3)]
    calib, evals = batches[:2], batches[2]
    jhess, jnorms = japply.collect_hessians(
        cfg, jparams, [{"tokens": jnp.asarray(b)} for b in calib])
    jloss = jax.jit(lambda p, b: jtf.loss_fn(cfg, p, b, scan=False))
    ref = {}
    for method in ("rtn", "gptq", "awq"):
        jq, bits, _ = japply.apply_baseline(cfg, jparams, method, 4,
                                            hessians=jhess,
                                            x_col_norms=jnorms)
        ref[method] = (jq, bits,
                       float(jloss(jq, {"tokens": jnp.asarray(evals)})))
    return dict(cfg=get_tiny("llama2-7b"), tparams=tparams, calib=calib,
                evals=evals, jhess=jhess, jnorms=jnorms, ref=ref)


def test_collect_hessians_matches_reference(llama):
    hess, norms = tapply.collect_hessians(
        llama["cfg"], llama["tparams"],
        [{"tokens": torch.from_numpy(b)} for b in llama["calib"]],
        device="cpu")
    assert set(hess) == set(llama["jhess"]) and set(norms) == set(
        llama["jnorms"])
    assert "L0.attn.wq" in hess and "lm_head" in hess
    for name, want in llama["jhess"].items():
        assert hess[name].dtype == torch.float32
        np.testing.assert_allclose(hess[name].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        np.testing.assert_allclose(norms[name].numpy(), llama["jnorms"][name],
                                   rtol=1e-5, err_msg=name)
    # the Hessian sums both batches; the norms are the last batch's
    x_col_last = norms["L0.attn.wq"] ** 2
    assert float(torch.diagonal(hess["L0.attn.wq"]).sum()) > 1.5 * float(
        x_col_last.sum())


@pytest.mark.parametrize("method", ["rtn", "gptq", "awq"])
def test_apply_baseline_matches_reference(llama, method):
    jq, want_bits, want_loss = llama["ref"][method]
    tparams = llama["tparams"]
    before = {k: v for k, v in tparams["layers"][0]["attn"].items()}
    out, bits, secs = tapply.apply_baseline(
        llama["cfg"], tparams, method, 4,
        hessians={k: _t(v) for k, v in llama["jhess"].items()},
        x_col_norms={k: _t(v) for k, v in llama["jnorms"].items()},
        device="cpu")
    assert bits == want_bits and secs >= 0
    assert tparams["layers"][0]["attn"] == before      # not mutated
    n = 0
    for i, lp in enumerate(out["layers"]):
        for path, kind in tpipe._walk_layer(tparams["layers"][i]):
            got = tpipe._get(lp, path)
            want = np.asarray(tpipe._get(jq["layers"][0][i], path))
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"L{i}.{path}")
            n += 1
    assert n == 6 * len(out["layers"])
    assert out["lm_head"] is tparams["lm_head"]
    loss = float(ttf.loss_fn(llama["cfg"], out,
                             {"tokens": torch.from_numpy(llama["evals"])}))
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)


@pytest.fixture(scope="module", params=["mixtral-8x7b", "whisper-large-v3"])
def model(request):
    """(reference cfg, port cfg, reference params, port params, a batch as
    numpy) for tiny mixtral (MoE capacity as the reference's) and tiny
    whisper (seeded frames for the audio stub)."""
    cfg = tiny(request.param)
    tcfg = get_tiny(request.param)
    if tcfg.moe is not None:
        tcfg = tcfg.with_(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cfg.moe.capacity_factor))
    jparams = jax_init(cfg, 2)
    tparams = bridge.params_from_reference(to_numpy_tree(jparams), "cpu")
    batch = {"tokens": np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32)}
    if cfg.enc_dec:
        batch["enc_embeds"] = frames(2, cfg, seed=2)
    return cfg, tcfg, jparams, tparams, batch


def _replaced(before: dict, after: dict, prefix=()):
    """Paths of the leaves of ``after`` that are not ``before``'s."""
    out = set()
    for k, v in after.items():
        if isinstance(v, dict):
            out |= _replaced(before[k], v, prefix + (k,))
        elif v is not before[k]:
            out.add(".".join(prefix + (k,)))
    return out


def _changed(before: dict, after: dict, prefix=()):
    """Paths of the reference's leaves whose values ``after`` changed."""
    out = set()
    for k, v in after.items():
        if isinstance(v, dict):
            out |= _changed(before[k], v, prefix + (k,))
        elif not np.array_equal(np.asarray(v), np.asarray(before[k])):
            out.add(".".join(prefix + (k,)))
    return out


def test_baselines_leave_experts_and_encoder(model):
    """RTN replaces exactly the weights the reference's replaces (by name),
    bit for bit, and shares every other leaf: MoE expert stacks and
    routers, the encoder, embeddings, norms, lm_head; every name it
    replaces has a Hessian from ``collect_hessians``."""
    cfg, tcfg, jparams, tparams, batch = model
    jq, want_bits, _ = japply.apply_baseline(cfg, jparams, "rtn", 3)
    out, bits, _ = tapply.apply_baseline(tcfg, tparams, "rtn", 3,
                                         device="cpu")
    assert bits == want_bits
    names, want = set(), set()
    for i, (a, b) in enumerate(zip(tparams["layers"], out["layers"])):
        jin = jax.tree.map(lambda x, i=i: x[i], jparams["layers"][0])
        want |= {f"L{i}.{p}" for p in _changed(jin, jq["layers"][0][i])}
        for path in _replaced(a, b):
            names.add(f"L{i}.{path}")
            np.testing.assert_array_equal(
                tpipe._get(b, path.split(".")).numpy(),
                np.asarray(tpipe._get(jq["layers"][0][i], path.split("."))))
    assert names == want
    hess, _ = tapply.collect_hessians(
        tcfg, tparams, [{k: torch.from_numpy(v) for k, v in batch.items()}],
        device="cpu")
    assert names <= set(hess)
    assert not any(".moe.wi" in n or ".moe.wo" in n or n.startswith("enc")
                   for n in names)
    for k in out:
        if k != "layers":
            assert out[k] is tparams[k], k        # encoder, embed, lm_head
    if cfg.moe is not None:
        assert all(b["moe"]["wi"] is a["moe"]["wi"]
                   and b["moe"]["router"] is a["moe"]["router"]
                   for a, b in zip(tparams["layers"], out["layers"]))


def _codes(q):
    if isinstance(q, QuantizedGrouped):
        return np.stack([tpacking.unpack_codes(p, q.bits, q.d).numpy()
                         for p in q.packed]).astype(int)
    return tpacking.unpack_codes(q.packed, q.bits, q.d_keep).numpy().astype(
        int)


def test_quantize_params_uniform_matches_reference(model):
    """The reference's uniform tree (stacked quantized leaves) carried
    across the bridge gives the reference's loss; the port's own uniform
    quantization with the reference's signs covers the same weights
    (decoder, MoE stacks, Whisper's encoder) with the same codes but at
    round-half ties, and a loss within LOGIT_TOL."""
    cfg, tcfg, jparams, tparams, batch = model
    bits = 3
    # the reference's function compiled once instead of op by op (it has
    # no data-dependent control flow: the dry-run traces it)
    jq = jax.jit(lambda p, k: jpipe.quantize_params_uniform(cfg, p, bits, k))(
        jparams, jax.random.PRNGKey(5))
    jtree = to_numpy_tree(jq)
    signs = bridge.reference_signs(jtree)
    names = {e[0] for e in tpipe._entries(tparams)}
    assert set(signs) == names
    if cfg.enc_dec:
        assert any(n.startswith("enc") for n in names)
    carried = bridge.params_from_reference(jtree, "cpu")
    tq = tpipe.quantize_params_uniform(tcfg, tparams, bits, signs=signs,
                                       device="cpu")
    diffs = total = 0
    for name, key, i, path, kind, _ in tpipe._entries(tparams):
        want_q = tpipe._get(carried[key][i], path)
        got_q = tpipe._get(tq[key][i], path)
        cls = QuantizedGrouped if kind == "grouped" else QuantizedLinear
        assert isinstance(got_q, cls) and isinstance(want_q, cls), name
        assert (got_q.bits, got_q.d, got_q.c) == (bits, want_q.d, want_q.c)
        assert torch.equal(got_q.signs1, want_q.signs1), name
        diff = _codes(got_q) - _codes(want_q)
        assert np.abs(diff).max() <= 1, name
        diffs += int((diff != 0).sum())
        total += diff.size
        np.testing.assert_allclose(
            got_q.rescale.numpy().astype(np.float32),
            want_q.rescale.numpy().astype(np.float32), rtol=5e-3, atol=1e-5,
            err_msg=name)
    assert diffs / total < 5e-3
    assert tq["embed"] is tparams["embed"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = float(jax.jit(lambda p, b: jtf.loss_fn(cfg, p, b))(jq, jb))
    assert abs(float(ttf.loss_fn(tcfg, carried, tb)) - want) <= 1e-4 * abs(
        want)
    assert abs(float(ttf.loss_fn(tcfg, tq, tb)) - want) <= LOGIT_TOL * abs(
        want)


def test_entry_points_refuse_host_without_card(monkeypatch, llama):
    cfg, tparams = llama["cfg"], llama["tparams"]
    w = torch.randn(128, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tqb.rtn_quantize(w, 4),
                 lambda: tqb.gptq_quantize(w, torch.eye(128), 4),
                 lambda: tqb.awq_quantize(w, torch.ones(128), 4),
                 lambda: tapply.collect_hessians(
                     cfg, tparams, [{"tokens": torch.zeros(1, 9,
                                                           dtype=torch.int32)}]),
                 lambda: tapply.apply_baseline(cfg, tparams, "rtn", 4),
                 lambda: tpipe.quantize_params_uniform(cfg, tparams, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
