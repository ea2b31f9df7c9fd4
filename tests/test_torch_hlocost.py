"""The port's op-level cost counter (``repro_torch/launch/hlocost.py``)
against the reference's loop-aware HLO cost (``repro/launch/
hlocost.analyze_hlo``).

The reference's programs of ``tests/test_hlocost.py`` (one matmul, k in
{1, 3, 9} trips, the gradient of a loop, nested loops, bytes that grow
with trips): the port's ``flops`` equal ``analyze_hlo``'s on the jitted
JAX program within 1e-6.  Every registry config's tiny decode step
(``runtime/steps.make_serve_step``, B 2, context 64) counts exactly the
reference's flops; the prefill step too for llama2, Mixtral,
recurrentgemma and deepseek-v2.  deepseek-v2's prefill once counted
+655,360 flops: MLA's prefill projected ``wkv_a`` twice (``mla_full``
and again for the cache), which XLA merges in the reference and an eager
step runs twice; the port now projects once (``mla_full(
return_latent=True)``), and the count of ``wkv_a`` GEMMs is pinned.

Every kernel wrapper credits the same work on plain CPU tensors as on fake
ones, equal to its ``cost(...)``, and hides the ops beneath; a real
tensor never takes the shape-only path.  A dry-run TP group's gather
reports its bytes.  ``repro.launch.dryrun`` is not imported: it sets
``XLA_FLAGS`` to 512 host devices at import.
"""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch.hlocost import analyze_hlo  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_tiny  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.qlinear import draw_signs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.hadamard import ops as hops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.qmatmul import ops as qops  # noqa: E402
from repro_torch.kernels.rabitq_quant import ops as rq_ops  # noqa: E402
from repro_torch.launch import hlocost  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime import tp  # noqa: E402

B, CTX, PROMPT = 2, 64, 32


def _ref(fn, *args) -> dict:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def _port(fn, *args, **kw) -> dict:
    return hlocost.analyze(fn, *args, **kw)


# ------------------------------------------------- the reference's programs


def test_single_matmul_exact():
    r = _ref(lambda x: x @ x, jnp.ones((128, 128)))
    p = _port(lambda x: x @ x, torch.ones(128, 128))
    assert abs(p["flops"] - r["flops"]) <= 1e-6 * r["flops"]
    assert p["flops"] == 2 * 128 ** 3 and p["unknown_trip_whiles"] == 0


@pytest.mark.parametrize("k", [1, 3, 9])
def test_loop_trip_counts(k):
    r = _ref(lambda x: jax.lax.scan(lambda c, _: (c @ c, None), x, None,
                                    length=k)[0], jnp.ones((64, 64)))

    def loop(x):
        for _ in range(k):
            x = x @ x
        return x
    p = _port(loop, torch.ones(64, 64))
    assert abs(p["flops"] - r["flops"]) <= 1e-6 * r["flops"]


def test_grad_of_loop():
    def jloss(x):
        y, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ c), None), x, None,
                            length=5)
        return jnp.sum(y)
    r = _ref(jax.grad(jloss), jnp.ones((64, 64)))

    def grad(x):
        x = x.clone().requires_grad_(True)
        y = x
        for _ in range(5):
            y = torch.tanh(y @ y)
        return torch.autograd.grad(y.sum(), x)[0]
    p = _port(grad, torch.ones(64, 64))
    assert abs(p["flops"] - r["flops"]) <= 1e-6 * r["flops"]
    assert p["flops"] == 2 * 64 ** 3 * 5 * 3


def test_nested_loops_multiply():
    def jnested(x):
        def outer(c, _):
            return jax.lax.scan(lambda d, _: (d @ d, None), c, None,
                                length=3)[0], None
        return jax.lax.scan(outer, x, None, length=4)[0]
    r = _ref(jnested, jnp.ones((32, 32)))

    def nested(x):
        for _ in range(4):
            for _ in range(3):
                x = x @ x
        return x
    p = _port(nested, torch.ones(32, 32))
    assert abs(p["flops"] - r["flops"]) <= 1e-6 * r["flops"]


def test_bytes_scale_with_trips():
    def loop(k):
        def f(x):
            for _ in range(k):
                x = x @ x
            return x
        return f
    r1 = _port(loop(2), torch.ones(64, 64))
    r2 = _port(loop(8), torch.ones(64, 64))
    assert r2["bytes"] > 3 * r1["bytes"]
    # each matmul reads its two operands and writes its result
    assert r2["bytes"] == 8 * 3 * 64 * 64 * 4


def test_views_count_nothing_and_gathers_their_rows():
    x = torch.ones(64, 32)
    assert _port(lambda x: x.t()[:10].unsqueeze(0).expand(3, 10, 64)
                 .transpose(1, 2), x)["bytes"] == 0
    # reshaping a transposed tensor copies it: read and written once
    assert _port(lambda x: x.t().reshape(-1), x)["bytes"] == 2 * 64 * 32 * 4
    idx = torch.tensor([0, 3, 5])
    p = _port(lambda x: x.index_select(0, idx), x)
    assert p["bytes"] == 2 * 3 * 32 * 4 + 3 * 8
    dst = torch.zeros(64, 32)
    p = _port(lambda d: d.index_copy_(0, idx, torch.ones(3, 32)), dst)
    assert p["bytes"] == 3 * 32 * 4 + 2 * 3 * 32 * 4 + 3 * 8   # ones + write


def test_device_dependent_scratch_is_not_counted():
    """log_sigmoid's second output is the input's size on the CPU and
    empty on CUDA: only its result counts, so the device does not move
    the bytes (recurrentgemma's RG-LRU gates)."""
    x = torch.ones(4, 2560)
    p = _port(torch.nn.functional.logsigmoid, x)
    assert p["bytes"] == 2 * 4 * 2560 * 4
    assert p["memory"]["temp_peak"] == 4 * 2560 * 4


def test_memory_tracker_by_hand():
    """Two live (64, 64) f32 results at once, then one freed: the peak is
    two results, not three."""
    def prog(x):
        y = x @ x                   # 16 KiB
        z = y + 1                   # 16 KiB, y still live
        del y
        return z * 2                # z freed after, the result live
    p = _port(prog, torch.ones(64, 64))
    assert p["memory"]["temp_peak"] == 2 * 64 * 64 * 4


# ------------------------------------------------------------ model steps


def _ref_setup(arch):
    """The reference's tiny params (and Whisper's encoder output) as
    shapes only: the programs are lowered from them, never run."""
    cfg = jreg.get_tiny(arch)
    params = jax.eval_shape(lambda: jtf.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    enc = (jax.ShapeDtypeStruct((B, cfg.n_audio_ctx, cfg.d_model),
                                jnp.float32) if cfg.enc_dec else None)
    return cfg, params, enc


def _port_setup(arch):
    cfg = get_tiny(arch)
    return cfg, ttf.init_params(cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_flops_equal_the_reference(arch):
    jcfg, jparams, enc = _ref_setup(arch)
    caches = jax.eval_shape(
        lambda p, e: jdec.init_caches(jcfg, p, B, CTX, jnp.float32,
                                      encoder_out=e), jparams, enc)
    r = _ref(jsteps.make_serve_step(jcfg), jparams, caches,
             jnp.zeros((B, 1), jnp.int32), jnp.int32(5))
    cfg, params = _port_setup(arch)
    tcaches = tdec.init_caches(cfg, B, CTX, torch.float32, "cpu")
    if cfg.enc_dec:
        for c in tcaches:
            for key in ("xk", "xv"):
                c[key] = torch.zeros(B, cfg.n_audio_ctx, cfg.n_kv, cfg.hd)
    with torch.no_grad():
        p = _port(tsteps.make_serve_step(cfg), params, tcaches,
                  torch.zeros(B, 1, dtype=torch.int32), 5)
    assert p["flops"] == r["flops"], (p["flops"], r["flops"])
    assert p["coll_bytes"] == 0 and p["kernel_credits"] == {}


PREFILL_ARCHS = ("llama2-7b", "mixtral-8x7b", "recurrentgemma-2b",
                 "deepseek-v2-236b")


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_step_flops_equal_the_reference(arch):
    jcfg, jparams, _ = _ref_setup(arch)
    r = _ref(jsteps.make_prefill_step(jcfg, context=CTX,
                                      cache_dtype=jnp.float32), jparams,
             {"tokens": jnp.zeros((B, PROMPT), jnp.int32)})
    cfg, params = _port_setup(arch)
    step = tsteps.make_prefill_step(cfg, context=CTX,
                                    cache_dtype=torch.float32)
    with torch.no_grad():
        p = _port(step, params, {"tokens": torch.zeros(B, PROMPT,
                                                       dtype=torch.int32)},
                  trace=True)
    assert p["flops"] == r["flops"], (p["flops"], r["flops"])
    if arch == "deepseek-v2-236b":
        # one wkv_a projection a layer: (B*S, d) @ (d, kv_lora + qk_rope)
        m = cfg.mla
        wkv_a = [e for e in p["ops"]["ops"] if e.get("op") == "aten.mm.default"
                 and e["args"][1]["shape"] == [cfg.d_model,
                                               m.kv_lora + m.qk_rope]]
        assert sum(e["count"] for e in wkv_a) == cfg.n_layers
        assert 2 * B * PROMPT * cfg.d_model * (m.kv_lora + m.qk_rope) \
            * cfg.n_layers == 655360      # what a second projection added


# ------------------------------------------------------------------ kernels


def _gemm_args(n=3, d=40, c=32, bits=4, e=None):
    g = torch.Generator().manual_seed(0)
    lead = () if e is None else (e,)
    packed = torch.randint(0, 256, (*lead, packing.packed_rows(d, bits), c),
                           generator=g, dtype=torch.int32).to(torch.uint8)
    rescale = (torch.rand((*lead, c), generator=g) * 0.1).to(torch.float16)
    s1, s2 = draw_signs(d, g)
    x = torch.randn((*lead, n, d), generator=g)
    return x, packed, rescale, s1, s2


def _attn_args():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 64, generator=g)
    ka, va = (torch.randn(5, 16, 2, 64, generator=g) for _ in range(2))
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([20, 9], dtype=torch.int32)
    ring = torch.tensor([32, 32], dtype=torch.int32)
    return q, ka, va, bt, pos, ring


def _calls():
    """(kernels credited, the call, its args, the plain twin's output)."""
    x, packed, rescale, s1, s2 = _gemm_args()
    xg, pg, rg, s1g, s2g = _gemm_args(e=2)
    w = torch.randn(40, 32, generator=torch.Generator().manual_seed(1))
    q, k, v = (torch.randn(1, 8, h, 64) for h in (4, 2, 2))
    att = _attn_args()
    return [
        ({"rht_qmatmul": dict(n=3, d=40, c=32, bits=4)},
         lambda *a: qops.rht_quantized_matmul(*a, bits=4, d=40),
         (x, packed, rescale, s1, s2)),
        ({"qmatmul": dict(n=3, d=40, c=32, bits=4)},
         lambda *a: qops.quantized_matmul(*a, bits=4, d=40),
         (x, packed, rescale)),
        ({"rht": dict(n=3, d=40)}, hops.practical_rht, (x, s1, s2)),
        ({"grouped_rht_qmatmul": dict(n=3, d=40, c=32, bits=4, groups=2)},
         lambda *a: qops.grouped_rht_quantized_matmul(*a, bits=4, d=40),
         (xg, pg, rg, s1g, s2g)),
        ({"grouped_qmatmul": dict(n=3, d=40, c=32, bits=4, groups=2)},
         lambda *a: qops.grouped_quantized_matmul(*a, bits=4, d=40),
         (xg, pg, rg)),
        ({"rabitq_quant": dict(d=40, c=32, n_cand=12)},
         lambda w: rq_ops.quantize(w, 4).codes, (w,)),
        ({"flash_attention": dict(b=1, sq=8, sk=8, h=4, kv=2, hd=64,
                                  causal=True, window=None, elem_bytes=4)},
         fops.attention, (q, k, v)),
        ({"paged_attention": dict(b=2, w=1, h=4, kv=2, hd=64, keys=64,
                                  elem_bytes=4, table=4)},
         pops.paged_attention, att),
    ]


def _credits(fn, args, fake: bool):
    if fake:
        with FakeTensorMode(allow_non_fake_inputs=True) as m:
            args = [m.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            res = hlocost.analyze(fn, *args)
    else:
        res = hlocost.analyze(fn, *args)
    return res


@pytest.mark.parametrize("case", range(8))
def test_wrapper_credits_its_cost_plain_and_fake(case):
    want, fn, args = _calls()[case]
    plain = _credits(fn, args, fake=False)
    fake = _credits(fn, args, fake=True)
    for res in (plain, fake):
        got = res["kernel_credits"]
        assert set(got) == set(want)
        for k, shape in want.items():
            c = kernels.kernel_cost(k, **shape)
            assert got[k] == {"calls": 1, "flops": c["flops"],
                              "bytes": c["bytes"]}
        # the ops beneath are hidden: the credit is all that is counted
        assert res["flops"] == sum(v["flops"] for v in got.values())
        assert res["bytes"] == sum(v["bytes"] for v in got.values())
    # a real tensor ran the plain version: a result with values
    out = plain["result"]
    assert not kernels.is_fake(out) and bool(out.ne(0).any())
    assert kernels.is_fake(fake["result"])
    assert fake["result"].shape == out.shape
    assert fake["result"].dtype == out.dtype


def test_unfused_path_credits_the_rotation_and_the_gemm():
    x, packed, rescale, s1, s2 = _gemm_args()
    with qops.fusion(False):
        res = _credits(lambda *a: qops.rht_quantized_matmul(*a, bits=4, d=40),
                       (x, packed, rescale, s1, s2), fake=True)
    assert set(res["kernel_credits"]) == {"rht", "qmatmul"}


def test_shape_only_path_keeps_the_kernel_checks():
    x, packed, rescale, s1, s2 = _gemm_args(c=40)
    with pytest.raises(ValueError, match="multiple of 16"):
        _credits(lambda *a: qops.rht_quantized_matmul(*a, bits=4, d=40),
                 (x, packed, rescale, s1, s2), fake=True)
    q, ka, va, bt, pos, ring = _attn_args()
    q, ka, va = q[..., :48], ka[..., :48], va[..., :48]
    with pytest.raises(ValueError, match="head_dim 48"):
        _credits(pops.paged_attention, (q, ka, va, bt, pos, ring), fake=True)


def test_dryrun_group_gather_reports_its_bytes():
    group = tp.dryrun_group(4, "cpu")
    with FakeTensorMode():
        y = torch.empty(2, 1, 8)
        h = torch.empty(2, 1, 3, 16)
        with tp.scope(group), hlocost.CostCounter() as cc:
            out = tp.gather_cols(y, 32)
            heads = tp.gather_heads(h, 12)
    assert tuple(out.shape) == (2, 1, 32) and tuple(heads.shape) == (
        2, 1, 12, 16)
    want = 2 * 32 * 4 + 2 * 12 * 16 * 4
    assert cc.coll_bytes == want
    assert cc.coll_by_kind == {"all-gather": want}
    with tp.scope(group), pytest.raises(RuntimeError, match="fake"):
        tp.gather_cols(torch.ones(2, 8), 32)


def test_fake_step_counts_what_the_real_step_does():
    """RWKV6's prefill runs its chunk loop once for all trips on fake
    inputs (``kernels.repeated``); counted, it equals the real run's
    four chunks."""
    cfg, params = _port_setup("rwkv6-3b")
    step = tsteps.make_prefill_step(cfg, context=CTX,
                                    cache_dtype=torch.float32)
    tokens = torch.zeros(B, 64, dtype=torch.int32)
    with torch.no_grad():
        real = _port(step, params, {"tokens": tokens})
        with FakeTensorMode(allow_non_fake_inputs=True) as m:
            fake = _port(step, params, {"tokens": m.from_tensor(tokens)})
    assert (fake["flops"], fake["bytes"]) == (real["flops"], real["bytes"])
