"""The port's training step and driver against the JAX reference on the
host: ``repro_torch.runtime.steps.make_train_step`` against
``repro.runtime.steps.make_train_step`` (jitted), from the same params
(the reference's init carried across by ``repro_torch.bridge``) on the same
numpy batches of the synthetic corpus, for tiny llama2 (cut to 2 layers)
and tiny Mixtral (MoE top-2 at the no-drop capacity, aux loss included);
then ``launch/train.train`` against the reference's ``train`` and the CLI.

Tolerances (each with the largest error measured on a CPU):
  * step 0: loss within rtol 1e-5; gradients within 1e-4 of each leaf's
    largest |gradient| and the grad norm within rtol 1e-4 (the repo's
    per-op f32 tolerance);
  * five steps (lr 1e-2, warmup 2, the clip active at every step): each
    step's loss within rtol 1e-5 (measured at most 1.2e-6), grad norm
    within rtol 1e-4 (measured 2.1e-5), lr within 1e-6; params and
    moments after five steps within 1e-3 of each leaf's largest |value|
    (measured 4.0e-4: AdamW's normalised update turns round-off in a
    near-zero gradient into a step of order lr, so an element's error is
    bounded by its leaf's scale, not its own);
  * with int8 compression the same, except that a gradient whose scaled
    value lies within round-off of a rounding boundary takes the other
    code, and AdamW moves that element by up to lr: at most 0.5% of the
    elements (measured 0.13%) may miss the 1e-3 bound, and none may move
    by more than lr (measured 5.9e-3);
  * ``remat`` on and off: identical numbers, bit for bit.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import tiny  # noqa: E402
from test_torch_engine import _moe_cfgs  # noqa: E402

from repro.launch.train import train as jtrain  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw_init as jinit  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import bridge, tree  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.data import LMBatchLoader, make_corpus_tokens  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

LR, WARMUP, STEPS, BATCH, SEQ = 1e-2, 2, 5, 4, 16
LOSS0_RTOL, GRAD_TOL = 1e-5, 1e-4
LOSS_RTOL, GNORM_RTOL, TREE_TOL = 1e-5, 1e-4, 1e-3
INT8_OFF = 5e-3          # share of elements a code flip may move


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs: the tiny models gain nothing
    from more, and spinning threads slow the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(reference cfg, port cfg): llama2 cut to 2 layers, Mixtral at the
    no-drop capacity."""
    if arch == "mixtral-8x7b":
        return _moe_cfgs("nodrop")
    return tiny(arch).with_(n_layers=2), get_tiny(arch).with_(n_layers=2)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _to_port(jtree):
    """A reference tree in the params' layout (params, grads, moments) as
    the port's, on the host."""
    return bridge.params_from_reference(_np_tree(jtree), device="cpu")


def _close_by_leaf_scale(got, want_ref, tol, off_share=0.0, max_move=None):
    """Every leaf of the port tree ``got`` within ``tol`` x its largest
    |value| in the reference tree ``want_ref``, but for at most
    ``off_share`` of all elements, which must be within ``max_move``."""
    off = n = 0
    for a, b in zip(tree.leaves(got), tree.leaves(_to_port(want_ref))):
        a, b = a.detach().numpy(), b.numpy()
        err = np.abs(a - b)
        off += int((err > tol * np.abs(b).max()).sum())
        n += err.size
        if max_move is not None:
            assert err.max() <= max_move, err.max()
    assert off <= off_share * n, (off, n)


def _numpy_params(jcfg, seed: int = 0):
    """Params in the reference's layout, drawn with numpy: norms 1, biases
    0, the embedding N(0, 0.02^2), every matrix N(0, 1/d_in) -- the
    reference's init scheme, without its eager init's seconds."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))

    def draw(path, sds):
        name = str(getattr(path[-1], "key", ""))
        if name in ("scale", "q_norm", "k_norm"):
            return jnp.ones(sds.shape, sds.dtype)
        if name == "bias":
            return jnp.zeros(sds.shape, sds.dtype)
        std = 0.02 if name == "embed" else sds.shape[-2] ** -0.5
        return jnp.asarray((rng.standard_normal(sds.shape) * std
                            ).astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setups():
    """arch -> (reference cfg, port cfg, reference params, batches)."""
    out = {}
    for arch in ("llama2-7b", "mixtral-8x7b"):
        jcfg, tcfg = _cfgs(arch)
        params = _numpy_params(jcfg)
        loader = LMBatchLoader(make_corpus_tokens(jcfg.vocab, 600), BATCH, SEQ)
        out[arch] = (jcfg, tcfg, params,
                     [loader.next_batch() for _ in range(STEPS)])
    return out


@pytest.mark.parametrize("arch", ["llama2-7b", "mixtral-8x7b"])
def test_step0_loss_and_grads_match_reference(setups, arch):
    jcfg, tcfg, jparams, batches = setups[arch]
    b = batches[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jtf.loss_fn(jcfg, p, {"tokens": t})))(jparams, b)
    tparams = _to_port(jparams)
    loss, grads, treedef = tsteps._value_and_grad(
        tcfg, tparams, {"tokens": torch.from_numpy(b)}, remat=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS0_RTOL)
    _close_by_leaf_scale(tree.unflatten(treedef, grads), jgrads, GRAD_TOL)
    gn = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads])))
    jgn = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(jgrads))))
    np.testing.assert_allclose(gn, jgn, rtol=GRAD_TOL)
    # the caller's params are left as they were, not marked for grad
    assert not any(p.requires_grad for p in tree.leaves(tparams))


def _run_both(setups, arch, **kw):
    """STEPS train steps of the reference (jitted) and the port from the
    same params and batches -> (reference (params, opt, metrics), port's)."""
    jcfg, tcfg, jparams, batches = setups[arch]
    # the reference's remat changes no number and costs compile time
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, peak_lr=LR, warmup=WARMUP, total_steps=STEPS, remat=False,
        **kw))
    tstep = tsteps.make_train_step(tcfg, peak_lr=LR, warmup=WARMUP,
                                   total_steps=STEPS, **kw)
    jp, jo = jparams, jinit(jparams)
    tp = _to_port(jparams)
    to = adamw_init(tp)
    jm, tm = [], []
    for b in batches:
        jp, jo, m = jstep(jp, jo, {"tokens": jnp.asarray(b)})
        jm.append({k: float(v) for k, v in m.items()})
        tp, to, m = tstep(tp, to, {"tokens": torch.from_numpy(b)})
        tm.append({k: float(v) for k, v in m.items()})
    return (jp, jo, jm), (tp, to, tm)


@pytest.mark.parametrize("arch,kw", [
    ("llama2-7b", {}),
    ("llama2-7b", {"microbatches": 2}),
    ("llama2-7b", {"grad_compression": "int8"}),
    ("mixtral-8x7b", {"microbatches": 2, "grad_compression": "int8"}),
], ids=["llama2", "llama2-mb2", "llama2-int8", "mixtral-mb2-int8"])
def test_five_steps_track_reference(setups, arch, kw):
    (jp, jo, jm), (tp, to, tm) = _run_both(setups, arch, **kw)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=GNORM_RTOL)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
    assert tm[-1]["loss"] < tm[0]["loss"]
    assert int(to.step) == int(jo.step) == STEPS
    int8 = kw.get("grad_compression") == "int8"
    for got, want in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        _close_by_leaf_scale(got, want, TREE_TOL,
                             off_share=INT8_OFF if int8 else 0.0,
                             max_move=LR if int8 else None)


def test_remat_changes_no_number(setups):
    """Per-layer recomputation gives the same losses, grad norms and params
    as keeping the activations, bit for bit (Mixtral: the router and the
    capacity dispatch are recomputed too)."""
    jcfg, tcfg, jparams, batches = setups["mixtral-8x7b"]
    runs = []
    for remat in (False, True):
        step = tsteps.make_train_step(tcfg, peak_lr=LR, warmup=WARMUP,
                                      total_steps=STEPS, remat=remat,
                                      microbatches=2)
        p = _to_port(jparams)
        o = adamw_init(p)
        ms = []
        for b in batches[:2]:
            p, o, m = step(p, o, {"tokens": torch.from_numpy(b)})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((ms, tree.leaves((p, o))))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_train_driver_tracks_reference_train(tmp_path):
    """``train`` (loader, schedule, step, the fault-tolerant loop with a
    checkpoint) against the reference's ``train`` from the same params:
    the same losses within LOSS_RTOL, and a checkpoint on disk."""
    arch = "qwen3-0.6b"                 # 2 layers, qk-norm: the card's model
    jcfg = get_tiny(arch)
    jparams = _numpy_params(tiny(arch), seed=1)
    kw = dict(arch=arch, tiny=True, steps=4, batch=2, seq=16, lr=LR,
              warmup=WARMUP, log_every=10 ** 9)
    _, _, jl = jtrain(params=jparams, **kw)
    cfg, _, tl = ttrain.train(params=_to_port(jparams), device="cpu",
                              ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert cfg.name == jcfg.name and len(tl) == len(jl) == 4
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert sorted(int(f[5:15]) for f in os.listdir(tmp_path)) == [2, 4]


def test_train_cli_on_the_host(capsys):
    ttrain.main(["--device", "cpu", "--tiny", "--arch", "qwen3-0.6b",
                 "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"step +0 loss \d+\.\d{4} gnorm \d+\.\d{3} \d+ms",
                        out[0])
    assert re.fullmatch(r"trained qwen3-tiny: loss \d+\.\d{3} -> \d+\.\d{3} "
                        r"in \d+s", out[-1])


def test_train_needs_a_card_unless_asked_for_the_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--tiny", "--steps", "1"])


def test_train_refuses_params_on_another_device(setups):
    jcfg, tcfg, jparams, _ = setups["llama2-7b"]
    params = _to_port(jparams)
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="must live on cpu"):
        ttrain.train(params=params, device="cpu", steps=1)


def test_prefill_and_serve_steps_match_reference(setups):
    """``make_prefill_step`` / ``make_serve_step``: the last position's
    logits after a 12-token prefix, then one decode step, against the
    reference's steps (f32 caches), within rtol 1e-4 of max |logit|; then
    tiny qwen2-vl's prefill step on an mrope (3, B, S) position batch."""
    jcfg, tcfg, jparams, batches = setups["llama2-7b"]
    toks = batches[0][:2, :12]
    jpre = jsteps.make_prefill_step(jcfg, 16, cache_dtype=jnp.float32)
    jlast, jcaches = jpre(jparams, {"tokens": jnp.asarray(toks)})
    tparams = _to_port(jparams)
    tlast, tcaches = tsteps.make_prefill_step(
        tcfg, 16, cache_dtype=torch.float32)(
            tparams, {"tokens": torch.from_numpy(toks)})
    scale = float(jnp.abs(jlast).max())
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0,
                               atol=1e-4 * scale)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    jlog, _ = jsteps.make_serve_step(jcfg)(jparams, jcaches,
                                           jnp.asarray(nxt), jnp.int32(12))
    tlog, _ = tsteps.make_serve_step(tcfg)(tparams, tcaches,
                                           torch.from_numpy(nxt), 12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4 * float(jnp.abs(jlog).max()))
    # mrope (tiny qwen2-vl): a (3, B, S) batch whose height and width
    # streams differ, as a vision grid's do
    mcfg = tiny("qwen2-vl-2b")
    mparams = _numpy_params(mcfg, seed=2)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 2, 12)).copy()
    pos[1, :, :4], pos[2, :, :4] = [0, 0, 1, 1], [0, 1, 0, 1]
    jlast, _ = jsteps.make_prefill_step(mcfg, 16, cache_dtype=jnp.float32)(
        mparams, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    tlast, _ = tsteps.make_prefill_step(
        get_tiny("qwen2-vl-2b"), 16, cache_dtype=torch.float32)(
            _to_port(mparams), {"tokens": torch.from_numpy(toks),
                                "positions": torch.from_numpy(pos)})
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0,
                               atol=1e-4 * float(jnp.abs(jlast).max()))


def test_train_cuts_the_config_to_depth():
    """``train(depth=)``: the published widths with the first ``depth``
    layers (the card's smoke run trains qwen3-0.6b so)."""
    cfg, params, losses = ttrain.train(arch="llama2-7b", tiny=True,
                                       steps=2, batch=2, seq=16,
                                       log_every=100, device="cpu", depth=1)
    full = get_tiny("llama2-7b")
    assert cfg.n_layers == 1 and len(params["layers"]) == 1
    assert (cfg.d_model, cfg.d_ff, cfg.vocab) == (full.d_model, full.d_ff,
                                                   full.vocab)
    assert len(losses) == 2 and all(np.isfinite(losses))
