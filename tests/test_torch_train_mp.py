"""Model-parallel training (``runtime/steps.make_train_step(mesh=)``: ZeRO-3
over the data axis x tensor parallelism over the model axis) against the
JAX reference's one-device train step and the port's own 1 x 1 run, on
the host.

Host-only cases: ``prepare_train_params``' slices concatenate back to the
full leaves (wq/wk/wv and the gate|up ``wi`` by column, ``wo`` by row,
``lm_head`` by vocab, the rest whole); ZeRO shards round-trip, padding
included; over a fake (data 2, model 2) layout whose four ranks run in
threads, the global squared norm and the int8 scales equal one device's
exactly (the codes too).

Spawned: one run of four gloo ranks (DP 2 x TP 2, one thread each,
``tests/_torch_train_mp_ranks.py``): tiny llama2 (2 layers) with
microbatches 2, tiny qwen3 (qk-norm) with int8 gradient compression, and
the checkpoint round trip (a DP 2 x TP 2 checkpoint restored at 1 x 1,
and a 1 x 1 one at DP 2 x TP 2; a resumed run under the same layout
replays its losses bit for bit).  Each runs five steps on bridged params
(lr 1e-2, warmup 2) and is held to the reference's jitted
``repro.runtime.steps.make_train_step`` by ``tests/test_torch_train.py``'s
tolerances (its docstring gives the measured errors): losses within
LOSS_RTOL 1e-5, grad norms GNORM_RTOL 1e-4, lr 1e-6, params and both
moments within TREE_TOL 1e-3 of each leaf's largest |value| (int8: up to
INT8_OFF of the elements off by at most lr), and to the port's 1 x 1 run
by the same.  The sums run in another order on the mesh (a reduce-scatter
over dp, the row-sliced ``wo``'s all-reduce, the vocab-parallel
cross-entropy), so only a tolerance holds, never bit identity.
"""
import concurrent.futures
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_train_mp_ranks  # noqa: E402
from helpers import tiny  # noqa: E402
from test_torch_train import (BATCH, GNORM_RTOL, INT8_OFF,  # noqa: E402
                              LOSS_RTOL, LR, SEQ, STEPS, TREE_TOL, WARMUP,
                              _close_by_leaf_scale, _numpy_params, _to_port)

from repro.optim import adamw_init as jinit  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.data import LMBatchLoader, make_corpus_tokens  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import compression, sharding  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime import tp  # noqa: E402

DENSE = ("llama2-7b", "qwen3-0.6b", "internlm2-1.8b", "llama3.2-3b",
         "yi-34b", "qwen2-vl-2b")
LAYERS = 2
# the spawned runs: (arch, train-step kwargs)
RUNS = {"llama2-mb2": ("llama2-7b", {"microbatches": 2}),
        "qwen3-int8": ("qwen3-0.6b", {"grad_compression": "int8"})}
SAVE_AT, RESTORE_AT = 3, 2      # the mesh's checkpoint, the 1 x 1 one's
LAYERS_OF = {a: get_tiny(a).n_layers for a in DENSE}


def _kw(**kw):
    return dict(peak_lr=LR, warmup=WARMUP, total_steps=STEPS, **kw)


def _full_params(arch):
    cfg = get_tiny(arch)
    return cfg, ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def _mesh_at(d, m, dp, tp_, pgs=None):
    """A TrainMesh at coordinates (d, m) whose groups join nothing (or the
    fake groups ``pgs[axis][index]``)."""
    data = tp.TPGroup(rank=d, size=dp, backend="fake", device=torch.device(
        "cpu"), pg=pgs and pgs["data"][m], axis="data")
    model = tp.TPGroup(rank=m, size=tp_, backend="fake",
                       device=torch.device("cpu"),
                       pg=pgs and pgs["model"][d], axis="model")
    return sharding.TrainMesh(dp=dp, tp=tp_, data=data, model=model)


# ------------------------------------------------------------ host only


@pytest.mark.parametrize("arch", DENSE)
def test_train_slices_concatenate_back(arch):
    cfg, params = _full_params(arch)
    plan = tp.plan_for(cfg, 2)
    ranks = [tp.prepare_train_params(cfg, params, r, 2) for r in range(2)]
    names = list(sharding._leaf_paths(params))
    full, parts = tree.leaves(params), [tree.leaves(r) for r in ranks]
    sliced = 0
    for i, (path, leaf) in enumerate(zip(names, full)):
        how = tp.train_slice(plan, path)
        if how is None:
            assert all(p[i] is leaf for p in parts), path
            continue
        sliced += 1
        axis, permute = how
        assert parts[0][i].shape[axis] * 2 == leaf.shape[axis]
        back = tp.unslice_leaf([p[i] for p in parts], axis, permute)
        assert torch.equal(back, leaf), path
    # attention (where the heads divide), the FFN and the head are cut
    assert sliced == LAYERS_OF[arch] * (6 if plan.attn else 2) + 1
    assert plan.ffn and plan.lm_head


@pytest.mark.parametrize("dp,tp_", [(2, 2), (3, 2), (3, 1)])
def test_zero_shards_round_trip(dp, tp_):
    """Every (d, m) rank's shards put back together give the full leaves,
    and the padding is zeros; the sizes do not divide dp = 3."""
    cfg, params = _full_params("llama3.2-3b")
    meshes = [[_mesh_at(d, m, dp, tp_) for m in range(tp_)]
              for d in range(dp)]
    lays = [[sharding.TrainLayout(cfg, x) for x in row] for row in meshes]
    shards = [[lay.shard(params) for lay in row] for row in lays]
    lay0 = lays[0][0]
    full = tree.leaves(params)
    for i, leaf in enumerate(full):
        how = lay0.slices[i]
        slices = []
        for m in range(tp_):
            flat = torch.cat([tree.leaves(shards[d][m])[i]
                              for d in range(dp)])
            n = flat.numel()
            local = list(leaf.shape)
            if how is not None:
                local[how[0]] //= tp_
            k = int(np.prod(local))
            assert n == dp * -(-k // dp)
            assert not flat[k:].any()
            slices.append(flat[:k].reshape(local))
        back = (slices[0] if how is None
                else tp.unslice_leaf(slices, how[0], how[1]))
        assert torch.equal(back, leaf)


class _FakePG:
    """The members' all-reduce in threads: each puts its tensor, all wait,
    each takes the reduction."""

    def __init__(self, n):
        self.slots, self.barrier = [None] * n, threading.Barrier(n)


def _threaded_all_reduce(x, group, op="sum"):
    if group.size == 1:
        return x
    pg = group.pg
    pg.slots[group.rank] = x.clone()
    pg.barrier.wait()
    stack = torch.stack(pg.slots)
    out = stack.amax(0) if op == "max" else stack.sum(0)
    pg.barrier.wait()
    return out


def test_global_norm_and_int8_scale_equal_one_device(monkeypatch):
    """A (data 2, model 2) layout's four ranks in threads: ``sq_total`` of
    their shards' squared norms is one device's squared global norm, and
    int8 compression with ``amax_total`` gives every element one device's
    code (the dequantized shards put back are one device's exactly)."""
    monkeypatch.setattr(tp, "all_reduce", _threaded_all_reduce)
    cfg, params = _full_params("qwen3-0.6b")
    g = torch.Generator().manual_seed(3)
    grads = tree.tree_map(lambda t: torch.randn(t.shape, generator=g)
                          * torch.rand((), generator=g), params)
    pgs = {"data": [_FakePG(2) for _ in range(2)],
           "model": [_FakePG(2) for _ in range(2)]}
    lays = {(d, m): sharding.TrainLayout(cfg, _mesh_at(d, m, 2, 2, pgs))
            for d in range(2) for m in range(2)}
    out = {}

    def rank(d, m):
        lay = lays[d, m]
        mine = lay.shard(grads)
        sq = [torch.sum(t * t) for t in tree.leaves(mine)]
        out[d, m] = (lay.sq_total(sq),
                     compression.compress_decompress_grads(
                         mine, lay.amax_total))
    threads = [threading.Thread(target=rank, args=k) for k in lays]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(out) == 4
    want_sq = sum(float(torch.sum(t.double() ** 2)) for t in
                  tree.leaves(grads))
    for sq, _ in out.values():
        np.testing.assert_allclose(float(sq), want_sq, rtol=1e-6)
    want = tree.leaves(compression.compress_decompress_grads(grads))
    lay0 = lays[0, 0]
    for i, leaf in enumerate(want):
        how = lay0.slices[i]
        local = list(leaf.shape)
        if how is not None:
            local[how[0]] //= 2
        k = int(np.prod(local))
        slices = [torch.cat([tree.leaves(out[d, m][1])[i] for d in range(2)]
                            )[:k].reshape(local) for m in range(2)]
        back = (slices[0] if how is None
                else tp.unslice_leaf(slices, how[0], how[1]))
        assert torch.equal(back, leaf)


def test_recompute_sees_the_group_off_its_thread(monkeypatch):
    """On the card autograd runs the backward, and with it each layer's
    recompute, in a device thread that does not see the caller's TP
    scope: a backward started from another thread must still find the
    model group (the all-reduce is faked as if the other rank held the
    same values)."""
    monkeypatch.setattr(tp, "all_reduce", lambda x, group, op="sum":
                        x if op == "max" else 2 * x)
    cfg, params = _full_params("qwen3-0.6b")
    m = _mesh_at(0, 0, 1, 2)
    lay = sharding.TrainLayout(cfg, m)
    shards = lay.shard(params)
    live = [t.requires_grad_(True) for t in tree.leaves(shards["layers"])]
    layers = {"layers": tree.unflatten(tree.flatten(shards["layers"])[1],
                                       live)}
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator(
        ).manual_seed(0))
    with tp.scope(m.model):
        loss = ttf.loss_fn(cfg, lay.view(layers, lay.gather_roots(shards)),
                           {"tokens": tokens}, remat=True)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, live)
        except Exception as e:                             # noqa: BLE001
            out["error"] = e
    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert all(torch.isfinite(g).all() for g in out["grads"])


def test_mesh_refuses_the_other_families():
    for arch, fam in (("mixtral-8x7b", "MoE"), ("rwkv6-3b", "RWKV"),
                      ("recurrentgemma-2b", "RGLRU"),
                      ("deepseek-v2-236b", "MoE/MLA"),
                      ("whisper-large-v3", "encoder-decoder")):
        with pytest.raises(ValueError, match=f"{fam} model-parallel "
                           "training waits for ROADMAP Queue 1 item 11"):
            tsteps.make_train_step(get_tiny(arch),
                                   mesh=sharding.single_mesh("cpu"))


# ------------------------------------------------------------- spawned


@pytest.fixture(scope="module")
def setups():
    """run name -> (reference cfg, port cfg, reference params, batches)."""
    out = {}
    for name, (arch, _) in RUNS.items():
        jcfg = tiny(arch).with_(n_layers=LAYERS)
        loader = LMBatchLoader(make_corpus_tokens(jcfg.vocab, 600), BATCH,
                               SEQ)
        out[name] = (jcfg, get_tiny(arch).with_(n_layers=LAYERS),
                     _numpy_params(jcfg, seed=1),
                     [loader.next_batch() for _ in range(STEPS)])
    return out


def _port_run(tcfg, params, batches, kw, state=None):
    """The port's 1 x 1 run from ``params`` (or ``state``) -> (state,
    metrics)."""
    step = tsteps.make_train_step(tcfg, **_kw(**kw))
    if state is None:
        p = tree.tree_map(torch.clone, params)
        state = (p, adamw_init(p))
    p, o = state
    ms = []
    for b in batches:
        p, o, m = step(p, o, {"tokens": torch.from_numpy(b)})
        ms.append({k: float(v) for k, v in m.items()})
    return (p, o), ms


def _reference_run(jcfg, jparams, batches, kw):
    jstep = jax.jit(jsteps.make_train_step(jcfg, remat=False, **_kw(**kw)))
    jp, jo, ms = jparams, jinit(jparams), []
    for b in batches:
        jp, jo, m = jstep(jp, jo, {"tokens": jnp.asarray(b)})
        ms.append({k: float(v) for k, v in m.items()})
    return jp, jo, ms


@pytest.fixture(scope="module")
def mp_runs(setups, tmp_path_factory):
    """The DP 2 x TP 2 runs in one spawn of four gloo ranks and, while they
    run, the reference's and the port's 1 x 1 runs here."""
    ones = str(tmp_path_factory.mktemp("ckpt_1x1"))
    mine = str(tmp_path_factory.mktemp("ckpt_2x2"))
    jobs, port = [], {}
    for name, (arch, kw) in RUNS.items():
        jcfg, tcfg, jparams, batches = setups[name]
        tparams = _to_port(jparams)
        jobs.append({"arch": arch, "layers": LAYERS, "kw": _kw(**kw),
                     "params": tparams, "batches": batches})
        port[name] = (tcfg, tparams, batches, kw)
    # the checkpoint round trip on llama2 without microbatches; its 1 x 1
    # checkpoint is written before the ranks start
    tcfg, tparams, batches, _ = port["llama2-mb2"]
    state, _ = _port_run(tcfg, tparams, batches[:RESTORE_AT], {})
    assert not any(t.requires_grad for t in tree.leaves(state))
    CheckpointManager(ones).save(RESTORE_AT, state,
                                 {"next_step": RESTORE_AT})
    jobs.append({"arch": "llama2-7b", "layers": LAYERS, "kw": _kw(),
                 "params": tparams, "batches": batches,
                 "ckpt": (mine, ones), "save_at": SAVE_AT,
                 "restore_at": RESTORE_AT})
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(mesh.spawn, _torch_train_mp_ranks.run_all, 2,
                            jobs, dp=2, device="cpu", threads=1)
        ref = {}
        for name, (jcfg, _, jparams, batches) in setups.items():
            ref[name] = _reference_run(jcfg, jparams, batches, RUNS[name][1])
        one = {name: _port_run(*port[name]) for name in RUNS}
        one["ckpt"] = _port_run(*port["llama2-mb2"][:3], {})
        ranks = spawned.result()
    return {"ref": ref, "one": one, "ranks": ranks, "dirs": (mine, ones),
            "port": port}


def _state_tree(state_np):
    return tree.tree_map(torch.from_numpy, state_np)


@pytest.mark.parametrize("name", list(RUNS))
def test_dp2_tp2_tracks_the_reference(mp_runs, name):
    jp, jo, jm = mp_runs["ref"][name]
    got = mp_runs["ranks"][0][list(RUNS).index(name)]
    int8 = RUNS[name][1].get("grad_compression") == "int8"
    for j, t in zip(jm, got["metrics"]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=GNORM_RTOL)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]
    params, opt = _state_tree(got["state"])
    assert int(opt.step) == STEPS
    for g, w in ((params, jp), (opt.mu, jo.mu), (opt.nu, jo.nu)):
        _close_by_leaf_scale(g, w, TREE_TOL,
                             off_share=INT8_OFF if int8 else 0.0,
                             max_move=LR if int8 else None)
    # every rank reports the same metrics
    for r in mp_runs["ranks"][1:]:
        assert r[list(RUNS).index(name)]["metrics"] == got["metrics"]
        assert "state" not in r[list(RUNS).index(name)]


@pytest.mark.parametrize("name", list(RUNS))
def test_dp2_tp2_tracks_the_port_1x1(mp_runs, name):
    (p1, o1), m1 = mp_runs["one"][name]
    got = mp_runs["ranks"][0][list(RUNS).index(name)]
    int8 = RUNS[name][1].get("grad_compression") == "int8"
    for a, b in zip(m1, got["metrics"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=GNORM_RTOL)
        assert b["lr"] == a["lr"]
    params, opt = _state_tree(got["state"])
    for g, w in ((params, p1), (opt.mu, o1.mu), (opt.nu, o1.nu)):
        for a, b in zip(tree.leaves(g), tree.leaves(w)):
            err = (a - b).abs()
            off = int((err > TREE_TOL * b.abs().max()).sum())
            assert off <= (INT8_OFF if int8 else 0.0) * err.numel()
            if int8:
                assert float(err.max()) <= LR


def test_checkpoints_move_between_meshes(mp_runs):
    """A DP 2 x TP 2 checkpoint restores at 1 x 1 and goes on as the
    mesh did; a 1 x 1 one restores at DP 2 x TP 2 and goes on as one
    device does; the mesh resumed from its own checkpoint replays its
    losses bit for bit."""
    got = mp_runs["ranks"][0][-1]
    mine, ones = mp_runs["dirs"]
    tcfg, tparams, batches, _ = mp_runs["port"]["llama2-mb2"]
    (_, _), m1 = mp_runs["one"]["ckpt"]
    losses = [m["loss"] for m in got["metrics"]]
    assert [m["loss"] for m in got["replayed"]] == losses[SAVE_AT:]
    mgr = CheckpointManager(mine)
    assert mgr.latest_step() == SAVE_AT
    like = (tparams, adamw_init(tparams))
    state, extra = mgr.restore(SAVE_AT, like)
    assert extra["next_step"] == SAVE_AT and int(state[1].step) == SAVE_AT
    _, after = _port_run(tcfg, None, batches[SAVE_AT:], {}, state=state)
    np.testing.assert_allclose([m["loss"] for m in after],
                               losses[SAVE_AT:], rtol=LOSS_RTOL)
    np.testing.assert_allclose([m["loss"] for m in got["from_one_device"]],
                               [m["loss"] for m in m1[RESTORE_AT:]],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, [m["loss"] for m in m1],
                               rtol=LOSS_RTOL)
