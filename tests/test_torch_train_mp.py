"""Model-parallel training (``runtime/steps.make_train_step(mesh=)``: ZeRO-3
over the data axis x tensor parallelism over the model axis) against the
JAX reference's one-device train step and the port's own 1 x 1 run, on
the host.

Host-only cases: ``prepare_train_params``' slices concatenate back to the
full leaves (wq/wk/wv and the gate|up ``wi`` by column, ``wo`` by row,
``lm_head`` by vocab; an MoE's experts on their expert axis, or by
column and row within each expert when TP does not divide their count;
the shared experts by column and row; MLA's ``wq_b`` / ``wkv_b`` by
head and ``wo`` by row; the rest whole); ZeRO shards round-trip, padding
included; over a fake (data 2, model 2) layout whose four ranks run in
threads, the global squared norm and the int8 scales equal one device's
exactly (the codes too); a backward started in another thread finds the
model group, and the MoE's recompute the data group.

Spawned: one run of four gloo ranks (DP 2 x TP 2, one thread each,
``tests/_torch_train_mp_ranks.py``): tiny llama2 (2 layers) with
microbatches 2, tiny qwen3 (qk-norm) with int8 gradient compression,
tiny mixtral with microbatches 2 at its capacity factor 1.25 and without
at 0.5 (tokens drop: the data ranks' dropped assignments add up to one
device's), tiny deepseek-v2 (MLA, 8 experts, a shared one), tiny mixtral
with 3 experts (TP 2 slices within each), and two checkpoint round trips
(llama2's and deepseek-v2's: a DP 2 x TP 2 checkpoint restored at 1 x 1,
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
cross-entropy, the experts' combine), so only a tolerance holds, never
bit identity.  The MoE runs free (each step from the mesh's own state):
no top-k near-tie flipped by the round-off on the host.
"""
import concurrent.futures
import dataclasses
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

from repro.configs import registry as jreg  # noqa: E402
from repro.optim import adamw_init as jinit  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.data import LMBatchLoader, make_corpus_tokens  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import compression, sharding  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime import tp  # noqa: E402

DENSE = ("llama2-7b", "qwen3-0.6b", "internlm2-1.8b", "llama3.2-3b",
         "yi-34b", "qwen2-vl-2b")
LAYERS = 2
# the spawned runs: (arch, train-step kwargs, MoE fields replaced; None:
# the reference's no-drop tiny config).  The MoE runs keep their tiny
# configs' capacity factor (1.25, Mixtral's and DeepSeek-V2's published
# one) or cut it to 0.5, so that tokens drop; mixtral-e3 has 3 experts, so
# TP 2 falls back to slicing within each expert.
RUNS = {"llama2-mb2": ("llama2-7b", {"microbatches": 2}, None),
        "qwen3-int8": ("qwen3-0.6b", {"grad_compression": "int8"}, None),
        "mixtral-mb2": ("mixtral-8x7b", {"microbatches": 2}, {}),
        "mixtral-drop": ("mixtral-8x7b", {}, {"capacity_factor": 0.5}),
        "deepseek": ("deepseek-v2-236b", {}, {}),
        "mixtral-e3": ("mixtral-8x7b", {}, {"n_experts": 3})}
MOE_RUNS = [n for n, r in RUNS.items() if r[2] is not None]
# the checkpoint round trips: the run whose params and batches they take
CKPTS = {"ckpt": "llama2-mb2", "ckpt-ep": "deepseek"}
SAVE_AT, RESTORE_AT = 3, 2      # the mesh's checkpoint, the 1 x 1 one's
LAYERS_OF = {a: get_tiny(a).n_layers for a in DENSE}


def _kw(**kw):
    return dict(peak_lr=LR, warmup=WARMUP, total_steps=STEPS, **kw)


def _full_params(arch, moe_kw=None):
    cfg = _torch_train_mp_ranks.config(arch, get_tiny(arch).n_layers, moe_kw)
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


def _slices_concatenate_back(cfg, params) -> tuple:
    """Each rank's TP 2 slices of ``params`` concatenate back to the full
    leaves, and the replicated leaves are the caller's -> (the plan, the
    sliced leaves' paths with their (axis, permute))."""
    plan = tp.train_plan_for(cfg, 2)
    ranks = [tp.prepare_train_params(cfg, params, r, 2) for r in range(2)]
    names = list(sharding._leaf_paths(params))
    full, parts = tree.leaves(params), [tree.leaves(r) for r in ranks]
    sliced = {}
    for i, (path, leaf) in enumerate(zip(names, full)):
        how = tp.train_slice(plan, path)
        if how is None:
            assert all(p[i] is leaf for p in parts), path
            continue
        sliced[".".join(path)] = how
        axis, permute = how
        assert parts[0][i].shape[axis] * 2 == leaf.shape[axis]
        back = tp.unslice_leaf([p[i] for p in parts], axis, permute)
        assert torch.equal(back, leaf), path
    return plan, sliced


@pytest.mark.parametrize("arch", DENSE)
def test_train_slices_concatenate_back(arch):
    cfg, params = _full_params(arch)
    plan, sliced = _slices_concatenate_back(cfg, params)
    # attention (where the heads divide), the FFN and the head are cut
    assert len(sliced) == LAYERS_OF[arch] * (6 if plan.attn else 2) + 1
    assert plan.ffn and plan.lm_head


# (arch, MoE fields) -> what TP 2 cuts in each layer, by leaf: experts
# whole on their expert axis, or within each expert (3 experts); the
# shared experts by column and row; MLA's wq_b / wkv_b by head, wo by row
MOE_SLICES = {
    ("mixtral-8x7b", None): {
        "attn.wq": (1, False), "attn.wk": (1, False), "attn.wv": (1, False),
        "attn.wo": (0, False), "moe.wi": (0, False), "moe.wo": (0, False)},
    ("mixtral-8x7b", 3): {
        "attn.wq": (1, False), "attn.wk": (1, False), "attn.wv": (1, False),
        "attn.wo": (0, False), "moe.wi": (2, True), "moe.wo": (1, False)},
    ("deepseek-v2-236b", None): {
        "mla.wq_b": (1, False), "mla.wkv_b": (1, False), "mla.wo": (0, False),
        "moe.wi": (0, False), "moe.wo": (0, False), "moe.swi": (1, True),
        "moe.swo": (0, False)}}


@pytest.mark.parametrize("arch,experts", list(MOE_SLICES))
def test_moe_and_mla_slices_concatenate_back(arch, experts):
    """The MoE and MLA leaves' slices and their inverse; the router, MLA's
    latent projections and their norms replicate."""
    cfg, params = _full_params(arch, experts and {"n_experts": experts})
    plan, sliced = _slices_concatenate_back(cfg, params)
    want = {f"layers.{i}.{k}": v for i in range(cfg.n_layers)
            for k, v in MOE_SLICES[arch, experts].items()}
    assert sliced == dict(want, lm_head=(1, False))
    assert plan.ep == (experts is None) and plan.moe == (experts == 3)
    assert plan.mla == (cfg.mla is not None)


def _zero_round_trip(cfg, params, dp, tp_):
    """Every (d, m) rank's shards put back together give the full leaves,
    and the padding is zeros."""
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


@pytest.mark.parametrize("dp,tp_", [(2, 2), (3, 2), (3, 1)])
def test_zero_shards_round_trip(dp, tp_):
    """Every (d, m) rank's shards put back together give the full leaves,
    and the padding is zeros; the sizes do not divide dp = 3."""
    _zero_round_trip(*_full_params("llama3.2-3b"), dp, tp_)


@pytest.mark.parametrize("arch,experts", [("deepseek-v2-236b", None),
                                          ("mixtral-8x7b", 3)])
def test_zero_shards_round_trip_moe(arch, experts):
    """The same over (data 3, model 2) for the expert-parallel, MLA and
    intra-expert leaves."""
    _zero_round_trip(*_full_params(arch, experts and {"n_experts": experts}),
                     3, 2)


def test_zero_collectives_staged_on_the_host_equal_the_direct_ones(
        monkeypatch):
    """The ZeRO gather and scatter of a layer, with their collective run
    on a host copy (as under gloo with CUDA tensors) or directly, give the
    same leaves and shards (a data group of two whose other rank holds the
    same values)."""
    monkeypatch.setattr(tp, "all_gather_flat", lambda x, group: torch.cat(
        [x.reshape(-1)] * group.size))
    monkeypatch.setattr(tp, "reduce_scatter_flat", lambda x, group: (
        x.reshape(group.size, -1)[group.rank] * group.size).clone())
    cfg, params = _full_params("deepseek-v2-236b")
    lay = sharding.TrainLayout(cfg, _mesh_at(1, 0, 2, 2))
    unit = lay.units["layers", 0]
    shards = tree.leaves(lay.shard(params)["layers"][0])
    grads = [torch.randn(s, generator=torch.Generator().manual_seed(i))
             for i, s in enumerate(unit.shapes)]
    out = {}
    for staged in (False, True):
        monkeypatch.setattr(tp, "through_host", lambda group, x: staged)
        out[staged] = (sharding._gather_leaves(unit, lay.mesh.data, shards),
                       sharding._scatter_grads(unit, lay.mesh.data, grads))
    for a, b in zip(out[False][0] + out[False][1],
                    out[True][0] + out[True][1]):
        assert torch.equal(a, b)
    # the gathered leaves are the rank's TP slices, whole
    assert [tuple(t.shape) for t in out[True][0]] == list(unit.shapes)


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
    _norm_and_int8_equal_one_device(*_full_params("qwen3-0.6b"))


@pytest.mark.parametrize("arch,experts", [("deepseek-v2-236b", None),
                                          ("mixtral-8x7b", 3)])
def test_global_norm_and_int8_scale_equal_one_device_moe(monkeypatch, arch,
                                                         experts):
    """The same with expert-parallel leaves (each counted once over the
    model axis), a replicated router and MLA latents, or the intra-expert
    slices."""
    monkeypatch.setattr(tp, "all_reduce", _threaded_all_reduce)
    _norm_and_int8_equal_one_device(*_full_params(
        arch, experts and {"n_experts": experts}))


def _norm_and_int8_equal_one_device(cfg, params):
    """The four ranks' ``sq_total`` and int8 codes against one device's."""
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
    _recompute_off_its_thread("qwen3-0.6b", 1)


def test_moe_recompute_sees_the_data_group_off_its_thread(monkeypatch):
    """The same for the MoE's recompute, which gathers the expert counts
    over the data group (faked as if the other data rank routed the same
    rows; the ZeRO gathers' data group is of one rank)."""
    monkeypatch.setattr(tp, "all_reduce", lambda x, group, op="sum":
                        x if op == "max" else 2 * x)
    calls = []

    def gather(x, group):
        calls.append((group.axis, group.size))
        return torch.cat([x.reshape(-1)] * group.size)
    monkeypatch.setattr(tp, "all_gather_flat", gather)
    _recompute_off_its_thread("deepseek-v2-236b", 2)
    # each layer's forward and its recompute off the thread
    assert calls.count(("data", 2)) == 2 * get_tiny(
        "deepseek-v2-236b").n_layers


def _recompute_off_its_thread(arch, moe_dp):
    """A rank of model 2 whose backward runs in another thread;
    ``moe_dp``: the data group the MoE sees (the layout's is of one)."""
    cfg, params = _full_params(arch)
    m = _mesh_at(0, 0, 1, 2)
    lay = sharding.TrainLayout(cfg, m)
    shards = lay.shard(params)
    live = [t.requires_grad_(True) for t in tree.leaves(shards["layers"])]
    layers = {"layers": tree.unflatten(tree.flatten(shards["layers"])[1],
                                       live)}
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator(
        ).manual_seed(0))
    data = _mesh_at(0, 0, moe_dp, 2).data
    with tp.scope(m.model, data):
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
    for arch, fam in (("rwkv6-3b", "RWKV"), ("recurrentgemma-2b", "RGLRU"),
                      ("whisper-large-v3", "encoder-decoder")):
        with pytest.raises(ValueError, match=f"{fam} model-parallel "
                           "training waits for ROADMAP Queue 1 item 11"):
            tsteps.make_train_step(get_tiny(arch),
                                   mesh=sharding.single_mesh("cpu"))
    for arch in ("mixtral-8x7b", "deepseek-v2-236b"):
        tsteps.make_train_step(get_tiny(arch),
                               mesh=sharding.single_mesh("cpu"))


# ------------------------------------------------------------- spawned


def _reference_cfg(arch, moe_kw):
    """The reference's tiny config of a run: the no-drop one, or its own
    capacity with ``moe_kw`` replaced."""
    if moe_kw is None:
        return tiny(arch).with_(n_layers=LAYERS)
    jcfg = jreg.get_tiny(arch).with_(n_layers=LAYERS)
    return jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe_kw))


@pytest.fixture(scope="module")
def setups():
    """run name -> (reference cfg, port cfg, reference params, batches)."""
    out = {}
    for name, (arch, _, moe_kw) in RUNS.items():
        jcfg = _reference_cfg(arch, moe_kw)
        loader = LMBatchLoader(make_corpus_tokens(jcfg.vocab, 600), BATCH,
                               SEQ)
        out[name] = (jcfg, _torch_train_mp_ranks.config(arch, LAYERS,
                                                        moe_kw),
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
    run, the reference's and the port's 1 x 1 runs here (with the MoE's
    dropped assignments counted)."""
    jobs, port, dirs = [], {}, {}
    for name, (arch, kw, moe_kw) in RUNS.items():
        jcfg, tcfg, jparams, batches = setups[name]
        tparams = _to_port(jparams)
        jobs.append({"arch": arch, "layers": LAYERS, "kw": _kw(**kw),
                     "moe": moe_kw, "params": tparams, "batches": batches})
        port[name] = (tcfg, tparams, batches, kw)
    # the checkpoint round trips without microbatches (llama2; DeepSeek-V2's
    # expert-parallel, shared-expert and MLA leaves); each 1 x 1
    # checkpoint is written before the ranks start
    for ck, name in CKPTS.items():
        tcfg, tparams, batches, _ = port[name]
        mine = str(tmp_path_factory.mktemp(f"{ck}_2x2"))
        ones = str(tmp_path_factory.mktemp(f"{ck}_1x1"))
        state, _ = _port_run(tcfg, tparams, batches[:RESTORE_AT], {})
        assert not any(t.requires_grad for t in tree.leaves(state))
        CheckpointManager(ones).save(RESTORE_AT, state,
                                     {"next_step": RESTORE_AT})
        jobs.append({"arch": RUNS[name][0], "layers": LAYERS, "kw": _kw(),
                     "moe": RUNS[name][2], "params": tparams,
                     "batches": batches, "ckpt": (mine, ones),
                     "save_at": SAVE_AT, "restore_at": RESTORE_AT})
        dirs[ck] = (mine, ones)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(mesh.spawn, _torch_train_mp_ranks.run_all, 2,
                            jobs, dp=2, device="cpu", threads=1)
        ref = {}
        for name, (jcfg, _, jparams, batches) in setups.items():
            ref[name] = _reference_run(jcfg, jparams, batches, RUNS[name][1])
        one, dropped = {}, {}
        for name in RUNS:
            counter = torch.zeros((), dtype=torch.int64)
            with tmoe.count_overflow(counter):
                one[name] = _port_run(*port[name])
            dropped[name] = int(counter)
        for ck, name in CKPTS.items():
            one[ck] = _port_run(*port[name][:3], {})
        ranks = spawned.result()
    index = {name: i for i, name in enumerate(list(RUNS) + list(CKPTS))}
    return {"ref": ref, "one": one, "ranks": ranks, "dirs": dirs,
            "port": port, "dropped": dropped, "index": index}


def _state_tree(state_np):
    return tree.tree_map(torch.from_numpy, state_np)


@pytest.mark.parametrize("name", list(RUNS))
def test_dp2_tp2_tracks_the_reference(mp_runs, name):
    jp, jo, jm = mp_runs["ref"][name]
    got = mp_runs["ranks"][0][mp_runs["index"][name]]
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
        assert r[mp_runs["index"][name]]["metrics"] == got["metrics"]
        assert "state" not in r[mp_runs["index"][name]]


@pytest.mark.parametrize("name", list(RUNS))
def test_dp2_tp2_tracks_the_port_1x1(mp_runs, name):
    (p1, o1), m1 = mp_runs["one"][name]
    got = mp_runs["ranks"][0][mp_runs["index"][name]]
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
    _checkpoint_moves(mp_runs, "ckpt")


def test_ep_checkpoints_move_between_meshes(mp_runs):
    """The same with DeepSeek-V2's leaves: the experts whole over the
    model axis, the shared experts and MLA's heads sliced, the router and
    the latent projections replicated."""
    _checkpoint_moves(mp_runs, "ckpt-ep")


def _checkpoint_moves(mp_runs, ck):
    got = mp_runs["ranks"][0][mp_runs["index"][ck]]
    mine, ones = mp_runs["dirs"][ck]
    tcfg, tparams, batches, _ = mp_runs["port"][CKPTS[ck]]
    (_, _), m1 = mp_runs["one"][ck]
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


@pytest.mark.parametrize("name", MOE_RUNS)
def test_moe_drops_what_one_device_drops(mp_runs, name):
    """The data ranks' dropped assignments add up to one device's (the
    capacity and each token's rank within its expert are the whole
    microbatch's); the model ranks of a data row drop the same; at
    capacity factor 0.5 tokens do drop."""
    ranks = [r[mp_runs["index"][name]]["dropped"] for r in mp_runs["ranks"]]
    # rank = d * tp + m
    assert ranks[0] == ranks[1] and ranks[2] == ranks[3]
    assert ranks[0] + ranks[2] == mp_runs["dropped"][name]
    if RUNS[name][2].get("capacity_factor", 1.25) < 1:
        assert mp_runs["dropped"][name] > 0
