"""The port's checkpointing (atomicity, keep-N, milestones, async, restore
with a placement function) and fault-tolerant loop (runs and checkpoints,
injected failures, resume, the straggler watchdog): the cases of
``tests/test_checkpoint_fault.py`` on ``repro_torch.checkpoint`` and
``repro_torch.runtime.fault``, plus the trees the train loop saves (nested
dicts and lists, ``AdamWState``, a 0-d step tensor) and bf16 leaves, which
numpy cannot hold and are stored widened.

Also held against the reference: the leaf order (``repro_torch.tree``
flattens as ``jax.tree`` does), and a checkpointed reference loop and the
port's, driven by the same counter step and failures, end in the same
state with the same checkpoints on disk.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.runtime.fault import FaultTolerantLoop as JLoop  # noqa: E402
from repro.runtime.fault import LoopConfig as JLoopConfig  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402
from repro_torch.runtime.fault import FaultTolerantLoop, LoopConfig  # noqa: E402


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=gen),
            "nested": {"b": torch.arange(5, dtype=torch.int32)},
            "lst": [torch.ones((3,)), torch.zeros((2, 2))]}


def _assert_same(t1, t2):
    l1, l2 = tree.leaves(t1), tree.leaves(t2)
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(7, t, {"next_step": 8})
    restored, extra = mgr.restore(7, t)
    assert extra["next_step"] == 8
    _assert_same(t, restored)


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(6):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [4, 5]


def test_milestones_protected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, milestone_every=4)
    for s in range(6):
        mgr.save(s, _tree())
    assert 0 in mgr.all_steps() and 4 in mgr.all_steps()


def test_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp.")]


def test_async_save_copies_before_returning(tmp_path):
    """The write runs on a thread, but the leaves are copied off the live
    tensors inside ``save``: the train step updates them in place."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    t = _tree()
    want = t["a"].clone()
    mgr.save(3, t)
    t["a"].add_(1.0)                   # the next step, in place
    mgr.wait()
    assert mgr.latest_step() == 3
    restored, _ = mgr.restore(3, _tree(1))
    assert torch.equal(restored["a"], want)


def test_restore_with_placement_fn(tmp_path):
    """The elastic analog: each host array is placed by the caller's
    function (here: as float64 tensors), whatever the saved leaves were."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    seen = []

    def place(host, like):
        seen.append((host.shape, like.dtype))
        return torch.from_numpy(host).to(torch.float64)
    restored, _ = mgr.restore(1, t, placement_fn=place)
    assert restored["a"].dtype == torch.float64
    np.testing.assert_array_equal(restored["a"].numpy(), t["a"].numpy())
    assert [s for s, _ in seen] == [x.shape for x in tree.leaves(t)]


def test_default_placement_follows_like(tmp_path):
    """By default a leaf goes back to the ``like`` leaf's dtype (and
    device): int32 stays int32, a float32 like narrows nothing."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(2, t)
    like = tree.tree_map(lambda x: torch.empty_like(x), t)
    restored, _ = mgr.restore(2, like)
    _assert_same(t, restored)


def test_train_state_tree_roundtrips(tmp_path):
    """(params, AdamWState) with nested dicts, a list of layers and the 0-d
    int32 step: structure, dtypes and values come back."""
    params = {"embed": torch.randn(6, 4), "layers": [
        {"attn": {"wq": torch.randn(4, 4)}, "ln1": {"scale": torch.ones(4)}}
        for _ in range(2)], "final_norm": {"scale": torch.ones(4)}}
    opt = adamw_init(params)
    opt = AdamWState(step=opt.step + 5, mu=opt.mu, nu=opt.nu)
    opt.mu["layers"][1]["attn"]["wq"].fill_(0.25)
    state = (params, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, state, {"next_step": 5})
    (p2, o2), extra = mgr.restore(5, state)
    assert isinstance(o2, AdamWState) and o2.step.shape == ()
    assert o2.step.dtype == torch.int32 and int(o2.step) == 5
    assert isinstance(p2["layers"], list) and extra == {"next_step": 5}
    _assert_same(state, (p2, o2))


def test_bf16_leaves_stored_widened(tmp_path):
    """numpy has no bfloat16: a bf16 leaf is saved as float32 (exact), the
    metadata says so, and a bf16 like leaf gets it back bit for bit."""
    t = {"w": torch.randn(33, generator=torch.Generator().manual_seed(3)
                          ).to(torch.bfloat16), "n": torch.ones(2)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, t)
    with np.load(mgr._path(1)) as z:
        assert z["leaf_1"].dtype == np.float32      # sorted keys: n, w
        assert '"leaf_1": "bfloat16"' in str(z["__meta__"])
    restored, _ = mgr.restore(1, t)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       t["w"].view(torch.int16))


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="holds 4 leaves"):
        mgr.restore(1, {"a": torch.zeros(1)})


def test_leaf_order_is_the_reference_order():
    """``repro_torch.tree`` flattens as ``jax.tree`` does (sorted dict keys,
    list order, NamedTuple fields; None is empty), so ``leaf_i`` names the
    same leaf in both packages' checkpoints."""
    from repro.optim import AdamWState as JState
    shape = {"z": [1, 2, {"y": 3, "b": None, "a": 4}], "c": (5, 6),
             "m": AdamWState(step=7, mu={"q": 8, "p": 9}, nu=[10])}
    jshape = {"z": [1, 2, {"y": 3, "b": None, "a": 4}], "c": (5, 6),
              "m": JState(step=7, mu={"q": 8, "p": 9}, nu=[10])}
    flat, treedef = tree.flatten(shape)
    assert flat == jax.tree.leaves(jshape)
    rebuilt = tree.unflatten(treedef, [x * 10 for x in flat])
    assert rebuilt["m"].mu == {"p": 90, "q": 80} and rebuilt["z"][2]["b"] is None
    assert isinstance(rebuilt["m"], AdamWState) and rebuilt["c"] == (50, 60)


# ------------------------------------------------------- fault-tolerant loop


def _counter_loop(tmp_path, inject=None, cfg=None):
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def step(state, batch):
        return state + batch, {"loss": float(state)}

    return FaultTolerantLoop(step, mgr,
                             cfg or LoopConfig(ckpt_every=5, max_retries=1),
                             inject_failure=inject), mgr


def test_loop_runs_and_checkpoints(tmp_path):
    loop, mgr = _counter_loop(tmp_path)
    state = loop.run(torch.tensor(0.0), lambda s: 1.0, 12)
    assert float(state) == 12.0
    assert mgr.latest_step() == 12


def _failing(fails):
    def inject(step):
        if fails.get(step, 0) > 0:
            fails[step] -= 1
            return True
        return False
    return inject


def test_loop_recovers_from_injected_failure(tmp_path):
    # step 7 fails 3 times -> exceeds retries -> restore from step 5
    loop, mgr = _counter_loop(tmp_path, _failing({7: 3}))
    state = loop.run(torch.tensor(0.0), lambda s: 1.0, 12)
    assert float(state) == 12.0      # deterministic despite failure/restore
    assert loop.stats.retries >= 2 and loop.stats.restores == 1


def test_loop_matches_reference_loop(tmp_path):
    """The same counter step, failures and schedule through the reference's
    loop and the port's: the same final state, retries and checkpoints."""
    fails = {3: 1, 7: 3, 11: 2}
    loop, mgr = _counter_loop(tmp_path / "port", _failing(dict(fails)))
    jmgr = JManager(str(tmp_path / "ref"), keep=3)
    jloop = JLoop(lambda s, b: (s + b, {}), jmgr,
                  JLoopConfig(ckpt_every=5, max_retries=1),
                  inject_failure=_failing(dict(fails)))
    got = loop.run(torch.tensor(0.0), lambda s: float(s % 3), 14)
    want = jloop.run(jnp.float32(0.0), lambda s: float(s % 3), 14)
    assert float(got) == float(want)
    assert loop.stats.retries == jloop.stats.retries
    assert mgr.all_steps() == jmgr.all_steps()


def test_loop_resume_from_checkpoint(tmp_path):
    loop, mgr = _counter_loop(tmp_path)
    loop.run(torch.tensor(0.0), lambda s: 1.0, 10)
    # new loop instance (simulated process restart)
    loop2, _ = _counter_loop(tmp_path)
    state, start = loop2.maybe_resume(torch.tensor(0.0))
    assert start == 10 and loop2.stats.resumed_from == 10
    state = loop2.run(state, lambda s: 1.0, 15, start_step=start)
    assert float(state) == 15.0


def test_hard_failure_without_checkpoint_raises(tmp_path):
    loop, _ = _counter_loop(tmp_path, _failing({2: 5}))
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        loop.run(torch.tensor(0.0), lambda s: 1.0, 4)


def test_straggler_watchdog(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def step(state, batch):
        if 8 <= batch < 10:
            time.sleep(0.05)
        return state + 1, {}

    loop = FaultTolerantLoop(step, mgr, LoopConfig(
        ckpt_every=100, straggler_factor=3.0, straggler_window=8,
        straggler_patience=2))
    loop.run(torch.tensor(0.0), lambda s: s, 12)
    assert loop.stats.straggler_events >= 1
    # two slow steps in a row (patience 2): a checkpoint for eviction
    assert 9 in mgr.all_steps()
