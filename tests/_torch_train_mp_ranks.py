"""The ranks' side of ``test_torch_train_mp.py``: spawned by
``repro_torch.launch.mesh.spawn`` on a (data, model) training mesh, so it
imports nothing of JAX."""
import dataclasses

import torch

from repro_torch.checkpoint import ShardedCheckpointManager
from repro_torch.configs import get_tiny
from repro_torch.models import moe
from repro_torch.optim import adamw_init
from repro_torch.runtime import steps
from repro_torch.runtime.sharding import TrainLayout
from repro_torch.tree import tree_map


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _steps(step_fn, state, batches):
    """``state`` through ``batches`` -> (state, each step's metrics)."""
    params, opt = state
    metrics = []
    for b in batches:
        params, opt, m = step_fn(params, opt, {"tokens": torch.from_numpy(b)})
        metrics.append({k: float(v) for k, v in m.items()})
    return (params, opt), metrics


def config(arch: str, layers: int, moe_kw: dict | None = None):
    """``arch``'s tiny config cut to ``layers``, its MoE fields replaced
    by ``moe_kw``."""
    cfg = get_tiny(arch).with_(n_layers=layers)
    if moe_kw:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


def run(mesh, job: dict):
    """The train steps of ``job["arch"]``'s tiny config (cut to
    ``job["layers"]``, MoE fields from ``job.get("moe")``) from
    ``job["params"]`` over ``job["batches"]`` on the mesh -> each step's
    metrics, the MoE's dropped assignments on this rank (``dropped``, the
    recompute's included) and, on rank 0, the full params and moments
    gathered (numpy).  With ``job["ckpt"]`` (two directories): save the
    state at ``job["save_at"]`` to the first, go on to the end, restore it
    and replay the rest; then restore the one-device checkpoint in the
    second at ``job["restore_at"]`` and run from there."""
    cfg = config(job["arch"], job["layers"], job.get("moe"))
    layout = TrainLayout(cfg, mesh)
    step_fn = steps.make_train_step(cfg, mesh=mesh, **job["kw"])
    shards = layout.shard(job["params"])
    state = (shards, adamw_init(shards))
    batches = job["batches"]
    out = {}
    if "ckpt" not in job:
        dropped = torch.zeros((), dtype=torch.int64)
        with moe.count_overflow(dropped):
            state, out["metrics"] = _steps(step_fn, state, batches)
        out["dropped"] = int(dropped)
    else:
        mine, ones = job["ckpt"]
        k = job["save_at"]
        state, first = _steps(step_fn, state, batches[:k])
        mgr = ShardedCheckpointManager(mine, layout)
        mgr.save(k, state, {"next_step": k})
        state, rest = _steps(step_fn, state, batches[k:])
        out["metrics"] = first + rest
        back, extra = mgr.restore(k, state)
        _, out["replayed"] = _steps(step_fn, back, batches[extra["next_step"]:])
        r = job["restore_at"]
        back, _ = ShardedCheckpointManager(ones, layout).restore(r, state)
        _, out["from_one_device"] = _steps(step_fn, back, batches[r:])
    full = layout.gather_state(state)
    return out if mesh.rank else dict(out, state=_numpy(full))


def run_all(mesh, jobs: list) -> list:
    """``run`` for each of ``jobs`` in turn."""
    return [run(mesh, job) for job in jobs]
