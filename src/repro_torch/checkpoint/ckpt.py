"""Fault-tolerant checkpointing (port of ``repro/checkpoint/ckpt.py``).

Design (numpy .npz per step, no external deps), as the reference's:
  * atomic: write to <dir>/tmp.<step>.<pid>, fsync, rename -- a crash
    mid-write can never corrupt the latest checkpoint;
  * keep-N GC with a protected "milestone" stride;
  * resume: ``latest_step()`` scans the directory, ``restore`` rebuilds the
    tree of ``like``'s structure;
  * leaves are saved as host numpy in the flatten order of the port's trees
    (``repro_torch.tree``: dict keys sorted, then list order, then a
    ``NamedTuple``'s fields), so ``restore(..., placement_fn)`` can put each
    one anywhere: ``placement_fn(host_array, like_leaf)`` is the port's
    counterpart of the reference's elastic ``sharding_fn``.  By default a
    leaf goes back to ``like_leaf``'s device and dtype;
  * numpy has no bfloat16, so a bf16 leaf is stored widened to float32
    (exact) and the metadata names it; restoring onto a bf16 ``like`` leaf
    narrows it back, bit for bit;
  * async mode: the device -> host copy happens in ``save`` (the port's
    train step updates params in place, so the copy must be taken before
    the next step), the serialize + write on a background thread, with a
    barrier (``wait``) before the next save;
  * a model-parallel run (``ShardedCheckpointManager``) writes the same
    one-device format: every rank gathers the full state from the shards,
    rank 0 writes it, and a restore gives every rank its own shards of the
    full leaves, so a checkpoint moves between meshes of any shape.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _to_host(leaf) -> tuple[np.ndarray, Optional[str]]:
    """(a host copy of ``leaf``, the dtype it was widened from or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.to(device="cpu", dtype=torch.float32).numpy(), "bfloat16"
        return t.to("cpu", copy=True).numpy(), None
    return np.array(leaf), None


def _place(host: np.ndarray, like):
    """The default placement: ``like``'s device and dtype for a tensor
    leaf, a CPU tensor otherwise."""
    t = torch.from_numpy(host)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, milestone_every: int = 0,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.milestone_every = milestone_every
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def all_steps(self) -> list[int]:
        steps = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                try:
                    steps.append(int(f[5:-4]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -------------------------------------------------------------- save
    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Copy the tree's leaves to the host and write them atomically."""
        self.wait()
        leaves, treedef = flatten(tree)
        host, widened = {}, {}
        for i, leaf in enumerate(leaves):
            host[f"leaf_{i}"], wide = _to_host(leaf)
            if wide:
                widened[f"leaf_{i}"] = wide
        meta = {"step": step, "treedef": repr(treedef),
                "widened": widened, "extra": extra or {}, "time": time.time()}

        def _write():
            tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
            with open(tmp, "wb") as f:
                np.savez(f, __meta__=json.dumps(meta), **host)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self._path(step))
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _gc(self) -> None:
        steps = self.all_steps()
        protected = set(steps[-self.keep:])
        if self.milestone_every:
            protected |= {s for s in steps if s % self.milestone_every == 0}
        for s in steps:
            if s not in protected:
                try:
                    os.remove(self._path(s))
                except OSError:
                    pass

    # ------------------------------------------------------------ restore
    def restore(self, step: int, like: Any,
                placement_fn: Optional[Callable[[np.ndarray, Any], Any]] = None
                ) -> tuple[Any, dict]:
        """Rebuild the tree of ``like``'s structure from checkpoint ``step``
        -> (tree, the ``extra`` dict saved with it).

        ``placement_fn(host_array, like_leaf) -> leaf`` places each leaf
        (default: onto ``like_leaf``'s device and dtype)."""
        place = placement_fn or _place
        leaves_like, treedef = flatten(like)
        with np.load(self._path(step), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            n_saved = len(z.files) - 1
            if n_saved != len(leaves_like):
                raise ValueError(
                    f"checkpoint {step} holds {n_saved} leaves, the tree to "
                    f"restore has {len(leaves_like)}")
            out = [place(z[f"leaf_{i}"], ll)
                   for i, ll in enumerate(leaves_like)]
        return unflatten(treedef, out), meta["extra"]


class ShardedCheckpointManager(CheckpointManager):
    """``CheckpointManager`` for one rank of a model-parallel run: the state
    is the rank's ``(params, AdamWState)`` of shards, ``layout`` a
    ``runtime/sharding.TrainLayout``.  ``save`` is collective (every rank
    calls it): the full state is gathered, rank 0 writes it synchronously
    in the one-device format and every rank waits for the write.
    ``restore`` reads the full leaves on the host and keeps the rank's
    shards of them, on its device."""

    def __init__(self, directory: str, layout, keep: int = 3,
                 milestone_every: int = 0):
        super().__init__(directory, keep, milestone_every, async_write=False)
        self.layout = layout

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        full = self.layout.gather_state(tree)
        if self.layout.mesh.rank == 0:
            super().save(step, full, extra)
        del full
        self.layout.mesh.barrier()

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        params, opt = like
        full_like = (self.layout.full_like(params),
                     opt._replace(mu=self.layout.full_like(opt.mu),
                                  nu=self.layout.full_like(opt.nu)))
        host, extra = super().restore(
            step, full_like, lambda a, ll: torch.from_numpy(a).to(ll.dtype))
        mine = self.layout.shard_state(host)
        leaves_like = flatten(like)[0]
        out, treedef = flatten(mine)
        return unflatten(treedef, [
            t.to(ll.device) for t, ll in zip(out, leaves_like)]), extra
