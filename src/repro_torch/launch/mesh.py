"""Tensor-parallel groups on ``torch.distributed`` (port of
``repro/launch/mesh.py``).  Functions only: importing this module starts
nothing.

``make_host_mesh(tp, ...)`` is the counterpart of the reference's
``make_host_mesh``: where the reference splits one process's devices into
a ``("data", "model")`` mesh, the port joins ``tp`` processes, one per
rank, into a ``runtime.tp.TPGroup``.  The backend follows the device:
gloo for CPU tensors, NCCL for one card per rank (rank r on ``cuda:r``).
A caller may name the backend: the one-card parity run puts every rank on
``cuda:0`` with ``backend="gloo"``, whose gathers go through the host
(NCCL will not put two ranks on one card).  ``spawn`` starts the ranks
and joins them through a ``file://`` rendezvous in a fresh temporary
directory, so concurrent runs (parallel test workers) never share a port.

``make_production_mesh`` is the dry-run's mesh (``launch/dryrun.py``): an
abstract ``ProductionMesh`` of axis names and sizes that touches no device
and joins no process, the attributes the sharding rules read
(``runtime/sharding.py``).  The reference's is a 16 x 16 TPU pod (256
chips; 2 x 16 x 16 for two pods), whose model axis of 16 runs over the
pod's torus.  An H100 node joins 8 GPUs all to all over NVLink and nodes
over InfiniBand, so the port keeps the reference's 256 and 512 chips but
lays them out as (data 32, model 8) and (pod 2, data 32, model 8): 32 or
64 eight-GPU nodes, with the tensor-parallel model axis inside one node's
NVLink domain.  A model axis of 16 would put every TP gather across
InfiniBand, about a ninth of NVLink's rate (``launch/roofline.py``).
"""
from __future__ import annotations

import dataclasses
import datetime
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.runtime.tp import TPGroup

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 600.0        # a collective's wait, and a spawned run's


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """An abstract device mesh: ``axis_names`` in order, ``shape`` each
    axis's size (the fields of a ``jax.sharding.Mesh`` the rules read).
    ``name`` is its label in the dry-run's records, ``size`` its chips."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """(data 32, model 8): 256 H100s as 32 NVLink nodes of 8; with
    ``multi_pod`` (pod 2, data 32, model 8): 512 (see the module
    docstring for why not the reference's 16 x 16)."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 32, 8))
    return ProductionMesh(("data", "model"), (32, 8))


def resolve_backend(tp: int, backend: str | None, device) -> str | None:
    """The backend a ``tp``-rank group on ``device`` uses (None at tp 1):
    gloo on the CPU, NCCL on the card unless ``backend`` names one.
    Raises ValueError for tp < 1, an unknown backend, NCCL on the CPU, and
    NCCL with fewer than ``tp`` cards."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    if tp == 1:
        return None
    dev = torch.device(device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        n = torch.cuda.device_count()
        if n < tp:
            raise ValueError(f"tp={tp} over nccl needs {tp} cards, one per "
                             f"rank; this host has {n}")
    return backend


def make_host_mesh(tp: int = 1, *, rank: int = 0,
                   init_method: str | None = None,
                   backend: str | None = None, device=None) -> TPGroup:
    """Build (tp 1) or join (tp > 1, as rank ``rank``) a TP group of
    ``tp`` ranks.  ``device`` is the ranks' device, CUDA unless ``"cpu"``;
    under NCCL rank r runs on ``cuda:r``.  ``init_method`` is the
    rendezvous every rank names (``spawn`` makes one).  Collectives wait
    at most TIMEOUT_S."""
    dev = resolve_device(device)
    backend = resolve_backend(tp, backend, dev)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} is not in [0, {tp})")
    if tp == 1:
        return TPGroup(rank=0, size=1, backend=None, device=dev)
    if init_method is None:
        raise ValueError("tp > 1 needs init_method, the ranks' rendezvous")
    import torch.distributed as dist
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=tp,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    pg = dist.group.WORLD
    ctrl = pg if backend == "gloo" else dist.new_group(backend="gloo")
    return TPGroup(rank=rank, size=tp, backend=backend, device=dev, pg=pg,
                   ctrl=ctrl)


def _rank_main(fn, rank, tp, init_method, backend, device, threads,
               results, args):
    """A spawned rank: join the group, run ``fn(group, *args)``, report."""
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        group = make_host_mesh(tp, rank=rank, init_method=init_method,
                               backend=backend, device=device)
        try:
            out = fn(group, *args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:    # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def _report(results, procs, out: dict, deadline: float):
    """The next rank's report, waiting up to a second (``queue.Empty`` if
    none came).  Raises if a rank exited without one (a report is flushed
    before its rank exits) or the deadline passed."""
    try:
        return results.get(timeout=1.0)
    except queue.Empty:
        dead = [r for r, p in enumerate(procs)
                if r not in out and p.exitcode is not None]
        if dead:
            try:
                return results.get(timeout=5.0)
            except queue.Empty:
                raise RuntimeError(
                    f"rank {dead[0]} exited with code "
                    f"{procs[dead[0]].exitcode} and no report") from None
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(procs)} ranks did not finish in "
                               f"{TIMEOUT_S} s (reported: {sorted(out)})"
                               ) from None
        raise


def spawn(fn: Callable, tp: int, *args, backend: str | None = None,
          device=None, threads: int | None = None) -> list:
    """``fn(group, *args)`` on ``tp`` fresh processes, one per rank, joined
    in one TP group; returns each rank's result in rank order.  ``fn`` and
    ``args`` are pickled (tensors through shared memory), so ``fn`` must
    be importable.  ``threads`` sets each rank's intra-op threads.  Raises
    if a rank fails (with its traceback) or the run outlasts TIMEOUT_S;
    every process is stopped either way."""
    if tp < 2:
        raise ValueError(f"spawn needs tp >= 2, got {tp}")
    resolve_backend(tp, backend, resolve_device(device))
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main, args=(
                     fn, r, tp, init, backend, device, threads, results,
                     args), daemon=True) for r in range(tp)]
        for p in procs:
            p.start()
        try:
            out: dict[int, object] = {}
            deadline = time.monotonic() + TIMEOUT_S
            while len(out) < tp:
                try:
                    rank, ok, value = _report(results, procs, out, deadline)
                except queue.Empty:
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(tp)]
