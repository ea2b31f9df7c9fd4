"""Tensor-parallel groups and training meshes on ``torch.distributed``
(port of ``repro/launch/mesh.py``).  Functions only: importing this module
starts nothing.

``make_host_mesh(tp, ...)`` is the counterpart of the reference's
``make_host_mesh``: where the reference splits one process's devices into
a ``("data", "model")`` mesh, the port joins ``tp`` processes, one per
rank, into a ``runtime.tp.TPGroup``.  The backend follows the device:
gloo for CPU tensors, NCCL for one card per rank (rank r on ``cuda:r``).
Ranks that must share a card (fewer cards than ranks) take gloo, whose
collectives go through the host: NCCL will not put two ranks on one card,
and the one-card parity runs put every rank on ``cuda:0``.  A caller may
name the backend.  ``spawn`` starts the ranks
and joins them through a ``file://`` rendezvous in a fresh temporary
directory, so concurrent runs (parallel test workers) never share a port.
``make_train_mesh(tp, dp, ...)`` joins ``dp * tp`` ranks into a (data,
model) training mesh (``runtime/sharding.TrainMesh``): rank d * tp + m
sits in the model group of row d and the data group of column m, the
reference's ("data", "model") order; ``spawn(..., dp=dp)`` starts them.
A run is bounded by TIMEOUT_S, or, for a server (``deadline_s=None``),
lives until its ranks return; the directory lives as long.  The ctrl
group, which carries rank 0's host messages, waits ``timeout_s`` for one
(TIMEOUT_S unless the caller lowers it): an idle server's rank 0 keeps it
alive with heartbeats (``serve.engine.PagedServer.keepalive``).

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

import contextlib
import dataclasses
import datetime
import os
import queue
import signal
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.runtime.sharding import TrainMesh
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
    gloo on the CPU and where ranks share a card (fewer cards than
    ranks), NCCL with a card per rank, unless ``backend`` names one.
    Raises ValueError for tp < 1, an unknown backend, NCCL on the CPU, and
    NCCL with fewer than ``tp`` cards."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    if tp == 1:
        return None
    dev = torch.device(device)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= tp else "gloo")
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
                   backend: str | None = None, device=None,
                   timeout_s: float = TIMEOUT_S) -> TPGroup:
    """Build (tp 1) or join (tp > 1, as rank ``rank``) a TP group of
    ``tp`` ranks.  ``device`` is the ranks' device, CUDA unless ``"cpu"``;
    under NCCL rank r runs on ``cuda:r``.  ``init_method`` is the
    rendezvous every rank names (``spawn`` makes one).  The gathers wait
    at most TIMEOUT_S, a host message on the ctrl group (a gloo group of
    its own) ``timeout_s``."""
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
    ctrl = dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))
    return TPGroup(rank=rank, size=tp, backend=backend, device=dev,
                   pg=dist.group.WORLD, ctrl=ctrl, ctrl_timeout_s=timeout_s)


def make_train_mesh(tp: int = 1, dp: int = 1, *, rank: int = 0,
                    init_method: str | None = None,
                    backend: str | None = None, device=None,
                    timeout_s: float = TIMEOUT_S) -> TrainMesh:
    """Build (1 x 1) or join (as rank ``rank``) a training mesh of ``dp``
    data rows by ``tp`` model columns: rank = d * tp + m.  Every rank
    creates every row's and column's group (``new_group`` is collective)
    and keeps its own two, plus a gloo ctrl group over all ranks.  Under
    NCCL rank r runs on ``cuda:r``; under gloo every rank on ``device``."""
    from repro_torch.runtime.sharding import single_mesh
    if dp < 1:
        raise ValueError(f"dp={dp} must be >= 1")
    world = tp * dp
    dev = resolve_device(device)
    backend = resolve_backend(world, backend, dev)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in [0, {world})")
    if world == 1:
        return single_mesh(dev)
    if init_method is None:
        raise ValueError("a mesh of more than one rank needs init_method, "
                         "the ranks' rendezvous")
    import torch.distributed as dist
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    d, m = divmod(rank, tp)

    def groups(members: list, mine: int, axis: str) -> TPGroup:
        pgs = [dist.new_group(ranks) if len(ranks) > 1 else None
               for ranks in members]
        size = len(members[mine])
        return TPGroup(rank=members[mine].index(rank), size=size,
                       backend=backend if size > 1 else None, device=dev,
                       pg=pgs[mine], axis=axis)
    model = groups([list(range(r * tp, (r + 1) * tp)) for r in range(dp)],
                   d, "model")
    data = groups([list(range(c, world, tp)) for c in range(tp)], m, "data")
    ctrl = dist.new_group(backend="gloo", timeout=timeout)
    return TrainMesh(dp=dp, tp=tp, data=data, model=model, ctrl=ctrl)


def _rank_main(fn, rank, tp, dp, init_method, backend, device, threads,
               timeout_s, results, args):
    """A spawned rank: join the group (a TP group, or with ``dp`` a
    training mesh), run ``fn(group, *args)``, report."""
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        if dp is None:
            group = make_host_mesh(tp, rank=rank, init_method=init_method,
                                   backend=backend, device=device,
                                   timeout_s=timeout_s)
        else:
            group = make_train_mesh(tp, dp, rank=rank,
                                    init_method=init_method,
                                    backend=backend, device=device,
                                    timeout_s=timeout_s)
        try:
            out = fn(group, *args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:    # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def _report(results, procs, out: dict, deadline: float | None):
    """The next rank's report, waiting up to a second (``queue.Empty`` if
    none came).  Raises if a rank exited without one (a report is flushed
    before its rank exits) or the deadline (None: none) passed."""
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
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"{len(procs)} ranks did not finish by their "
                               f"deadline (reported: {sorted(out)})"
                               ) from None
        raise


@contextlib.contextmanager
def _forwarding(signals, proc):
    """While inside, each of ``signals`` this process receives is sent on
    to ``proc`` instead of acting here (handlers are set from the main
    thread only)."""
    if not signals:
        yield
        return

    def forward(sig, _frame):
        if proc.pid is not None and proc.exitcode is None:
            os.kill(proc.pid, sig)
    old = {sig: signal.signal(sig, forward) for sig in signals}
    try:
        yield
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)


def spawn(fn: Callable, tp: int, *args, dp: int | None = None,
          backend: str | None = None,
          device=None, threads: int | None = None,
          timeout_s: float = TIMEOUT_S,
          deadline_s: float | None = TIMEOUT_S,
          forward_signals: tuple = ()) -> list:
    """``fn(group, *args)`` on ``tp`` fresh processes, one per rank, joined
    in one TP group, or with ``dp`` on ``dp * tp`` processes joined in a
    training mesh (``group`` is then a ``TrainMesh``); returns each rank's
    result in rank order.  ``fn`` and
    ``args`` are pickled (tensors through shared memory), so ``fn`` must
    be importable.  ``threads`` sets each rank's intra-op threads,
    ``timeout_s`` the ctrl group's wait (``make_host_mesh``).  The run
    may last ``deadline_s`` (None: until the ranks return, as a server
    does); ``forward_signals`` (e.g. SIGINT, SIGTERM) received here
    meanwhile go to rank 0 instead.  Raises if a rank fails (with its
    traceback), exits without a report or outlasts the deadline; every
    process is stopped either way."""
    world = tp * (dp or 1)
    if world < 2:
        raise ValueError(f"spawn needs at least 2 ranks, got {world}")
    resolve_backend(world, backend, resolve_device(device))
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main, args=(
                     fn, r, tp, dp, init, backend, device, threads,
                     timeout_s, results, args), daemon=True)
                 for r in range(world)]
        try:
            with _forwarding(forward_signals, procs[0]):
                for p in procs:
                    p.start()
                out: dict[int, object] = {}
                deadline = (None if deadline_s is None
                            else time.monotonic() + deadline_s)
                while len(out) < world:
                    try:
                        rank, ok, value = _report(results, procs, out,
                                                  deadline)
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
    return [out[r] for r in range(world)]
