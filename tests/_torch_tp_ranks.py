"""The ranks' side of ``test_torch_tp.py`` and of the front door's TP CLI
cases in ``test_torch_frontdoor.py``: spawned by
``repro_torch.launch.mesh.spawn``, so it imports nothing of JAX."""
import functools
import http.client
import json
import threading
import time

import torch

from repro_torch.launch import serve
from repro_torch.runtime.compression import int8_psum
from repro_torch.serve.frontdoor import SchedConfig
from repro_torch.serve.frontdoor.client import stream_generate

PACE_S = 0.01     # the driver's pause between ticks until the preemption


def rank_main(group, jobs: list, psum_cases, doors: list):
    """Serve ``jobs`` over ``group`` (rank 0 returns their tokens and
    stats), ``int8_psum`` each case's slice of this rank, then serve each
    of ``doors`` through the front door (``serve.frontdoor_rank``; rank 0
    streams its traffic, ``_traffic``)."""
    served = serve.serve_rank(group, jobs)
    summed = [int8_psum(torch.from_numpy(case[group.rank]), group.pg).numpy()
              for case in psum_cases]
    streamed = [serve.frontdoor_rank(group, door["job"], SchedConfig(), 0,
                                     functools.partial(_traffic, door))
                for door in doors]
    return {"served": served, "int8_psum": summed,
            "frontdoor": None if group.rank else streamed}


def _stream(port: int, req: dict, record: dict) -> None:
    """One streaming client: its events (or the exception it met) go to
    ``record[req["rid"]]``."""
    try:
        record[req["rid"]] = list(stream_generate(
            "127.0.0.1", port, tokens=req["prompt"], max_new=req["max_new"],
            tenant=req["tenant"], priority=req["priority"], timeout=120.0))
    except Exception as exc:                              # noqa: BLE001
        record[req["rid"]] = repr(exc)


class _PacedLock:
    """The front door's lock, the same underlying lock: until ``done()``,
    the driver thread pauses PACE_S after each release, outside the lock.
    On a loaded host the driver takes the lock again right after each
    tick, and the late request's submit, which waits for it, may find
    the slots freed by then; paced, it is queued within a tick."""

    def __init__(self, lock, done):
        self._lock, self._done = lock, done

    def __enter__(self):
        self._lock.acquire()

    def __exit__(self, *exc):
        self._lock.release()
        if (threading.current_thread().name == "frontdoor-driver"
                and not self._done()):
            time.sleep(PACE_S)


def _traffic(door_spec: dict, door) -> dict:
    """Rank 0's clients: ``early`` streams at once; once every slot
    decodes, ``late`` (a higher priority: it preempts one) and ``rest``;
    then, after ``idle_s`` with nothing to serve, ``after``.  The driver
    is paced (``_PacedLock``) until the preemption.  Returns each
    stream's events by rid, /v1/stats before and after the idle, and the
    idle's seconds."""
    engine, sched = door.engine, door.scheduler
    door._lock = _PacedLock(door._lock, lambda: sched.stats["preempted"])
    record: dict = {}

    def start(reqs):
        threads = [threading.Thread(target=_stream,
                                    args=(door.port, r, record))
                   for r in reqs]
        for t in threads:
            t.start()
        return threads
    clients = start(door_spec["early"])
    deadline = time.monotonic() + 60
    while (engine.active_count < engine.pool.max_slots
           and time.monotonic() < deadline):
        time.sleep(0.001)
    clients += start([door_spec["late"]]) + start(door_spec["rest"])
    for t in clients:
        t.join()
    out = {"stats": _stats(door.port)}
    if door_spec.get("after"):
        t0 = time.monotonic()
        time.sleep(door_spec["idle_s"])
        out["idle_s"] = time.monotonic() - t0
        for t in start([door_spec["after"]]):
            t.join()
        out["stats_after"] = _stats(door.port)
    out["record"] = record
    return out


def _stats(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def failing_frontdoor_rank(group, *args):
    """``serve.frontdoor_rank`` with every decode step on rank 0 raising:
    the CLI's driver failure under TP."""
    if group.rank == 0:
        def boom(self, *a):
            raise RuntimeError("injected engine failure")
        serve.PagedServer._decode_once = boom
    return serve.frontdoor_rank(group, *args)
