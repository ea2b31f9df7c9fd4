"""Asyncio HTTP/SSE front door over the paged engine (port of
``repro/serve/frontdoor/server.py``).

Written on ``asyncio.start_server``, no web framework.  One connection
carries one HTTP/1.1 request (``Connection: close``):

  ``POST /v1/generate``  JSON body -> per-token SSE stream (or one JSON
                         response with ``"stream": false``)
  ``GET  /healthz``      liveness probe
  ``GET  /v1/stats``     engine and scheduler counters

Threads: the asyncio event loop owns the sockets and does no CUDA work.
The engine and the scheduler live on ONE driver thread, which ticks the
scheduler whenever there is work, so every CUDA graph is captured and
replayed there.  The driver runs in a copy of the context of the thread
that called ``serve_forever``, so a scoped switch entered around it
(``graphs.eager()``, a forced plain path) holds in the driver too; the
engine enters its own fusion and paged-attention settings in every step.
The bridges between the threads are explicit and small:

- submit: the HTTP handler builds a ``Request`` whose ``on_token`` closure
  posts ``(event, data)`` onto that stream's ``asyncio.Queue`` with
  ``loop.call_soon_threadsafe``, then hands it to the scheduler under
  ``self._lock`` and wakes the driver; ``_lock`` serializes ``submit``,
  ``cancel`` and the stats read against ``tick`` and the engine's
  ``keepalive``.  Under tensor parallelism (an engine over a
  ``runtime.tp.TPGroup``, rank 0 of it) every message to the workers is
  sent under the lock: the ticks' device ops and, while the server idles,
  the heartbeat that keeps the workers from timing out; ``cancel`` and
  preemption change host state only.
- completion: the driver posts the terminal ``done`` (or ``error``) event
  the same way.
- disconnect: a failed SSE write cancels the request through the
  scheduler, so an abandoned stream stops holding pool capacity.

Every generation streams ``event: token`` frames (``{"rid", "token",
"text", "t"}``) and ends with ``event: done`` (``{"rid", "tokens", "text",
"ttft_s", "n_tokens", "preemptions", "tenant"}``).  Preemption shows in the
stream only as a pause: tokens already streamed are never sent again (the
engine re-feeds them as prompt on replay and emits only new ones).

Two deliberate divergences from the reference.  An engine failure in the
driver thread ends the server with an error: every open stream gets an
``error`` event, the listener closes, and ``serve_forever`` raises, so the
CLI exits non-zero (the reference's returns normally and its CLI exits 0).
Prompt tokens outside ``[0, vocab)`` are refused with a 400 at the HTTP
boundary instead of reaching the embedding on the driver thread.
"""
from __future__ import annotations

import asyncio
import contextlib
import contextvars
import itertools
import json
import signal
import sys
import threading
import time
import traceback

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer

from ..engine import Request
from .scheduler import SchedConfig, Scheduler
from .sse import encode_event

_MAX_BODY = 1 << 20      # 1 MiB request-body cap


def _json_default(o):
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def _http_response(status: str, body: bytes, ctype: str = "application/json"
                   ) -> bytes:
    return (f"HTTP/1.1 {status}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


def _sse_headers() -> bytes:
    return (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")


class FrontDoor:
    """The streaming HTTP server that owns a ``PagedServer`` and a
    ``Scheduler``.

    ``tokenize`` / ``detokenize`` translate between request-body strings
    and model tokens; they default to ``ByteTokenizer`` over the engine's
    vocab.  ``port=0`` binds an ephemeral port; the chosen one is printed as
    ``frontdoor listening on HOST:PORT`` and stored on ``self.port``, and
    ``ready`` is set.  ``serve_forever`` runs in any thread; ``stop()``
    (from any thread) or, in the main thread, SIGINT / SIGTERM ends it
    cleanly.
    """

    def __init__(self, engine, cfg: SchedConfig | None = None, *,
                 host: str = "127.0.0.1", port: int = 8080,
                 tokenize=None, detokenize=None):
        self.engine = engine
        self.scheduler = Scheduler(engine, cfg)
        self.host, self.port = host, port
        tok = ByteTokenizer(engine.cfg.vocab)
        self.tokenize = tokenize or tok.encode
        self.detokenize = detokenize or (
            lambda ids: tok.decode(np.asarray(ids, np.int32)))
        self._rids = itertools.count()
        self._lock = threading.Lock()        # scheduler + engine state
        self._watchers: dict[int, asyncio.Queue] = {}
        self._wake = threading.Event()       # driver: new work submitted
        self._stopping = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self.ready = threading.Event()       # listening; ``port`` is set
        self.failure: BaseException | None = None   # the driver's, if any

    # -------------------------------------------------------- driver thread

    def _post(self, q: asyncio.Queue, item) -> None:
        self._loop.call_soon_threadsafe(q.put_nowait, item)

    def _drive(self) -> None:
        """The serving loop: tick the scheduler while there is work, sleep
        on the wake event while there is none.  An exception here ends the
        server (the engine's state cannot be trusted after it): every open
        stream gets an ``error`` event, and ``serve_forever`` raises."""
        self.engine.start_clock()
        try:
            while not self._stopping.is_set():
                with self._lock:
                    busy = self.scheduler.has_work()
                    finished = self.scheduler.tick() if busy else {}
                    done_watch = [(self._watchers.pop(rid, None), res)
                                  for rid, res in finished.items()]
                    # a tensor-parallel engine's heartbeat to its workers
                    # when it has sent them nothing for a while (idle)
                    self.engine.keepalive()
                for q, res in done_watch:
                    if q is not None:
                        self._post(q, ("done", self._done_payload(res)))
                if busy:
                    # yield between ticks: a handler blocked on the lock
                    # gets it before the next tick takes it again
                    time.sleep(0)
                else:
                    self._wake.wait(0.02)
                    self._wake.clear()
        except Exception as exc:                          # noqa: BLE001
            traceback.print_exc()
            self.failure = exc
            with self._lock:
                watchers, self._watchers = dict(self._watchers), {}
            for q in watchers.values():
                self._post(q, ("error", {"error": "engine failure"}))
            self._stopping.set()

    def _done_payload(self, res) -> dict:
        toks = [int(t) for t in res.tokens]
        return {"rid": res.rid, "tokens": toks, "text": self.detokenize(toks),
                "n_tokens": len(toks), "ttft_s": float(res.ttft_s),
                "preemptions": int(res.preemptions), "tenant": res.tenant}

    # --------------------------------------------------------- HTTP parsing

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            clen = int(headers.get("content-length", 0) or 0)
            if clen > _MAX_BODY:
                writer.write(_http_response(
                    "413 Payload Too Large",
                    b'{"error": "request body too large"}'))
                return
            body = await reader.readexactly(clen) if clen else b""
            if method == "POST" and path == "/v1/generate":
                await self._generate(body, writer)
            elif method == "GET" and path == "/healthz":
                writer.write(_http_response("200 OK", b'{"ok": true}'))
            elif method == "GET" and path == "/v1/stats":
                writer.write(_http_response("200 OK", self._stats_body()))
            else:
                writer.write(_http_response(
                    "404 Not Found", b'{"error": "no such route"}'))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    def _stats_body(self) -> bytes:
        with self._lock:
            stats = dict(self.engine.finalize_stats())
            sched = dict(self.scheduler.stats)
            snap = {"engine": stats, "scheduler": sched,
                    "queued": self.scheduler.queued(),
                    "slo_throttled": self.scheduler.throttled,
                    "slo_last_p95_ms": self.scheduler.last_p95_ms}
        # the raw per-step lists are internal accounting, not API surface
        snap["engine"].pop("occupancy", None)
        snap["engine"].pop("decode_gap_s", None)
        return json.dumps(snap, default=_json_default).encode()

    # ----------------------------------------------------------- generation

    def _build_request(self, spec: dict, q: asyncio.Queue) -> Request:
        if "tokens" in spec:
            prompt = np.asarray(spec["tokens"], np.int32)
        elif "prompt" in spec:
            prompt = np.asarray(self.tokenize(str(spec["prompt"])), np.int32)
        else:
            raise ValueError('body needs "prompt" (string) or "tokens"')
        vocab = self.engine.cfg.vocab
        if prompt.ndim != 1 or ((prompt < 0) | (prompt >= vocab)).any():
            raise ValueError(f"prompt tokens must be a list of ids in "
                             f"[0, {vocab})")
        rid = next(self._rids)
        detok = self.detokenize

        def on_token(rid_, tok, t):
            self._post(q, ("token", {"rid": rid_, "token": tok,
                                     "text": detok([tok]), "t": t}))

        return Request(
            rid=rid, prompt=prompt, max_new=int(spec.get("max_new", 16)),
            eos=spec.get("eos"), arrival=self.engine.now(),
            tenant=str(spec.get("tenant", "default")),
            priority=int(spec.get("priority", 0)),
            deadline=spec.get("deadline_s"),
            on_token=on_token if spec.get("stream", True) else None)

    async def _generate(self, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        try:
            spec = json.loads(body or b"{}")
            if not isinstance(spec, dict):
                raise ValueError("body must be a JSON object")
            q: asyncio.Queue = asyncio.Queue()
            req = self._build_request(spec, q)
            with self._lock:
                # validated under the lock, so a bad request is a 400 here
                # and never reaches the driver thread
                self.scheduler.submit(req, weight=float(spec.get("weight",
                                                                 1.0)))
                self._watchers[req.rid] = q
        except (ValueError, TypeError, KeyError, OverflowError,
                json.JSONDecodeError) as e:
            writer.write(_http_response(
                "400 Bad Request",
                json.dumps({"error": str(e)}).encode()))
            return
        self._wake.set()
        streaming = bool(spec.get("stream", True))
        if streaming:
            writer.write(_sse_headers())
            await writer.drain()
        collected: dict | None = None
        try:
            while True:
                event, data = await q.get()
                if streaming:
                    writer.write(encode_event(event, data))
                    await writer.drain()
                if event in ("done", "error"):
                    collected = data
                    break
            if not streaming:
                status = ("200 OK" if "error" not in (collected or {})
                          else "500 Internal Server Error")
                writer.write(_http_response(
                    status, json.dumps(collected,
                                       default=_json_default).encode()))
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            # the client went away mid-stream: free its pool capacity
            with self._lock:
                self._watchers.pop(req.rid, None)
                self.scheduler.cancel(req.rid)
            raise

    # -------------------------------------------------------------- running

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        print(f"frontdoor listening on {self.host}:{self.port}", flush=True)
        self.ready.set()
        # the driver sees the switches its caller entered (see the module
        # docstring); the engine enters its own settings in every step
        driver = threading.Thread(target=contextvars.copy_context().run,
                                  args=(self._drive,), daemon=True,
                                  name="frontdoor-driver")
        driver.start()
        stop = asyncio.Event()
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                with contextlib.suppress(NotImplementedError, ValueError):
                    self._loop.add_signal_handler(sig, stop.set)

        async def watch_driver():
            # stop() and a driver crash bring the listener down too
            while driver.is_alive() and not self._stopping.is_set():
                await asyncio.sleep(0.1)
            stop.set()
        watcher = asyncio.ensure_future(watch_driver())
        try:
            await stop.wait()
        finally:
            self._stopping.set()
            self._wake.set()
            watcher.cancel()
            server.close()
            await server.wait_closed()
            driver.join(timeout=30.0)
            if driver.is_alive() and self.failure is None:
                self.failure = RuntimeError("the driver did not stop")
            if self.failure is None:
                print("frontdoor shut down cleanly", flush=True)
            else:
                print("frontdoor stopped: the engine failed in the driver "
                      "thread", file=sys.stderr, flush=True)

    def stop(self) -> None:
        """Ask a running ``serve_forever`` to shut down cleanly (from any
        thread): the driver finishes its tick, the listener closes."""
        self._stopping.set()
        self._wake.set()

    def serve_forever(self) -> None:
        """Serve until ``stop()``, SIGINT or SIGTERM (in the main thread),
        then return.  After an engine failure in the driver thread it shuts
        the listener down and raises ``RuntimeError``."""
        try:
            asyncio.run(self._main())
        except KeyboardInterrupt:
            pass
        if self.failure is not None:
            raise RuntimeError("frontdoor: the engine failed in the driver "
                               "thread") from self.failure
