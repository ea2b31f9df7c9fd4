"""Streaming front door over the paged serving engine (port of
``repro/serve/frontdoor``).

``scheduler`` — ``Scheduler``: per-tenant priority admission queues with
                weighted fair sharing, drop-and-replay preemption of the
                engine's in-flight requests, and an SLO controller that
                holds chunked prefill (with hysteresis) while the decode
                gap's p95 is past a target.
``server``    — ``FrontDoor``: asyncio HTTP server with ``POST
                /v1/generate`` streaming tokens as SSE (plus ``/healthz``
                and ``/v1/stats``), the engine and scheduler driven on one
                background thread.
``sse``       — the Server-Sent-Events wire format (encode, incremental
                parse), shared by server and client.
``client``    — standard-library streaming client (``stream_generate``)
                and a small CLI (``python -m
                repro_torch.serve.frontdoor.client``).
"""
from .scheduler import SchedConfig, Scheduler
from .server import FrontDoor
from .sse import encode_event, iter_events

__all__ = ["SchedConfig", "Scheduler", "FrontDoor", "encode_event",
           "iter_events"]
