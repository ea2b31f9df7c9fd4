"""Streaming client for the front door, standard library only (port of
``repro/serve/frontdoor/client.py``).

``stream_generate`` opens one ``POST /v1/generate`` and yields the SSE
``(event, data)`` pairs as they arrive: ``token`` events while the engine
decodes, then one ``done`` (or ``error``).  The module's CLI streams one
generation from a running server and exits non-zero unless it saw at least
one token event and a ``done``:

    python -m repro_torch.serve.frontdoor.client --port 8080
"""
from __future__ import annotations

import argparse
import http.client
import json
import sys
from typing import Iterator, Optional, Tuple

from .sse import iter_events


def stream_generate(host: str, port: int, *,
                    prompt: Optional[str] = None,
                    tokens: Optional[list] = None,
                    max_new: int = 16,
                    tenant: str = "default",
                    priority: int = 0,
                    weight: float = 1.0,
                    timeout: float = 120.0,
                    **extra) -> Iterator[Tuple[str, dict]]:
    """POST one generation request and yield its SSE events as parsed
    ``(event, data)`` pairs.  Exactly one of ``prompt`` / ``tokens``."""
    body = {"max_new": max_new, "tenant": tenant, "priority": priority,
            "weight": weight, **extra}
    if tokens is not None:
        body["tokens"] = [int(t) for t in tokens]
    elif prompt is not None:
        body["prompt"] = prompt
    else:
        raise ValueError("need prompt= or tokens=")
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(
                f"HTTP {resp.status}: {resp.read().decode(errors='replace')}")
        lines = (raw.decode("utf-8", errors="replace")
                 for raw in iter(resp.readline, b""))
        yield from iter_events(lines)
    finally:
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Stream one generation from a running front door.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--prompt", default="the quick brown fox")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--tenant", default="default")
    ap.add_argument("--priority", type=int, default=0)
    args = ap.parse_args(argv)

    n_tokens, done = 0, False
    for event, data in stream_generate(
            args.host, args.port, prompt=args.prompt, max_new=args.max_new,
            tenant=args.tenant, priority=args.priority):
        if event == "token":
            n_tokens += 1
            print(f"token[{n_tokens}] {data.get('token')} "
                  f"{data.get('text')!r}", flush=True)
        elif event == "done":
            done = True
            print(f"done: {data.get('n_tokens')} tokens, "
                  f"ttft={data.get('ttft_s', 0):.3f}s, "
                  f"preemptions={data.get('preemptions')}, "
                  f"text={data.get('text')!r}", flush=True)
        else:
            print(f"{event}: {data}", flush=True)
    ok = done and n_tokens >= 1
    print(f"client: {'OK' if ok else 'FAIL'} "
          f"({n_tokens} token events, done={done})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
