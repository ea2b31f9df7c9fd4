"""Server-Sent-Events wire format, shared by the front door's server and
client (port of ``repro/serve/frontdoor/sse.py``).

One event is an ``event:`` line, one or more ``data:`` lines and a blank
terminator; the payloads here are always one JSON object.  ``encode_event``
is what the server writes; ``iter_events`` is the incremental parser the
client (and the tests) read streams back through.  Lines starting with
``:`` are SSE comments (keep-alives) and are skipped.
"""
from __future__ import annotations

import json
from typing import Iterable, Iterator, Tuple


def encode_event(event: str, data: dict) -> bytes:
    """One SSE frame: ``event: <name>``, the JSON ``data``, a blank line."""
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode("utf-8")


def iter_events(lines: Iterable[str]) -> Iterator[Tuple[str, dict]]:
    """Parse a stream of text lines into ``(event, data)`` pairs.

    ``lines`` may keep or strip their newlines.  Several ``data:`` lines
    join with ``\\n`` (as the SSE spec says) before the JSON decode; an
    event with no data yields ``{}``.  The unterminated tail of a closed
    stream is dropped, as a browser's EventSource drops it.
    """
    event, datas = None, []
    for raw in lines:
        line = raw.rstrip("\r\n")
        if line == "":
            if event is not None or datas:
                payload = json.loads("\n".join(datas)) if datas else {}
                yield (event or "message", payload)
            event, datas = None, []
        elif line.startswith(":"):
            continue
        elif line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            datas.append(line[len("data:"):].strip())
