"""Minimal asyncio HTTP/1.1 request handling (stdlib-only).
(the port's copy of ``mixlab_tpu/server/http.py``)

Replaces warp (``src/server.rs:53-127``) for the handful of routes the
server needs.  Request parsing is shared with the Icecast SOURCE handler
(``src/icecast/http.rs``), which speaks an HTTP-shaped protocol on the same
port.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, Optional

MAX_HEADER_BYTES = 64 * 1024


@dataclass
class Request:
    method: str
    path: str
    version: str
    headers: Dict[str, str] = field(default_factory=dict)

    def header(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self.headers.get(name.lower(), default)


class HttpError(Exception):
    pass


async def read_request(reader: asyncio.StreamReader) -> Optional[Request]:
    """Parse one request head; returns None on clean EOF."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HttpError("truncated request head")
    except asyncio.LimitOverrunError:
        raise HttpError("request head too large")
    if len(head) > MAX_HEADER_BYTES:
        raise HttpError("request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3:
        raise HttpError(f"bad request line: {lines[0]!r}")
    method, path, version = parts
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        if ":" not in line:
            raise HttpError(f"bad header line: {line!r}")
        k, v = line.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return Request(method, path, version, headers)


def wants_keep_alive(req: Request) -> bool:
    """HTTP/1.1 defaults to persistent connections; 1.0 opts in."""
    conn = (req.header("connection") or "").lower()
    if req.version == "HTTP/1.0":
        return "keep-alive" in conn
    return "close" not in conn


def response(
    status: int,
    reason: str,
    body: bytes = b"",
    content_type: str = "text/plain",
    extra_headers: Optional[Dict[str, str]] = None,
    keep_alive: bool = False,
) -> bytes:
    headers = {
        "Content-Length": str(len(body)),
        "Content-Type": content_type,
        "Connection": "keep-alive" if keep_alive else "close",
    }
    if extra_headers:
        headers.update(extra_headers)
    head = f"HTTP/1.1 {status} {reason}\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()
    )
    return head.encode("latin-1") + b"\r\n" + body
