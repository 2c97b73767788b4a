"""Single-port protocol disambiguation.
(the port's copy of ``mixlab_tpu/io_host/listen.py``)

Rebuild of ``src/listen.rs``: one TCP port serves HTTP, Icecast SOURCE and
RTMP.  The first 7 bytes decide (listen.rs:87-97):

    b"SOURCE "      -> Icecast
    first byte 0x03 -> RTMP (the C0 version byte)
    anything else   -> HTTP

The peeked bytes are replayed through ``PeekStreamReader`` so downstream
handlers read a pristine stream (PeekTcpStream, listen.rs:100-163).
"""

from __future__ import annotations

import asyncio
from enum import Enum
from typing import Awaitable, Callable, Tuple


class Protocol(Enum):
    HTTP = "http"
    ICECAST = "icecast"
    RTMP = "rtmp"


PEEK_LEN = 7


def classify(peek: bytes) -> Protocol:
    if peek.startswith(b"SOURCE "):
        return Protocol.ICECAST
    if peek[:1] == b"\x03":
        return Protocol.RTMP
    return Protocol.HTTP


class PeekStreamReader:
    """StreamReader facade replaying peeked bytes first."""

    def __init__(self, peeked: bytes, reader: asyncio.StreamReader):
        self._buf = bytearray(peeked)
        self._reader = reader

    def _take(self, n: int) -> bytes:
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def read(self, n: int = -1) -> bytes:
        if self._buf:
            if n < 0:
                rest = await self._reader.read(-1)
                return self._take(len(self._buf)) + rest
            return self._take(n)
        return await self._reader.read(n)

    async def readexactly(self, n: int) -> bytes:
        out = bytearray()
        if self._buf:
            out += self._take(min(n, len(self._buf)))
        if len(out) < n:
            out += await self._reader.readexactly(n - len(out))
        return bytes(out)

    async def readuntil(self, sep: bytes = b"\n") -> bytes:
        # search the pushback buffer first, then fall back to the reader
        idx = bytes(self._buf).find(sep)
        if idx >= 0:
            return self._take(idx + len(sep))
        rest = await self._reader.readuntil(sep)
        return self._take(len(self._buf)) + rest

    def at_eof(self) -> bool:
        return not self._buf and self._reader.at_eof()


Handler = Callable[
    [Protocol, PeekStreamReader, asyncio.StreamWriter], Awaitable[None]
]


async def start(
    host: str, port: int, handler: Handler
) -> asyncio.AbstractServer:
    """Listen and dispatch each connection by protocol."""

    async def on_connect(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                import socket as _socket

                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            peek = await reader.readexactly(PEEK_LEN)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        proto = classify(peek)
        try:
            await handler(proto, PeekStreamReader(peek, reader), writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    return await asyncio.start_server(on_connect, host, port)
