"""Minimal RFC 6455 WebSocket server implementation (asyncio, stdlib-only).
(the port's copy of ``mixlab_tpu/server/ws.py``)

The reference gets WebSockets from warp (``src/server.rs:96-116``); this
environment has no websocket package, so the protocol is implemented
directly: handshake (Sec-WebSocket-Accept = b64(sha1(key + GUID))), frame
parsing with client masking, text/binary/ping/pong/close opcodes,
fragmented-message reassembly, and the permessage-deflate extension
(RFC 7692, negotiated with no context takeover in both directions so each
message is a self-contained raw-deflate stream).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
import zlib
from typing import Optional, Tuple

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# compress server frames at/above this payload size (tiny frames grow)
DEFLATE_MIN_SIZE = 64
# decompression cap — a malicious peer can't balloon memory (zip bomb)
MAX_MESSAGE_SIZE = 64 * 1024 * 1024

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def negotiate_deflate(offer_header: Optional[str]) -> Optional[Tuple[str, int]]:
    """Negotiate permessage-deflate from a Sec-WebSocket-Extensions offer
    (RFC 7692 §5-7).  Returns (response header value, server window bits)
    or None when the extension isn't offered / can't be honored.  We always
    answer with no context takeover both ways — every message is then an
    independent raw-deflate stream (allowed regardless of the offer, §7.1.1)
    — and honor a server_max_window_bits cap if the client requires one."""
    if not offer_header:
        return None
    for offer in offer_header.split(","):
        parts = [s.strip() for s in offer.split(";") if s.strip()]
        if not parts or parts[0] != "permessage-deflate":
            continue
        server_bits = 15
        ok = True
        for param in parts[1:]:
            k, _, v = param.partition("=")
            k, v = k.strip(), v.strip().strip('"')
            if k in ("client_no_context_takeover", "server_no_context_takeover"):
                pass  # we grant both anyway
            elif k == "client_max_window_bits":
                pass  # raw-inflate at 15 bits accepts any smaller window
            elif k == "server_max_window_bits":
                if v:
                    bits = int(v)
                    # zlib cannot make a raw-deflate stream with 8 bits
                    # (window 256); decline such offers like other servers
                    if not 9 <= bits <= 15:
                        ok = False
                    else:
                        server_bits = bits
            else:
                ok = False  # unknown parameter: decline this offer
        if ok:
            resp = ("permessage-deflate; server_no_context_takeover; "
                    "client_no_context_takeover")
            if server_bits != 15:
                resp += f"; server_max_window_bits={server_bits}"
            return resp, server_bits
    return None


def handshake_response(client_key: str, extensions: Optional[str] = None) -> bytes:
    ext = f"Sec-WebSocket-Extensions: {extensions}\r\n" if extensions else ""
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(client_key)}\r\n"
        f"{ext}"
        "\r\n"
    ).encode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True,
                 rsv1: bool = False) -> bytes:
    head = bytearray()
    head.append((0x80 if fin else 0) | (0x40 if rsv1 else 0) | opcode)
    n = len(payload)
    if n < 126:
        head.append(n)  # server frames are unmasked
    elif n < 0x10000:
        head.append(126)
        head += struct.pack(">H", n)
    else:
        head.append(127)
        head += struct.pack(">Q", n)
    return bytes(head) + payload


class WebSocket:
    """Server-side websocket over asyncio streams (post-handshake)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 deflate: bool = False, server_wbits: int = 15):
        self.reader = reader
        self.writer = writer
        self.closed = False
        self.deflate = deflate
        self.server_wbits = server_wbits

    async def send_text(self, text: str):
        await self._send(OP_TEXT, text.encode())

    async def send_binary(self, data: bytes):
        await self._send(OP_BINARY, data)

    async def _send(self, opcode: int, payload: bytes):
        if self.closed:
            raise ConnectionError("websocket closed")
        rsv1 = False
        if (self.deflate and opcode in (OP_TEXT, OP_BINARY)
                and len(payload) >= DEFLATE_MIN_SIZE):
            # no context takeover: a fresh raw-deflate stream per message,
            # Z_SYNC_FLUSH tail 00 00 ff ff stripped (RFC 7692 §7.2.1)
            co = zlib.compressobj(wbits=-self.server_wbits)
            data = co.compress(payload) + co.flush(zlib.Z_SYNC_FLUSH)
            if data.endswith(b"\x00\x00\xff\xff"):
                data = data[:-4]
            payload, rsv1 = data, True
        self.writer.write(encode_frame(opcode, payload, rsv1=rsv1))
        await self.writer.drain()

    async def close(self, code: int = 1000):
        if not self.closed:
            self.closed = True
            try:
                self.writer.write(encode_frame(OP_CLOSE, struct.pack(">H", code)))
                await self.writer.drain()
            except Exception:
                pass
            self.writer.close()

    async def recv(self) -> Optional[Tuple[int, bytes]]:
        """Receive one message: (opcode, payload) or None on close/EOF.
        Handles fragmentation and replies to pings."""
        message_op = None
        compressed = False
        buffer = bytearray()
        while True:
            frame = await self._read_frame()
            if frame is None:
                return None
            fin, rsv1, opcode, payload = frame
            if opcode == OP_CLOSE:
                await self.close()
                return None
            if opcode == OP_PING:
                await self._send(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode in (OP_TEXT, OP_BINARY):
                if rsv1 and not self.deflate:
                    # RFC 6455 5.2: RSV bits MUST be 0 unless an extension
                    # negotiated them — fail the connection, don't deliver
                    # raw deflate bytes as payload
                    await self.close(1002)
                    return None
                message_op = opcode
                compressed = rsv1 and self.deflate
                buffer = bytearray(payload)
            elif opcode == OP_CONT:
                if message_op is None:
                    return None  # protocol error
                buffer += payload
            if len(buffer) > MAX_MESSAGE_SIZE:
                # fragmented-message flood: same cap as the inflate bound
                await self.close(1009)
                return None
            if fin and message_op is not None:
                data = bytes(buffer)
                if compressed:
                    data = self._inflate(data)
                    if data is None:
                        await self.close(1002)
                        return None
                return message_op, data

    def _inflate(self, data: bytes) -> Optional[bytes]:
        """Per-message raw inflate (client_no_context_takeover was granted),
        bounded by MAX_MESSAGE_SIZE."""
        try:
            do = zlib.decompressobj(wbits=-15)
            out = do.decompress(data + b"\x00\x00\xff\xff", MAX_MESSAGE_SIZE)
            if do.unconsumed_tail:
                return None  # exceeded the size cap
            return out
        except zlib.error:
            return None

    async def _read_frame(self):
        try:
            head = await self.reader.readexactly(2)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        fin = bool(head[0] & 0x80)
        rsv1 = bool(head[0] & 0x40)
        opcode = head[0] & 0x0F
        masked = bool(head[1] & 0x80)
        n = head[1] & 0x7F
        try:
            if n == 126:
                (n,) = struct.unpack(">H", await self.reader.readexactly(2))
            elif n == 127:
                (n,) = struct.unpack(">Q", await self.reader.readexactly(8))
            if n > MAX_MESSAGE_SIZE:
                # a claimed 2^40-byte frame would otherwise make
                # readexactly buffer unboundedly — close 1009, never read
                await self.close(1009)
                return None
            mask = await self.reader.readexactly(4) if masked else None
            payload = await self.reader.readexactly(n) if n else b""
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        if mask:
            from mixlab_tpu_torch import native

            payload = native.ws_unmask(payload, mask)
        return fin, rsv1, opcode, payload
