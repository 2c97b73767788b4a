"""RTMP handshake (simple/unversioned variant, RTMP spec §5.2).
(the port's copy of ``mixlab_tpu/io_host/rtmp/handshake.py``)

C0/C1 <-> S0/S1/S2 <-> C2.  The digest-based variant used by Flash DRM is
unnecessary for open encoders (OBS/ffmpeg accept the simple handshake).
"""

from __future__ import annotations

import os
import struct

RTMP_VERSION = 3
HANDSHAKE_LEN = 1536


def _packet(ts: int = 0) -> bytes:
    return struct.pack(">II", ts, 0) + os.urandom(HANDSHAKE_LEN - 8)


async def server_handshake(reader, writer):
    """Server side: read C0+C1, send S0+S1+S2, read C2."""
    c0 = await reader.readexactly(1)
    if c0[0] != RTMP_VERSION:
        raise ConnectionError(f"unsupported RTMP version {c0[0]}")
    c1 = await reader.readexactly(HANDSHAKE_LEN)
    s1 = _packet()
    writer.write(bytes([RTMP_VERSION]) + s1 + c1)  # S2 echoes C1
    await writer.drain()
    await reader.readexactly(HANDSHAKE_LEN)  # C2 (echo of S1); not validated


async def client_handshake(reader, writer):
    """Client side: send C0+C1, read S0+S1+S2, send C2."""
    c1 = _packet()
    writer.write(bytes([RTMP_VERSION]) + c1)
    await writer.drain()
    s0 = await reader.readexactly(1)
    if s0[0] != RTMP_VERSION:
        raise ConnectionError(f"unsupported RTMP version {s0[0]}")
    s1 = await reader.readexactly(HANDSHAKE_LEN)
    await reader.readexactly(HANDSHAKE_LEN)  # S2
    writer.write(s1)  # C2 echoes S1
    await writer.drain()
