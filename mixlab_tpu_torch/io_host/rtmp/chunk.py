"""RTMP chunk stream protocol (Adobe RTMP spec §5.3).
(the port's copy of ``mixlab_tpu/io_host/rtmp/chunk.py``)

Message framing for both the ingest server (``src/rtmp/mod.rs``) and the
publish client (``src/rtmp/client.rs``).  Supports header formats 0-3,
extended timestamps, per-csid reassembly and Set Chunk Size handling.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

DEFAULT_CHUNK_SIZE = 128

# message type ids
MSG_SET_CHUNK_SIZE = 1
MSG_ABORT = 2
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF3 = 15
MSG_COMMAND_AMF3 = 17
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20


@dataclass
class Message:
    timestamp: int
    type_id: int
    stream_id: int
    payload: bytes


@dataclass
class _CsidState:
    timestamp: int = 0
    timestamp_delta: int = 0
    length: int = 0
    type_id: int = 0
    stream_id: int = 0
    has_ext_ts: bool = False  # fmt-3 chunks repeat the extended timestamp
    buffer: bytearray = field(default_factory=bytearray)


class ChunkReader:
    def __init__(self, reader):
        self.reader = reader  # needs .readexactly
        self.chunk_size = DEFAULT_CHUNK_SIZE
        self.states: Dict[int, _CsidState] = {}
        self.bytes_received = 0

    async def _read(self, n: int) -> bytes:
        data = await self.reader.readexactly(n)
        self.bytes_received += n
        return data

    async def read_message(self) -> Optional[Message]:
        """Read chunks until one full message is assembled.  Handles
        Set Chunk Size internally; returns None on EOF."""
        while True:
            try:
                head = await self._read(1)
            except Exception:
                return None
            fmt = head[0] >> 6
            csid = head[0] & 0x3F
            if csid == 0:
                csid = 64 + (await self._read(1))[0]
            elif csid == 1:
                ext = await self._read(2)
                csid = 64 + ext[0] + ext[1] * 256

            st = self.states.setdefault(csid, _CsidState())
            if fmt == 0:
                data = await self._read(11)
                ts = int.from_bytes(data[0:3], "big")
                st.length = int.from_bytes(data[3:6], "big")
                st.type_id = data[6]
                st.stream_id = struct.unpack("<I", data[7:11])[0]
                st.has_ext_ts = ts == 0xFFFFFF
                if st.has_ext_ts:
                    ts = struct.unpack(">I", await self._read(4))[0]
                st.timestamp = ts
                st.timestamp_delta = 0
            elif fmt == 1:
                data = await self._read(7)
                delta = int.from_bytes(data[0:3], "big")
                st.length = int.from_bytes(data[3:6], "big")
                st.type_id = data[6]
                st.has_ext_ts = delta == 0xFFFFFF
                if st.has_ext_ts:
                    delta = struct.unpack(">I", await self._read(4))[0]
                st.timestamp_delta = delta
                if not st.buffer:
                    st.timestamp += delta
            elif fmt == 2:
                data = await self._read(3)
                delta = int.from_bytes(data, "big")
                st.has_ext_ts = delta == 0xFFFFFF
                if st.has_ext_ts:
                    delta = struct.unpack(">I", await self._read(4))[0]
                st.timestamp_delta = delta
                if not st.buffer:
                    st.timestamp += delta
            else:  # fmt == 3: continuation or repeat
                if st.has_ext_ts:
                    await self._read(4)  # repeated extended timestamp
                if not st.buffer:
                    st.timestamp += st.timestamp_delta

            take = min(self.chunk_size, st.length - len(st.buffer))
            if take > 0:
                st.buffer += await self._read(take)
            if len(st.buffer) >= st.length:
                payload = bytes(st.buffer)
                st.buffer = bytearray()
                msg = Message(st.timestamp, st.type_id, st.stream_id, payload)
                if msg.type_id == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
                    self.chunk_size = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
                    continue
                if msg.type_id in (MSG_ACK, MSG_WINDOW_ACK_SIZE, MSG_SET_PEER_BW, MSG_ABORT):
                    continue  # flow control handled implicitly
                return msg


class ChunkWriter:
    def __init__(self, writer, chunk_size: int = DEFAULT_CHUNK_SIZE):
        self.writer = writer
        self.chunk_size = chunk_size

    def set_chunk_size(self, size: int):
        self.write_message(
            Message(0, MSG_SET_CHUNK_SIZE, 0, struct.pack(">I", size)), csid=2
        )
        self.chunk_size = size

    def write_message(self, msg: Message, csid: int = 3):
        out = bytearray()
        ts = min(msg.timestamp, 0xFFFFFF)
        # fmt 0 header every message (simple, always-valid encoding)
        out.append((0 << 6) | csid)
        out += int(ts).to_bytes(3, "big")
        out += len(msg.payload).to_bytes(3, "big")
        out.append(msg.type_id)
        out += struct.pack("<I", msg.stream_id)
        if msg.timestamp >= 0xFFFFFF:
            out += struct.pack(">I", msg.timestamp)

        pos = 0
        payload = msg.payload
        first = True
        while pos < len(payload) or first:
            if not first:
                out.append((3 << 6) | csid)  # fmt 3 continuation
                if msg.timestamp >= 0xFFFFFF:
                    out += struct.pack(">I", msg.timestamp)
            take = min(self.chunk_size, len(payload) - pos)
            out += payload[pos : pos + take]
            pos += take
            first = False
        self.writer.write(bytes(out))
