"""RTMP publish client (egress).
(the port's copy of ``mixlab_tpu/io_host/rtmp/client.py``)

Rebuild of ``src/rtmp/client.rs``: async connect + handshake + the
connect/createStream/publish command sequence, then a bounded command queue
(depth 100, client.rs:186) so the realtime engine thread never blocks on the
network; audio/video FLV tag bodies are sent as RTMP messages with ms
timestamps.  Chunk size is raised after connect (the reference uses 512 KiB,
client.rs:71).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from mixlab_tpu_torch.io_host.rtmp import amf0
from mixlab_tpu_torch.io_host.rtmp.chunk import (
    MSG_AUDIO,
    MSG_COMMAND_AMF0,
    MSG_VIDEO,
    ChunkReader,
    ChunkWriter,
    Message,
)
from mixlab_tpu_torch.io_host.rtmp.handshake import client_handshake

PUBLISH_QUEUE_DEPTH = 100  # client.rs:97
OUT_CHUNK_SIZE = 512 * 1024  # client.rs:71


class RtmpClientError(Exception):
    pass


class RtmpPublishClient:
    """Connected publishing session; use :func:`start` to create."""

    def __init__(self, reader, writer, cw: ChunkWriter):
        self._reader = reader
        self._writer = writer
        self._cw = cw
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=PUBLISH_QUEUE_DEPTH)
        self._pump: Optional[asyncio.Task] = None
        self.stream_id = 1

    def start_pump(self):
        self._pump = asyncio.create_task(self._run_pump())

    async def _run_pump(self):
        try:
            while True:
                item = await self._queue.get()
                if item is None:
                    break
                type_id, timestamp_ms, payload = item
                self._cw.write_message(
                    Message(timestamp_ms, type_id, self.stream_id, payload),
                    csid=4 if type_id == MSG_AUDIO else 6,
                )
                await self._writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass

    def publish_audio(self, timestamp_ms: int, flv_body: bytes) -> bool:
        return self._enqueue(MSG_AUDIO, timestamp_ms, flv_body)

    def publish_video(self, timestamp_ms: int, flv_body: bytes) -> bool:
        return self._enqueue(MSG_VIDEO, timestamp_ms, flv_body)

    def _enqueue(self, type_id, ts, payload) -> bool:
        try:
            self._queue.put_nowait((type_id, ts, payload))
            return True
        except asyncio.QueueFull:
            return False  # realtime caller never blocks (client.rs:186)

    async def close(self):
        if self._pump is not None:
            await self._queue.put(None)
            await self._pump
        self._writer.close()


async def start(
    host: str, port: int, app: str, stream_key: str, timeout: float = 10.0
) -> RtmpPublishClient:
    """Connect, handshake, and run the publish command sequence
    (client.rs:47-119,144-205)."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout
    )
    await client_handshake(reader, writer)
    cr = ChunkReader(reader)
    cw = ChunkWriter(writer)

    tc_url = f"rtmp://{host}:{port}/{app}"
    cw.write_message(
        Message(
            0,
            MSG_COMMAND_AMF0,
            0,
            amf0.encode_all(
                "connect",
                1.0,
                {"app": app, "type": "nonprivate", "flashVer": "mixlab-tpu", "tcUrl": tc_url},
            ),
        )
    )
    await writer.drain()
    await _await_result(cr, "NetConnection.Connect.Success")

    cw.set_chunk_size(OUT_CHUNK_SIZE)
    await writer.drain()

    cw.write_message(
        Message(0, MSG_COMMAND_AMF0, 0, amf0.encode_all("createStream", 2.0, None))
    )
    await writer.drain()
    await _await_command(cr, "_result")

    cw.write_message(
        Message(
            0,
            MSG_COMMAND_AMF0,
            1,
            amf0.encode_all("publish", 3.0, None, stream_key, "live"),
        )
    )
    await writer.drain()
    await _await_result(cr, "NetStream.Publish.Start")

    client = RtmpPublishClient(reader, writer, cw)
    client.start_pump()
    return client


async def _await_command(cr: ChunkReader, name: str, timeout: float = 10.0):
    async def inner():
        while True:
            msg = await cr.read_message()
            if msg is None:
                raise RtmpClientError("connection closed during command sequence")
            if msg.type_id == MSG_COMMAND_AMF0:
                values = amf0.decode_all(msg.payload)
                if values and values[0] == name:
                    return values
                if values and values[0] == "onStatus":
                    return values

    return await asyncio.wait_for(inner(), timeout)


async def _await_result(cr: ChunkReader, expect_code: str, timeout: float = 10.0):
    values = await _await_command(cr, "_result", timeout)
    for v in values:
        if isinstance(v, dict) and v.get("code"):
            if v["code"] != expect_code and "Success" not in str(v.get("code")) and "Start" not in str(v.get("code")):
                raise RtmpClientError(f"unexpected status {v['code']}")
            return values
    return values
