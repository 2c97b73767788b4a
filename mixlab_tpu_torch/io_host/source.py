"""Mountpoint registry: named SPSC channels from ingest threads to the engine
(the port's copy of ``mixlab_tpu/io_host/source.py``, with registries of its
own: a port engine listens on ``mixlab_tpu_torch`` mountpoints only).

Rebuild of ``src/source.rs``: a global registry of named channels, exactly
one producer (the network ingest) and one consumer (a stream_input module)
per channel; two bounded SPSC rings (audio frames of i16 PCM, video frames)
of capacity 65536; a ``SourceId`` sequence distinguishing reconnects
(source.rs:89-145); the producer slot is returned to the registry when a
``SourceSend`` closes, and the channel is deleted when the ``SourceRecv``
closes (source.rs:194-238).

Python rings use a lock-light bounded deque (GIL-atomic append/popleft);
push on full FAILS (newest dropped) matching ringbuf semantics.  A C++
SPSC ring (native/) can be slotted in for the realtime path.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Generic, Optional, TypeVar

from mixlab_tpu_torch.utils.mtime import MediaTime

RING_CAPACITY = 65536  # source.rs:97-98

T = TypeVar("T")


@dataclass
class Frame(Generic[T]):
    source_id: int
    source_time: MediaTime
    data: T  # np.ndarray i16 [n,2] for audio; video.VideoFrame for video


class Ring:
    """Bounded SPSC ring; push fails when full."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._q = deque()
        self._capacity = capacity

    def push(self, item) -> bool:
        if len(self._q) >= self._capacity:
            return False
        self._q.append(item)
        return True

    def pop(self):
        try:
            return self._q.popleft()
        except IndexError:
            return None

    def __len__(self):
        return len(self._q)


class ListenError(Exception):
    pass


class AlreadyInUse(ListenError):
    pass


class ConnectError(Exception):
    pass


class NoMountpoint(ConnectError):
    pass


class AlreadyConnected(ConnectError):
    pass


class _Channel:
    def __init__(self, name: str):
        self.name = name
        self.seq = 0
        self.audio = Ring()
        self.video = Ring()
        self.recv_online = True
        self.producer_active = False


class SourceSend:
    """Producer half; write_* fails once the receiver is gone."""

    def __init__(self, registry: "Registry", channel: _Channel, source_id: int):
        self._registry = registry
        self._channel = channel
        self.source_id = source_id
        self._open = True

    @property
    def connected(self) -> bool:
        return self._open and self._channel.recv_online

    def write_audio(self, timestamp: MediaTime, pcm) -> bool:
        if not self.connected:
            return False
        return self._channel.audio.push(Frame(self.source_id, timestamp, pcm))

    def write_video(self, timestamp: MediaTime, frame) -> bool:
        if not self.connected:
            return False
        return self._channel.video.push(Frame(self.source_id, timestamp, frame))

    def close(self):
        if self._open:
            self._open = False
            self._registry._release_producer(self._channel)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SourceRecv:
    """Consumer half; closing deletes the channel."""

    def __init__(self, registry: "Registry", channel: _Channel):
        self._registry = registry
        self._channel = channel

    @property
    def channel_name(self) -> str:
        return self._channel.name

    def read_audio(self) -> Optional[Frame]:
        return self._channel.audio.pop()

    def read_video(self) -> Optional[Frame]:
        return self._channel.video.pop()

    def close(self):
        self._channel.recv_online = False
        self._registry._remove_channel(self._channel.name)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._channels: Dict[str, _Channel] = {}

    def listen(self, channel_name: str) -> SourceRecv:
        with self._lock:
            if channel_name in self._channels:
                raise AlreadyInUse(channel_name)
            ch = _Channel(channel_name)
            self._channels[channel_name] = ch
            return SourceRecv(self, ch)

    def connect(self, channel_name: str) -> SourceSend:
        with self._lock:
            ch = self._channels.get(channel_name)
            if ch is None:
                raise NoMountpoint(channel_name)
            if ch.producer_active:
                raise AlreadyConnected(channel_name)
            ch.producer_active = True
            ch.seq += 1
            return SourceSend(self, ch, ch.seq)

    def _release_producer(self, ch: _Channel):
        with self._lock:
            if ch.name in self._channels:
                ch.producer_active = False

    def _remove_channel(self, name: str):
        with self._lock:
            self._channels.pop(name, None)


# global registries, one per protocol, matching the reference's per-protocol
# MOUNTPOINTS statics (rtmp/mod.rs:30-36, icecast/mod.rs)
RTMP_MOUNTPOINTS = Registry()
ICECAST_MOUNTPOINTS = Registry()

# the reference pre-registers a default RTMP mountpoint (rtmp/mod.rs:30-36);
# ingest rejects publishes to unknown app names until a stream_input listens,
# so we mirror the behaviour lazily in rtmp ingest instead of a static.
DEFAULT_RTMP_MOUNTPOINT = "my_stream_endpoint"
