"""Host-side per-tick feed logic for externally-sourced modules (the port's
copy of ``mixlab_tpu/engine/feeds.py``).

``StreamInputFeed`` mirrors ``src/module/stream_input.rs:72-147``: consume
i16 audio frames from the ingest ring with sample-exact splitting and
carry-over, re-epoch source timestamps onto engine time on source change,
and release the pending video frame only when it falls within the current
tick window.  (The i16 -> f32 conversion happens on device, sinks.py.)

``MediaSourceFeed`` mirrors the tick-release half of
``src/module/media_source.rs:93-126``: pull decoded audio from the decode
thread's bounded queue.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.io_host.source import Frame, SourceRecv
from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime


@dataclass
class _SourceTiming:
    id: int
    epoch: MediaTime


class StreamInputFeed:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.recv: Optional[SourceRecv] = None
        self.source: Optional[_SourceTiming] = None
        self.audio_carry: Optional[Frame] = None  # partially-consumed frame
        self.video_carry: Optional[Frame] = None

    def set_recv(self, recv: Optional[SourceRecv]):
        if self.recv is not None and self.recv is not recv:
            self.recv.close()
        self.recv = recv
        self.audio_carry = None
        self.video_carry = None

    def fill_tick(self, engine_time_samples: int, n_samples: int):
        """Returns (pcm i16 [n_samples, 2], video_frame_or_None, tick_offset).

        video frame is a mixlab_tpu_torch.video.frame.VideoFrame with tick_offset
        computed against engine time.
        """
        cfg = self.cfg
        engine_time = MediaTime.new(engine_time_samples, cfg.sample_rate)
        tick_duration = MediaDuration.new(n_samples, cfg.sample_rate)

        pcm = np.zeros((n_samples, 2), dtype=np.int16)
        filled = 0

        video_frame = self.video_carry
        self.video_carry = None
        if video_frame is None and self.recv is not None:
            video_frame = self.recv.read_video()

        while filled < n_samples:
            frame = self.audio_carry
            self.audio_carry = None
            if frame is None and self.recv is not None:
                frame = self.recv.read_audio()
            if frame is None:
                break  # rest stays zero (stream_input.rs:118-121)

            if self.source is None or self.source.id != frame.source_id:
                # source changed: re-epoch (stream_input.rs:100-106)
                self.source = _SourceTiming(
                    frame.source_id, engine_time.remove_epoch(frame.source_time)
                )

            data = frame.data  # i16 [n, 2]
            take = min(n_samples - filled, len(data))
            pcm[filled : filled + take] = data[:take]
            filled += take
            if take < len(data):
                self.audio_carry = Frame(
                    frame.source_id, frame.source_time, data[take:]
                )

        out_video = None
        if video_frame is not None:
            if self.source is not None:
                tick_offset = (
                    video_frame.source_time.add_epoch(self.source.epoch) - engine_time
                )
                if tick_offset < MediaDuration.zero():
                    tick_offset = MediaDuration.zero()
            else:
                tick_offset = MediaDuration.zero()

            if tick_offset > tick_duration:
                # not due this tick; put it back (stream_input.rs:138-141)
                self.video_carry = video_frame
            else:
                vf = video_frame.data  # VideoFrame from ingest
                vf.tick_offset = tick_offset
                out_video = vf
        return pcm, out_video


class MediaSourceFeed:
    """Bounded queues from a decode thread (sync_channel(2) analogue,
    media_source.rs:140-143).  Audio is pulled sample-exact; video frames
    are pts-windowed against the feed's media position, mirroring the
    reference's per-tick release (media_source.rs:93-126)."""

    def __init__(self, cfg: EngineConfig, depth: int = 2):
        self.cfg = cfg
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.carry: Optional[np.ndarray] = None  # f32 [n, 2]
        self.video_q: "queue.Queue" = queue.Queue(maxsize=8)
        self.video_carry = None  # (pts MediaTime, VideoFrame)
        self.pos = MediaTime.new(0, cfg.sample_rate)

    def push_block(self, pcm_f32: np.ndarray, block: bool = True, timeout=None) -> bool:
        try:
            self.queue.put(pcm_f32, block=block, timeout=timeout)
            return True
        except queue.Full:
            return False

    def push_video(self, pts: MediaTime, frame, block: bool = True, timeout=None) -> bool:
        try:
            self.video_q.put((pts, frame), block=block, timeout=timeout)
            return True
        except queue.Full:
            return False

    def take_video(self, n_samples: int):
        """Release the pending frame if due within this tick's window; also
        advances the media position clock."""
        tick_dur = MediaDuration.new(n_samples, self.cfg.sample_rate)
        item = self.video_carry
        self.video_carry = None
        if item is None:
            try:
                item = self.video_q.get_nowait()
            except queue.Empty:
                item = None
        out = None
        if item is not None:
            pts, frame = item
            offset = pts - self.pos
            if offset > tick_dur:
                self.video_carry = item  # not due yet (media_source.rs:117-121)
            else:
                frame.tick_offset = (
                    offset if offset > MediaDuration.zero() else MediaDuration.zero()
                )
                out = frame
        self.pos = self.pos + tick_dur
        return out

    def fill_tick(self, n_samples: int) -> np.ndarray:
        out = np.zeros((n_samples, 2), dtype=np.float32)
        filled = 0
        while filled < n_samples:
            chunk = self.carry
            self.carry = None
            if chunk is None:
                try:
                    chunk = self.queue.get_nowait()
                except queue.Empty:
                    break
            take = min(n_samples - filled, len(chunk))
            out[filled : filled + take] = chunk[:take]
            filled += take
            if take < len(chunk):
                self.carry = chunk[take:]
        return out
