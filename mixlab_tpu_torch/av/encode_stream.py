"""A/V encode interleaver.
(the port's copy of ``mixlab_tpu/av/encode_stream.py``)

Rebuild of ``src/video/encode.rs`` EncodeStream/AudioCtx semantics over
pluggable codec backends:

  * audio is accumulated into 1024-samples-per-channel granules with exact
    rational timestamps (encode.rs:20,183-221); f32 samples are clamped and
    scaled to i16 (encode.rs:186-199);
  * video frame durations are recomputed gap-free as (end of this frame -
    end of previous frame) so input timestamp imprecision can't open gaps
    (encode.rs:61-76); frames ending before the current video timestamp are
    dropped;
  * ``barrier(ts)`` inserts a blank frame so a stalled video input can't
    stall audio (encode.rs:78-84);
  * ``recv_segment`` emits segments in decode-timestamp order while keeping
    at least one segment of each kind buffered (encode.rs:113-123).

Encoders are duck-typed (see av/codecs.py): audio encoder consumes i16 PCM
granules and yields encoded frames; video encoder consumes Pictures and
yields (is_key, composition_time, bytes) packets.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Union

import numpy as np

from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
from mixlab_tpu_torch.video.frame import Picture

SAMPLES_PER_CHANNEL_PER_FRAGMENT = 1024  # encode.rs:20
AUDIO_CHANNELS = 2


@dataclass
class AudioSegment:
    decode_timestamp: MediaTime
    duration: MediaDuration
    frame: bytes


@dataclass
class VideoSegment:
    decode_timestamp: MediaTime
    duration: MediaDuration
    is_key_frame: bool
    composition_time: MediaDuration
    frame: bytes


StreamSegment = Union[AudioSegment, VideoSegment]


def f32_to_i16(samples: np.ndarray) -> np.ndarray:
    """Clamp [-1,1] then scale by i16::MAX (encode.rs:186-199)."""
    clamped = np.clip(samples, -1.0, 1.0)
    return (clamped * 32767.0).astype(np.int16)


class AudioPipe:
    """Granule buffering + encode (AudioCtx, encode.rs:146-222)."""

    def __init__(self, encoder, sample_rate: int):
        self.encoder = encoder
        self.sample_rate = sample_rate
        self._pcm = np.zeros((0,), dtype=np.int16)

    def send_audio(self, samples_f32: np.ndarray):
        """samples_f32: interleaved [n*2] or [n,2] f32. Yields
        (duration, frame_bytes) per completed granule."""
        pcm = f32_to_i16(np.asarray(samples_f32).reshape(-1))
        self._pcm = np.concatenate([self._pcm, pcm])
        n = AUDIO_CHANNELS * SAMPLES_PER_CHANNEL_PER_FRAGMENT
        out = []
        # NOTE: strictly-greater check mirrors encode.rs:201 (`>`ected quirk:
        # a granule is emitted only once the buffer EXCEEDS 2048 samples)
        while len(self._pcm) > n:
            granule = self._pcm[:n]
            self._pcm = self._pcm[n:]
            frame = self.encoder.encode(granule)
            duration = MediaDuration.new(
                SAMPLES_PER_CHANNEL_PER_FRAGMENT, self.sample_rate
            )
            out.append((duration, frame))
        return out


class EncodeStream:
    def __init__(self, audio_pipe: AudioPipe, video_encoder, time_base: int):
        self.audio_pipe = audio_pipe
        self.video_encoder = video_encoder
        self.time_base = time_base
        self.audio_segments: Deque[AudioSegment] = deque()
        self.audio_timestamp = MediaTime.zero()
        self.video_segments: Deque[VideoSegment] = deque()
        self.video_timestamp = MediaTime.zero()

    # -- audio ------------------------------------------------------------

    def send_audio(self, samples_f32: np.ndarray):
        for duration, frame in self.audio_pipe.send_audio(samples_f32):
            dts = self.audio_timestamp
            self.audio_timestamp = dts + duration
            self.audio_segments.append(AudioSegment(dts, duration, frame))

    # -- video ------------------------------------------------------------

    def send_video(
        self, timestamp: MediaTime, duration_hint: MediaDuration, picture: Picture
    ):
        end = timestamp + duration_hint
        if end < self.video_timestamp:
            return  # frame ends before current timestamp: drop (encode.rs:66-69)
        duration = end - self.video_timestamp  # gap-free (encode.rs:71-76)
        self._encode_video(duration, picture)

    def barrier(self, timestamp: MediaTime):
        if self.video_timestamp < timestamp:
            duration = timestamp - self.video_timestamp
            self._encode_video(duration, self.video_encoder.blank_picture())

    def _encode_video(self, duration: MediaDuration, picture: Picture):
        tb = self.time_base
        start = self.video_timestamp
        end = start + duration
        self.video_timestamp = end
        start_in_base = start.round_to_base(tb)
        end_in_base = end.round_to_base(tb)
        duration_in_base = end_in_base - start_in_base

        for pkt in self.video_encoder.encode(picture, pts=start_in_base):
            self.video_segments.append(
                VideoSegment(
                    decode_timestamp=MediaTime.new(pkt.dts, tb),
                    duration=MediaDuration.new(duration_in_base, tb),
                    is_key_frame=pkt.is_key,
                    composition_time=MediaDuration.new(pkt.pts - pkt.dts, tb),
                    frame=pkt.data,
                )
            )

    # -- output -----------------------------------------------------------

    def recv_segment(self) -> Optional[StreamSegment]:
        # keep >=1 of each buffered so ordering is stable (encode.rs:113-123)
        if len(self.audio_segments) <= 1 or len(self.video_segments) <= 1:
            return None
        if (
            self.audio_segments[0].decode_timestamp
            < self.video_segments[0].decode_timestamp
        ):
            return self.audio_segments.popleft()
        return self.video_segments.popleft()
