"""Minimal RIFF/WAVE parsing and writing, and f32 -> i16 PCM conversion (the
port's copy of ``mixlab_tpu/io_host/wav.py`` and
``mixlab_tpu.native.pcm_f32_to_i16``).

Parsing supports PCM s16le and float32, mono or stereo, streaming-friendly:
the MediaPlayer reads a WAV upload's header once and decodes its frames
chunk by chunk (``engine/media_player.py``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def pcm_f32_to_i16(x: np.ndarray) -> np.ndarray:
    """Clip to [-1, 1], scale by 32767 in f32 and truncate toward zero, as
    ``mixlab_tpu/native/mixlab_native.cpp:94-101`` does."""
    x = np.asarray(x, dtype=np.float32)
    return (np.clip(x, -1.0, 1.0) * np.float32(32767.0)).astype(np.int16)


class WavError(Exception):
    pass


@dataclass
class WavFormat:
    channels: int
    sample_rate: int
    bits_per_sample: int
    audio_format: int  # 1 = PCM, 3 = IEEE float

    @property
    def bytes_per_frame(self) -> int:
        return self.channels * self.bits_per_sample // 8


def parse_header(data: bytes) -> Tuple[WavFormat, int, int]:
    """Parse a WAV header from the start of ``data``.

    Returns (format, data_offset, data_size).  Raises WavError if the
    header is invalid or incomplete.
    """
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt: Optional[WavFormat] = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if chunk_id == b"fmt ":
            if chunk_size < 16 or body + 16 > len(data):
                raise WavError("bad fmt chunk")
            audio_format, channels, rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", data, body
            )
            if audio_format == 0xFFFE and chunk_size >= 40:
                (audio_format,) = struct.unpack_from("<H", data, body + 24)
            fmt = WavFormat(channels, rate, bits, audio_format)
        elif chunk_id == b"data":
            if fmt is None:
                raise WavError("data chunk before fmt chunk")
            return fmt, body, chunk_size
        pos = body + chunk_size + (chunk_size & 1)
    raise WavError("no data chunk found")


def decode_frames(fmt: WavFormat, payload: bytes) -> np.ndarray:
    """Decode raw sample bytes to i16 [n, 2] (mono duplicated to stereo,
    matching the reference's mono handling, icecast/mod.rs:110-123)."""
    if fmt.audio_format == 1 and fmt.bits_per_sample == 16:
        x = np.frombuffer(payload, dtype="<i2")
    elif fmt.audio_format == 3 and fmt.bits_per_sample == 32:
        f = np.frombuffer(payload, dtype="<f4")
        x = (np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        raise WavError(
            f"unsupported format: fmt={fmt.audio_format} bits={fmt.bits_per_sample}"
        )
    n = len(x) - (len(x) % fmt.channels)
    x = x[:n].reshape(-1, fmt.channels)
    if fmt.channels == 1:
        x = np.repeat(x, 2, axis=1)
    return x[:, :2]


def write_wav(path, sample_rate: int, pcm: np.ndarray):
    """Write i16 or f32 [n, c] PCM to a 16-bit WAV file."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        pcm = pcm_f32_to_i16(pcm)
    n, c = pcm.shape
    data = pcm.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(
            b"fmt " + struct.pack("<IHHIIHH", 16, 1, c, sample_rate, sample_rate * c * 2, c * 2, 16)
        )
        f.write(b"data" + struct.pack("<I", len(data)) + data)
