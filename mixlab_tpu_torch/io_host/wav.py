"""WAV writing and f32 -> i16 PCM conversion (the port's copy of
``mixlab_tpu/io_host/wav.py:write_wav`` and ``mixlab_tpu.native.pcm_f32_to_i16``).
"""

from __future__ import annotations

import struct

import numpy as np


def pcm_f32_to_i16(x: np.ndarray) -> np.ndarray:
    """Clip to [-1, 1], scale by 32767 in f32 and truncate toward zero, as
    ``mixlab_tpu/native/mixlab_native.cpp:94-101`` does."""
    x = np.asarray(x, dtype=np.float32)
    return (np.clip(x, -1.0, 1.0) * np.float32(32767.0)).astype(np.int16)


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
