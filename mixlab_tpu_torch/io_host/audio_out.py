"""Audio output backends for the OutputDevice module (the port's copy of
``mixlab_tpu/io_host/audio_out.py``).

Rebuild of ``src/module/output_device.rs``'s cpal integration as a backend
interface: the reference enumerates soundcards, maps L/R to device channels,
and feeds a 65536-sample ring consumed by the audio callback with underrun
backoff and lag flags (output_device.rs:106-137,188-246).

Backends:
  * ``FileAudioBackend`` — always available: "devices" are WAV files under a
    spool directory; used headless and in tests.  Ring + lag semantics preserved.
  * ``AlsaAudioBackend`` (alsa_out.py) — real soundcards via libasound when
    the library is present; validated here against an in-tree fake
    libasound since no sound stack exists in this image.
"""

from __future__ import annotations

import pathlib
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

RING_SAMPLES = 65536  # output_device.rs:106


class OutputStream:
    """Bounded sample ring between the engine and a sink consumer."""

    def __init__(self, channels: int, sink, sample_rate: int):
        self.channels = channels
        self.sink = sink
        self.sample_rate = sample_rate
        self._buf = np.zeros((0, channels), dtype=np.float32)
        self._lock = threading.Lock()
        self.lagged = False
        self._consumer = threading.Thread(target=self._run, daemon=True)
        self._stop = threading.Event()
        self._consumer.start()

    def write(self, frames: np.ndarray) -> bool:
        """Engine-side push; returns False (and sets lag) when the ring is
        full (output_device.rs:213-239 lag semantics)."""
        with self._lock:
            if len(self._buf) + len(frames) > RING_SAMPLES:
                self.lagged = True
                return False
            self._buf = np.concatenate([self._buf, frames.astype(np.float32)])
            return True

    def _run(self):
        period = 1024
        while not self._stop.is_set():
            with self._lock:
                take = self._buf[:period]
                self._buf = self._buf[len(take) :]
            if len(take):
                self.sink(take)
            else:
                time.sleep(period / self.sample_rate / 2)
            time.sleep(period / self.sample_rate * 0.9)

    def close(self):
        self._stop.set()
        self._consumer.join(timeout=2.0)
        if hasattr(self.sink, "close"):
            self.sink.close()


class FileAudioBackend:
    """WAV-file 'soundcard': device names are file stems in a spool dir."""

    name = "file"

    def __init__(self, spool_dir: str | pathlib.Path | None = None):
        # default under the temporary directory ($TMPDIR, else the system's)
        self.spool = pathlib.Path(
            spool_dir or pathlib.Path(tempfile.gettempdir()) / "mixlab_audio_out")
        self.spool.mkdir(parents=True, exist_ok=True)

    def devices(self) -> List[Tuple[str, int]]:
        """[(name, channels)] (output_device.rs:52-61 enumeration)."""
        return [("wav-file", 2)]

    def default_device(self) -> Optional[str]:
        return "wav-file"

    def open(self, device: str, sample_rate: int) -> Optional[OutputStream]:
        if device != "wav-file":
            return None
        path = self.spool / f"output-{int(time.time())}.wav"
        sink = _WavSink(path, sample_rate)
        return OutputStream(2, sink, sample_rate)


class _WavSink:
    def __init__(self, path, sample_rate):
        import struct

        self.path = path
        self.sample_rate = sample_rate
        self.f = open(path, "wb")
        self.frames = 0
        # placeholder header, finalized on close
        self.f.write(b"\x00" * 44)

    def __call__(self, frames: np.ndarray):
        pcm = (np.clip(frames, -1, 1) * 32767).astype("<i2")
        self.f.write(pcm.tobytes())
        self.frames += len(frames)

    def close(self):
        import struct

        data_len = self.frames * 4
        self.f.seek(0)
        self.f.write(b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVE")
        self.f.write(
            b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, self.sample_rate, self.sample_rate * 4, 4, 16)
        )
        self.f.write(b"data" + struct.pack("<I", data_len))
        self.f.close()


_BACKEND: Optional[object] = None


def get_backend():
    """Active backend: ``MIXLAB_AUDIO_BACKEND`` selects "alsa" or "file";
    unset = auto (real soundcard via libasound when it loads, like the
    reference's cpal default host, else the WAV-file spool)."""
    global _BACKEND
    if _BACKEND is None:
        import os

        choice = os.environ.get("MIXLAB_AUDIO_BACKEND", "auto")
        if choice in ("alsa", "auto"):
            try:
                from mixlab_tpu_torch.io_host.alsa_out import AlsaAudioBackend

                backend = AlsaAudioBackend()
                # auto: require a usable default device, not just the
                # library — headless hosts with libasound installed must
                # keep the WAV-spool backend ("alsa" forces it regardless)
                if choice == "alsa" or backend.probe_default():
                    _BACKEND = backend
            except RuntimeError:
                if choice == "alsa":
                    raise
        if _BACKEND is None:
            _BACKEND = FileAudioBackend()
    return _BACKEND


def set_backend(backend):
    global _BACKEND
    _BACKEND = backend
