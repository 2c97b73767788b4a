"""ALSA audio output backend, ctypes over libasound (the port's copy of
``mixlab_tpu/io_host/alsa_out.py``).

Closes the reference's real-soundcard path: ``output_device.rs:106-137``
builds a cpal stream (which is ALSA on Linux), remaps L/R onto device
channels, feeds a 65536-sample ring from the engine, and on underrun plays
3 callbacks of silence before resuming (output_device.rs:113-130).  This
backend reproduces that discipline directly on the ALSA PCM API:

  * device enumeration via ``snd_device_name_hint`` (cpal's own source),
  * S16_LE interleaved playback via ``snd_pcm_set_params`` +
    ``snd_pcm_writei``,
  * underrun (-EPIPE) -> ``snd_pcm_recover`` + 3 periods of silence backoff,
    then the interrupted period is retried.

Without sound hardware the backend is validated against the JAX package's
fake libasound (``mixlab_tpu/native/fake_asound.cpp``) that
implements exactly this API subset and records the call/PCM stream; point
``MIXLAB_ALSA_LIB`` at any alternative .so (tests do).  On a real machine
with ALSA the same code path plays to the actual device.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from mixlab_tpu_torch.io_host.audio_out import OutputStream

log = logging.getLogger(__name__)

# snd_pcm_stream_t / snd_pcm_format_t / snd_pcm_access_t constants
_SND_PCM_STREAM_PLAYBACK = 0
_SND_PCM_FORMAT_S16_LE = 2
_SND_PCM_ACCESS_RW_INTERLEAVED = 3
_EPIPE = 32

# underrun backoff: silence periods before resuming (output_device.rs:117)
_BACKOFF_PERIODS = 3
_LATENCY_US = 100_000


def _load_lib() -> Optional[ctypes.CDLL]:
    path = os.environ.get("MIXLAB_ALSA_LIB", "libasound.so.2")
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    try:
        lib.snd_pcm_open.restype = ctypes.c_int
        lib.snd_pcm_open.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.snd_pcm_set_params.restype = ctypes.c_int
        lib.snd_pcm_set_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
        ]
        lib.snd_pcm_writei.restype = ctypes.c_long
        lib.snd_pcm_writei.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong,
        ]
        lib.snd_pcm_recover.restype = ctypes.c_int
        lib.snd_pcm_recover.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.snd_pcm_drain.restype = ctypes.c_int
        lib.snd_pcm_drain.argtypes = [ctypes.c_void_p]
        lib.snd_pcm_close.restype = ctypes.c_int
        lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
        lib.snd_device_name_hint.restype = ctypes.c_int
        lib.snd_device_name_hint.argtypes = [
            ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p)),
        ]
        lib.snd_device_name_get_hint.restype = ctypes.c_void_p  # malloc'd
        lib.snd_device_name_get_hint.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
        ]
        lib.snd_device_name_free_hint.restype = ctypes.c_int
        lib.snd_device_name_free_hint.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
        ]
    except AttributeError:
        return None
    return lib


_libc = ctypes.CDLL(None)


def _hint_str(lib, hint, key: bytes) -> Optional[str]:
    ptr = lib.snd_device_name_get_hint(hint, key)
    if not ptr:
        return None
    s = ctypes.cast(ptr, ctypes.c_char_p).value
    _libc.free(ctypes.c_void_p(ptr))
    return s.decode("utf-8", "replace") if s is not None else None


class _AlsaSink:
    """OutputStream sink: interleaved S16_LE writei with underrun backoff."""

    def __init__(self, lib, pcm, channels: int, sample_rate: int):
        self._lib = lib
        self._pcm = pcm
        self.channels = channels
        self.sample_rate = sample_rate
        self._lock = threading.Lock()
        self.underruns = 0

    def __call__(self, frames: np.ndarray):
        pcm = (np.clip(frames, -1.0, 1.0) * 32767.0).astype("<i2")
        pcm = np.ascontiguousarray(pcm)
        with self._lock:
            if self._pcm is None:
                return
            self._writei(pcm)

    def _writei(self, pcm: np.ndarray):
        # one bounded loop, never recursion (1-frame short-write progress
        # on a large period would blow the stack); each error consumes one
        # recover+backoff attempt, and audio-out is best-effort like the
        # reference's callback — after the budget the period is dropped
        recoveries = 0
        while len(pcm):
            n = len(pcm)
            ret = self._lib.snd_pcm_writei(self._pcm, pcm.ctypes.data, n)
            if ret == n:
                return
            if ret > 0:  # short write: continue with the remainder
                pcm = np.ascontiguousarray(pcm[ret:])
                continue
            if ret == 0:
                log.warning("alsa: writei made no progress; "
                            "%d frames dropped", n)
                return
            if recoveries >= 2:
                log.warning("alsa: writei failing repeatedly (err %d); "
                            "%d frames dropped", int(ret), n)
                return
            # underrun: recover + 3 periods of silence, then retry
            # (output_device.rs:113-130 plays SILENCE_FRAMES for 3 callbacks)
            recoveries += 1
            self.underruns += 1
            self._lib.snd_pcm_recover(self._pcm, int(ret), 1)
            silence = np.zeros((n, self.channels), "<i2")
            for _ in range(_BACKOFF_PERIODS):
                if self._lib.snd_pcm_writei(
                        self._pcm, silence.ctypes.data, n) < 0:
                    self._lib.snd_pcm_recover(self._pcm, -_EPIPE, 1)

    def close(self):
        with self._lock:
            if self._pcm is not None:
                self._lib.snd_pcm_drain(self._pcm)
                self._lib.snd_pcm_close(self._pcm)
                self._pcm = None


class AlsaAudioBackend:
    """Soundcard backend over libasound; raises RuntimeError if the library
    is unavailable (callers use audio_out.get_backend() for gating)."""

    name = "alsa"

    def __init__(self):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("libasound unavailable")
        self._lib = lib

    def probe_default(self) -> bool:
        """Can the default device actually open?  auto-mode backend
        selection uses this so a host with libasound installed but no
        usable playback device (headless boxes) keeps the WAV-spool
        backend instead of silently dead audio."""
        dev = self.default_device()
        if dev is None:
            return False
        pcm = ctypes.c_void_p()
        if self._lib.snd_pcm_open(ctypes.byref(pcm), dev.encode(),
                                  _SND_PCM_STREAM_PLAYBACK, 0) < 0:
            return False
        self._lib.snd_pcm_close(pcm)
        return True

    def devices(self) -> List[Tuple[str, int]]:
        """Playback PCM names via device-name hints (the cpal enumeration
        path); stereo assumed as in the engine's L/R mapping."""
        hints = ctypes.POINTER(ctypes.c_void_p)()
        if self._lib.snd_device_name_hint(-1, b"pcm", ctypes.byref(hints)) < 0:
            return [("default", 2)]
        out: List[Tuple[str, int]] = []
        try:
            i = 0
            while hints[i]:
                name = _hint_str(self._lib, hints[i], b"NAME")
                ioid = _hint_str(self._lib, hints[i], b"IOID")
                i += 1
                if name is None or ioid == "Input":
                    continue
                out.append((name, 2))
        finally:
            self._lib.snd_device_name_free_hint(hints)
        return out or [("default", 2)]

    def default_device(self) -> Optional[str]:
        names = [n for (n, _) in self.devices()]
        return "default" if "default" in names else (names[0] if names else None)

    def open(self, device: str, sample_rate: int) -> Optional[OutputStream]:
        pcm = ctypes.c_void_p()
        err = self._lib.snd_pcm_open(
            ctypes.byref(pcm), device.encode(), _SND_PCM_STREAM_PLAYBACK, 0)
        if err < 0:
            log.warning("snd_pcm_open(%s) failed: %d", device, err)
            return None
        channels = 2
        err = self._lib.snd_pcm_set_params(
            pcm, _SND_PCM_FORMAT_S16_LE, _SND_PCM_ACCESS_RW_INTERLEAVED,
            channels, sample_rate, 1, _LATENCY_US)
        if err < 0:
            log.warning("snd_pcm_set_params failed: %d", err)
            self._lib.snd_pcm_close(pcm)
            return None
        sink = _AlsaSink(self._lib, pcm, channels, sample_rate)
        return OutputStream(channels, sink, sample_rate)
