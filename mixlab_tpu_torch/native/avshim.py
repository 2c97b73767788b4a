"""ctypes bindings for the ffmpeg-libraries shim (``avshim.cpp``): the
port's copy of ``mixlab_tpu/native/avshim.py``.

The reference links the ffmpeg C API via FFI for every compressed codec
(``codec/src/ffmpeg*.rs``, ``codec/src/avc/encode.rs``); this module is the
same boundary for the port: system libavcodec/libavformat behind a thin C
surface, loaded lazily, with ``available()`` gating so that a host without
the libraries takes the pure tiers, as the JAX package does
(``av/codecs.py`` ``codec_tier``, ``engine/media_player.py``, the RTMP and
Icecast decoders).

The library is built with ``g++`` at first use into ``mixlab_tpu_torch/_build/``
(not into the package, as the JAX package builds its copy), under a name
that carries a hash of the source and the flags, by one process at a time
(an exclusive ``flock`` on a lock file beside it) into a name of its own
that ``os.replace`` puts in place, as ``native/__init__.py`` builds the
port's other host library.  Where the build fails (no ffmpeg development
files, no ``g++``) ``available()`` is False and ``unavailable_reason()``
says why; it is logged once.  Host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "avshim.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
LIBS = ("-lavcodec", "-lavformat", "-lavutil", "-lswscale", "-lswresample")

_lib = None
_lock = threading.Lock()
_tried = False
_reason: Optional[str] = None

c_u8p = ctypes.POINTER(ctypes.c_uint8)
c_i16p = ctypes.POINTER(ctypes.c_int16)
# callback-IO bridge signatures (avshim_media_open_io)
_READ_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, c_u8p, ctypes.c_int)
_SEEK_CB = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_int)
c_i64p = ctypes.POINTER(ctypes.c_int64)
c_intp = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libavshim_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``avshim.cpp`` against the system ffmpeg libraries unless the
    library for the current source exists; raises ``RuntimeError`` with the
    compiler's message when ``g++`` fails (the libraries or their headers
    absent) or is absent."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():  # another process built it while this one waited
            return path
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ could not build {_SRC.name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {_SRC.name} (the ffmpeg libraries "
                               f"libavcodec, libavformat, libavutil, libswscale and "
                               f"libswresample with their headers are needed):\n"
                               f"{proc.stderr.strip()[-2000:]}")
        os.replace(tmp, path)  # atomic: no process ever loads half a file
    return path


def _sig(lib):
    f = lib.avshim_venc_open
    f.restype = ctypes.c_void_p
    f.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_char_p]
    lib.avshim_venc_extradata.restype = ctypes.c_int
    lib.avshim_venc_extradata.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int]
    lib.avshim_venc_send.restype = ctypes.c_int
    lib.avshim_venc_send.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int,
                                     c_u8p, ctypes.c_int, c_u8p, ctypes.c_int,
                                     ctypes.c_int64]
    lib.avshim_venc_flush.argtypes = [ctypes.c_void_p]
    lib.avshim_venc_receive.restype = ctypes.c_int
    lib.avshim_venc_receive.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int,
                                        c_i64p, c_i64p, c_intp]
    lib.avshim_venc_close.argtypes = [ctypes.c_void_p]

    lib.avshim_aenc_open.restype = ctypes.c_void_p
    lib.avshim_aenc_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.avshim_aenc_frame_size.restype = ctypes.c_int
    lib.avshim_aenc_frame_size.argtypes = [ctypes.c_void_p]
    lib.avshim_aenc_extradata.restype = ctypes.c_int
    lib.avshim_aenc_extradata.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int]
    lib.avshim_aenc_send.restype = ctypes.c_int
    lib.avshim_aenc_send.argtypes = [ctypes.c_void_p, c_i16p, ctypes.c_int]
    lib.avshim_aenc_flush.argtypes = [ctypes.c_void_p]
    lib.avshim_aenc_receive.restype = ctypes.c_int
    lib.avshim_aenc_receive.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int,
                                        c_i64p]
    lib.avshim_aenc_close.argtypes = [ctypes.c_void_p]

    lib.avshim_adec_open.restype = ctypes.c_void_p
    lib.avshim_adec_open.argtypes = [ctypes.c_char_p, c_u8p, ctypes.c_int]
    lib.avshim_adec_open2.restype = ctypes.c_void_p
    lib.avshim_adec_open2.argtypes = [ctypes.c_char_p, c_u8p, ctypes.c_int,
                                      ctypes.c_int]
    lib.avshim_adec_receive_flt.restype = ctypes.c_int
    lib.avshim_adec_receive_flt.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        c_intp, c_intp, c_i64p]
    lib.avshim_aenc_open2.restype = ctypes.c_void_p
    lib.avshim_aenc_open2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p]
    lib.avshim_adec_send.restype = ctypes.c_int
    lib.avshim_adec_send.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int,
                                     ctypes.c_int64]
    lib.avshim_adec_receive.restype = ctypes.c_int
    lib.avshim_adec_receive.argtypes = [ctypes.c_void_p, c_i16p, ctypes.c_int,
                                        c_intp, c_intp, c_i64p]
    lib.avshim_adec_close.argtypes = [ctypes.c_void_p]

    lib.avshim_vdec_open.restype = ctypes.c_void_p
    lib.avshim_vdec_open.argtypes = [ctypes.c_char_p, c_u8p, ctypes.c_int]
    lib.avshim_vdec_send.restype = ctypes.c_int
    lib.avshim_vdec_send.argtypes = [ctypes.c_void_p, c_u8p, ctypes.c_int,
                                     ctypes.c_int64]
    lib.avshim_vdec_receive.restype = ctypes.c_int
    lib.avshim_vdec_receive.argtypes = [ctypes.c_void_p, c_u8p, c_u8p, c_u8p,
                                        ctypes.c_int, c_intp, c_intp, c_i64p]
    lib.avshim_vdec_close.argtypes = [ctypes.c_void_p]

    lib.avshim_media_open.restype = ctypes.c_void_p
    lib.avshim_media_open.argtypes = [ctypes.c_char_p]
    lib.avshim_media_open_io.restype = ctypes.c_void_p
    lib.avshim_media_open_io.argtypes = [ctypes.c_void_p, _READ_CB, _SEEK_CB]
    lib.avshim_media_audio_info.restype = ctypes.c_int
    lib.avshim_media_audio_info.argtypes = [ctypes.c_void_p, c_intp, c_intp,
                                            c_intp, c_intp]
    lib.avshim_media_video_info.restype = ctypes.c_int
    lib.avshim_media_video_info.argtypes = [ctypes.c_void_p, c_intp, c_intp,
                                            c_intp, c_intp, c_intp, c_intp]
    lib.avshim_media_read.restype = ctypes.c_int
    lib.avshim_media_read.argtypes = [
        ctypes.c_void_p, c_i16p, ctypes.c_int, c_intp, c_i64p,
        c_u8p, c_u8p, c_u8p, ctypes.c_int, c_intp, c_intp, c_i64p,
    ]
    lib.avshim_media_seek_start.restype = ctypes.c_int
    lib.avshim_media_seek_start.argtypes = [ctypes.c_void_p]
    lib.avshim_media_close.argtypes = [ctypes.c_void_p]

    lib.avshim_have_encoder.restype = ctypes.c_int
    lib.avshim_have_encoder.argtypes = [ctypes.c_char_p]
    lib.avshim_have_decoder.restype = ctypes.c_int
    lib.avshim_have_decoder.argtypes = [ctypes.c_char_p]


def _load():
    global _lib, _tried, _reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _reason = str(e)
            log.warning("libavcodec shim unavailable, the pure codec tiers are used: %s", e)
            return None
        _sig(lib)
        _lib = lib
        return _lib


def unavailable_reason() -> Optional[str]:
    """Why the shim is unavailable (the build's or the loader's message);
    None where it loads (or has not been tried)."""
    _load()
    return _reason


def available() -> bool:
    return _load() is not None


def have_encoder(name: str) -> bool:
    lib = _load()
    return bool(lib and lib.avshim_have_encoder(name.encode()))


def have_decoder(name: str) -> bool:
    lib = _load()
    return bool(lib and lib.avshim_have_decoder(name.encode()))


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(c_u8p)


class ShimError(Exception):
    pass


class VideoEncoder:
    """libx264 via libavcodec (codec/src/avc/encode.rs analogue).

    Profiles mirror the reference's operating points
    (video/encode.rs:253-271)."""

    def __init__(self, width: int, height: int, fps: int, profile: str = "monitor",
                 codec: str = "libx264", opts: Optional[str] = None):
        lib = _load()
        if lib is None:
            raise ShimError("avshim unavailable")
        if opts is None and codec == "libx264":
            if profile == "monitor":
                # CRF 30, veryfast, zerolatency, gop 1 (monitor.rs:21-22)
                opts = "preset=veryfast,tune=zerolatency,crf=30,g=1,threads=1"
            else:
                # CBR 1.5 Mbps, slow, film, gop 60 (stream_output.rs:23-24)
                # bf=0: no B-frames, so dts==pts and FLV composition time
                # stays zero (rtmp/packet.rs BE24 field unused by this encoder)
                opts = ("preset=slow,tune=film,b=1500000,minrate=1500000,"
                        "maxrate=1500000,bufsize=3000000,g=60,bf=0,threads=2")
        self._h = lib.avshim_venc_open(codec.encode(), width, height, fps, 1,
                                       (opts or "").encode())
        if not self._h:
            raise ShimError(f"{codec} open failed")
        self._lib = lib
        self.width, self.height = width, height
        self._buf = np.zeros(width * height * 2 + 65536, dtype=np.uint8)
        self._pending: List[Tuple[int, int, bool, bytes]] = []

    def extradata(self) -> bytes:
        n = self._lib.avshim_venc_extradata(self._h, _u8(self._buf),
                                            len(self._buf))
        return bytes(self._buf[:n])

    def send(self, y: np.ndarray, u: np.ndarray, v: np.ndarray, pts: int):
        y = np.ascontiguousarray(y, dtype=np.uint8)
        u = np.ascontiguousarray(u, dtype=np.uint8)
        v = np.ascontiguousarray(v, dtype=np.uint8)
        for _ in range(2):
            rc = self._lib.avshim_venc_send(
                self._h, _u8(y), y.shape[1], _u8(u), u.shape[1], _u8(v),
                v.shape[1], pts,
            )
            if rc == -11:  # EAGAIN: drain pending packets, retry
                self._pending.extend(self._receive_raw())
                continue
            break
        if rc < 0:
            raise ShimError(f"venc_send: {rc}")

    def flush(self):
        # avcodec_send_frame(NULL) returns EAGAIN while packets are
        # pending; drain and retry or the last frame is silently dropped
        rc = self._lib.avshim_venc_flush(self._h)
        if rc == -11:
            self._pending.extend(self._receive_raw())
            self._lib.avshim_venc_flush(self._h)

    def receive(self) -> List[Tuple[int, int, bool, bytes]]:
        """[(pts, dts, is_key, annexb_payload)]"""
        out = self._pending
        self._pending = []
        out.extend(self._receive_raw())
        return out

    def _receive_raw(self) -> List[Tuple[int, int, bool, bytes]]:
        out = []
        pts = ctypes.c_int64()
        dts = ctypes.c_int64()
        key = ctypes.c_int()
        while True:
            n = self._lib.avshim_venc_receive(
                self._h, _u8(self._buf), len(self._buf),
                ctypes.byref(pts), ctypes.byref(dts), ctypes.byref(key))
            if n == 0:
                return out
            if n < -1000:
                self._buf = np.zeros((-n) * 2, dtype=np.uint8)
                continue
            if n < 0:
                raise ShimError(f"venc_receive: {n}")
            out.append((pts.value, dts.value, bool(key.value),
                        bytes(self._buf[:n])))

    def close(self):
        if self._h:
            self._lib.avshim_venc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AacEncoder:
    """Native AAC-LC encoder (AudioCtx analogue, video/encode.rs:146-222)."""

    def __init__(self, sample_rate: int, channels: int = 2,
                 bitrate: Optional[int] = None, codec: str = "aac",
                 opts: str = ""):
        lib = _load()
        if lib is None:
            raise ShimError("avshim unavailable")
        self._h = lib.avshim_aenc_open2(codec.encode(), sample_rate, channels,
                                        bitrate or 0, opts.encode())
        if not self._h:
            raise ShimError(f"{codec} open failed")
        self._lib = lib
        self.sample_rate = sample_rate
        self.channels = channels
        self.frame_size = lib.avshim_aenc_frame_size(self._h)
        self._buf = np.zeros(65536, dtype=np.uint8)
        self._pending: List[Tuple[int, bytes]] = []

    def extradata(self) -> bytes:
        """AudioSpecificConfiguration bytes (aac/config.rs analogue)."""
        n = self._lib.avshim_aenc_extradata(self._h, _u8(self._buf),
                                            len(self._buf))
        return bytes(self._buf[:n])

    def send(self, pcm_i16: np.ndarray):
        pcm = np.ascontiguousarray(pcm_i16, dtype=np.int16).reshape(-1)
        nframes = len(pcm) // self.channels
        # chunk large pushes so the C-side granule fifo never overflows
        step = 16384
        for at in range(0, nframes, step):
            chunk = pcm[at * self.channels : (at + step) * self.channels]
            rc = self._lib.avshim_aenc_send(
                self._h, chunk.ctypes.data_as(c_i16p),
                len(chunk) // self.channels)
            if rc < 0:
                raise ShimError(f"aenc_send: {rc}")
            self._pending.extend(self._receive_raw())

    def flush(self):
        # see VideoEncoder.flush: EAGAIN means drain first, then re-flush
        rc = self._lib.avshim_aenc_flush(self._h)
        if rc == -11:
            self._pending.extend(self._receive_raw())
            self._lib.avshim_aenc_flush(self._h)

    def receive(self) -> List[Tuple[int, bytes]]:
        """[(pts_samples, raw_frame)] — no framing; wrap via av/aac.py."""
        out = self._pending
        self._pending = []
        out.extend(self._receive_raw())
        return out

    def _receive_raw(self) -> List[Tuple[int, bytes]]:
        out = []
        pts = ctypes.c_int64()
        while True:
            n = self._lib.avshim_aenc_receive(self._h, _u8(self._buf),
                                              len(self._buf), ctypes.byref(pts))
            if n == 0:
                return out
            if n < 0:
                raise ShimError(f"aenc_receive: {n}")
            out.append((pts.value, bytes(self._buf[:n])))

    def close(self):
        if self._h:
            self._lib.avshim_aenc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AudioDecoder:
    """AAC (and other) audio decode (rtmp/mod.rs:192-258 analogue)."""

    def __init__(self, codec: str, extradata: bytes = b"", strict: bool = False):
        """``strict``: bitstream errors fail the decode instead of being
        concealed (err_recognition EXPLODE) — the AAC table-extraction
        oracle's success/failure signal."""
        lib = _load()
        if lib is None:
            raise ShimError("avshim unavailable")
        ed = np.frombuffer(extradata, dtype=np.uint8) if extradata else None
        self._h = lib.avshim_adec_open2(
            codec.encode(), _u8(ed) if ed is not None else None,
            len(extradata), 1 if strict else 0)
        if not self._h:
            raise ShimError(f"decoder {codec} open failed")
        self._lib = lib
        self._buf = np.zeros(65536 * 8, dtype=np.int16)
        self._fbuf = np.zeros(65536 * 8, dtype=np.float32)

    def decode(self, packet: bytes, pts: int = 0) -> List[Tuple[int, np.ndarray, int]]:
        """-> [(pts, pcm (frames, ch) i16, sample_rate)]"""
        data = np.frombuffer(packet, dtype=np.uint8)
        rc = self._lib.avshim_adec_send(self._h, _u8(data), len(packet), pts)
        if rc < 0:
            raise ShimError(f"adec_send: {rc}")
        return self._drain()

    def decode_flt(self, packet: bytes, pts: int = 0) -> List[Tuple[int, np.ndarray, int]]:
        """Like ``decode`` but float32 output (no s16 quantization).
        Raises ShimError on send OR receive errors (with strict=True any
        bitstream parse error surfaces here)."""
        data = np.frombuffer(packet, dtype=np.uint8)
        rc = self._lib.avshim_adec_send(self._h, _u8(data), len(packet), pts)
        if rc < 0:
            raise ShimError(f"adec_send: {rc}")
        out = []
        ch = ctypes.c_int()
        rate = ctypes.c_int()
        fpts = ctypes.c_int64()
        while True:
            n = self._lib.avshim_adec_receive_flt(
                self._h, self._fbuf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)),
                len(self._fbuf) // 8, ctypes.byref(ch), ctypes.byref(rate),
                ctypes.byref(fpts))
            if n == 0:
                return out
            if n < 0:
                raise ShimError(f"adec_receive: {n}")
            pcm = self._fbuf[: n * ch.value].reshape(n, ch.value).copy()
            out.append((fpts.value, pcm, rate.value))

    def _drain(self):
        out = []
        ch = ctypes.c_int()
        rate = ctypes.c_int()
        fpts = ctypes.c_int64()
        while True:
            n = self._lib.avshim_adec_receive(
                self._h, self._buf.ctypes.data_as(c_i16p),
                len(self._buf) // 8, ctypes.byref(ch), ctypes.byref(rate),
                ctypes.byref(fpts))
            if n <= 0:
                return out
            pcm = self._buf[: n * ch.value].reshape(n, ch.value).copy()
            out.append((fpts.value, pcm, rate.value))

    def close(self):
        if self._h:
            self._lib.avshim_adec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoDecoder:
    """H.264 (and other) video decode to yuv420p (rtmp/mod.rs:260-338)."""

    def __init__(self, codec: str, extradata: bytes = b"",
                 max_pixels: int = 4096 * 2304):
        lib = _load()
        if lib is None:
            raise ShimError("avshim unavailable")
        ed = np.frombuffer(extradata, dtype=np.uint8) if extradata else None
        self._h = lib.avshim_vdec_open(
            codec.encode(), _u8(ed) if ed is not None else None,
            len(extradata))
        if not self._h:
            raise ShimError(f"decoder {codec} open failed")
        self._lib = lib
        self._cap = max_pixels
        self._y = np.zeros(max_pixels, dtype=np.uint8)
        self._u = np.zeros(max_pixels // 4, dtype=np.uint8)
        self._v = np.zeros(max_pixels // 4, dtype=np.uint8)

    def decode(self, packet: bytes, pts: int = 0):
        """-> [(pts, y, u, v)] planes as 2-D u8 arrays."""
        data = np.frombuffer(packet, dtype=np.uint8)
        rc = self._lib.avshim_vdec_send(self._h, _u8(data), len(packet), pts)
        if rc < 0:
            raise ShimError(f"vdec_send: {rc}")
        return self._drain()

    def flush(self):
        self._lib.avshim_vdec_send(self._h, None, 0, 0)
        return self._drain()

    def _drain(self):
        out = []
        w = ctypes.c_int()
        h = ctypes.c_int()
        fpts = ctypes.c_int64()
        while True:
            rc = self._lib.avshim_vdec_receive(
                self._h, _u8(self._y), _u8(self._u), _u8(self._v), self._cap,
                ctypes.byref(w), ctypes.byref(h), ctypes.byref(fpts))
            if rc == 0:
                return out
            if rc < 0:
                raise ShimError(f"vdec_receive: {rc}")
            W, H = w.value, h.value
            out.append((
                fpts.value,
                self._y[: W * H].reshape(H, W).copy(),
                self._u[: W * H // 4].reshape(H // 2, W // 2).copy(),
                self._v[: W * H // 4].reshape(H // 2, W // 2).copy(),
            ))

    def close(self):
        if self._h:
            self._lib.avshim_vdec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_AVERROR_EOF = -0x20464F45  # FFERRTAG('E','O','F',' ')
_AVERROR_EIO = -5
_AVSEEK_SIZE = 0x10000


class MediaReader:
    """Demux + decode a media file: audio as i16 at native rate, video as
    yuv420p planes, both with rational pts (InputContainer +
    media_source.rs:185-292 decode-loop analogue).

    ``from_reader`` opens via callback IO (avio_alloc_context) so project
    blob streams demux directly, with no temp-file spool — the reference's
    IoReader bridge (codec/src/ffmpeg/ioctx.rs:15-100).  Python exceptions
    inside the C callbacks are trapped into an error side-channel
    (``io_error``) and surfaced as IO errors to libavformat, mirroring the
    reference's panic-catching callbacks."""

    def __init__(self, path: str, max_pixels: int = 4096 * 2304):
        lib = _load()
        if lib is None:
            raise ShimError("avshim unavailable")
        self._cbs = None
        self.io_error = None
        self._h = lib.avshim_media_open(str(path).encode())
        if not self._h:
            raise ShimError(f"cannot open media: {path}")
        self._lib = lib
        self._init_streams(lib, max_pixels)

    @classmethod
    def from_reader(cls, reader, max_pixels: int = 4096 * 2304) -> "MediaReader":
        """Open from a seekable reader: read(n) -> bytes, seek(pos, whence)
        -> new offset, and a ``size`` attribute (project.ReadStream)."""
        lib = _load()
        if lib is None:
            raise ShimError("avshim unavailable")
        self = cls.__new__(cls)
        self._lib = lib
        self.io_error = None

        def _read(_opaque, buf, n):
            try:
                data = reader.read(n)
            except Exception as e:  # error side-channel (ioctx.rs:60-80)
                self.io_error = e
                return _AVERROR_EIO
            if not data:
                return _AVERROR_EOF
            ctypes.memmove(buf, data, len(data))
            return len(data)

        def _seek(_opaque, off, whence):
            try:
                if whence & _AVSEEK_SIZE:
                    return int(getattr(reader, "size", -1))
                return int(reader.seek(off, whence & 3))
            except Exception as e:
                self.io_error = e
                return -1

        # the CFUNCTYPE objects must outlive the handle: keep them on self
        self._cbs = (_READ_CB(_read), _SEEK_CB(_seek))
        self._h = lib.avshim_media_open_io(None, self._cbs[0], self._cbs[1])
        if not self._h:
            err = f": {self.io_error}" if self.io_error else ""
            raise ShimError(f"cannot open media from reader{err}")
        self._init_streams(lib, max_pixels)
        return self

    def _init_streams(self, lib, max_pixels: int):
        rate = ctypes.c_int(); ch = ctypes.c_int()
        tn = ctypes.c_int(); td = ctypes.c_int()
        self.audio = None
        if lib.avshim_media_audio_info(self._h, ctypes.byref(rate),
                                       ctypes.byref(ch), ctypes.byref(tn),
                                       ctypes.byref(td)):
            self.audio = {"rate": rate.value, "channels": ch.value,
                          "time_base": (tn.value, td.value)}
        w = ctypes.c_int(); hh = ctypes.c_int()
        fn = ctypes.c_int(); fd = ctypes.c_int()
        self.video = None
        if lib.avshim_media_video_info(self._h, ctypes.byref(w),
                                       ctypes.byref(hh), ctypes.byref(tn),
                                       ctypes.byref(td), ctypes.byref(fn),
                                       ctypes.byref(fd)):
            self.video = {"width": w.value, "height": hh.value,
                          "time_base": (tn.value, td.value),
                          "fps": (fn.value, fd.value)}
        self._cap = max_pixels
        self._abuf = np.zeros(65536 * 8, dtype=np.int16)
        self._y = np.zeros(max_pixels, dtype=np.uint8)
        self._u = np.zeros(max_pixels // 4, dtype=np.uint8)
        self._v = np.zeros(max_pixels // 4, dtype=np.uint8)

    def read(self):
        """-> ("audio", pts, pcm) | ("video", pts, (y,u,v)) | None at EOF."""
        an = ctypes.c_int(); apts = ctypes.c_int64()
        vw = ctypes.c_int(); vh = ctypes.c_int(); vpts = ctypes.c_int64()
        ch = self.audio["channels"] if self.audio else 2
        rc = self._lib.avshim_media_read(
            self._h, self._abuf.ctypes.data_as(c_i16p),
            len(self._abuf) // max(ch, 1), ctypes.byref(an),
            ctypes.byref(apts), _u8(self._y), _u8(self._u), _u8(self._v),
            self._cap, ctypes.byref(vw), ctypes.byref(vh), ctypes.byref(vpts))
        if rc == 0:
            return None
        if rc < 0:
            raise ShimError(f"media_read: {rc}")
        if rc == 1:
            pcm = self._abuf[: an.value * ch].reshape(an.value, ch).copy()
            return ("audio", apts.value, pcm)
        W, H = vw.value, vh.value
        return ("video", vpts.value, (
            self._y[: W * H].reshape(H, W).copy(),
            self._u[: W * H // 4].reshape(H // 2, W // 2).copy(),
            self._v[: W * H // 4].reshape(H // 2, W // 2).copy(),
        ))

    def seek_start(self) -> int:
        """Seek back to the start; -> libavformat's code (< 0: the demuxer
        cannot seek this input, e.g. a fragmented MP4 with no index)."""
        return self._lib.avshim_media_seek_start(self._h)

    def close(self):
        if self._h:
            self._lib.avshim_media_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
