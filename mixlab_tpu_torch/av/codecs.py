"""Codec backends (gated on availability): the port's copy of
``mixlab_tpu/av/codecs.py``.

The reference links fdk-aac and x264 via FFI (``codec/src/avc/encode.rs``,
``src/video/encode.rs:146-308``).  Codecs here are a pluggable backend
interface, in preference order:

  * ``ShimAacStream`` / ``ShimH264Stream`` — in-process libavcodec/libx264
    via the C++ shim (native/avshim.py): the reference's architecture.
    Real AAC-ADTS / AVC feeding the fMP4 mux for true MSE monitor parity.
  * ``FfmpegAacStream`` / ``FfmpegH264Stream`` — AAC-ADTS / AVC via an
    ``ffmpeg`` CLI binary (subprocess pipes with drain threads), when one
    exists.
  * ``PureH264Stream`` (av/h264enc.py) + ``PureAacStream`` (av/aacenc.py)
    — zero-dependency tier: CAVLC intra H.264 (the C++ frame encoder of
    ``native/`` when it builds, else numpy) + AAC-LC; fMP4 with
    ``codecs="avc1.*, mp4a.40.2"`` plays via MSE with no codec libraries.
    The AAC-LC encoder is Python; it runs in a codec process of its own
    (``av/aac_worker.py``), so that its time is not taken from the engine
    thread under the interpreter lock (the JAX package runs it in the
    calling thread).
  * ``PcmAudioEncoder`` / ``PngVideoEncoder`` — preview mode: s16le
    passthrough + zlib PNG frames; the web client plays these via
    WebAudio/img when MSE is unavailable.

Without the shim's libraries (``native.avshim.unavailable_reason()`` says
why, and the log names it once) the tier is the one the JAX package takes
there: ffmpeg, else pure.

Operating points mirror the reference profiles:
  monitor:  560x350, all-key-frames, low latency (monitor.rs:21-22)
  stream:   1120x700, CBR 1.5 Mbps gop 60 (stream_output.rs:23-24)
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import threading
import time
import weakref
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from mixlab_tpu_torch.av import codec_process
from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
from mixlab_tpu_torch.video.colorspace import picture_yuv420_to_rgb
from mixlab_tpu_torch.video.frame import Picture, PictureSettings

MONITOR_PICTURE = PictureSettings(560, 350 + (350 % 2), "yuv420p")  # 560x350
STREAM_PICTURE = PictureSettings(1120, 700, "yuv420p")


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def avshim_codecs_available() -> bool:
    """True when the ffmpeg-libraries shim (native/avshim.py) provides real
    AAC + H.264 encoders — the same FFI surface the reference links
    (codec/src/avc/encode.rs, fdk-aac)."""
    from mixlab_tpu_torch.native import avshim

    return (
        avshim.available()
        and avshim.have_encoder("libx264")
        and avshim.have_encoder("aac")
    )


def codec_tier() -> str:
    """Best available monitor codec backend:
      * "shim"   — in-process libavcodec/libx264 (AAC + H.264)
      * "ffmpeg" — CLI subprocess pipes (AAC + H.264)
      * "pure"   — zero-dependency encoders: CAVLC intra H.264
                   (av/h264cavlc.py) + AAC-LC (av/aacenc.py)

    ``MIXLAB_CODEC_TIER`` overrides the auto-selection (deployment
    debugging, or exercising the pure tier on an image that has the
    libraries); an override naming an unavailable tier raises rather than
    silently auto-selecting.
    """
    forced = os.environ.get("MIXLAB_CODEC_TIER", "").strip().lower()
    if forced:
        if forced not in ("shim", "ffmpeg", "pure"):
            raise ValueError(f"MIXLAB_CODEC_TIER={forced!r}: expected "
                             "shim|ffmpeg|pure")
        if forced == "shim" and not avshim_codecs_available():
            from mixlab_tpu_torch.native import avshim

            raise RuntimeError("MIXLAB_CODEC_TIER=shim but the libavcodec shim is "
                               f"unavailable: {avshim.unavailable_reason() or 'no libx264 or aac encoder'}")
        if forced == "ffmpeg" and not ffmpeg_available():
            raise RuntimeError("MIXLAB_CODEC_TIER=ffmpeg but no ffmpeg CLI")
        return forced
    if avshim_codecs_available():
        return "shim"
    if ffmpeg_available():
        return "ffmpeg"
    return "pure"


def fmp4_capable() -> bool:
    """Can the monitor path produce a real fMP4 stream?  Always true since
    the pure tier (CAVLC H.264 + FLAC) has no dependencies; kept for
    callers that distinguish fmp4 from the pcm+png preview mode."""
    return True


# ---------------------------------------------------------------------------
# audio encoders
# ---------------------------------------------------------------------------


class PcmAudioEncoder:
    """s16le passthrough; 'codec' name pcm_s16le."""

    codec = "pcm_s16le"

    def __init__(self, sample_rate: int = 44100, channels: int = 2):
        self.sample_rate = sample_rate
        self.channels = channels

    def encode(self, granule_i16: np.ndarray) -> bytes:
        return granule_i16.astype("<i2").tobytes()

    def configuration_data(self) -> bytes:
        return b""


class _DrainThread:
    """Background stdout reader so codec pipes never deadlock.  ``lock`` is
    a condition, notified at each read and at the end of the stream
    (``eof``), for a reader that waits for output."""

    def __init__(self, stream):
        self.buf = bytearray()
        self.lock = threading.Condition()
        self.eof = False

        def run():
            while True:
                data = stream.read1(65536)  # what is there, not a full 64 KiB
                with self.lock:
                    if not data:
                        self.eof = True
                        self.lock.notify_all()
                        return
                    self.buf += data
                    self.lock.notify_all()

        self.thread = threading.Thread(target=run, daemon=True, name="codec-drain")
        self.thread.start()

    def snapshot(self) -> bytearray:
        with self.lock:
            return bytearray(self.buf)

    def consume(self, n: int):
        with self.lock:
            del self.buf[:n]


class FfmpegAacStream:
    """Streaming AAC-LC encoder via the ffmpeg CLI (ADTS out).

    Push PCM with :meth:`feed`; poll complete ADTS frames with
    :meth:`poll_frames` (frame boundaries come from the ADTS frame-length
    field).  Operating point: CBR (stream profile, 160 kbps,
    stream_output.rs:337-345) or default VBR (monitor profile)."""

    codec = "aac"

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: Optional[int] = 160_000):
        self.sample_rate = sample_rate
        self.channels = channels
        self.asc = AudioSpecificConfiguration.lc_stereo(sample_rate)
        args = ["ffmpeg", "-loglevel", "quiet",
                "-f", "s16le", "-ar", str(sample_rate), "-ac", str(channels),
                "-i", "-", "-c:a", "aac"]
        if bitrate:
            args += ["-b:a", str(bitrate)]
        args += ["-f", "adts", "-"]
        self.proc = subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.out = _DrainThread(self.proc.stdout)

    def feed(self, pcm_i16: np.ndarray):
        self.proc.stdin.write(pcm_i16.astype("<i2").tobytes())
        self.proc.stdin.flush()

    def poll_frames(self):
        with self.out.lock:
            frames, used = _split_adts(self.out.buf)
            del self.out.buf[:used]
        return frames

    def configuration_data(self) -> bytes:
        return self.asc.to_bytes()


class FfmpegH264Stream:
    """Streaming H.264 encoder via the ffmpeg CLI (Annex B out, converted to
    avcc).  Profiles mirror the reference (video/encode.rs:253-271):
    monitor = all-intra ultrafast zerolatency CRF30; stream = CBR 1.5 Mbps
    gop 60."""

    codec = "h264"

    def __init__(self, picture: PictureSettings, fps: int = 60, profile: str = "monitor"):
        from mixlab_tpu_torch.av.avc import DecoderConfigurationRecord
        from mixlab_tpu_torch.av.sps import parse_sps

        self.picture = picture
        self._parse_sps = parse_sps
        self._DCR = DecoderConfigurationRecord
        self.dcr: Optional[bytes] = None
        args = ["ffmpeg", "-loglevel", "quiet",
                "-f", "rawvideo", "-pix_fmt", "yuv420p",
                "-s", f"{picture.width}x{picture.height}", "-r", str(fps), "-i", "-",
                "-c:v", "libx264", "-pix_fmt", "yuv420p"]
        if profile == "monitor":
            args += ["-preset", "ultrafast", "-tune", "zerolatency",
                     "-crf", "30", "-g", "1"]
        else:
            args += ["-preset", "fast", "-b:v", "1500k", "-g", "60"]
        args += ["-f", "h264", "-"]
        self.proc = subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.out = _DrainThread(self.proc.stdout)
        self._param_units = {}

    def feed(self, pic: Picture):
        pl = pic.to_numpy()  # host copy of the planes
        raw = pl["y"].tobytes() + pl["u"].tobytes() + pl["v"].tobytes()
        self.proc.stdin.write(raw)
        self.proc.stdin.flush()

    def poll_access_units(self):
        """-> list of (is_key, avcc_bytes). Updates self.dcr as SPS/PPS
        appear.  Splits on IDR/non-IDR boundaries."""
        from mixlab_tpu_torch.av.avc import UnitType, annexb_to_avcc

        data = bytes(self.out.snapshot())
        if not data:
            return []
        # keep a tail in the pipe buffer in case a NAL is split mid-stream:
        last_sc = max(data.rfind(b"\x00\x00\x01"), 0)
        if last_sc == 0:
            return []
        head, _tail = data[:last_sc], data[last_sc:]
        self.out.consume(last_sc)
        payload, params = annexb_to_avcc(head)
        for u in params:
            self._param_units[u.kind] = u
        sps = self._param_units.get(UnitType.SEQUENCE_PARAMETER_SET)
        pps = self._param_units.get(UnitType.PICTURE_PARAMETER_SET)
        if sps and pps and self.dcr is None:
            info = self._parse_sps(sps.data)
            self.dcr = self._DCR(
                1, info.profile_idc, 0, info.level_idc, 4, [sps], [pps]
            ).to_bytes()
        if not payload:
            return []
        is_key = b"\x65" in payload[:6] or any(
            u.kind == UnitType.IDR_PICTURE
            for u in _safe_units(payload)
        )
        return [(is_key, payload)]


def _safe_units(avcc: bytes):
    from mixlab_tpu_torch.av.avc import iter_nal_units

    try:
        return list(iter_nal_units(avcc, 4))
    except Exception:
        return []


# ---------------------------------------------------------------------------
# video encoders
# ---------------------------------------------------------------------------


@dataclass
class VideoPacket:
    dts: int
    pts: int
    is_key: bool
    data: bytes


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + kind
        + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png_rgb(rgb: np.ndarray) -> bytes:
    """Minimal PNG encoder (stdlib zlib), RGB8."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )


class PngVideoEncoder:
    """PNG preview 'encoder' — every frame is a key frame."""

    codec = "png"

    def __init__(self, picture: PictureSettings, device="cpu"):
        self.picture = picture
        self._blank = Picture.blank(picture, device)

    def blank_picture(self) -> Picture:
        return self._blank

    def encode(self, picture: Picture, pts: int) -> List[VideoPacket]:
        # converted on the picture's device, then fetched
        rgb = picture_yuv420_to_rgb(picture).planes["rgb"].cpu().numpy()
        return [VideoPacket(dts=pts, pts=pts, is_key=True, data=encode_png_rgb(rgb))]


def make_monitor_encoders(sample_rate: int):
    """(audio_encoder, video_encoder, mode) for the monitor profile."""
    audio = PcmAudioEncoder(sample_rate)
    video = PngVideoEncoder(MONITOR_PICTURE)
    return audio, video, "pcm+png"


def _split_adts(buf) -> tuple:
    """Whole ADTS frames at the start of ``buf`` -> (frames, bytes used);
    a byte that starts no valid header is skipped (resync)."""
    from mixlab_tpu_torch.av.aac import parse_adts_header

    frames = []
    used = 0
    while len(buf) - used >= 7:
        try:
            n = parse_adts_header(bytes(buf[used:used + 7]))["frame_length"]
        except Exception:
            used += 1
            continue
        if len(buf) - used < n:
            break
        frames.append(bytes(buf[used:used + n]))
        used += n
    return frames, used


# ---------------------------------------------------------------------------
# shim-backed codec streams (native/avshim.py): same duck-type interfaces as
# the Ffmpeg* CLI streams, but in-process via libavcodec — the reference's
# architecture (ffmpeg FFI + pure byte layers around it)
# ---------------------------------------------------------------------------


class ShimAacStream:
    """AAC-LC via libavcodec's native encoder; ADTS framing from av/aac.py
    (the reference wraps fdk output in its own pure-Rust ADTS the same way,
    monitor.rs:187-191 + aac/adts.rs)."""

    codec = "aac"

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: Optional[int] = 160_000):
        from mixlab_tpu_torch.native import avshim

        self._enc = avshim.AacEncoder(sample_rate, channels, bitrate)
        self.sample_rate = sample_rate
        self.channels = channels
        self.asc = AudioSpecificConfiguration.parse(self._enc.extradata()[:2])

    def feed(self, pcm_i16: np.ndarray):
        self._enc.send(np.asarray(pcm_i16).reshape(-1, self.channels))

    def poll_frames(self) -> List[bytes]:
        from mixlab_tpu_torch.av.aac import adts_frame

        return [adts_frame(raw, self.asc) for _, raw in self._enc.receive()]

    def configuration_data(self) -> bytes:
        return self._enc.extradata()

    def close(self):
        self._enc.close()


class ShimH264Stream:
    """H.264 via libx264 (libavcodec), avcc access units + DCR out.

    Matches FfmpegH264Stream's interface; profiles mirror the reference
    (monitor: CRF30/veryfast/zerolatency/gop1, monitor.rs:21-22;
    stream: CBR 1.5 Mbps slow/film gop60, stream_output.rs:23-24).  A
    picture on a device is copied to the host at ``feed``."""

    codec = "h264"

    def __init__(self, picture: PictureSettings, fps: int = 60,
                 profile: str = "monitor"):
        from mixlab_tpu_torch.av.avc import (
            DecoderConfigurationRecord,
            UnitType,
            annexb_to_avcc,
        )
        from mixlab_tpu_torch.av.sps import parse_sps
        from mixlab_tpu_torch.native import avshim

        self.picture = picture
        self._enc = avshim.VideoEncoder(picture.width, picture.height,
                                        max(fps, 1), profile)
        self._annexb_to_avcc = annexb_to_avcc
        # extradata is Annex-B SPS/PPS with GLOBAL_HEADER
        _, params = annexb_to_avcc(self._enc.extradata())
        sps = next(u for u in params if u.kind == UnitType.SEQUENCE_PARAMETER_SET)
        pps = next(u for u in params if u.kind == UnitType.PICTURE_PARAMETER_SET)
        info = parse_sps(sps.data)
        self.dcr = DecoderConfigurationRecord(
            1, info.profile_idc, 0, info.level_idc, 4, [sps], [pps]
        ).to_bytes()
        self._pts = 0

    def feed(self, pic: Picture):
        pl = pic.to_numpy()
        self._enc.send(pl["y"], pl["u"], pl["v"], self._pts)
        self._pts += 1

    def poll_access_units(self) -> List[tuple]:
        out = []
        for pts, dts, key, annexb in self._enc.receive():
            payload, _params = self._annexb_to_avcc(annexb)
            if payload:
                out.append((key, payload))
        return out

    def close(self):
        self._enc.close()


class PureAacStream:
    """Zero-dependency AAC-LC encode (av/aacenc.py): the duck type of the
    JAX package's ShimAacStream — feed interleaved i16, poll ADTS frames.
    Makes pure-tier RTMP publish and fMP4 monitoring standards-compliant
    where the reference cannot build at all (fdk-aac FFI,
    src/video/encode.rs:146-222).

    The encoder runs in a child process (``python -m
    mixlab_tpu_torch.av.aac_worker``, started here: never a fork of this
    process, which may hold a CUDA context), fed interleaved i16 over a
    pipe; its ADTS frames come back on another, read by a ``_DrainThread``.
    ``poll_frames`` returns the frames of every whole granule fed so far,
    waiting for the child without the interpreter lock, so the frames and
    the order they arrive in are the in-process encoder's, byte for byte
    (the JAX package's ``PureAacStream``); the child encodes while the
    caller does other work between ``feed`` and ``poll_frames``.  A child
    that dies raises ``RuntimeError`` in the caller; ``close`` ends it."""

    codec = "aac"
    POLL_TIMEOUT_S = 30.0

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: Optional[int] = None, quality: int = 60):
        from mixlab_tpu_torch.av.aac import (
            AudioObjectType,
            AudioSpecificConfiguration,
            sampling_frequency_index,
        )
        from mixlab_tpu_torch.av.aac_tables import SWB_OFFSET_LONG
        from mixlab_tpu_torch.av.aacenc import AacEncodeError

        # bitrate engages the encoder's coarse rate control + reservoir
        # (the reference publishes CBR 160k, stream_output.rs:337-345);
        # None = VBR quality mode (cheapest, the monitor default)
        sfi = sampling_frequency_index(sample_rate)
        if sfi not in SWB_OFFSET_LONG:  # refused here, as the encoder would
            raise AacEncodeError(f"unsupported sample rate {sample_rate}")
        self.sample_rate = sample_rate
        self.channels = channels
        self.asc = AudioSpecificConfiguration(
            object_type=AudioObjectType.LOW_COMPLEXITY,
            sampling_frequency_index=sfi, channel_configuration=channels)
        self.proc = codec_process.spawn("mixlab_tpu_torch.av.aac_worker", sample_rate,
                                        channels, quality, bitrate or 0)
        self.out = _DrainThread(self.proc.stdout)
        self._fed = 0       # samples per channel written to the child
        self._returned = 0  # frames handed out
        self._closer = weakref.finalize(self, codec_process.end_process, self.proc)

    def feed(self, pcm_i16: np.ndarray):
        pcm = np.asarray(pcm_i16, dtype="<i2").reshape(-1, self.channels)
        try:
            self.proc.stdin.write(pcm.tobytes())
            self.proc.stdin.flush()
        except (BrokenPipeError, ValueError) as e:
            raise RuntimeError(
                f"the AAC codec process has exited (code {self.proc.poll()})") from e
        self._fed += len(pcm)

    def poll_frames(self) -> List[bytes]:
        want = self._fed // 1024 - self._returned
        out: List[bytes] = []
        deadline = time.monotonic() + self.POLL_TIMEOUT_S
        with self.out.lock:
            while True:
                frames, used = _split_adts(self.out.buf)
                del self.out.buf[:used]
                out += frames
                if len(out) >= want:
                    break
                if self.out.eof:
                    raise RuntimeError(
                        f"the AAC codec process has exited (code {self.proc.poll()}) "
                        f"with {want - len(out)} frames owed")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the AAC codec process owes {want - len(out)} frames "
                        f"after {self.POLL_TIMEOUT_S} s")
                self.out.lock.wait(timeout=0.5)
        self._returned += len(out)
        return out

    def configuration_data(self) -> bytes:
        return self.asc.to_bytes()

    def close(self):
        """End the child (stdin closed, waited for, killed if it lingers)."""
        self._closer()
        self.out.thread.join(timeout=5)
