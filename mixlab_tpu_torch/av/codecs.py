"""Codec backends (gated on availability): the port's copy of
``mixlab_tpu/av/codecs.py`` without the shim tier.

The reference links fdk-aac and x264 via FFI (``codec/src/avc/encode.rs``,
``src/video/encode.rs:146-308``).  Codecs here are a pluggable backend
interface, in preference order:

  * ``FfmpegAacStream`` / ``FfmpegH264Stream`` — AAC-ADTS / AVC via an
    ``ffmpeg`` CLI binary (subprocess pipes with drain threads), when one
    exists.
  * ``PureH264Stream`` (av/h264enc.py) + ``PureAacStream`` (av/aacenc.py)
    — zero-dependency tier: CAVLC intra H.264 (the C++ frame encoder of
    ``native/`` when it builds, else numpy) + AAC-LC; fMP4 with
    ``codecs="avc1.*, mp4a.40.2"`` plays via MSE with no codec libraries.
  * ``PcmAudioEncoder`` / ``PngVideoEncoder`` — preview mode: s16le
    passthrough + zlib PNG frames; the web client plays these via
    WebAudio/img when MSE is unavailable.

The JAX package's first tier, the in-process libavcodec shim
(``native/avshim.cpp``), is not ported: ``MIXLAB_CODEC_TIER=shim`` raises
(ROADMAP.md queue 1, Shim codec tier).

Operating points mirror the reference profiles:
  monitor:  560x350, all-key-frames, low latency (monitor.rs:21-22)
  stream:   1120x700, CBR 1.5 Mbps gop 60 (stream_output.rs:23-24)
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration, adts_frame
from mixlab_tpu_torch.video.colorspace import picture_yuv420_to_rgb
from mixlab_tpu_torch.video.frame import Picture, PictureSettings

MONITOR_PICTURE = PictureSettings(560, 350 + (350 % 2), "yuv420p")  # 560x350
STREAM_PICTURE = PictureSettings(1120, 700, "yuv420p")


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


NOT_PORTED_SHIM = (
    "the libavcodec shim codec tier (native/avshim.cpp) is not ported to "
    "mixlab_tpu_torch yet: ROADMAP.md queue 1, Shim codec tier")


def codec_tier() -> str:
    """Best available monitor codec backend:
      * "ffmpeg" — CLI subprocess pipes (AAC + H.264)
      * "pure"   — zero-dependency encoders: CAVLC intra H.264
                   (av/h264cavlc.py) + AAC-LC (av/aacenc.py)

    ``MIXLAB_CODEC_TIER`` overrides the auto-selection, as in the JAX
    package; an override naming an unavailable tier raises rather than
    silently auto-selecting, and ``shim`` always raises here.
    """
    forced = os.environ.get("MIXLAB_CODEC_TIER", "").strip().lower()
    if forced:
        if forced not in ("shim", "ffmpeg", "pure"):
            raise ValueError(f"MIXLAB_CODEC_TIER={forced!r}: expected "
                             "shim|ffmpeg|pure")
        if forced == "shim":
            raise RuntimeError(f"MIXLAB_CODEC_TIER=shim: {NOT_PORTED_SHIM}")
        if forced == "ffmpeg" and not ffmpeg_available():
            raise RuntimeError("MIXLAB_CODEC_TIER=ffmpeg but no ffmpeg CLI")
        return forced
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
    """Background stdout reader so codec pipes never deadlock."""

    def __init__(self, stream):
        import threading

        self.buf = bytearray()
        self.lock = threading.Lock()

        def run():
            while True:
                data = stream.read(65536)
                if not data:
                    return
                with self.lock:
                    self.buf += data

        threading.Thread(target=run, daemon=True).start()

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
        from mixlab_tpu_torch.av.aac import parse_adts_header

        frames = []
        buf = self.out.snapshot()
        consumed = 0
        while len(buf) - consumed >= 7:
            view = bytes(buf[consumed : consumed + 7])
            try:
                hdr = parse_adts_header(view)
            except Exception:
                consumed += 1  # resync
                continue
            n = hdr["frame_length"]
            if len(buf) - consumed < n:
                break
            frames.append(bytes(buf[consumed : consumed + n]))
            consumed += n
        if consumed:
            self.out.consume(consumed)
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


class PureAacStream:
    """Zero-dependency AAC-LC encode (av/aacenc.py, round 4): the duck
    type of the JAX package's ShimAacStream — feed interleaved i16, poll
    ADTS frames.
    Makes pure-tier RTMP publish and fMP4 monitoring standards-compliant
    where the reference cannot build at all (fdk-aac FFI,
    src/video/encode.rs:146-222)."""

    codec = "aac"

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 bitrate: Optional[int] = None, quality: int = 60):
        from mixlab_tpu_torch.av.aacenc import AacLcEncoder

        # bitrate engages the encoder's coarse rate control + reservoir
        # (the reference publishes CBR 160k, stream_output.rs:337-345);
        # None = VBR quality mode (cheapest, the monitor default)
        self._enc = AacLcEncoder(sample_rate, channels, quality=quality,
                                 bitrate=bitrate)
        self.sample_rate = sample_rate
        self.channels = channels
        self.asc = self._enc.asc
        self._buf = np.zeros((0, channels), dtype=np.int16)

    def feed(self, pcm_i16: np.ndarray):
        pcm = np.asarray(pcm_i16, dtype=np.int16).reshape(-1, self.channels)
        self._buf = np.concatenate([self._buf, pcm]) if len(self._buf) else pcm

    def poll_frames(self) -> List[bytes]:
        from mixlab_tpu_torch.av.aac import adts_frame

        out = []
        while len(self._buf) >= 1024:
            raw = self._enc.encode_granule(self._buf[:1024])
            self._buf = self._buf[1024:]
            out.append(adts_frame(raw, self.asc))
        return out

    def configuration_data(self) -> bytes:
        return self.asc.to_bytes()

    def close(self):
        pass
