"""Icecast SOURCE ingest (the port of ``mixlab_tpu/io_host/icecast.py``).

Rebuild of ``src/icecast/``: a SOURCE client (ices/butt/liquidsoap-style)
connects on the shared port, the request is parsed HTTP-style
(``src/icecast/http.rs``), a ``200 OK`` is sent, and the body is decoded on
a worker thread into i16 stereo PCM pushed into the mountpoint registry
with realtime pacing (``AudioThrottle``, ``src/icecast/mod.rs:101-138``).

Codec support is a superset of the reference: the reference decodes
Ogg/Vorbis via lewton and rejects non-44.1 kHz streams with a TODO
(icecast/mod.rs:94-97).  Here:
  * Ogg/Vorbis decodes natively via the pure decoder in ``av/vorbis.py``
    (no ffmpeg), mono upmixed to stereo like the reference
    (icecast/mod.rs:110-123);
  * WAV (s16/f32) and raw s16le (audio/L16) bodies decode natively;
  * ANY sample rate is accepted — the polyphase resampler converts to the
    engine rate on the ingest thread (the reference's missing feature).

  * MP3 and ADTS-AAC decode through the in-process libavcodec shim
    (``native/avshim.py``, ``_ShimAudioDecoder``), our pure frame
    splitters (``av/mp3.py``, ``av/aac.py``) cutting the stream into
    packets.  Where the shim's libraries are absent, the source is refused
    with a log line that says so, and the mount closes (the JAX package
    raises out of its handler there).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

import numpy as np

from mixlab_tpu_torch.dsp.resampler import context_len, design, resample_block_np
from mixlab_tpu_torch.engine.config import DEFAULT_CONFIG
from mixlab_tpu_torch.engine.media_player import NO_SHIM
from mixlab_tpu_torch.io_host import source as source_mod
from mixlab_tpu_torch.io_host.throttle import AudioThrottle
from mixlab_tpu_torch.io_host.wav import WavError, WavFormat, decode_frames, parse_header
from mixlab_tpu_torch.server.http import read_request, response
from mixlab_tpu_torch.utils.mtime import MediaTime

log = logging.getLogger(__name__)


ENGINE_RATE = DEFAULT_CONFIG.sample_rate


def listen(mountpoint: str):
    """Called by stream_input modules (stream_input.rs:158-165)."""
    return source_mod.ICECAST_MOUNTPOINTS.listen(mountpoint)


async def accept(reader, writer):
    """Handle one SOURCE connection (icecast/mod.rs:26-63)."""
    try:
        req = await read_request(reader)
    except Exception:
        writer.write(response(400, "Bad Request"))
        return
    if req is None or req.method != "SOURCE":
        writer.write(response(405, "Method Not Allowed"))
        return

    mountpoint = req.path.lstrip("/")
    content_type = (req.header("content-type") or "").lower()

    is_ogg = "ogg" in content_type or "vorbis" in content_type

    try:
        send = source_mod.ICECAST_MOUNTPOINTS.connect(mountpoint)
    except source_mod.ConnectError:
        writer.write(response(403, "Forbidden", b"mountpoint unavailable"))
        return

    writer.write(b"HTTP/1.0 200 OK\r\n\r\n")
    await writer.drain()

    decoder = None
    if is_ogg:
        decoder = _OggVorbisDecoder(content_type, engine_rate=ENGINE_RATE)
    try:
        while True:
            chunk = await reader.read(16384)
            if not chunk:
                break
            if decoder is None:
                # sniff: SOURCE clients don't always set content-type
                try:
                    decoder = _pick_decoder(content_type, chunk)
                except RuntimeError as e:
                    log.warning("icecast: source on /%s refused, the mount closes: %s",
                                mountpoint, e)
                    break
            # decode + pace on a worker thread so the event loop stays live
            try:
                pcm = await asyncio.get_running_loop().run_in_executor(
                    None, decoder.feed, chunk
                )
            except Exception as e:
                # malformed/corrupted source data (network input is
                # untrusted): drop the mount, never the server
                log.warning("icecast: decode failed, dropping mount: %s", e)
                break
            if pcm is not None and len(pcm):
                if not send.write_audio(
                    MediaTime.new(decoder.samples_out - len(pcm), ENGINE_RATE), pcm
                ):
                    break  # receiver gone
    finally:
        send.close()


def _pick_decoder(content_type: str, first_chunk: bytes):
    """Codec selection for a SOURCE body: explicit content-type first,
    then byte sniffing (Ogg magic, MPEG-audio sync, ADTS sync)."""
    from mixlab_tpu_torch.av.mp3 import looks_like_mp3

    ct = content_type
    if first_chunk[:4] == b"OggS" or "ogg" in ct or "vorbis" in ct:
        return _OggVorbisDecoder(ct, engine_rate=ENGINE_RATE)
    if "mpeg" in ct or "mp3" in ct or looks_like_mp3(first_chunk[:10]):
        return _ShimAudioDecoder(ct, ENGINE_RATE, "mp3")
    if "aac" in ct or _looks_like_adts(first_chunk[:7]):
        return _ShimAudioDecoder(ct, ENGINE_RATE, "aac")
    return _PcmDecoder(ct, engine_rate=ENGINE_RATE)


def _looks_like_adts(data: bytes) -> bool:
    if len(data) < 2 or data[0] != 0xFF or (data[1] & 0xF0) != 0xF0:
        return False
    return (data[1] & 0x06) == 0  # layer bits 00 distinguish ADTS from MP3


class _PcmDecoder:
    """Streaming WAV/raw-PCM decoder + resampler + realtime throttle."""

    def __init__(self, content_type: str, engine_rate: int):
        self.engine_rate = engine_rate
        self.content_type = content_type
        self.fmt: Optional[WavFormat] = None
        self.header_buf = bytearray()
        self.byte_carry = b""
        self.sample_carry = np.zeros((0, 2), dtype=np.int16)
        self.resample_ctx = None
        self.throttle: Optional[AudioThrottle] = None
        self.samples_out = 0
        self.is_wav = "wav" not in content_type  # resolved on first bytes
        self._header_done = False

    def feed(self, chunk: bytes) -> Optional[np.ndarray]:
        if not self._header_done:
            self.header_buf += chunk
            if self.header_buf[:4] == b"RIFF":
                try:
                    fmt, off, _size = parse_header(bytes(self.header_buf))
                except WavError:
                    if len(self.header_buf) < 65536:
                        return None  # need more header bytes
                    raise
                self.fmt = fmt
                chunk = bytes(self.header_buf[off:])
            else:
                if len(self.header_buf) < 12:
                    return None
                # raw s16le; rate from content-type param or engine rate
                rate = self.engine_rate
                for part in self.content_type.split(";"):
                    part = part.strip()
                    if part.startswith("rate="):
                        rate = int(part[5:])
                self.fmt = WavFormat(2, rate, 16, 1)
                chunk = bytes(self.header_buf)
            self._header_done = True
            self.header_buf = bytearray()
            self.throttle = AudioThrottle(self.fmt.sample_rate)

        fmt = self.fmt
        data = self.byte_carry + chunk
        usable = len(data) - (len(data) % fmt.bytes_per_frame)
        self.byte_carry = data[usable:]
        frames = decode_frames(fmt, data[:usable])
        if len(frames) == 0:
            return None

        # realtime pacing at the SOURCE rate (icecast decode loop behaviour)
        self.throttle.send_samples(len(frames))

        if fmt.sample_rate == self.engine_rate:
            out = frames
        else:
            out = self._resample(frames)
        self.samples_out += len(out)
        return out

    def _resample(self, frames: np.ndarray) -> np.ndarray:
        L, M, _ = design(self.fmt.sample_rate, self.engine_rate)
        buf = np.concatenate([self.sample_carry, frames], axis=0)
        usable = len(buf) - (len(buf) % M)
        self.sample_carry = buf[usable:]
        if usable == 0:
            return np.zeros((0, 2), dtype=np.int16)
        x = buf[:usable].astype(np.float32)
        if self.resample_ctx is None:
            self.resample_ctx = np.zeros(
                (context_len(self.fmt.sample_rate, self.engine_rate), 2),
                dtype=np.float32,
            )
        y, self.resample_ctx = resample_block_np(
            x, self.resample_ctx, self.fmt.sample_rate, self.engine_rate
        )
        return np.clip(y, -32768, 32767).astype(np.int16)


class _OggVorbisDecoder(_PcmDecoder):
    """Ogg/Vorbis body decode via the pure decoder (av/vorbis.py), matching
    the reference's lewton path (icecast/mod.rs:101-138): i16 stereo out,
    mono upmixed, realtime-throttled at the source rate, resampled to the
    engine rate (which the reference TODO'd at icecast/mod.rs:94-97)."""

    def __init__(self, content_type: str, engine_rate: int):
        super().__init__(content_type, engine_rate)
        from mixlab_tpu_torch.av.vorbis import OggVorbisStream

        self.stream = OggVorbisStream()

    def feed(self, chunk: bytes) -> Optional[np.ndarray]:
        pcm = self.stream.feed_i16(chunk)
        if self.fmt is None:
            if self.stream.info is None:
                return None
            self.fmt = WavFormat(2, self.stream.info.sample_rate, 16, 1)
            self.throttle = AudioThrottle(self.fmt.sample_rate)
        if len(pcm) == 0:
            return None
        self.throttle.send_samples(len(pcm))
        if self.fmt.sample_rate == self.engine_rate:
            out = pcm
        else:
            out = self._resample(pcm)
        self.samples_out += len(out)
        return out


class _ShimAudioDecoder(_PcmDecoder):
    """MP3 / ADTS-AAC ingest: our pure frame splitters (av/mp3.py, av/aac.py)
    segment the raw stream into packets for the in-process libavcodec
    decoder — real-world Icecast sources mostly send MP3, which the
    reference rejects outright (icecast/mod.rs)."""

    def __init__(self, content_type: str, engine_rate: int, codec: str):
        super().__init__(content_type, engine_rate)
        from mixlab_tpu_torch.native import avshim

        if not avshim.available():
            raise RuntimeError(f"icecast: no {codec} decoder: {NO_SHIM}")
        if not avshim.have_decoder(codec):
            raise RuntimeError(f"icecast: no {codec} decoder in this libavcodec")
        self._dec = avshim.AudioDecoder(codec)
        self._codec = codec
        if codec == "mp3":
            from mixlab_tpu_torch.av.mp3 import Mp3FrameSplitter

            self._split = Mp3FrameSplitter().feed
        else:
            self._adts_buf = bytearray()
            self._split = self._split_adts

    def _split_adts(self, data: bytes):
        from mixlab_tpu_torch.av.aac import parse_adts_header

        self._adts_buf += data
        out = []
        while len(self._adts_buf) >= 7:
            try:
                hdr = parse_adts_header(bytes(self._adts_buf[:7]))
            except Exception:
                del self._adts_buf[0:1]  # resync
                continue
            n = hdr["frame_length"]
            if len(self._adts_buf) < n:
                break
            out.append(bytes(self._adts_buf[:n]))
            del self._adts_buf[:n]
        return out

    def feed(self, chunk: bytes) -> Optional[np.ndarray]:
        pcms = []
        for frame in self._split(chunk):
            for _pts, pcm, rate in self._dec.decode(frame):
                if self.fmt is None:
                    self.fmt = WavFormat(2, rate, 16, 1)
                    self.throttle = AudioThrottle(rate)
                if pcm.shape[1] == 1:
                    pcm = np.repeat(pcm, 2, axis=1)
                pcms.append(pcm[:, :2])
        if not pcms:
            return None
        frames_pcm = np.ascontiguousarray(np.concatenate(pcms))
        self.throttle.send_samples(len(frames_pcm))
        if self.fmt.sample_rate == self.engine_rate:
            out = frames_pcm
        else:
            out = self._resample(frames_pcm)
        self.samples_out += len(out)
        return out
