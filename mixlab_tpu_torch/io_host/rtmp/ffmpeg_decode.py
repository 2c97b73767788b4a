"""ffmpeg-CLI media decoder for RTMP ingest (gated backend).
(the port of ``mixlab_tpu/io_host/rtmp/ffmpeg_decode.py``)

Active only when an ``ffmpeg`` binary exists (av/codecs.py
``ffmpeg_available``) — the reference links fdk-aac/ffmpeg via FFI; this
build pipes through subprocesses:

  * audio: ADTS-framed AAC on stdin -> s16le 44.1 kHz stereo on stdout
    (forced stereo downmix, matching rtmp/mod.rs:229-231)
  * video: length-prefixed NALUs converted to Annex B on stdin -> rawvideo
    yuv420p frames on stdout, sized from our own SPS parse (av/sps.py)

Reader threads drain stdout so the pipes never deadlock; decoded output is
pulled by the ingest thread as it arrives (decode latency is hidden behind
the mountpoint rings exactly like the reference's decode threads).

Unlike the JAX package's tier, which hands on host numpy planes, the
pictures are uploaded to the engine's ``device`` (``_frame_on``, as the pure
tier does), so the VideoMixer sees one kind of frame whichever tier decoded.
"""

from __future__ import annotations

import logging
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from mixlab_tpu_torch.av import flv
from mixlab_tpu_torch.av.codec_process import end_process
from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration, adts_frame
from mixlab_tpu_torch.av.avc import DecoderConfigurationRecord, iter_nal_units
from mixlab_tpu_torch.av.sps import parse_sps
from mixlab_tpu_torch.io_host.rtmp.server import MediaDecoder, _frame_on

log = logging.getLogger(__name__)


class _PipeReader(threading.Thread):
    def __init__(self, stream, chunk: int = 65536):
        super().__init__(daemon=True)
        self.stream = stream
        self.chunk = chunk
        self.buf = bytearray()
        self.lock = threading.Lock()
        self.start()

    def run(self):
        while True:
            data = self.stream.read(self.chunk)
            if not data:
                return
            with self.lock:
                self.buf += data

    def take(self, n: int) -> Optional[bytes]:
        with self.lock:
            if len(self.buf) < n:
                return None
            out = bytes(self.buf[:n])
            del self.buf[:n]
            return out

    def take_all(self) -> bytes:
        with self.lock:
            out = bytes(self.buf)
            self.buf.clear()
            return out


class FfmpegDecoder(MediaDecoder):
    def __init__(self, device):
        self.device = torch.device(device)
        self.video_duration_hint = None  # set per tag from timestamp deltas
        self.asc: Optional[AudioSpecificConfiguration] = None
        self.dcr: Optional[DecoderConfigurationRecord] = None
        self.audio_proc = None
        self.audio_out: Optional[_PipeReader] = None
        self.video_proc = None
        self.video_out: Optional[_PipeReader] = None
        self.video_size = None  # (w, h)

    # -- audio -------------------------------------------------------------

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        self.asc = asc
        if self.audio_proc is None:
            self.audio_proc = subprocess.Popen(
                ["ffmpeg", "-loglevel", "quiet", "-f", "aac", "-i", "-",
                 "-f", "s16le", "-ar", "44100", "-ac", "2", "-"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            )
            self.audio_out = _PipeReader(self.audio_proc.stdout)

    def decode_audio(self, raw_aac: bytes):
        if self.asc is None or self.audio_proc is None:
            return None
        try:
            self.audio_proc.stdin.write(adts_frame(raw_aac, self.asc))
            self.audio_proc.stdin.flush()
        except (BrokenPipeError, ValueError):
            return None
        data = self.audio_out.take_all()
        n = len(data) - (len(data) % 4)
        if n == 0:
            return None
        pcm = np.frombuffer(data[:n], dtype="<i2").reshape(-1, 2)
        return pcm

    # -- video -------------------------------------------------------------

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        self.dcr = dcr
        for sps in dcr.sps:
            try:
                info = parse_sps(sps.data)
                self.video_size = (info.width, info.height)
            except Exception as e:
                log.warning("ffmpeg_decode: SPS parse failed: %s", e)
        if self.video_proc is None and self.video_size:
            self.video_proc = subprocess.Popen(
                ["ffmpeg", "-loglevel", "quiet", "-f", "h264", "-i", "-",
                 "-f", "rawvideo", "-pix_fmt", "yuv420p", "-"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            )
            self.video_out = _PipeReader(self.video_proc.stdout)
            # prime decoder with SPS/PPS in Annex B
            annexb = b""
            for u in dcr.sps + dcr.pps:
                annexb += b"\x00\x00\x00\x01" + u.to_bytes()
            self.video_proc.stdin.write(annexb)

    def decode_video(self, packet: flv.VideoPacket):
        if self.video_proc is None or self.dcr is None or not self.video_size:
            return None
        annexb = bytearray()
        try:
            for unit in iter_nal_units(packet.data, self.dcr.nalu_size):
                annexb += b"\x00\x00\x00\x01" + unit.to_bytes()
        except Exception as e:
            log.warning("ffmpeg_decode: NALU parse: %s", e)
            return None
        try:
            self.video_proc.stdin.write(bytes(annexb))
            self.video_proc.stdin.flush()
        except (BrokenPipeError, ValueError):
            return None

        w, h = self.video_size
        frame_bytes = w * h * 3 // 2
        raw = self.video_out.take(frame_bytes)
        if raw is None:
            return None
        y = np.frombuffer(raw[: w * h], dtype=np.uint8).reshape(h, w)
        u = np.frombuffer(raw[w * h : w * h * 5 // 4], dtype=np.uint8).reshape(h // 2, w // 2)
        v = np.frombuffer(raw[w * h * 5 // 4 :], dtype=np.uint8).reshape(h // 2, w // 2)
        return _frame_on(self.device, y, u, v, self.video_duration_hint)

    def close(self):
        for proc in (self.audio_proc, self.video_proc):
            if proc is not None:
                end_process(proc)
