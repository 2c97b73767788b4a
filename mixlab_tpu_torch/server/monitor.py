"""Monitor sockets + codec pipeline (the port's copy of
``mixlab_tpu/server/monitor.py``).

Rebuild of ``src/module/monitor.rs``: each Monitor module gets a UUID socket
registered in a global map (monitor.rs:24-26); a codec thread consumes
(timestamp, audio, video) ticks from the engine over a bounded queue with
drop-on-lag (monitor.rs:154-176) and broadcasts encoded segments to every
WebSocket subscribed at ``/_monitor/<uuid>`` (monitor.rs:33-66).

The codec thread always muxes fMP4: audio + AVC into the fragmented-MP4
mux for MSE (reference parity).  Backends (av/codecs.py codec_tier): the
in-process libavcodec shim (libx264 + AAC) where its libraries exist, else
the ffmpeg CLI when present, else the pure zero-dependency tier (CAVLC
intra H.264 + AAC-LC), so the stream is always available.  On the pure
tier ``MIXLAB_PURE_AUDIO=flac`` muxes lossless FLAC (``av/flacenc.py``,
``codecs="avc1.…, flac"``) in place of AAC, as in the JAX package; the FLAC
encoder runs on this thread.  The JAX package's ``pcm+png`` preview mode is
left out: every tier muxes fMP4, so no caller would reach it.

Transport packet framing (binary WS message): one JSON header line + b"\\n"
+ raw payload.  The reference's ``MonitorTransportPacket`` bincode enum
(protocol/src/lib.rs:254-263) maps to header kinds init/audio/video.

Differences from the JAX package, each deliberate:
  * the Monitor's picture is scaled to ``MONITOR_PICTURE`` on the device it
    lives on (the engine's: ``video/scale.py``) on this thread, then copied
    to the host for the encoders.  The engine and this thread issue on the
    same (default) stream, and the engine synchronised it when it fetched
    the tick's taps, before it pushed the item; the blocking host copy of
    the scaled picture completes this thread's reads of the engine's
    picture before the item is let go, so its memory cannot be reused
    under them;
  * a pipe item of several ticks (an engine with ``block_ticks > 1``, as
    the ``.mp4`` export runs) carries one picture per tick, and is encoded
    tick by tick, so it gives the packets of as many one-tick items;
  * ``stats`` adds up the encoders' host time, for the measurements;
  * the pure tier's AAC-LC encoder runs in a codec process
    (``av/codecs.py`` ``PureAacStream``), ended when this thread ends; its
    frames and their order are the in-process encoder's.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid as uuid_mod
from typing import Dict, Optional

import numpy as np

from mixlab_tpu_torch.av.codecs import MONITOR_PICTURE
from mixlab_tpu_torch.av.encode_stream import f32_to_i16
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.video.frame import Picture
from mixlab_tpu_torch.video.scale import scale_picture

# global socket map: uuid -> Broadcast of framed packets (monitor.rs:24-26)
_SOCKETS_LOCK = threading.Lock()
_SOCKETS: Dict[str, "PacketBroadcast"] = {}

SEGMENT_BROADCAST_DEPTH = 1024  # monitor.rs:214
VIDEO_TICK_DIVISOR = 6  # one video frame every 6 ticks: ~10 fps


class PacketBroadcast:
    def __init__(self, init_packet: bytes, depth: int = SEGMENT_BROADCAST_DEPTH):
        self.init_packet = init_packet
        self._subs = []
        self._lock = threading.Lock()
        self._depth = depth

    def subscribe(self) -> "queue.Queue[bytes]":
        q: "queue.Queue[bytes]" = queue.Queue(maxsize=self._depth)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q):
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def send(self, packet: bytes):
        with self._lock:
            dead = []
            for q in self._subs:
                try:
                    q.put_nowait(packet)
                except queue.Full:
                    dead.append(q)  # lagged subscriber: drop it
            for q in dead:
                self._subs.remove(q)


def register_socket(socket_id: str, bc: PacketBroadcast):
    with _SOCKETS_LOCK:
        _SOCKETS[socket_id] = bc


def unregister_socket(socket_id: str):
    with _SOCKETS_LOCK:
        _SOCKETS.pop(socket_id, None)


def get_socket(socket_id: str) -> Optional[PacketBroadcast]:
    with _SOCKETS_LOCK:
        return _SOCKETS.get(socket_id)


def frame_packet(header: dict, payload: bytes = b"") -> bytes:
    return json.dumps(header, separators=(",", ":")).encode() + b"\n" + payload


class MonitorPipeline(threading.Thread):
    """Codec thread for one Monitor module (monitor.rs:185-251)."""

    def __init__(self, pipe, cfg: EngineConfig):
        super().__init__(daemon=True, name="monitor-codec")
        self.pipe = pipe
        self.cfg = cfg
        self.socket_id = str(uuid_mod.uuid4())
        self._stop_evt = threading.Event()
        # encoder host time: frames / seconds of audio encoded, and seconds
        self.stats = {"video_frames": 0, "video_s": 0.0,
                      "audio_samples": 0, "audio_s": 0.0}
        # the JAX package's placeholder init packet, byte for byte: a
        # subscriber gets it only while the ffmpeg tier waits for SPS/PPS
        init = frame_packet(
            {
                "t": "init",
                "mode": "pcm+png",
                "sample_rate": cfg.sample_rate,
                "channels": cfg.channels,
                "video": "png",
                "width": MONITOR_PICTURE.width,
                "height": MONITOR_PICTURE.height,
            }
        )
        self.broadcast = PacketBroadcast(init)
        self._tick_count = 0
        # Codec construction is DEFERRED to the pipeline thread, as in the
        # JAX package: a live edit that creates a Monitor must not pay the
        # encoders' set-up (the native library's first build included)
        # inside the realtime tick.
        self._codecs_ready = threading.Event()
        self.broadcast.ready = self._codecs_ready
        register_socket(self.socket_id, self.broadcast)

    def _ensure_codecs(self):
        """Idempotent codec setup, on the pipeline thread (not the engine
        thread — a live edit creating a Monitor must not pay encoder set-up
        inside the realtime tick)."""
        if self._codecs_ready.is_set():
            return
        self._init_fmp4()
        self._codecs_ready.set()

    def _init_fmp4(self):
        """Real audio+AVC into the fragmented-MP4 mux for MSE playback —
        the reference's monitor path (monitor.rs:185-251).  Backend tier
        (av/codecs.py codec_tier): shim (libavcodec) > ffmpeg CLI > pure
        (zero-dep CAVLC H.264 + AAC-LC)."""
        from mixlab_tpu_torch.av.codecs import codec_tier
        from mixlab_tpu_torch.av.encode_stream import SAMPLES_PER_CHANNEL_PER_FRAGMENT

        fps = max(self.cfg.ticks_per_second // VIDEO_TICK_DIVISOR, 1)
        tier = codec_tier()
        if tier == "shim":
            # in-process libavcodec/libx264 (the reference's FFI shape)
            from mixlab_tpu_torch.av.codecs import ShimAacStream, ShimH264Stream

            self._aac = ShimAacStream(self.cfg.sample_rate, bitrate=None)
            self._h264 = ShimH264Stream(MONITOR_PICTURE, fps=fps, profile="monitor")
        elif tier == "ffmpeg":
            from mixlab_tpu_torch.av.codecs import FfmpegAacStream, FfmpegH264Stream

            self._aac = FfmpegAacStream(self.cfg.sample_rate, bitrate=None)
            self._h264 = FfmpegH264Stream(MONITOR_PICTURE, fps=fps, profile="monitor")
        else:
            from mixlab_tpu_torch.av.h264enc import PureH264Stream

            # real AAC-LC by default: the reference's monitor codec and what
            # MSE expects everywhere; lossless FLAC one variable away
            if os.environ.get("MIXLAB_PURE_AUDIO", "aac") == "flac":
                from mixlab_tpu_torch.av.flacenc import PureFlacStream

                self._aac = PureFlacStream(self.cfg.sample_rate, self.cfg.channels,
                                           SAMPLES_PER_CHANNEL_PER_FRAGMENT)
            else:
                from mixlab_tpu_torch.av.codecs import PureAacStream

                self._aac = PureAacStream(self.cfg.sample_rate, self.cfg.channels)
            self._h264 = PureH264Stream(MONITOR_PICTURE, fps=fps, profile="monitor")
        self._mux = None
        self._granule = SAMPLES_PER_CHANNEL_PER_FRAGMENT
        # pure encoders know their DCR at construction: emit the real
        # fmp4 init segment immediately so the FIRST subscriber sees it
        # (the reference sends init once, up front — monitor.rs:203-214);
        # only the ffmpeg-CLI tier must defer until SPS/PPS appear.
        self._try_create_mux()

    def _try_create_mux(self) -> bool:
        from mixlab_tpu_torch.av import mp4

        if self._mux is not None:
            return True
        if getattr(self._h264, "dcr", None) is None:
            return False
        audio_is_flac = getattr(self._aac, "codec", "aac") == "flac"
        params = mp4.Mp4Params(
            timescale=self.cfg.sample_rate,
            width=MONITOR_PICTURE.width,
            height=MONITOR_PICTURE.height,
            dcr=self._h264.dcr,
            sample_rate=self.cfg.sample_rate,
            channels=self.cfg.channels,
            audio_codec="flac" if audio_is_flac else "aac",
            flac_streaminfo_block=self._aac.streaminfo_block() if audio_is_flac else b"",
        )
        self._mux, init_seg = mp4.Mp4Mux.create(params)
        # avc1.PPCCLL from the DCR's profile/compat/level bytes
        avc1 = "avc1.%02x%02x%02x" % (
            self._h264.dcr[1], self._h264.dcr[2], self._h264.dcr[3]
        )
        audio_codec = "flac" if audio_is_flac else "mp4a.40.2"
        self.broadcast.init_packet = frame_packet(
            {"t": "init", "mode": "fmp4",
             "mime": f'video/mp4; codecs="{avc1}, {audio_codec}"'},
            init_seg,
        )
        self.broadcast.send(self.broadcast.init_packet)
        return True

    def stop(self):
        self._stop_evt.set()
        unregister_socket(self.socket_id)

    def run(self):
        try:
            self._ensure_codecs()
            spt = self.cfg.samples_per_tick
            while not self._stop_evt.is_set():
                try:
                    t0, audio, video = self.pipe.q.get(timeout=0.25)
                except queue.Empty:
                    continue
                if audio.shape[0] > spt:
                    # a block of several ticks carries a picture per tick:
                    # encode it tick by tick, as that many one-tick items
                    for j, tick_video in enumerate(video):
                        self._encode_tick_fmp4(t0 + j * spt,
                                               audio[j * spt:(j + 1) * spt], tick_video)
                else:
                    self._encode_tick_fmp4(t0, audio, video)
        finally:
            # the pure tier's AAC codec process, or the shim's encoders, end
            # with this thread
            for enc in (getattr(self, "_aac", None), getattr(self, "_h264", None)):
                close = getattr(enc, "close", None)
                if close is not None:
                    close()

    def _encode_tick_fmp4(self, t0: int, audio: np.ndarray, video):
        self._ensure_codecs()
        from mixlab_tpu_torch.av import mp4
        from mixlab_tpu_torch.utils.mtime import MediaDuration

        t = time.perf_counter()
        self._aac.feed(f32_to_i16(audio.reshape(-1)))
        self.stats["audio_samples"] += audio.shape[0]
        self.stats["audio_s"] += time.perf_counter() - t
        self._tick_count += 1
        if self._tick_count % VIDEO_TICK_DIVISOR == 0:
            t = time.perf_counter()
            pic = (
                _host_picture(scale_picture(video.picture, MONITOR_PICTURE))
                if video is not None
                else Picture.blank(MONITOR_PICTURE, "cpu")
            )
            self._h264.feed(pic)
            self.stats["video_frames"] += 1
            self.stats["video_s"] += time.perf_counter() - t

        units = self._h264.poll_access_units()
        if not self._try_create_mux():
            return  # ffmpeg tier: wait for SPS/PPS before the init segment

        t = time.perf_counter()
        frames = self._aac.poll_frames()
        self.stats["audio_s"] += time.perf_counter() - t
        track = mp4.FlacFrame if self._mux.params.audio_codec == "flac" else mp4.AdtsFrame
        for frame in frames:
            dur = MediaDuration.new(self._granule, self.cfg.sample_rate)
            seg = self._mux.write_track(dur, track(frame))
            self.broadcast.send(frame_packet({"t": "segment"}, seg))
        for is_key, payload in units:
            dur = MediaDuration.new(
                VIDEO_TICK_DIVISOR, self.cfg.ticks_per_second
            )
            seg = self._mux.write_track(
                dur,
                mp4.AvcFrame(is_key_frame=is_key, composition_time=MediaDuration.zero(), data=payload),
            )
            self.broadcast.send(frame_packet({"t": "segment"}, seg))


def _host_picture(pic: Picture) -> Picture:
    """``pic`` with numpy planes (a blocking copy from the device)."""
    return Picture(pic.settings, pic.to_numpy())
