"""StreamOutput host controller: RTMP broadcast state machine + publish pipe
(the port of ``mixlab_tpu/server/stream_output.py``).

Rebuild of ``src/module/stream_output.rs``:

  * impulse-encoded connect/disconnect params: an update is accepted only if
    ``seq`` increases; ``connect_seq == seq`` requests a connect,
    ``disconnect_seq == seq`` a disconnect; params cannot change while live
    (stream_output.rs:62-105);
  * connection state machine Offline -> Connecting -> Live | Failed with
    StreamOutputIndication updates (stream_output.rs:261-278);
  * when live, a publish loop on the controller's IO thread drains the
    engine's bounded tick pipe (drop-on-lag, stream_output.rs:314-321) and
    sends FLV tags over the RTMP client with 1 kHz timestamps
    (stream_output.rs:373-406).

Codecs: where the libavcodec shim has its encoders
(``av/codecs.py`` ``avshim_codecs_available``), AAC CBR 160 kb/s
(``ShimAacStream``) and x264 CBR 1.5 Mbps at 1120x700, 30 fps
(``ShimH264Stream``), the reference operating point
(stream_output.rs:23-24, 337-345); else the pure tier: AAC-LC at CBR 160
kb/s from ``PureAacStream``, whose encoder runs in its codec process (if
that cannot start, audio goes out as linear-PCM FLV tags), and intra H.264
at 1120x700 from ``PureH264Stream``, at 30 fps on the native CAVLC tier and
5 fps on the numpy one.  Video is encoded on its own encode thread behind a
depth-2 drop-on-lag queue (the reference's codec-thread shape,
monitor.rs:154-176), so a slow frame costs a dropped frame, never an audio
stall.

Differences from the JAX package, each deliberate:
  * the shim's video also runs on the encode thread, scaled on the host
    (the JAX package scales on its device and encodes on the IO thread);
  * the video item is the engine's picture on its device.  The encode
    thread copies its planes to the host with one wait on its stream
    (``engine/engine.py`` ``_fetch_tree``), the stream the engine issues on,
    and holds the item until the copy is done, as the Monitor's codec
    thread does; then it scales to 1120x700 on the host
    (``video/scale_host.py``, the native banded resize);
  * an item of a block of n ticks (``block_ticks`` > 1) carries n pictures
    and is published tick by tick, as n one-tick items;
  * the AAC codec process ends when the connection does;
  * the ticks the pipe holds when the connection goes live, pushed while
    the output was offline, are dropped: the broadcast starts with the
    ticks after it (the JAX package publishes those two stale ticks first).
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
from enum import Enum
from typing import Optional

import numpy as np

from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.av import flv
from mixlab_tpu_torch.av.encode_stream import f32_to_i16
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.io_host.rtmp import client as rtmp_client

log = logging.getLogger(__name__)

OUTPUT_WIDTH = 1120  # stream_output.rs:23
OUTPUT_HEIGHT = 700  # stream_output.rs:24
AUDIO_BITRATE = 160_000  # stream_output.rs:337-345


class ConnState(Enum):
    OFFLINE = "offline"
    CONNECTING = "connecting"
    LIVE = "live"
    FAILED = "failed"


def parse_rtmp_url(url: str):
    """rtmp://host[:port]/app -> (host, port, app)."""
    if not url.startswith("rtmp://"):
        raise ValueError("not an rtmp:// url")
    rest = url[len("rtmp://") :]
    hostport, _, app = rest.partition("/")
    host, _, port = hostport.partition(":")
    return host, int(port) if port else 1935, app or ""


class StreamOutputController:
    """One per StreamOutput module; owns an asyncio IO thread."""

    def __init__(self, pipe, cfg: EngineConfig, indicate=None):
        self.pipe = pipe
        self.cfg = cfg
        self.params = p.StreamOutputParams()
        self.state = ConnState.OFFLINE
        self.error = False
        self._indicate = indicate or (lambda ind: None)
        self._client: Optional[rtmp_client.RtmpPublishClient] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._io_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._epoch_samples: Optional[int] = None
        self._aac = None
        self._h264 = None
        self._last_pic = None
        self._video_fps = 30
        self._tick_count = 0
        self._venc_q: Optional[queue.Queue] = None
        self._venc_thread: Optional[threading.Thread] = None
        # for the measurements: tags the client's queue took and refused
        # (full: the receiver reads slower than the output publishes), and
        # pictures the encode queue dropped
        self.stats = {"audio_tags": 0, "video_tags": 0, "audio_refused": 0,
                      "video_refused": 0, "video_dropped": 0}

    # -- indication --------------------------------------------------------

    def indication(self) -> p.StreamOutputIndication:
        live = {
            ConnState.OFFLINE: p.StreamOutputLiveStatus.OFFLINE,
            ConnState.FAILED: p.StreamOutputLiveStatus.OFFLINE,
            ConnState.CONNECTING: p.StreamOutputLiveStatus.CONNECTING,
            ConnState.LIVE: p.StreamOutputLiveStatus.LIVE,
        }[self.state]
        return p.StreamOutputIndication(live=live, error=self.error)

    def _set_state(self, state: ConnState, error: bool = False):
        self.state = state
        self.error = error
        self._indicate(p.Indication("StreamOutput", self.indication()))

    # -- impulse param updates (stream_output.rs:62-105) -------------------

    def update(self, new_params: p.StreamOutputParams) -> bool:
        if new_params.seq <= self.params.seq:
            return False  # out-of-date update
        if self.state in (ConnState.CONNECTING, ConnState.LIVE):
            if new_params.disconnect_seq == new_params.seq:
                self.params = new_params
                self.disconnect()
                return True
            return False  # cannot change params on a live output
        self.params = new_params
        if new_params.connect_seq == new_params.seq:
            self.connect()
            return True
        return False

    # -- connection lifecycle ----------------------------------------------

    def connect(self):
        self._set_state(ConnState.CONNECTING)
        self._stop.clear()
        self._io_thread = threading.Thread(
            target=self._run_io, daemon=True, name="stream-output-io"
        )
        self._io_thread.start()

    def disconnect(self):
        self._stop.set()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(lambda: None)
        self._set_state(ConnState.OFFLINE)

    def stop(self):
        """Ask the IO thread to end; as it leaves it ends the encode thread
        and the AAC codec process (``join`` waits for that)."""
        self._stop.set()

    def join(self, timeout: float = 10.0):
        thread = self._io_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)

    def _run_io(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        try:
            loop.run_until_complete(self._io_main())
        except Exception as e:
            log.warning("stream_output: connection failed: %s", e)
            self._set_state(ConnState.FAILED, error=True)
        finally:
            self._close_encoders(video_done=self._end_video_thread())
            loop.close()
            self._loop = None

    def _end_video_thread(self) -> bool:
        """-> whether no encode thread runs any more."""
        thread, q = self._venc_thread, self._venc_q
        self._venc_thread = self._venc_q = None
        if thread is None:
            return True
        try:
            q.put(None, timeout=5.0)
        except queue.Full:
            pass  # the thread also exits on self._stop
        thread.join(timeout=5.0)
        return not thread.is_alive()

    async def _io_main(self):
        host, port, app = parse_rtmp_url(self.params.rtmp_url)
        client = await rtmp_client.start(host, port, app, self.params.rtmp_stream_key)
        self._client = client
        self._setup_encoders()
        if self._h264 is not None:
            self._venc_q = queue.Queue(maxsize=2)
            self._venc_thread = threading.Thread(
                target=self._video_encode_loop, args=(self._venc_q,), daemon=True,
                name="stream-output-venc")
            self._venc_thread.start()
        self._set_state(ConnState.LIVE)
        self._epoch_samples = None
        self._tick_count = 0
        # sequence headers first (LiveOutput::start, stream_output.rs:336-371)
        if self._aac is not None:
            client.publish_audio(
                0, flv.AudioPacket(True, self._aac.configuration_data()).to_bytes()
            )
        if self._h264 is not None:
            client.publish_video(
                0,
                flv.VideoPacket(
                    flv.VideoFrameType.KEY_FRAME,
                    flv.VideoPacketType.SEQUENCE_HEADER,
                    0,
                    self._h264.dcr,
                ).to_bytes(),
            )
        # what the pipe held while offline is stale: publish from here on
        while True:
            try:
                self.pipe.q.get_nowait()
            except queue.Empty:
                break
        # drain the engine tick pipe and publish until stopped
        while not self._stop.is_set():
            item = await asyncio.get_running_loop().run_in_executor(
                None, self._pipe_get, 0.25
            )
            if item is not None:
                self._publish_item(*item)
        self._end_video_thread()
        await client.close()
        self._client = None
        if self.state == ConnState.LIVE:
            self._set_state(ConnState.OFFLINE)

    def _setup_encoders(self):
        """The shim's AAC CBR 160 kb/s and x264 CBR 1.5 Mbps at 1120x700, 30
        fps, where it has them; else AAC-LC CBR 160 kb/s in its codec process
        (PCM-FLV audio if it cannot start) and intra H.264 at 1120x700: 30
        fps on the native CAVLC tier, 5 fps on the numpy one."""
        from mixlab_tpu_torch.av.codecs import (
            STREAM_PICTURE,
            PureAacStream,
            avshim_codecs_available,
        )
        from mixlab_tpu_torch.av.h264cavlc_fast import NativeCavlcIntraEncoder
        from mixlab_tpu_torch.av.h264enc import PureH264Stream

        self._aac = self._h264 = None
        self._last_pic = None
        self._video_fps = 30
        if avshim_codecs_available():
            from mixlab_tpu_torch.av.codecs import ShimAacStream, ShimH264Stream

            try:
                self._aac = ShimAacStream(self.cfg.sample_rate, bitrate=AUDIO_BITRATE)
                self._h264 = ShimH264Stream(STREAM_PICTURE, fps=30, profile="stream")
                return
            except Exception as e:
                log.warning("stream_output: codec init failed: %s", e)
                self._close_encoders()
        try:
            self._aac = PureAacStream(self.cfg.sample_rate, 2, bitrate=AUDIO_BITRATE)
        except Exception as e:
            log.warning("stream_output: pure aac init failed (%s); "
                        "falling back to PCM-FLV", e)
        try:
            self._h264 = PureH264Stream(STREAM_PICTURE, fps=30, profile="stream", qp=32)
            native = isinstance(self._h264._cavlc, NativeCavlcIntraEncoder)
            self._video_fps = 30 if native else 5
        except Exception as e:
            log.warning("stream_output: pure video init failed: %s", e)
            self._h264 = None

    def _close_encoders(self, video_done: bool = True):
        """End the audio encoder, and the shim's video encoder once no
        encode thread can feed it (``video_done``)."""
        if self._aac is not None:
            self._aac.close()
        self._aac = None
        close = getattr(self._h264, "close", None)
        if video_done and close is not None:
            close()

    def _pipe_get(self, timeout):
        try:
            return self.pipe.q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _publish_item(self, t0: int, audio: np.ndarray, video=None):
        """One pipe item: a tick, or a block of n ticks whose ``video`` is
        the tuple of its n pictures, published tick by tick."""
        if not isinstance(video, tuple):
            self._publish_tick(t0, audio, video)
            return
        spt = len(audio) // len(video)
        for j, v in enumerate(video):
            self._publish_tick(t0 + j * spt, audio[j * spt:(j + 1) * spt], v)

    def _publish_tick(self, t0: int, audio: np.ndarray, video=None):
        if self._client is None:
            return
        if self._epoch_samples is None:
            self._epoch_samples = t0
        # RTMP timestamps on a 1 kHz timebase (stream_output.rs TIME_BASE)
        ts_ms = int((t0 - self._epoch_samples) * 1000 // self.cfg.sample_rate)
        if self._aac is None:
            pcm = f32_to_i16(audio.reshape(-1)).astype("<i2").tobytes()
            body = flv.pcm_s16le_tag(pcm, min(self.cfg.sample_rate, 44100))
            self._publish_audio(ts_ms, body)
        else:
            # real AAC path: granule pts is in samples since epoch -> ms
            self._aac.feed(f32_to_i16(audio.reshape(-1)))
            for frame in self._aac.poll_frames():
                # poll_frames wraps ADTS; RTMP wants raw AAC (rtmp/packet.rs)
                self._publish_audio(ts_ms, flv.AudioPacket(False, frame[7:]).to_bytes())

        if self._h264 is not None:
            self._tick_count += 1
            divisor = max(self.cfg.ticks_per_second // self._video_fps, 1)
            q = self._venc_q
            if self._tick_count % divisor == 0 and q is not None:
                try:
                    q.put_nowait((ts_ms, video))
                except queue.Full:
                    self.stats["video_dropped"] += 1
                    log.debug("stream_output: video encode lagging; frame dropped")

    def _publish_audio(self, ts_ms: int, body: bytes):
        if self._client.publish_audio(ts_ms, body):
            self.stats["audio_tags"] += 1
        else:
            self.stats["audio_refused"] += 1
            log.debug("stream_output: publish queue full, audio dropped")

    def _publish_video(self, ts_ms: int, body: bytes):
        client = self._client
        if client is None:
            return  # the connection ended while the picture was encoded
        if client.publish_video(ts_ms, body):
            self.stats["video_tags"] += 1
        else:
            self.stats["video_refused"] += 1
            log.debug("stream_output: publish queue full, video dropped")

    def _video_encode_loop(self, q: queue.Queue):
        """The video pipeline, off the IO loop: the picture copied to the
        host, the host banded scale (video/scale_host.py) and the CAVLC
        encode; access units are posted back to the IO loop (the RTMP
        client's queue is not thread-safe from here)."""
        from mixlab_tpu_torch.av.codecs import STREAM_PICTURE
        from mixlab_tpu_torch.engine.engine import _fetch_tree
        from mixlab_tpu_torch.video.frame import Picture
        from mixlab_tpu_torch.video.scale_host import scale_picture_host

        blank = None
        while not self._stop.is_set():
            try:
                item = q.get(timeout=0.25)
            except queue.Empty:
                continue
            if item is None:
                break
            ts_ms, video = item
            try:
                if video is not None:
                    src = video.picture
                    src = Picture(src.settings, _fetch_tree(dict(src.planes)))
                    del item, video  # the engine's picture is let go here
                    pic = scale_picture_host(src, STREAM_PICTURE)
                    self._last_pic = pic
                else:
                    # barrier semantics: repeat/blank so video never stalls
                    # audio (video/encode.rs:78-84)
                    if self._last_pic is None and blank is None:
                        blank = Picture(STREAM_PICTURE, {
                            "y": np.zeros((STREAM_PICTURE.height,
                                           STREAM_PICTURE.width), np.uint8),
                            "u": np.full((STREAM_PICTURE.height // 2,
                                          STREAM_PICTURE.width // 2),
                                         0x80, np.uint8),
                            "v": np.full((STREAM_PICTURE.height // 2,
                                          STREAM_PICTURE.width // 2),
                                         0x80, np.uint8)})
                    pic = self._last_pic or blank
                self._h264.feed(pic)
                units = list(self._h264.poll_access_units())
            except Exception:
                log.exception("stream_output: video encode failed; frame dropped")
                continue
            loop = self._loop
            if loop is None:
                continue
            for is_key, avcc in units:
                body = flv.VideoPacket(
                    flv.VideoFrameType.KEY_FRAME if is_key
                    else flv.VideoFrameType.INTER_FRAME,
                    flv.VideoPacketType.NALU, 0, avcc).to_bytes()
                try:
                    loop.call_soon_threadsafe(self._publish_video, ts_ms, body)
                except RuntimeError:
                    break  # loop closed mid-shutdown
