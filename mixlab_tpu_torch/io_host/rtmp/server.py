"""RTMP ingest server (publish side) (the port of
``mixlab_tpu/io_host/rtmp/server.py``).

Rebuild of ``src/rtmp/mod.rs`` + ``src/rtmp/incoming.rs``: accept a
publisher (OBS/ffmpeg), run the handshake, answer connect/createStream/
publish over AMF0, bind the publish app name to a mountpoint in the RTMP
registry, then route FLV audio/video tag bodies:

  * AAC sequence header -> AudioSpecificConfiguration (rtmp/mod.rs:205-216)
  * AAC raw -> decode to i16 stereo PCM -> ``write_audio(MediaTime(ts,1000))``
    (TIME_BASE = 1000, rtmp/mod.rs:42)
  * AVC sequence header -> DecoderConfigurationRecord (rtmp/mod.rs:277-287)
  * AVC NALU -> decode to a video frame -> ``write_video``

Decode is routed through a pluggable ``MediaDecoder``, made per connection
by ``DECODER_FACTORY(device)``: the ffmpeg CLI tier (``ffmpeg_decode.py``)
where an ``ffmpeg`` binary exists, else the pure tier (``PureTierDecoder``:
the port's H.264 decoder with its native tier, and its AAC-LC decoder).

Differences from the JAX package, each deliberate:
  * Decoded pictures are uploaded to the engine's ``device``
    (``engine/media_player.py`` ``_upload_planes``: the copies are complete
    on the card before the frame reaches the mountpoint), which
    ``server/app.py`` passes in; there is no default device.  A failed
    decode or upload is logged and counted in the server's ``IngestStats``;
    it never turns into a frame on another device.
  * Tags are parsed on the event loop, and every decode runs on one worker
    thread per connection (``_DecodeLane``), in the order the tags came, so
    the mountpoint gets the same frames in the same order as when decoding
    on the loop; the loop, which also carries the session socket and the
    Monitor's WebSockets, is not held for the 15-26 ms of a 1080p decode.
    At most ``_DecodeLane.DEPTH`` tags wait for the worker: beyond that
    the loop waits for it, and so reads no more from the publisher's socket.
  * The pure tier's AAC-LC decode runs in a codec process per connection
    (``av/aacdec_worker.py``), ended with the connection.
  * A decode the libavcodec shim (``ShimDecoder``) refuses is logged and
    counted like the pure tier's, not raised.  Where the shim's libraries
    are absent, MP3 is dropped with a log line that says so (the pure tier,
    like the JAX package's, has no MP3 decoder).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from mixlab_tpu_torch.av import flv
from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
from mixlab_tpu_torch.av.avc import DecoderConfigurationRecord
from mixlab_tpu_torch.engine.media_player import NO_SHIM, _upload_planes
from mixlab_tpu_torch.io_host import source as source_mod
from mixlab_tpu_torch.io_host.rtmp import amf0
from mixlab_tpu_torch.io_host.rtmp.chunk import (
    MSG_AUDIO,
    MSG_COMMAND_AMF0,
    MSG_DATA_AMF0,
    MSG_VIDEO,
    ChunkReader,
    ChunkWriter,
    Message,
)
from mixlab_tpu_torch.io_host.rtmp.handshake import server_handshake
from mixlab_tpu_torch.utils.mtime import MediaDuration, TimeBase

log = logging.getLogger(__name__)

TIME_BASE = TimeBase.new(1, 1000)  # rtmp/mod.rs:42


class IngestStats:
    """A server's ingest counters over its connections: ``video_frames``
    written, ``video_decode_s`` on the decode workers, and the decode
    failures each connection's decoder logged (``video_failures``,
    ``audio_failures``, added as the connection ends).  The workers of
    several connections add to it, so it takes a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = collections.Counter()

    def add(self, key: str, n=1):
        with self._lock:
            self._counts[key] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


def listen(mountpoint: str):
    """Called by stream_input modules."""
    return source_mod.RTMP_MOUNTPOINTS.listen(mountpoint)


class MediaDecoder:
    """Decode interface; see module docstring.  A decoder that logs a
    failed decode and returns None counts it in ``video_failures`` or
    ``audio_failures``."""

    video_failures = 0
    audio_failures = 0

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        pass

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        pass

    def decode_audio(self, raw_aac: bytes) -> Optional[np.ndarray]:
        """-> i16 [n, 2] PCM or None."""
        return None

    def decode_mp3(self, frame: bytes) -> Optional[np.ndarray]:
        """-> i16 [n, 2] PCM or None (FLV sound format 2)."""
        return None

    def decode_video(self, packet: flv.VideoPacket):
        """-> mixlab_tpu_torch.video.frame.VideoFrame or None."""
        return None

    def close(self):
        """End what the decoder started (codec processes)."""


class NullDecoder(MediaDecoder):
    def __init__(self, device=None):
        self._warned = False

    def _warn(self):
        if not self._warned:
            self._warned = True
            log.warning(
                "rtmp: no AAC/H.264 decoder backend available; "
                "ingest media is parsed but dropped"
            )

    def decode_audio(self, raw_aac):
        self._warn()
        return None

    def decode_video(self, packet):
        self._warn()
        return None


class ShimDecoder(MediaDecoder):
    """AAC + H.264 (and MP3) ingest decode via the in-process ffmpeg-libraries
    shim (native/avshim.py) — the reference's exact shape: fdk-aac/ffmpeg
    FFI on the blocking receive thread (rtmp/mod.rs:192-338).  Pictures go
    to ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._adec = None
        self._vdec = None
        self._mp3dec = None
        self.video_duration_hint = None  # set by _on_video from ts deltas

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        from mixlab_tpu_torch.native import avshim

        self._adec = avshim.AudioDecoder("aac", asc.to_bytes())

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        from mixlab_tpu_torch.native import avshim

        self._vdec = avshim.VideoDecoder("h264", dcr.to_bytes())

    def _stereo(self, decoded):
        out = []
        for _pts, pcm, _rate in decoded:
            # force stereo like the reference (rtmp/mod.rs:229-231)
            if pcm.shape[1] == 1:
                pcm = np.repeat(pcm, 2, axis=1)
            out.append(pcm[:, :2])
        return np.concatenate(out) if out else None

    def decode_audio(self, raw_aac: bytes):
        if self._adec is None:
            return None
        from mixlab_tpu_torch.native.avshim import ShimError

        try:
            return self._stereo(self._adec.decode(raw_aac))
        except ShimError as e:
            self.audio_failures += 1
            log.warning("rtmp: shim aac decode failed: %s", e)
            return None

    def decode_mp3(self, frame: bytes):
        from mixlab_tpu_torch.native import avshim

        if self._mp3dec is None:
            if not avshim.have_decoder("mp3"):
                return None
            self._mp3dec = avshim.AudioDecoder("mp3")
        try:
            return self._stereo(self._mp3dec.decode(frame))
        except avshim.ShimError as e:
            self.audio_failures += 1
            log.warning("rtmp: shim mp3 decode failed: %s", e)
            return None

    def decode_video(self, packet: flv.VideoPacket):
        if self._vdec is None:
            return None
        from mixlab_tpu_torch.native.avshim import ShimError

        try:
            frames = self._vdec.decode(packet.data)
        except ShimError as e:
            self.video_failures += 1
            log.warning("rtmp: shim h264 decode failed: %s", e)
            return None
        if not frames:
            return None
        _pts, y, u, v = frames[-1]
        return _frame_on(self.device, y, u, v, self.video_duration_hint)

    def close(self):
        for dec in (self._adec, self._vdec, self._mp3dec):
            if dec is not None:
                dec.close()


def _frame_on(device, y, u, v, hint):
    """A VideoFrame of the decoded planes, uploaded to ``device``."""
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame

    h, w = y.shape
    pic = Picture(PictureSettings(w, h), _upload_planes(y, u, v, device))
    return VideoFrame(picture=pic, duration_hint=hint or MediaDuration.new(1, 30))


class PureTierDecoder(MediaDecoder):
    """Zero-dependency ingest tier: H.264 video through the pure decoder
    (av/h264dec.py — full intra AND inter P slices, CAVLC and CABAC, with
    its native tier), AAC-LC audio through the pure decoder (av/aacdec.py)
    in a codec process — no codec libraries at all.  Pictures go to
    ``device``.  The reference simply fails to build without ffmpeg/fdk
    (rtmp/mod.rs:192-338)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._vdec = None
        self._adec = None
        self._asc = None
        self._warned_mp3 = False
        self.video_duration_hint = None

    def set_video_config(self, dcr: DecoderConfigurationRecord):
        from mixlab_tpu_torch.av.h264dec import PureH264Decoder

        self._vdec = PureH264Decoder(dcr.to_bytes())

    def set_audio_config(self, asc: AudioSpecificConfiguration):
        from mixlab_tpu_torch.av.aacdec_worker import AacDecodeProcess

        if self._adec is not None:
            self._adec.close()
        self._asc = asc
        self._adec = AacDecodeProcess(asc)

    def decode_audio(self, raw_aac: bytes):
        if self._adec is None:
            return None
        from mixlab_tpu_torch.av.aacdec import AacDecodeError

        try:
            pcm = self._adec.decode_raw(
                raw_aac, self._asc.sampling_frequency_index
            )
        except AacDecodeError as e:
            self.audio_failures += 1
            log.warning("rtmp: pure aac decode failed: %s", e)
            return None
        out = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
        if out.shape[1] == 1:  # force stereo like the reference
            out = np.repeat(out, 2, axis=1)
        return out[:, :2]

    def decode_mp3(self, frame: bytes):
        if not self._warned_mp3:
            self._warned_mp3 = True
            log.warning("rtmp: MP3 audio is dropped: the pure tier has no MP3 decoder; %s",
                        NO_SHIM)
        return None

    def decode_video(self, packet: flv.VideoPacket):
        if self._vdec is None:
            return None
        try:
            frames = self._vdec.decode(packet.data)
        except Exception as e:
            self.video_failures += 1
            log.warning("rtmp: pure h264 decode failed: %s", e)
            return None
        if not frames:
            return None
        _pts, y, u, v = frames[-1]
        return _frame_on(self.device, y, u, v, self.video_duration_hint)

    def close(self):
        if self._adec is not None:
            self._adec.close()


def default_decoder_factory(device) -> MediaDecoder:
    from mixlab_tpu_torch.av.codecs import ffmpeg_available
    from mixlab_tpu_torch.native import avshim

    if (
        avshim.available()
        and avshim.have_decoder("aac")
        and avshim.have_decoder("h264")
    ):
        return ShimDecoder(device)
    if ffmpeg_available():
        try:
            from mixlab_tpu_torch.io_host.rtmp.ffmpeg_decode import FfmpegDecoder

            return FfmpegDecoder(device)
        except Exception:
            pass
    return PureTierDecoder(device)


# test/instrumentation hook: device -> a MediaDecoder for one connection
DECODER_FACTORY: Callable[[torch.device], MediaDecoder] = default_decoder_factory


class _DecodeLane:
    """One worker thread for one connection's decodes, taken in order."""

    DEPTH = 8  # tags waiting for the worker before the loop waits for it

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rtmp-decode")
        self._pending = collections.deque()

    async def submit(self, fn, *args):
        loop = asyncio.get_running_loop()
        self._pending.append(loop.run_in_executor(self._pool, fn, *args))
        while self._pending and (len(self._pending) > self.DEPTH or self._pending[0].done()):
            await self._pending.popleft()

    async def drain(self):
        while self._pending:
            await self._pending.popleft()

    def close(self):
        """Drop what waits, let the running decode finish."""
        self._pool.shutdown(wait=True, cancel_futures=True)


async def accept(reader, writer, device, stats: Optional[IngestStats] = None):
    """Handle one RTMP connection end-to-end (rtmp/mod.rs:59-104); decoded
    pictures go to ``device`` (the engine's), counts to ``stats``."""
    stats = stats or IngestStats()
    await server_handshake(reader, writer)
    cr = ChunkReader(reader)
    cw = ChunkWriter(writer)

    app_name: Optional[str] = None
    send: Optional[source_mod.SourceSend] = None
    decoder = DECODER_FACTORY(torch.device(device))
    lane = _DecodeLane()
    last_video_ts = [None]

    def reply(name, transaction_id, *args):
        cw.write_message(
            Message(0, MSG_COMMAND_AMF0, 0, amf0.encode_all(name, transaction_id, *args))
        )

    try:
        while True:
            msg = await cr.read_message()
            if msg is None:
                break
            if msg.type_id == MSG_COMMAND_AMF0:
                try:
                    values = amf0.decode_all(msg.payload)
                except amf0.Amf0Error:
                    break  # malformed command message: disconnect cleanly
                cmd = values[0] if values else None
                txn = values[1] if len(values) > 1 else 0
                if not isinstance(txn, (int, float)):
                    txn = 0
                if cmd == "connect":
                    props = values[2] if len(values) > 2 else {}
                    if not isinstance(props, dict):
                        props = {}  # AMF0 allows any type here
                    app_name = props.get("app", "")
                    if not isinstance(app_name, str):
                        app_name = ""
                    reply(
                        "_result",
                        txn,
                        {
                            "fmsVer": "mixlab-tpu/0.1",
                            "capabilities": 31.0,
                        },
                        {
                            "level": "status",
                            "code": "NetConnection.Connect.Success",
                            "description": "Connection succeeded.",
                        },
                    )
                    await writer.drain()
                elif cmd == "createStream":
                    reply("_result", txn, None, 1.0)
                    await writer.drain()
                elif cmd in ("releaseStream", "FCPublish", "FCUnpublish"):
                    pass
                elif cmd == "publish":
                    # stream key = values[3]; the mountpoint is the app name
                    # (rtmp/mod.rs:73: MOUNTPOINTS.connect(app name))
                    try:
                        send = source_mod.RTMP_MOUNTPOINTS.connect(app_name or "")
                    except source_mod.ConnectError as e:
                        reply(
                            "onStatus",
                            0,
                            None,
                            {
                                "level": "error",
                                "code": "NetStream.Publish.BadName",
                                "description": str(e),
                            },
                        )
                        await writer.drain()
                        break
                    reply(
                        "onStatus",
                        0,
                        None,
                        {
                            "level": "status",
                            "code": "NetStream.Publish.Start",
                            "description": "Publishing.",
                        },
                    )
                    await writer.drain()
                elif cmd == "deleteStream":
                    break
            elif msg.type_id == MSG_AUDIO and send is not None:
                job = _on_audio(msg, send, decoder)
                if job is not None:
                    await lane.submit(job)
            elif msg.type_id == MSG_VIDEO and send is not None:
                job = _on_video(msg, send, decoder, last_video_ts, stats)
                if job is not None:
                    await lane.submit(job)
            elif msg.type_id == MSG_DATA_AMF0:
                pass  # onMetaData etc.
        await lane.drain()  # a publisher that ends: every tag read is decoded
    finally:
        lane.close()
        if send is not None:
            send.close()
        decoder.close()
        stats.add("video_failures", decoder.video_failures)
        stats.add("audio_failures", decoder.audio_failures)


def _on_audio(msg: Message, send, decoder: MediaDecoder):
    """Parse an audio tag on the loop; -> the decode job for the lane, or
    None."""
    try:
        kind, data = flv.parse_audio_tag(msg.payload)
    except flv.FlvError as e:
        log.warning("rtmp: bad audio tag: %s", e)
        return None
    when = TIME_BASE.scale_timestamp(msg.timestamp)
    if kind == "aac_seq":
        def job():
            try:
                decoder.set_audio_config(AudioSpecificConfiguration.parse(data))
            except Exception as e:
                log.warning("rtmp: bad ASC: %s", e)
        return job
    if kind == "pcm_s16le":
        # codec-less linear PCM path (mixlab-tpu extension; see av/flv.py)
        def decode():
            x = np.frombuffer(data, dtype="<i2")
            return x.reshape(-1, 2) if len(x) % 2 == 0 else np.stack([x, x], -1)
    else:
        def decode():
            return (decoder.decode_mp3 if kind == "mp3" else decoder.decode_audio)(data)

    def job():
        pcm = decode()
        if pcm is not None and len(pcm):
            send.write_audio(when, pcm)
    return job


def _on_video(msg: Message, send, decoder: MediaDecoder, last_ts, stats: IngestStats):
    """Parse a video tag on the loop; -> the decode job for the lane, or
    None.  ``last_ts``: a one-item list, the previous tag's timestamp."""
    try:
        pkt = flv.VideoPacket.parse(msg.payload)
    except flv.FlvError as e:
        log.warning("rtmp: bad video tag: %s", e)
        return None
    if pkt.packet_type == flv.VideoPacketType.SEQUENCE_HEADER:
        def configure():
            try:
                decoder.set_video_config(DecoderConfigurationRecord.parse(pkt.data))
            except Exception as e:
                log.warning("rtmp: bad DCR: %s", e)
        return configure
    if pkt.packet_type == flv.VideoPacketType.END_OF_SEQUENCE:
        return None
    # estimate the frame duration from timestamp deltas so the video mixer's
    # expiry window (video_mixer.rs:94-148) holds the frame exactly one
    # frame interval; a tag whose timestamp does not advance keeps the last
    hint = None
    if last_ts[0] is not None and msg.timestamp > last_ts[0]:
        hint = MediaDuration.new(msg.timestamp - last_ts[0], 1000)
    last_ts[0] = msg.timestamp
    # presentation time = dts + composition time (rtmp/mod.rs:318-322)
    when = TIME_BASE.scale_timestamp(msg.timestamp + pkt.composition_time)

    def job():
        if hint is not None:
            decoder.video_duration_hint = hint
        t = time.perf_counter()
        try:
            frame = decoder.decode_video(pkt)
        except Exception:
            stats.add("video_failures")
            log.exception("rtmp: video decode or upload failed; frame dropped")
            return
        stats.add("video_decode_s", time.perf_counter() - t)
        if frame is not None:
            stats.add("video_frames")
            send.write_video(when, frame)
    return job
