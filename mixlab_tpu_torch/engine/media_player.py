"""MediaSource decode thread (the port of ``mixlab_tpu/engine/media_player.py``).

Rebuild of ``src/module/media_source.rs:140-292``: a decode thread opens the
media blob stream from the project database, decodes ahead of the engine
through a bounded queue (sync_channel(2) analogue), is realtime-throttled,
and loops by seeking back to the start on EOF (epoch accumulation,
media_source.rs:246-292).

Codec note (documented): the reference decodes any ffmpeg-supported media;
this build decodes WAV (io_host/wav.py), FLAC (av/flacdec.py), Ogg/Vorbis
(av/vorbis.py), Y4M raw video (av/y4m.py) and JPEG stills (av/jpeg.py) with
no codec libraries, resampling audio to the engine rate on the decode
thread; every other container and codec, and every MP4, plays through the
in-process libavcodec shim (native/avshim.py, ``_run_shim``) where the
libraries exist.  Without them an MP4 takes the pure demux (av/mp4read.py)
with H.264 video (av/h264dec.py, its native tier in native/) and FLAC or
AAC-LC audio (av/aacdec.py), as in the JAX package.
The reference's media_source emits only video (media_source.rs:52-55); this
build adds an audio output — WAV playback would otherwise be silent — as a
documented extension.

Differences from the JAX package, each deliberate:
  * The decoded planes are uploaded to the engine's ``device`` (the player
    is given it; there is no default).  The upload runs on this decode
    thread, on the thread's current stream of that device, which is the
    stream the engine thread issues on; an event recorded after the three
    copies is waited on before the frame is pushed, so a frame reaches the
    feed only once its planes are complete on the card, and the planes
    belong to the stream the engine reads them on (no ``record_stream``).
  * An MP4's AAC-LC granules are decoded in a codec process
    (``av/aacdec_worker.py`` ``AacDecodeProcess``), one per stream, ended
    as this thread ends: the Python decoder takes milliseconds a granule,
    which under this process's interpreter lock came out of the engine
    thread's tick.  This thread waits for each granule's PCM on the pipe
    with the lock released; the PCM is the in-process decoder's, bit for
    bit, and a granule it refuses is skipped as before.
  * ``_run_shim`` loops an input that libavformat cannot seek back to its
    start (a fragmented MP4 without an index) by opening it again from the
    stream; the JAX package's loop there reads nothing more and spins until
    the player stops.
  * Without the shim's libraries, a file that only the shim could decode
    (a non-WAV file no pure reader takes, a JPEG outside the pure decoder's
    scope) is logged as undecodable, saying that the libraries are absent,
    and plays nothing (the JAX package logs the pure decoder's error).
"""

from __future__ import annotations

import logging
import threading

import numpy as np

import torch

from mixlab_tpu_torch.dsp.resampler import context_len, design, resample_block_np
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.feeds import MediaSourceFeed
from mixlab_tpu_torch.io_host.throttle import AudioThrottle
from mixlab_tpu_torch.io_host.wav import WavError, decode_frames, parse_header

log = logging.getLogger(__name__)

DECODE_CHUNK_FRAMES = 4096

NO_SHIM = ("no libavcodec shim: the ffmpeg libraries (libavcodec, libavformat, "
           "libavutil, libswscale, libswresample) or their headers are absent")


def _upload_planes(y, u, v, device: torch.device):
    """The three u8 planes as tensors on ``device``, complete there when
    this returns: the copies run on the calling thread's current stream,
    and an event recorded after them is waited on."""
    # np.require copies a plane that is strided or read-only (a reader's
    # buffer): torch.from_numpy takes neither safely
    planes = {k: torch.from_numpy(np.require(a, np.uint8, ["C", "W"])).to(device)
              for k, a in (("y", y), ("u", u), ("v", v))}
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return planes


class _PcmPusher:
    """Stereo-normalize decoded f32 PCM at ``src_rate`` and push it into the
    player's feed, resampling to the engine rate with a persistent carry +
    polyphase context.  One instance per decode stream; ``reset()`` at loop
    rewinds.  Shared by every audio decode loop (WAV/Ogg/FLAC/MP4) —
    one copy of the carry/context/push discipline instead of five."""

    def __init__(self, player: "MediaPlayer", src_rate: int):
        self._player = player
        self.src_rate = src_rate
        self._dst_rate = player.cfg.sample_rate
        self._M = (design(src_rate, self._dst_rate)[1]
                   if src_rate != self._dst_rate else 1)
        self.reset()

    def reset(self):
        self._ctx = None
        self._carry = np.zeros((0, 2), np.float32)

    def push(self, pcm: np.ndarray):
        """pcm: f32 [n, channels]; blocks (bounded) against the engine."""
        player = self._player
        if pcm.shape[1] == 1:
            pcm = np.repeat(pcm, 2, axis=1)
        pcm = pcm[:, :2]
        if self.src_rate != self._dst_rate:
            buf = np.concatenate([self._carry, pcm])
            usable = len(buf) - (len(buf) % self._M)
            self._carry = buf[usable:]
            if usable == 0:
                return
            if self._ctx is None:
                self._ctx = np.zeros(
                    (context_len(self.src_rate, self._dst_rate), 2),
                    np.float32)
            out, self._ctx = resample_block_np(
                buf[:usable], self._ctx, self.src_rate, self._dst_rate)
        else:
            out = pcm
        while not player._stop_evt.is_set():
            if player.feed.push_block(out, block=True, timeout=0.25):
                break


class MediaPlayer(threading.Thread):
    """Decode thread feeding a MediaSourceFeed."""

    def __init__(self, stream, feed: MediaSourceFeed, cfg: EngineConfig,
                 device):
        super().__init__(daemon=True, name="media-decode")
        self.stream = stream  # seekable reader (project ReadStream)
        self.feed = feed
        self.cfg = cfg
        self.device = torch.device(device)  # the engine's: pictures go there
        self._stop_evt = threading.Event()
        self._warned_aac = False
        self._children = []  # codec processes, ended as the thread leaves

    def stop(self):
        self._stop_evt.set()

    def run(self):
        from mixlab_tpu_torch.engine.project import ProjectClosedError

        try:
            self._run_dispatch()
        except ProjectClosedError:
            # project closed while we were mid-read: clean end-of-stream,
            # not an error (see ProjectBase._check_open)
            log.debug("media_source: project closed during decode; exiting")
        finally:
            for child in self._children:
                child.close()

    def _run_dispatch(self):
        header = self.stream.read(64 * 1024)
        if header[:4] == b"OggS":
            self._run_ogg()
            return
        if header[:4] == b"fLaC":
            self._run_flac()
            return
        if header[:9] == b"YUV4MPEG2":
            self._run_y4m()
            return
        if header[:2] == b"\xff\xd8":
            self._run_jpeg_still()
            return
        if len(header) >= 8 and header[4:8] in (b"ftyp", b"styp", b"moov"):
            from mixlab_tpu_torch.native import avshim

            # the shim demuxes MP4 with full codec support (incl. AAC);
            # the pure demux+decode path is the zero-dependency fallback
            if avshim.available():
                self._run_shim()
            else:
                self._run_mp4()
            return
        try:
            fmt, data_off, data_size = parse_header(header)
        except WavError as e:
            from mixlab_tpu_torch.native import avshim

            if avshim.available():
                self._run_shim()
                return
            log.warning("media_source: cannot decode media (%s); %s", e, NO_SHIM)
            return

        throttle = AudioThrottle(fmt.sample_rate)
        bpf = fmt.bytes_per_frame
        pusher = _PcmPusher(self, fmt.sample_rate)

        while not self._stop_evt.is_set():
            # (re)start from the beginning of the data chunk: loop semantics
            self.stream.seek(data_off)
            remaining = data_size
            pusher.reset()
            while remaining > 0 and not self._stop_evt.is_set():
                n = min(DECODE_CHUNK_FRAMES * bpf, remaining)
                raw = self.stream.read(n - (n % bpf) or bpf)
                if not raw:
                    break
                remaining -= len(raw)
                frames = decode_frames(fmt, raw)
                throttle.send_samples(len(frames))
                # bounded put paces decode against engine consumption
                pusher.push(frames.astype(np.float32) / 32768.0)

    def _run_ogg(self):
        """Ogg/Vorbis playback loop via the pure decoder (av/vorbis.py)."""
        from mixlab_tpu_torch.av.vorbis import OggVorbisStream

        while not self._stop_evt.is_set():
            self.stream.seek(0)
            dec = OggVorbisStream()
            throttle = None
            pusher = None
            got_any = False
            while not self._stop_evt.is_set():
                raw = self.stream.read(16384)
                if not raw:
                    break
                try:
                    pcm = dec.feed(raw)
                except Exception as e:
                    log.warning("media_source: vorbis decode failed: %s", e)
                    return
                info = dec.info
                if info is None or len(pcm) == 0:
                    continue
                got_any = True
                if throttle is None:
                    throttle = AudioThrottle(info.sample_rate)
                    pusher = _PcmPusher(self, info.sample_rate)
                throttle.send_samples(len(pcm))
                pusher.push(pcm)
            if not got_any:
                return  # undecodable: don't loop forever

    def _run_flac(self):
        """FLAC playback via the pure decoder (av/flacdec.py) — frame-at-a-
        time decode with realtime pacing, looping at EOF."""
        from mixlab_tpu_torch.av.flacdec import FlacDecoder, FlacError

        self.stream.seek(0)
        data = bytearray()
        while True:
            chunk = self.stream.read(1 << 20)
            if not chunk:
                break
            data += chunk
        data = bytes(data)
        # walk metadata blocks to the first frame
        pos = 4
        streaminfo = None
        while pos + 4 <= len(data):
            head = data[pos]
            length = int.from_bytes(data[pos + 1 : pos + 4], "big")
            if (head & 0x7F) == 0:
                streaminfo = data[pos + 4 : pos + 4 + length]
            pos += 4 + length
            if head & 0x80:
                break
        try:
            dec = FlacDecoder(streaminfo or b"")
        except FlacError as e:
            log.warning("media_source: bad flac: %s", e)
            return
        first_frame = pos
        scale = float(1 << (dec.bps - 1))
        throttle = AudioThrottle(dec.sample_rate)
        pusher = _PcmPusher(self, dec.sample_rate)
        while not self._stop_evt.is_set():
            at = first_frame
            got_any = False
            pusher.reset()
            while at + 4 <= len(data) and not self._stop_evt.is_set():
                try:
                    pcm_i, used = dec.decode_frame(data, at)
                except FlacError as e:
                    # Trailing junk (ID3v1 tag, padding) after the last frame
                    # must not end playback: fall through to the loop/rewind
                    # once at least one frame decoded (mirrors the Ogg path's
                    # got_any logic). A failure on the FIRST frame is fatal.
                    if got_any:
                        log.debug("media_source: flac tail bytes ignored: %s", e)
                        break
                    log.warning("media_source: flac decode failed: %s", e)
                    return
                at += used
                got_any = True
                pcm = pcm_i.astype(np.float32) / scale
                throttle.send_samples(len(pcm))
                pusher.push(pcm)
            if not got_any:
                return  # undecodable: don't loop forever

    def _run_y4m(self):
        """Raw-video playback via the pure Y4M reader (av/y4m.py) — the
        zero-dependency video tier; realtime-paced, looping with epoch
        accumulation like the reference (media_source.rs:246-292)."""
        from fractions import Fraction

        from mixlab_tpu_torch.av.y4m import Y4mError, Y4mReader
        from mixlab_tpu_torch.io_host.throttle import MediaThrottle
        from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
        from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame

        try:
            reader = Y4mReader(self.stream)
        except Y4mError as e:
            log.warning("media_source: bad y4m: %s", e)
            return
        info = reader.info
        frame_dur = Fraction(info.fps.denominator, info.fps.numerator)
        throttle = MediaThrottle()
        epoch = Fraction(0)
        n = 0
        while not self._stop_evt.is_set():
            planes = reader.read_frame()
            if planes is None:
                if n == 0:
                    return  # no frames at all: don't loop forever
                epoch += n * frame_dur
                n = 0
                reader.rewind()
                continue
            t = epoch + n * frame_dur
            n += 1
            throttle.wait_until(MediaTime(t))
            y, u, v = planes
            pic = Picture(
                PictureSettings(info.width, info.height),
                _upload_planes(y, u, v, self.device),
            )
            frame = VideoFrame(
                picture=pic,
                duration_hint=MediaDuration.new(
                    info.fps.denominator, info.fps.numerator
                ),
            )
            pts = MediaTime(t)
            while not self._stop_evt.is_set():
                if self.feed.push_video(pts, frame, block=True, timeout=0.25):
                    break

    def _run_jpeg_still(self):
        """JPEG still: decode once with the pure decoder (av/jpeg.py), then
        emit the frame at a steady 10 fps so video_mixer sees a live
        source (stills-as-video, the ffmpeg behavior for images)."""
        from fractions import Fraction

        from mixlab_tpu_torch.av.jpeg import JpegError, decode_jpeg
        from mixlab_tpu_torch.io_host.throttle import MediaThrottle
        from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
        from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame

        self.stream.seek(0)
        data = bytearray()
        while True:
            chunk = self.stream.read(1 << 20)
            if not chunk:
                break
            data += chunk
        try:
            y, u, v = decode_jpeg(bytes(data))
        except JpegError as e:
            # arithmetic-coded/12-bit JPEGs exceed the pure decoder's scope
            # (baseline AND progressive decode pure): fall back to the
            # libavcodec shim when present
            from mixlab_tpu_torch.native import avshim

            if avshim.available():
                log.info("media_source: pure jpeg decode failed (%s); "
                         "using the codec shim", e)
                self.stream.seek(0)
                self._run_shim()
                return
            log.warning("media_source: jpeg decode failed (%s); %s", e, NO_SHIM)
            return
        h, w = y.shape
        pic = Picture(
            PictureSettings(w, h),
            _upload_planes(y, u, v, self.device),
        )
        FPS = 10
        frame = VideoFrame(picture=pic, duration_hint=MediaDuration.new(1, FPS))
        throttle = MediaThrottle()
        n = 0
        while not self._stop_evt.is_set():
            t = Fraction(n, FPS)
            n += 1
            throttle.wait_until(MediaTime(t))
            while not self._stop_evt.is_set():
                if self.feed.push_video(MediaTime(t), frame, block=True,
                                        timeout=0.25):
                    break

    def _run_mp4(self):
        """Codec-free MP4 playback: pure demux (av/mp4read.py) + pure
        decoders — H.264 video via av/h264dec.py, FLAC-in-MP4 audio via
        av/flacdec.py, AAC-LC audio via av/aacdec.py (tables recovered
        clean-room from the libavcodec oracle; differentially validated in
        tests/test_aacdec.py).  Out-of-scope shapes raise typed errors,
        never mis-decode."""
        from fractions import Fraction

        from mixlab_tpu_torch.av.avc import AvcError
        from mixlab_tpu_torch.av.h264dec import H264DecodeError, PureH264Decoder
        from mixlab_tpu_torch.av.flacdec import FlacDecoder, FlacError
        from mixlab_tpu_torch.av.mp4read import Mp4Error, Mp4Reader
        from mixlab_tpu_torch.io_host.throttle import MediaThrottle
        from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
        from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame

        self.stream.seek(0)
        data = bytearray()
        while True:
            chunk = self.stream.read(1 << 20)
            if not chunk:
                break
            data += chunk
        try:
            r = Mp4Reader(bytes(data))
        except Mp4Error as e:
            log.warning("media_source: bad mp4: %s", e)
            return
        vt = r.video_track()
        at = r.audio_track()
        video_ok = vt is not None and vt.codec == "h264"
        audio_ok = at is not None and at.codec in ("flac", "aac")
        if at is not None and not audio_ok:
            log.warning(
                "media_source: pure tier cannot decode %s audio (%s); "
                "playing video only", at.codec, NO_SHIM)
        if vt is not None and not video_ok:
            log.warning("media_source: pure tier cannot decode %s video",
                        vt.codec)
        if not video_ok and not audio_ok:
            log.warning("media_source: no decodable tracks in mp4")
            return

        events = []
        if video_ok:
            for i, s in enumerate(vt.samples):
                nxt = (vt.samples[i + 1].dts - s.dts
                       if i + 1 < len(vt.samples) else 0)
                # feed the decoder in DECODE (dts) order — B-frame files
                # store samples with cts reordering; the decoder emits
                # display-order frames carrying their composition pts
                dts = max(s.dts - vt.edit_media_time, 0)
                events.append((Fraction(dts, vt.timescale), "video", s,
                               Fraction(max(nxt, 1), vt.timescale)))
        if audio_ok:
            for s in at.samples:
                dts = max(s.dts - at.edit_media_time, 0)
                events.append((Fraction(dts, at.timescale), "audio", s,
                               Fraction(0)))
        events.sort(key=lambda e: (e[0], e[1]))
        if not events:
            return

        is_aac = audio_ok and at.codec == "aac"
        try:
            from mixlab_tpu_torch.av.aac import AacError, AudioSpecificConfiguration
            from mixlab_tpu_torch.av.aacdec import AacDecodeError
            from mixlab_tpu_torch.av.aacdec_worker import AacDecodeProcess

            vdec = PureH264Decoder(vt.dcr) if video_ok else None
            fdec = adec = asc = None
            if is_aac:
                asc = AudioSpecificConfiguration.parse(at.asc)
                # the decode runs in a codec process, off this process's
                # interpreter lock; the thread ends it as it leaves
                adec = AacDecodeProcess(asc)
                self._children.append(adec)
            elif audio_ok:
                fdec = FlacDecoder(at.streaminfo)
        except (H264DecodeError, FlacError, AvcError, AacError, ValueError,
                IndexError) as e:
            # fuzzed/corrupt dcr (AvcError from the DCR parse), ASC or
            # STREAMINFO: typed failure, not a dead thread
            log.warning("media_source: bad mp4 codec config: %s", e)
            return
        if is_aac:
            from mixlab_tpu_torch.av.aac import SAMPLING_FREQUENCIES

            a_rate = SAMPLING_FREQUENCIES[asc.sampling_frequency_index]
            a_scale = 1.0  # aacdec outputs float in [-1, 1]
        else:
            a_rate = fdec.sample_rate if audio_ok else self.cfg.sample_rate
            # full-scale divisor from the stream's bit depth (matches
            # _run_flac: 24-bit FLAC-in-MP4 must not be scaled as if 16-bit)
            a_scale = float(1 << (fdec.bps - 1)) if audio_ok else 32768.0
        pusher = _PcmPusher(self, a_rate)
        throttle = MediaThrottle()
        epoch = Fraction(0)
        while not self._stop_evt.is_set():
            pusher.reset()
            end = Fraction(0)
            for t0, kind, s, dur in events:
                if self._stop_evt.is_set():
                    return
                t = epoch + t0
                throttle.wait_until(MediaTime(t))
                try:
                    payload = r.sample_data(s)
                    if kind == "audio":
                        if is_aac:
                            try:
                                pcm32 = adec.decode_raw(
                                    payload, asc.sampling_frequency_index)
                            except AacDecodeError as e:
                                # one bad granule must not kill the video
                                # track: skip it (typed, never mis-decoded)
                                if not self._warned_aac:
                                    self._warned_aac = True
                                    log.warning(
                                        "media_source: aac granule "
                                        "skipped: %s", e)
                                continue
                        else:
                            pcm32, _ = fdec.decode_frame(payload)
                        end = max(end, t0 + Fraction(len(pcm32), a_rate))
                        pusher.push(pcm32.astype(np.float32) / a_scale)
                    else:
                        # elst media_time = leading-media skip (mp4read)
                        cts = max(s.cts - vt.edit_media_time, 0)
                        frames = vdec.decode(payload, cts)
                        end = max(end, t0 + dur)
                        for fpts, y, u, v in frames:
                            h, w = y.shape
                            pic = Picture(PictureSettings(w, h),
                                          _upload_planes(y, u, v, self.device))
                            frame = VideoFrame(
                                picture=pic,
                                duration_hint=MediaDuration(dur))
                            ft = epoch + Fraction(int(fpts), vt.timescale)
                            while not self._stop_evt.is_set():
                                if self.feed.push_video(MediaTime(ft), frame,
                                                        block=True,
                                                        timeout=0.25):
                                    break
                except (H264DecodeError, FlacError, Mp4Error,
                        AacDecodeError) as e:
                    # Mp4Error: sample offsets outside the file (corrupt
                    # moof/stco) surface here from sample_data
                    log.warning("media_source: pure mp4 decode failed: %s", e)
                    return
            if video_ok:  # drain the display-order reorder buffer (B)
                try:
                    tail = vdec.flush()
                except H264DecodeError:
                    tail = []
                for fpts, y, u, v in tail:
                    h, w = y.shape
                    pic = Picture(PictureSettings(w, h),
                                  _upload_planes(y, u, v, self.device))
                    frame = VideoFrame(
                        picture=pic,
                        duration_hint=MediaDuration(Fraction(1, 30)))
                    ft = epoch + Fraction(int(fpts), vt.timescale)
                    while not self._stop_evt.is_set():
                        if self.feed.push_video(MediaTime(ft), frame,
                                                block=True, timeout=0.25):
                            break
            if end == 0:
                return  # nothing played: don't spin
            epoch += end  # loop with epoch accumulation

    def _run_shim(self):
        """Any-container playback through the ffmpeg-libs shim
        (native/avshim.py): the reference's ffmpeg decode loop
        (media_source.rs:185-292) — audio AND video, realtime-paced,
        looping with epoch accumulation (media_source.rs:246-292).

        Demuxes straight from the project blob stream via callback IO
        (avshim_media_open_io; the reference's IoReader->AVIO bridge,
        codec/src/ffmpeg/ioctx.rs:15-100 + src/project/stream.rs:113-190)
        — no temp-file spool.  Decoded pictures go to the engine's device
        through ``_upload_planes``."""
        from fractions import Fraction

        from mixlab_tpu_torch.io_host.throttle import MediaThrottle
        from mixlab_tpu_torch.native import avshim
        from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
        from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame

        self.stream.seek(0)
        try:
            reader = avshim.MediaReader.from_reader(self.stream)
        except avshim.ShimError as e:
            log.warning("media_source: cannot open media: %s", e)
            return
        try:
            a_rate = reader.audio["rate"] if reader.audio else None
            pusher = _PcmPusher(self, a_rate) if a_rate else None
            throttle = MediaThrottle()
            epoch = Fraction(0)  # accumulated loop offset, seconds
            last_pts = Fraction(0)
            while not self._stop_evt.is_set():
                item = reader.read()
                if item is None:
                    # loop: seek to start, accumulate epoch
                    epoch = last_pts
                    if reader.seek_start() < 0:
                        # not seekable: open the stream again from its start
                        reader.close()
                        self.stream.seek(0)
                        reader = avshim.MediaReader.from_reader(self.stream)
                    if pusher is not None:
                        pusher.reset()
                    continue
                kind, pts, payload = item
                if kind == "audio":
                    tb = Fraction(*reader.audio["time_base"])
                    t = epoch + (pts * tb if pts >= 0 else last_pts - epoch)
                    last_pts = max(last_pts, t + Fraction(len(payload), a_rate))
                    throttle.wait_until(MediaTime(t))
                    pusher.push(payload.astype(np.float32) / 32768.0)
                else:  # video
                    tb = Fraction(*reader.video["time_base"])
                    t = epoch + (pts * tb if pts >= 0 else last_pts - epoch)
                    last_pts = max(last_pts, t)
                    throttle.wait_until(MediaTime(t))
                    y, u, v = payload
                    h, w = y.shape
                    pic = Picture(
                        PictureSettings(w, h),
                        _upload_planes(y, u, v, self.device),
                    )
                    fps_n, fps_d = reader.video["fps"]
                    frame = VideoFrame(
                        picture=pic,
                        duration_hint=MediaDuration.new(fps_d, fps_n),
                    )
                    pts_mt = MediaTime(t)
                    while not self._stop_evt.is_set():
                        if self.feed.push_video(pts_mt, frame, block=True, timeout=0.25):
                            break
        finally:
            reader.close()
