"""Media playback in the port against the JAX package, on the CPU.

The port's ``MediaPlayer`` (``mixlab_tpu_torch/engine/media_player.py``)
and the JAX package's play the same upload side by side, with both
packages' realtime throttles made no-ops so that the decode threads run as
fast as the test drains their feeds.  Both packages' libavcodec shims are
reported absent (as ``tests/test_mp4read.py`` does for the JAX package), so
both take the pure demux and decoders, and the JAX package's native library
is patched away so that no test here builds it; where the shims are present,
an MP4 also plays through both packages' ``_run_shim``.  The first audio samples match to 1e-6 and the
first video frames exactly, with their pts, past the first loop at EOF.

Then the port's ``Engine`` plays uploads through a ``ProjectHandle``:
MediaSource -> VideoMixer -> Monitor, as ``tests/test_stream_output_media.py``
does for the JAX engine.
"""

import io
import logging
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import mixlab_tpu.native as jax_native
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.feeds import MediaSourceFeed as JaxFeed
from mixlab_tpu.engine.media_player import MediaPlayer as JaxPlayer
from mixlab_tpu.io_host import throttle as jax_throttle
from mixlab_tpu.native import avshim as jax_avshim
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.native import avshim
from mixlab_tpu_torch.av import mp4
from mixlab_tpu_torch.av.aac import adts_frame
from mixlab_tpu_torch.av.aacenc import AacLcEncoder
from mixlab_tpu_torch.av.flacenc import FlacEncoder
from mixlab_tpu_torch.av.h264enc import PureH264Stream
from mixlab_tpu_torch.engine import media_player
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.feeds import MediaSourceFeed
from mixlab_tpu_torch.engine.media_player import MediaPlayer
from mixlab_tpu_torch.engine.project import open_or_create
from mixlab_tpu_torch.io_host import throttle
from mixlab_tpu_torch.io_host.wav import write_wav
from mixlab_tpu_torch.utils.mtime import MediaDuration
from mixlab_tpu_torch.video.frame import Picture, PictureSettings
from tests.test_torch_engine import _NoCodec

SR = 44_100


def _pygame_ogg() -> Path:
    """The Ogg/Vorbis clip pygame ships with its examples (the file
    ``tests/test_stream_output_media.py`` plays), where pygame is installed."""
    import importlib.util

    spec = importlib.util.find_spec("pygame")
    if spec is None or spec.origin is None:
        return Path("house_lo.ogg-absent")
    return Path(spec.origin).parent / "examples" / "data" / "house_lo.ogg"


OGG = _pygame_ogg()


# -- the uploads, made from a seed -------------------------------------------


def tone(rate, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    sig = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)], 1) * 0.4
    return (sig + rng.normal(0, 0.02, sig.shape)).clip(-1, 1).astype(np.float32)


def wav_bytes(tmp_path, rate=48_000, seconds=0.25):
    path = tmp_path / "tone.wav"
    write_wav(path, rate, tone(rate, seconds))
    return path.read_bytes()


def flac_bytes(seconds=0.2):
    enc = FlacEncoder(SR, 2, 1024)
    pcm = (tone(SR, seconds) * 32767).astype(np.int16)
    return enc.stream_header() + b"".join(
        enc.encode_frame(pcm[i:i + 1024]) for i in range(0, len(pcm), 1024))


def planes(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2 + seed * 17) % 200 + rng.integers(0, 40, (h, w))).astype(np.uint8)
    return (y, rng.integers(60, 200, (h // 2, w // 2), dtype=np.uint8),
            rng.integers(60, 200, (h // 2, w // 2), dtype=np.uint8))


def y4m_bytes(w=64, h=48, n=4):
    out = [f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420\n".encode()]
    for i in range(n):
        out.append(b"FRAME\n")
        out += [p.tobytes() for p in planes(w, h, i)]
    return b"".join(out)


def jpeg_bytes(w=64, h=48):
    from PIL import Image

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 4 % 256, yy * 5 % 256, (xx + yy) * 2 % 256], -1)
    rgb = (rgb + rng.integers(0, 30, rgb.shape)).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=85, subsampling=2)
    return buf.getvalue()


def mp4_bytes(audio_codec, w=112, h=64, n_video=3, seconds=0.3):
    """A fragmented MP4 of the port's mux: CAVLC intra H.264 at 10 fps and
    FLAC or AAC-LC audio, segments in time order."""
    vstream = PureH264Stream(PictureSettings(w, h), mode="cavlc", qp=26)
    pcm = (tone(SR, seconds) * 32767).astype(np.int16)
    if audio_codec == "flac":
        fenc = FlacEncoder(SR, 2, 1024)
        audio = [mp4.FlacFrame(fenc.encode_frame(pcm[i:i + 1024]))
                 for i in range(0, len(pcm) - 1023, 1024)]
        extra = dict(audio_codec="flac", flac_streaminfo_block=fenc.streaminfo_block())
    else:
        aenc = AacLcEncoder(SR, 2)
        audio = [mp4.AdtsFrame(adts_frame(aenc.encode_granule(pcm[i:i + 1024]), aenc.asc))
                 for i in range(0, len(pcm) - 1023, 1024)]
        extra = {}
    mux, blob = mp4.Mp4Mux.create(mp4.Mp4Params(
        timescale=SR, width=w, height=h, dcr=vstream.dcr, sample_rate=SR, channels=2,
        **extra))
    blob = bytearray(blob)
    events = [(Fraction(k * 1024, SR), "a", a) for k, a in enumerate(audio)]
    events += [(Fraction(k, 10), "v", k) for k in range(n_video)]
    for _, kind, item in sorted(events, key=lambda e: (e[0], e[1])):
        if kind == "a":
            blob += mux.write_track(MediaDuration.new(1024, SR), item)
        else:
            vstream.feed(Picture(PictureSettings(w, h), dict(zip("yuv", planes(w, h, item)))))
            ((key, avcc),) = vstream.poll_access_units()
            blob += mux.write_track(MediaDuration.new(1, 10),
                                    mp4.AvcFrame(key, MediaDuration.zero(), avcc))
    return bytes(blob)


# -- both players on one upload ----------------------------------------------


@pytest.fixture
def unthrottled(monkeypatch):
    """Both packages' players run unthrottled, without the shim and without
    the JAX package's native library."""
    for mod in (throttle, jax_throttle):
        monkeypatch.setattr(mod.AudioThrottle, "send_samples", lambda self, n: None)
        monkeypatch.setattr(mod.MediaThrottle, "wait_until", lambda self, t: None)
    monkeypatch.setattr(jax_avshim, "available", lambda: False)
    monkeypatch.setattr(avshim, "available", lambda: False)
    monkeypatch.setattr(jax_native, "_load", lambda: None)


@pytest.fixture
def unthrottled_shim(monkeypatch):
    """Both packages' players run unthrottled, each with its libavcodec
    shim (the test skips where either is absent)."""
    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    if not jax_avshim.available():
        pytest.skip("the JAX package's libavcodec shim is unavailable")
    for mod in (throttle, jax_throttle):
        monkeypatch.setattr(mod.AudioThrottle, "send_samples", lambda self, n: None)
        monkeypatch.setattr(mod.MediaThrottle, "wait_until", lambda self, t: None)
    monkeypatch.setattr(jax_native, "_load", lambda: None)


def collect(feed, n_samples, n_frames, timeout=90.0):
    """Drain ``feed``'s audio and video queues until ``n_samples`` samples
    and ``n_frames`` frames have come."""
    audio, video = [], []
    deadline = time.monotonic() + timeout
    while sum(map(len, audio)) < n_samples or len(video) < n_frames:
        assert time.monotonic() < deadline, (sum(map(len, audio)), len(video))
        got = False
        for q, out in ((feed.queue, audio), (feed.video_q, video)):
            try:
                out.append(q.get_nowait())
                got = True
            except Exception:
                pass
        if not got:
            time.sleep(0.001)
    return (np.concatenate(audio)[:n_samples] if n_samples else None), video[:n_frames]


def play_both(blob, n_samples, n_frames):
    """(port's, JAX package's) first ``n_samples`` audio samples and
    ``n_frames`` video items for the same upload."""
    results = []
    for player_cls, feed_cls, cfg_cls, kwargs in (
            (MediaPlayer, MediaSourceFeed, EngineConfig, {"device": "cpu"}),
            (JaxPlayer, JaxFeed, JaxEngineConfig, {})):
        cfg = cfg_cls(sample_rate=SR)
        feed = feed_cls(cfg)
        player = player_cls(io.BytesIO(blob), feed, cfg, **kwargs)
        player.start()
        try:
            results.append(collect(feed, n_samples, n_frames))
        finally:
            player.stop()
            player.join(timeout=5)
        assert not player.is_alive()
    return results


def assert_same_playback(port, jax):
    (pa, pv), (ja, jv) = port, jax
    if pa is not None:
        assert pa.dtype == np.float32 and pa.shape == ja.shape
        np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-6)
        assert np.abs(pa).max() > 0.1
    assert len(pv) == len(jv)
    for i, ((p_pts, p_frame), (j_pts, j_frame)) in enumerate(zip(pv, jv)):
        assert p_pts.frac == j_pts.frac, i
        assert p_frame.duration_hint.frac == j_frame.duration_hint.frac, i
        for k in "yuv":
            got = p_frame.picture.planes[k]
            assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
            assert got.device.type == "cpu"
            assert np.array_equal(got.numpy(), np.asarray(j_frame.picture.planes[k])), (i, k)


@pytest.mark.parametrize("kind", ["wav", "flac"])
def test_audio_upload_plays_as_in_the_jax_package(kind, unthrottled, tmp_path):
    """0.25 s of WAV at 48 kHz (resampled to 44.1 kHz on the decode thread)
    or 0.2 s of FLAC: 0.6 s of samples, so past the first loop."""
    blob = wav_bytes(tmp_path) if kind == "wav" else flac_bytes()
    assert_same_playback(*play_both(blob, int(SR * 0.6), 0))


def test_ogg_vorbis_upload_plays_as_in_the_jax_package(unthrottled):
    if not OGG.exists():
        pytest.skip(f"{OGG} is absent")
    assert_same_playback(*play_both(OGG.read_bytes(), SR // 2, 0))


def test_y4m_upload_plays_as_in_the_jax_package(unthrottled):
    """4 frames at 30 fps, 10 frames taken: the loops at EOF carry the
    epoch on (pts 4/30 .. 9/30)."""
    port, jax = play_both(y4m_bytes(), 0, 10)
    assert_same_playback(port, jax)
    assert [pts.frac for pts, _ in port[1]] == [Fraction(i, 30) for i in range(10)]
    want = planes(64, 48, 1)
    assert np.array_equal(port[1][5][1].picture.planes["y"].numpy(), want[0])


def test_jpeg_still_upload_plays_as_in_the_jax_package(unthrottled):
    port, jax = play_both(jpeg_bytes(), 0, 3)
    assert_same_playback(port, jax)
    assert [pts.frac for pts, _ in port[1]] == [Fraction(0), Fraction(1, 10), Fraction(2, 10)]


@pytest.mark.parametrize("audio_codec", ["flac", "aac"])
def test_mp4_upload_plays_as_in_the_jax_package(audio_codec, unthrottled):
    """H.264 at 10 fps with FLAC or AAC-LC: 7 frames (past the loop at the
    third) and 0.6 s of samples."""
    port, jax = play_both(mp4_bytes(audio_codec), int(SR * 0.6), 7)
    assert_same_playback(port, jax)
    pts = [p.frac for p, _ in port[1]]
    assert pts[:3] == [Fraction(0), Fraction(1, 10), Fraction(2, 10)] and pts[3] > pts[2]


@pytest.mark.parametrize("audio_codec", ["flac", "aac"])
def test_mp4_upload_plays_through_the_shim_as_in_the_jax_package(audio_codec,
                                                                  unthrottled_shim):
    """The same uploads through both packages' ``_run_shim`` (libavcodec's
    demux and decoders): the same samples and pictures over the clip (3
    frames, 12 audio frames of 1,024).  The fragmented MP4 cannot be
    seeked back to its start: the port opens it again and plays on past
    the loop (7 frames), where the JAX package's loop reads nothing more."""
    calls = []
    real = MediaPlayer._run_shim
    blob = mp4_bytes(audio_codec)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(MediaPlayer, "_run_shim", lambda self: calls.append(1) or real(self))
        port, jax = play_both(blob, 12 * 1024, 3)
        assert calls == [1]
        assert_same_playback(port, jax)
        cfg = EngineConfig(sample_rate=SR)
        feed = MediaSourceFeed(cfg)
        player = MediaPlayer(io.BytesIO(blob), feed, cfg, "cpu")
        player.start()
        try:
            _, looped = collect(feed, 0, 7)
        finally:
            player.stop()
            player.join(timeout=5)
    pts = [p.frac for p, _ in looped]
    assert pts[:3] == [Fraction(0), Fraction(1, 10), Fraction(2, 10)] and pts[3] > pts[2]
    assert all(b > a for a, b in zip(pts, pts[1:]))
    assert torch.equal(looped[3][1].picture.planes["y"], looped[0][1].picture.planes["y"])


def test_undecodable_upload_names_the_shim_item(unthrottled, caplog):
    """Without the shim's libraries, a file only the shim could decode plays
    nothing and says that the libraries are absent."""
    cfg = EngineConfig(sample_rate=SR)
    feed = MediaSourceFeed(cfg)
    player = MediaPlayer(io.BytesIO(b"\x1aE\xdf\xa3" + bytes(200)), feed, cfg, "cpu")
    with caplog.at_level(logging.WARNING, logger=media_player.__name__):
        player.start()
        player.join(timeout=10)
    assert not player.is_alive() and feed.queue.empty() and feed.video_q.empty()
    assert media_player.NO_SHIM in caplog.text and "absent" in media_player.NO_SHIM


def test_player_needs_the_engines_device():
    cfg = EngineConfig(sample_rate=SR)
    with pytest.raises(TypeError):
        MediaPlayer(io.BytesIO(b""), MediaSourceFeed(cfg), cfg)


# -- the engine and the project handle ----------------------------------------


def _create(eng, sid, seq, op):
    eng.update(sid, tp.WorkspaceMessage(seq, op))


def test_project_upload_plays_through_media_source_mixer_and_monitor(tmp_path, monkeypatch):
    """A ProjectHandle on the CPU: a WAV upload and a Y4M upload, each on a
    MediaSource; the WAV's audio and the Y4M's pictures (through a
    VideoMixer at fader 1, channel A) reach the Monitor's pipe."""
    monkeypatch.setattr("mixlab_tpu_torch.server.monitor.MonitorPipeline", _NoCodec)
    for mod in (throttle,):
        monkeypatch.setattr(mod.MediaThrottle, "wait_until", lambda self, t: None)
    cfg = EngineConfig(sample_rate=SR)
    proj = open_or_create(tmp_path / "media.mixlab", cfg, device="cpu")
    try:
        wav_id = proj.upload_media("tone.wav", "audio/wav", [wav_bytes(tmp_path, SR, 0.5)])
        y4m_id = proj.upload_media("clip.y4m", "video/x-yuv4mpeg", [y4m_bytes()])
        eng = proj.engine
        sid, _, _ = eng.connect_session()
        geo = tp.WindowGeometry()
        ops = [
            tp.CreateModule(tp.ModuleParams("MediaSource", tp.MediaSourceParams(wav_id)), geo),
            tp.CreateModule(tp.ModuleParams("MediaSource", tp.MediaSourceParams(y4m_id)), geo),
            tp.CreateModule(tp.ModuleParams("VideoMixer", tp.VideoMixerParams(a=0)), geo),
            tp.CreateModule(tp.ModuleParams("Monitor", None), geo),
            tp.CreateConnection(tp.InputId(tp.ModuleId(3), 0), tp.OutputId(tp.ModuleId(2), 0)),
            tp.CreateConnection(tp.InputId(tp.ModuleId(4), 0), tp.OutputId(tp.ModuleId(3), 0)),
            tp.CreateConnection(tp.InputId(tp.ModuleId(4), 1), tp.OutputId(tp.ModuleId(1), 1)),
        ]
        for seq, op in enumerate(ops, 1):
            _create(eng, sid, seq, op)
        assert set(eng._media_players) == {tp.ModuleId(1), tp.ModuleId(2)}
        assert all(pl.is_alive() and pl.device == torch.device("cpu")
                   for pl in eng._media_players.values())
        frames = [planes(64, 48, i)[0] for i in range(4)]
        pipe = eng.monitor_pipe(tp.ModuleId(4))
        peak, seen = 0.0, set()
        deadline = time.monotonic() + 30
        while (peak <= 0.3 or len(seen) < 2) and time.monotonic() < deadline:
            eng.tick_once()
            while not pipe.q.empty():
                _, audio, video = pipe.q.get_nowait()
                peak = max(peak, float(np.abs(audio).max()))
                if video is not None:
                    y = video.picture.planes["y"].numpy()
                    hits = [i for i, f in enumerate(frames) if np.array_equal(y, f)]
                    assert hits, "a composite that is not a decoded picture"
                    seen.update(hits)
            time.sleep(0.005)
        assert peak > 0.3 and len(seen) >= 2, (peak, seen)
        # deleting the MediaSource stops its decode thread
        player = eng._media_players[tp.ModuleId(1)]
        _create(eng, sid, len(ops) + 1, tp.DeleteModule(tp.ModuleId(1)))
        player.join(timeout=5)
        assert not player.is_alive() and tp.ModuleId(1) not in eng._media_players
    finally:
        proj.close()
    assert not any(pl.is_alive() for pl in eng._media_players.values())
