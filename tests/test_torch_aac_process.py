"""The pure tier's AAC-LC codec processes, on the CPU.

The encoder (``av/codecs.py`` ``PureAacStream``, ``av/aac_worker.py``): its
ADTS frames are the in-process encoder's and the JAX package's
``PureAacStream``'s, byte for byte and in the same polls; no child outlives
its stream, its Monitor's codec thread or its project handle; a child that
dies raises in the codec thread.

The decoder (``av/aacdec_worker.py`` ``AacDecodeProcess``, which the
MediaPlayer's MP4 path and the RTMP ingest run): its PCM is the in-process
``AacLcDecoder``'s, bit for bit, over the MP4 that ``tests/test_torch_media.py``
plays and over an RTMP stream's granules; a corrupt granule gives the typed
error, once, and the stream goes on as in process; the child imports no
torch and ends with its stream; the MediaPlayer skips a bad granule with one
warning and ends its child when it stops.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mixlab_tpu.av import codecs as jcodecs
from mixlab_tpu.av.encode_stream import f32_to_i16 as jax_f32_to_i16
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.av import codecs
from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration, adts_frame
from mixlab_tpu_torch.av.aacdec import AacDecodeError, AacLcDecoder
from mixlab_tpu_torch.av.aacdec_worker import AacDecodeProcess
from mixlab_tpu_torch.av.aacenc import AacLcEncoder
from mixlab_tpu_torch.av.encode_stream import f32_to_i16
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import _MonitorPipe
from mixlab_tpu_torch.engine.project import open_or_create
from mixlab_tpu_torch.av.mp4read import Mp4Reader
from mixlab_tpu_torch.server.monitor import MonitorPipeline

ROOT = Path(__file__).resolve().parents[1]


def seeded_pcm(rate, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    sig = np.stack([np.sin(2 * np.pi * 330 * t), np.sin(2 * np.pi * 495 * t)], 1) * 0.5
    return (sig + rng.normal(0, 0.05, sig.shape)).astype(np.float32)


@pytest.mark.parametrize("bitrate", [None, 160_000])
def test_codec_process_frames_equal_in_process_and_jax(bitrate):
    """3 s fed in ticks of 735 frames, polled after each: the same frames in
    the same polls as the JAX package's in-process stream, and the frames
    of ``AacLcEncoder`` in this process."""
    pcm = seeded_pcm(44_100, 3.0, seed=0 if bitrate is None else 1)
    port = codecs.PureAacStream(44_100, 2, bitrate=bitrate)
    jax = jcodecs.PureAacStream(44_100, 2, bitrate=bitrate)
    try:
        polls_t, polls_j = [], []
        for i in range(0, len(pcm), 735):
            chunk = pcm[i:i + 735].reshape(-1)
            port.feed(f32_to_i16(chunk))
            jax.feed(jax_f32_to_i16(chunk))
            polls_t.append(port.poll_frames())
            polls_j.append(jax.poll_frames())
        assert polls_t == polls_j
        frames = [f for poll in polls_t for f in poll]
        assert len(frames) == len(pcm) // 1024
        enc = AacLcEncoder(44_100, 2, bitrate=bitrate)
        i16 = f32_to_i16(pcm.reshape(-1)).reshape(-1, 2)
        assert frames == [adts_frame(enc.encode_granule(i16[k * 1024:(k + 1) * 1024]), enc.asc)
                          for k in range(len(frames))]
        assert port.configuration_data() == jax.configuration_data() == enc.asc.to_bytes()
    finally:
        port.close()
    assert port.proc.poll() == 0


def test_codec_process_imports_no_torch():
    code = ("import sys, mixlab_tpu_torch.av.aac_worker; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_decode_process_imports_no_torch():
    """The decode child's module and what its ``main`` imports, run to the
    end of an empty stdin."""
    asc = AudioSpecificConfiguration.lc_stereo().to_bytes().hex()
    code = ("import sys, mixlab_tpu_torch.av.aacdec_worker as m; "
            f"assert m.main([{asc!r}]) == 0; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60, input="")
    assert proc.returncode == 0, proc.stderr


def test_unsupported_rate_is_refused_before_a_child_starts():
    from mixlab_tpu_torch.av.aacenc import AacEncodeError

    with pytest.raises(AacEncodeError, match="unsupported sample rate"):
        codecs.PureAacStream(7_350, 2)


def _pipeline(monkeypatch, cfg):
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    pipe = _MonitorPipe()
    pipeline = MonitorPipeline(pipe, cfg)
    pipeline.start()
    assert pipeline._codecs_ready.wait(60)
    return pipe, pipeline


def _items(cfg, n, t0=0):
    spt = cfg.samples_per_tick
    pcm = seeded_pcm(cfg.sample_rate, n * spt / cfg.sample_rate)
    return [((t0 + k) * spt, pcm[k * spt:(k + 1) * spt], None) for k in range(n)]


def test_stopped_pipeline_leaves_no_child(monkeypatch):
    cfg = EngineConfig(sample_rate=44_100)
    pipe, pipeline = _pipeline(monkeypatch, cfg)
    sub = pipeline.broadcast.subscribe()
    for item in _items(cfg, 6):
        pipe.q.put(item, timeout=5)
    deadline = time.monotonic() + 30
    segments = 0
    while segments < 4 and time.monotonic() < deadline:
        try:
            segments += b'"segment"' in sub.get(timeout=1).partition(b"\n")[0]
        except Exception:
            pass
    assert segments >= 4  # 4,410 samples: four AAC frames
    proc = pipeline._aac.proc
    assert proc.poll() is None
    pipeline.stop()
    pipeline.join(timeout=10)
    assert not pipeline.is_alive() and proc.poll() == 0


def test_killed_child_raises_in_the_codec_thread(monkeypatch):
    cfg = EngineConfig(sample_rate=44_100)
    faults = []
    monkeypatch.setattr(threading, "excepthook", lambda args: faults.append(args.exc_value))
    pipe, pipeline = _pipeline(monkeypatch, cfg)
    pipeline._aac.proc.kill()
    pipeline._aac.proc.wait()
    for item in _items(cfg, 4):
        pipe.push(item)  # drops once the dead thread stops taking items
    pipeline.join(timeout=30)
    assert not pipeline.is_alive()
    assert len(faults) == 1 and isinstance(faults[0], RuntimeError)
    assert "AAC codec process has exited" in str(faults[0])


def test_closed_project_leaves_no_child(tmp_path, monkeypatch):
    """A ProjectHandle with a Monitor: its codec thread's AAC process ends
    when the handle closes."""
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    proj = open_or_create(tmp_path / "p.mixlab", EngineConfig(sample_rate=44_100),
                          device="cpu")
    eng = proj.engine
    sid, _, _ = eng.connect_session()
    eng.update(sid, tp.WorkspaceMessage(1, tp.CreateModule(
        tp.ModuleParams("Monitor", None), tp.WindowGeometry())))
    (pipeline,) = eng._monitor_pipelines.values()
    assert pipeline._codecs_ready.wait(60)
    proc = pipeline._aac.proc
    for _ in range(3):
        eng.tick_once()
    proj.close()
    assert not pipeline.is_alive() and proc.poll() == 0


# -- the decoder's codec process ---------------------------------------------


def _mp4_granules():
    """The raw AAC-LC granules and the ASC of the MP4 that
    ``tests/test_torch_media.py`` plays."""
    from tests.test_torch_media import mp4_bytes

    r = Mp4Reader(mp4_bytes("aac", seconds=1.0))
    at = r.audio_track()
    return [r.sample_data(s) for s in at.samples], AudioSpecificConfiguration.parse(at.asc)


def _rtmp_granules():
    from tests.test_torch_rtmp_icecast import _aac_tags

    _, raws, asc = _aac_tags(seconds=1.0, seed=9)
    return raws, asc


def _decode_both(raws, asc):
    """Each granule through the in-process decoder and the codec process:
    -> [(in-process, process)], a PCM array or the AacDecodeError text."""
    here, child = AacLcDecoder(asc), AacDecodeProcess(asc)
    out = []
    try:
        for raw in raws:
            pair = []
            for dec in (here, child):
                try:
                    pair.append(dec.decode_raw(raw, asc.sampling_frequency_index))
                except AacDecodeError as e:
                    pair.append(str(e))
            out.append(tuple(pair))
    finally:
        child.close()
    assert child.proc.poll() == 0
    return out


@pytest.mark.parametrize("source", ["mp4", "rtmp"])
def test_decode_process_pcm_is_bit_equal(source):
    raws, asc = _mp4_granules() if source == "mp4" else _rtmp_granules()
    pairs = _decode_both(raws, asc)
    assert len(pairs) == len(raws) >= 40
    for i, (a, b) in enumerate(pairs):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (1024, 2), i
        assert np.array_equal(a, b), i


@pytest.mark.parametrize("corrupt", [b"", b"\xff\xff\xff", "truncated", "bits"])
def test_corrupt_granule_gives_the_typed_error_and_the_stream_goes_on(corrupt):
    raws, asc = _rtmp_granules()
    bad = {"truncated": raws[10][:len(raws[10]) // 3],
           "bits": bytes(b ^ 0x5A for b in raws[10])}.get(corrupt, corrupt)
    pairs = _decode_both(raws[:10] + [bad] + raws[11:20], asc)
    a, b = pairs[10]
    if isinstance(a, str):  # the same AacDecodeError, raised in this process
        assert a == b
    else:  # flipped bits may still parse: then the same PCM
        assert corrupt == "bits" and np.array_equal(a, b)
    for x, y in pairs[:10] + pairs[11:]:
        assert np.array_equal(x, y)


def test_decode_process_ends_with_its_stream():
    child = AacDecodeProcess(AudioSpecificConfiguration.lc_stereo())
    raws, asc = _rtmp_granules()
    child.decode_raw(raws[0], asc.sampling_frequency_index)
    child.proc.stdin.close()  # the end of its stream, as ``close`` makes it
    assert child.proc.wait(timeout=10) == 0
    child.close()
    with pytest.raises(RuntimeError, match="AAC decode process has exited"):
        child.decode_raw(raws[1], asc.sampling_frequency_index)


def test_media_player_skips_a_bad_granule_once_and_ends_its_child(caplog):
    """An MP4 with every AAC granule from the fifth on replaced by junk: the
    MediaPlayer plays the first four as the decoder makes them, warns once,
    keeps playing the video, and its codec process ends with it."""
    import io

    from tests.test_torch_media import mp4_bytes

    from mixlab_tpu_torch.engine.feeds import MediaSourceFeed
    from mixlab_tpu_torch.engine.media_player import MediaPlayer
    from mixlab_tpu_torch.io_host import throttle
    from mixlab_tpu_torch.native import avshim

    blob = bytearray(mp4_bytes("aac", seconds=0.4, n_video=4))
    r = Mp4Reader(bytes(blob))
    at = r.audio_track()
    good = [r.sample_data(s) for s in at.samples]
    for s in at.samples[4:]:
        blob[s.offset:s.offset + s.size] = b"\x00" * s.size  # no channel elements
    cfg = EngineConfig(sample_rate=44_100)
    feed = MediaSourceFeed(cfg)
    player = MediaPlayer(io.BytesIO(bytes(blob)), feed, cfg, "cpu")
    with caplog.at_level("WARNING", logger="mixlab_tpu_torch.engine.media_player"), \
            pytest.MonkeyPatch.context() as m:
        m.setattr(throttle.MediaThrottle, "wait_until", lambda self, t: None)
        m.setattr(avshim, "available", lambda: False)  # the pure tier's codec process
        player.start()
        audio, frames = [], 0
        deadline = time.monotonic() + 60
        while (sum(map(len, audio)) < 4 * 1024 or frames < 6) and time.monotonic() < deadline:
            try:
                audio.append(feed.queue.get(timeout=0.05))
            except Exception:
                pass
            while not feed.video_q.empty():
                feed.video_q.get_nowait()
                frames += 1
        (child,) = player._children
        player.stop()
        player.join(timeout=10)
    assert not player.is_alive() and child.proc.poll() == 0
    asc = AudioSpecificConfiguration.parse(at.asc)
    dec = AacLcDecoder(asc)
    want = np.concatenate([dec.decode_raw(g, asc.sampling_frequency_index) for g in good[:4]])
    got = np.concatenate(audio)[:4 * 1024]
    assert np.array_equal(got, want) and frames >= 6
    assert caplog.text.count("aac granule skipped") == 1
