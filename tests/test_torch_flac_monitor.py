"""The Monitor's lossless audio (``MIXLAB_PURE_AUDIO=flac``) against the JAX
package: the port's ``PureFlacStream`` (``av/flacenc.py``), its FLAC-mode
``MonitorPipeline`` (``server/monitor.py``) and the ``.mp4`` export through
it (``render_cli._render_mp4``).

Both packages run on the pure tier with the JAX native library patched off
(its CAVLC encoder on the numpy tier), as ``tests/test_torch_monitor.py``
does.  The audio is held byte for byte; the port's FLAC frames are then
decoded by the port's own ``av/flacdec.py`` and must give exactly the int16
PCM that was fed."""

import json

import numpy as np
import pytest

from mixlab_tpu.av import flacenc as jflacenc
from mixlab_tpu.av import h264cavlc_fast as jfast
from mixlab_tpu.engine.engine import _MonitorPipe as JaxMonitorPipe
from mixlab_tpu.server import monitor as jmonitor
from mixlab_tpu_torch.av import codecs, flacenc
from mixlab_tpu_torch.av.encode_stream import f32_to_i16
from mixlab_tpu_torch.av.flacdec import FlacDecoder
from mixlab_tpu_torch.av.mp4read import Mp4Reader
from mixlab_tpu_torch.engine.engine import _MonitorPipe
from mixlab_tpu_torch.server import monitor
from test_torch_monitor import CFG, CFG_J, SPT, items, run_pipeline, track_of

MONITOR_SIZE = (codecs.MONITOR_PICTURE.width, codecs.MONITOR_PICTURE.height)


@pytest.fixture(autouse=True)
def _pure_flac(monkeypatch):
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    monkeypatch.setenv("MIXLAB_PURE_AUDIO", "flac")
    monkeypatch.setattr(jfast, "make_cavlc_encoder", jfast.FastCavlcIntraEncoder)
    monkeypatch.setattr("mixlab_tpu.native._load", lambda: None)


def feeds(seed: int, channels: int, total: int):
    """Seeded int16 PCM cut into pieces of uneven length (a tick's 735,
    pieces shorter and longer than a block, one of a single sample)."""
    rng = np.random.default_rng(seed)
    t = np.arange(total) / 44_100.0
    tone = 9000 * np.sin(2 * np.pi * 330.0 * t)[:, None] * np.array([1.0, -0.5][:channels])
    pcm = np.clip(tone + rng.normal(0, 700, (total, channels)), -32768, 32767).astype(np.int16)
    cuts, at = [], 0
    for n in [735, 1, 3000, 1023, 5000, 17, 4096, 735] * 8:
        if at >= total:
            break
        cuts.append(pcm[at:at + n])
        at += n
    return pcm[:at], cuts


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("block_size", [1024, 4096])
def test_pure_flac_stream_matches_the_jax_stream(block_size, channels):
    """Both streams fed the same uneven pieces: streaminfo and its block,
    every frame of every poll byte-equal, the same remainder kept; the
    port's frames decode exactly to what was fed."""
    pcm, pieces = feeds(block_size + channels, channels, 60_000)
    port = flacenc.PureFlacStream(44_100, channels, block_size)
    ref = jflacenc.PureFlacStream(44_100, channels, block_size)
    assert port.codec == ref.codec == "flac"
    assert port.configuration_data() == ref.configuration_data()
    assert port.streaminfo_block() == ref.streaminfo_block()
    frames = []
    for piece in pieces:
        port.feed(piece.reshape(-1))  # interleaved, as the codec thread feeds
        ref.feed(piece.reshape(-1))
        got, want = port.poll_frames(), ref.poll_frames()
        assert got == want
        frames += got
    assert np.array_equal(port._buf, ref._buf)
    assert len(frames) == len(pcm) // block_size and len(port._buf) == len(pcm) % block_size
    dec = FlacDecoder(port.configuration_data())
    decoded = np.concatenate([dec.decode_frame(f)[0] for f in frames])
    assert np.array_equal(decoded, pcm[:len(decoded)])
    port.close()


def flac_of(init: bytes, segments, audio_track: int):
    """(streaminfo, [(first sample, frame bytes)]) of a stream's audio
    segments, by the port's MP4 reader."""
    reader = Mp4Reader(init + b"".join(segments))
    track = reader.audio_track()
    assert track.codec == "flac" and track.track_id == audio_track
    return track.streaminfo, [(s.dts, reader.sample_data(s)) for s in track.samples]


def decode_exactly(streaminfo: bytes, frames, fed: np.ndarray) -> int:
    """Every frame decodes by ``av/flacdec.py`` to the fed int16 PCM at its
    place; -> the samples checked."""
    dec = FlacDecoder(streaminfo)
    n = 0
    for first, data in frames:
        got, used = dec.decode_frame(data)
        assert used == len(data)
        assert np.array_equal(got, fed[first:first + len(got)]), first
        n += len(got)
    return n


@pytest.mark.parametrize("size", ["monitor", "1080p"])
def test_flac_pipelines_match_the_jax_pipeline(size):
    """30 ticks through both packages' FLAC-mode pipelines.  At the
    Monitor's own picture size every packet is byte-identical; with 1080p
    input (each package scales the picture) the fed pictures are within
    1 LSB and the init packet and every audio segment are byte-identical.
    The init packet names ``flac`` and holds ``fLaC`` and ``dfLa``, and the
    port's FLAC decodes exactly to the PCM fed."""
    dims = MONITOR_SIZE if size == "monitor" else (1920, 1080)
    ticks = items(30, dims, lambda i: i % 12 != 11)
    fed_j, fed_t = [], []
    jp_, j = run_pipeline(jmonitor, JaxMonitorPipe(), CFG_J, ticks, True, fed_j)
    tp_, t = run_pipeline(monitor, _MonitorPipe(), CFG, ticks, False, fed_t)
    assert isinstance(tp_._aac, flacenc.PureFlacStream)
    assert isinstance(jp_._aac, jflacenc.PureFlacStream)
    header, _, init = t[0].partition(b"\n")
    assert json.loads(header)["mime"].endswith(', flac"')
    assert b"fLaC" in init and b"dfLa" in init
    assert tp_.broadcast.init_packet == jp_.broadcast.init_packet == t[0]
    n_audio = 30 * SPT // 1024
    assert len(t) == len(j) == 1 + n_audio + 5
    if size == "monitor":
        assert t == j
    else:
        assert len(fed_t) == len(fed_j) == 5
        for got, want in zip(fed_t, fed_j):
            for k in ("y", "u", "v"):
                assert int(np.abs(got[k].astype(int) - want[k].astype(int)).max()) <= 1, k
    video = track_of(t[-1])
    audio_t = [pkt for pkt in t[1:] if track_of(pkt) != video]
    audio_j = [pkt for pkt in j[1:] if track_of(pkt) != video]
    assert len(audio_t) == n_audio and audio_t == audio_j
    fed = f32_to_i16(np.concatenate([a for _, a, _ in ticks]).reshape(-1)).reshape(-1, 2)
    streaminfo, frames = flac_of(init, [pkt.partition(b"\n")[2] for pkt in t[1:]],
                                 3 - video)
    assert streaminfo == tp_._aac.configuration_data()
    assert decode_exactly(streaminfo, frames, fed) == n_audio * 1024


def _camera_project(path, cam, project_base):
    """A StreamInput on ``cam``: its picture on the Monitor's video input,
    its audio on the Monitor's audio input."""
    from mixlab_tpu_torch import protocol as tp
    from mixlab_tpu_torch.engine.graph import Workspace

    ws = Workspace()
    mon = ws.create_module(tp.ModuleParams("Monitor", None))
    src = ws.create_module(tp.ModuleParams("StreamInput", tp.StreamInputParams(
        tp.StreamProtocol.RTMP, cam)))
    ws.connect(tp.InputId(mon, 0), tp.OutputId(src, 0))
    ws.connect(tp.InputId(mon, 1), tp.OutputId(src, 1))
    with project_base(path) as base:
        base.write_workspace(ws.to_persist())


def _camera_pcm(tick: int) -> np.ndarray:
    rng = np.random.default_rng(7000 + tick)
    t = (tick * SPT + np.arange(SPT)) / 44_100.0
    tone = 12000 * np.sin(2 * np.pi * 440.0 * t)
    return np.clip(np.stack([tone, -0.5 * tone], 1) + rng.normal(0, 500, (SPT, 2)),
                   -32768, 32767).astype(np.int16)


def test_flac_mp4_export_matches_the_jax_export(tmp_path, monkeypatch):
    """A camera's pictures and int16 audio into the Monitor, exported to
    ``.mp4`` under ``MIXLAB_PURE_AUDIO=flac`` by both packages'
    ``_render_mp4`` for 24 ticks (the JAX CLI one tick a block, the port's
    12-tick blocks): the files are byte-identical, their audio track is
    FLAC, and its frames decode exactly to the published PCM as the
    Monitor's i16 -> f32 -> i16 round trip gives it."""
    from mixlab_tpu import render_cli as jrender_cli
    from mixlab_tpu.engine.engine import Engine as JaxEngine
    from mixlab_tpu.io_host import source as jsource
    from mixlab_tpu.utils.mtime import MediaDuration as JaxMediaDuration
    from mixlab_tpu.utils.mtime import MediaTime as JaxMediaTime
    from mixlab_tpu.video import frame as jframe
    from mixlab_tpu_torch import render_cli
    from mixlab_tpu_torch.engine.engine import Engine
    from mixlab_tpu_torch.engine.project import ProjectBase
    from mixlab_tpu_torch.io_host import source as tsource
    from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
    from mixlab_tpu_torch.video import frame
    from test_torch_monitor import tick_planes, video_frame

    cam = "flac-mp4-cam"
    proj = tmp_path / "cam.mixlab"
    _camera_project(proj, cam, ProjectBase)
    senders = []

    def publishing(engine_cls, registry, jax_side, n_ticks):
        tick_once = engine_cls.tick_once

        def tick(self, *args):
            if not senders or senders[0][0] is not registry:
                senders[:] = [(registry, registry.connect(cam))]
            send = senders[0][1]
            for j in range(n_ticks(self)):
                t = self.tick + j
                planes = tick_planes(t, *MONITOR_SIZE)
                if jax_side:
                    vf = jframe.VideoFrame(video_frame(planes, True).picture,
                                           duration_hint=JaxMediaDuration.new(1, 60))
                    at = JaxMediaTime.new(t * SPT, CFG.sample_rate)
                else:
                    vf = frame.VideoFrame(video_frame(planes, False).picture,
                                          duration_hint=MediaDuration.new(1, 60))
                    at = MediaTime.new(t * SPT, CFG.sample_rate)
                assert send.write_audio(at, _camera_pcm(t))
                assert send.write_video(at, vf)
            return tick_once(self, *args)

        monkeypatch.setattr(engine_cls, "tick_once", tick)

    publishing(JaxEngine, jsource.RTMP_MOUNTPOINTS, True, lambda eng: 1)
    publishing(Engine, tsource.RTMP_MOUNTPOINTS, False, lambda eng: eng.block.n_ticks)
    try:
        jrender_cli._render_mp4(str(proj), CFG_J, 24, str(tmp_path / "jax.mp4"))
        senders[0][1].close()
        render_cli.main([str(proj), str(tmp_path / "port.mp4"), "--seconds", "0.4",
                         "--block-ticks", "12", "--device", "cpu"])
    finally:
        for _, send in senders:
            send.close()
    want, got = (tmp_path / "jax.mp4").read_bytes(), (tmp_path / "port.mp4").read_bytes()
    reader = Mp4Reader(got)
    track = reader.audio_track()
    assert track.codec == "flac" and len(track.samples) == 24 * SPT // 1024
    scale = np.float32(1.0 / 32768)
    fed = f32_to_i16(np.concatenate([_camera_pcm(t) for t in range(24)]).astype(np.float32)
                     * scale)
    frames = [(s.dts, reader.sample_data(s)) for s in track.samples]
    assert decode_exactly(track.streaminfo, frames, fed) == 24 * SPT // 1024 * 1024
    assert len(reader.video_track().samples) == 4
    assert got == want
