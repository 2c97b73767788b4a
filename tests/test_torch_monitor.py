"""The Monitor's codec thread (``server/monitor.py``) against the JAX
package's, and its place in the port's engine.

The same pipe items (seeded audio ticks, with and without pictures) go into
the JAX ``MonitorPipeline`` and the port's, both on the pure tier (the JAX
package's CAVLC encoder on its numpy tier, the port's on its native one:
the two are byte-identical, ``tests/test_torch_codecs.py``).  At
``MONITOR_PICTURE`` size the packets are byte-identical.  With 1920x1080
input each package scales the picture (the JAX package through XLA, the port
through ``video/scale.py``): the scaled pictures are within 1 LSB
(``tests/test_video.py:197,215``), with the same segment count and
byte-identical audio segments.
"""

import queue
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu.av import h264cavlc_fast as jfast
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.engine import _MonitorPipe as JaxMonitorPipe
from mixlab_tpu.server import monitor as jmonitor
from mixlab_tpu.video import frame as jframe
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.av import codecs
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import Engine, _MonitorPipe
from mixlab_tpu_torch.server import monitor
from mixlab_tpu_torch.video import frame

CFG, CFG_J = EngineConfig(sample_rate=44_100), JaxEngineConfig(sample_rate=44_100)
SPT = CFG.samples_per_tick


@pytest.fixture(autouse=True)
def _pure_tier(monkeypatch):
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    monkeypatch.setattr(jfast, "make_cavlc_encoder", jfast.FastCavlcIntraEncoder)


def tick_audio(seed: int, n: int = SPT) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = (seed * n + np.arange(n)) / 44_100.0
    tone = 0.5 * np.sin(2 * np.pi * 330.0 * t)
    return np.stack([tone + 0.1 * rng.standard_normal(n),
                     -tone + 0.1 * rng.standard_normal(n)], axis=1).astype(np.float32)


def tick_planes(seed: int, w: int, h: int) -> dict:
    rng = np.random.default_rng(1000 + seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return {"y": ((xx + 3 * yy + 17 * seed) % 256).astype(np.uint8),
            "u": rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            "v": ((yy[::2, ::2] * 2 + seed) % 256).astype(np.uint8)}


def items(n_ticks, size, with_picture):
    """(t0, audio, planes or None) per tick."""
    return [(i * SPT, tick_audio(i), tick_planes(i, *size) if with_picture(i) else None)
            for i in range(n_ticks)]


def video_frame(planes, jax_side):
    """A VideoFrame of numpy ``planes`` for either package (None stays)."""
    if planes is None:
        return None
    w, h = planes["y"].shape[1], planes["y"].shape[0]
    if jax_side:
        return jframe.VideoFrame(jframe.Picture(
            jframe.PictureSettings(w, h), {k: jnp.asarray(v) for k, v in planes.items()}))
    return frame.VideoFrame(frame.Picture(
        frame.PictureSettings(w, h), {k: torch.from_numpy(v.copy()) for k, v in planes.items()}))


def run_pipeline(mod, pipe, cfg, ticks, jax_side, fed=None):
    """Push ``ticks`` through a started pipeline one item at a time and
    return its packets; ``fed`` collects the pictures its H.264 encoder
    was given."""
    pipeline = mod.MonitorPipeline(pipe, cfg)
    sub = pipeline.broadcast.subscribe()
    if fed is not None:
        pipeline._ensure_codecs()
        feed = pipeline._h264.feed
        pipeline._h264.feed = lambda pic: (fed.append(pic.to_numpy() if not jax_side else
                                                      {k: np.asarray(v) for k, v in
                                                       pic.planes.items()}), feed(pic))
    pipeline.start()
    try:
        for t0, audio, planes in ticks:
            # a block's item carries a tuple of its ticks' pictures
            video = (tuple(video_frame(pl, jax_side) for pl in planes)
                     if isinstance(planes, tuple) else video_frame(planes, jax_side))
            assert pipe.push((t0, audio, video))
            deadline = time.monotonic() + 60
            while not pipe.q.empty():
                assert pipeline.is_alive() and time.monotonic() < deadline
                time.sleep(0.002)
        time.sleep(0.3)  # the last item's encode
    finally:
        pipeline.stop()
        pipeline.join(10)
    assert not pipeline.is_alive()
    packets = []
    while True:
        try:
            packets.append(sub.get_nowait())
        except queue.Empty:
            return pipeline, packets


def track_of(packet: bytes) -> int:
    seg = packet.partition(b"\n")[2]
    i = seg.index(b"tfhd")
    return int.from_bytes(seg[i + 8:i + 12], "big")


def test_packets_are_identical_at_monitor_size():
    """18 ticks (3 video ticks), pictures on some ticks only: init packet
    and every segment byte-identical; the video ticks without a picture
    encode the blank frame."""
    size = (codecs.MONITOR_PICTURE.width, codecs.MONITOR_PICTURE.height)
    ticks = items(18, size, lambda i: i % 12 != 11)
    jp_, j = run_pipeline(jmonitor, JaxMonitorPipe(), CFG_J, ticks, True)
    tp_, t = run_pipeline(monitor, _MonitorPipe(), CFG, ticks, False)
    assert type(tp_._h264._cavlc).__name__ == "NativeCavlcIntraEncoder"
    assert t[0].startswith(b'{"t":"init","mode":"fmp4"')
    assert tp_.broadcast.init_packet == jp_.broadcast.init_packet == t[0]
    n_audio = 18 * SPT // 1024
    assert len(t) == 1 + n_audio + 3
    assert t == j


def test_scaled_1080p_pictures_within_one_lsb():
    """12 ticks of 1920x1080 input: the scaled pictures the encoders get are
    within 1 LSB, the segment counts agree and the audio segments are
    byte-identical."""
    ticks = items(12, (1920, 1080), lambda i: True)
    fed_j, fed_t = [], []
    _, j = run_pipeline(jmonitor, JaxMonitorPipe(), CFG_J, ticks, True, fed_j)
    _, t = run_pipeline(monitor, _MonitorPipe(), CFG, ticks, False, fed_t)
    assert len(fed_t) == len(fed_j) == 2
    for got, want in zip(fed_t, fed_j):
        for k in ("y", "u", "v"):
            assert got[k].shape == want[k].shape
            assert int(np.abs(got[k].astype(int) - want[k].astype(int)).max()) <= 1, k
    assert len(t) == len(j)
    video = track_of(t[-1])
    audio_t = [pkt for pkt in t[1:] if track_of(pkt) != video]
    audio_j = [pkt for pkt in j[1:] if track_of(pkt) != video]
    assert len(audio_t) == 12 * SPT // 1024 and audio_t == audio_j


def test_a_block_item_counts_its_ticks():
    """One item of 12 ticks (an engine with ``block_ticks=12``), carrying a
    picture per tick, gives the packets of the JAX pipeline's 12 one-tick
    items byte for byte: the same audio and the pictures of ticks 6 and 12
    (the tick with no picture encodes the blank frame)."""
    size = (codecs.MONITOR_PICTURE.width, codecs.MONITOR_PICTURE.height)
    ticks = items(24, size, lambda i: i != 11)
    _, one_by_one = run_pipeline(jmonitor, JaxMonitorPipe(), CFG_J, ticks, True)
    blocks = [(ticks[b][0], np.concatenate([a for _, a, _ in ticks[b:b + 12]]),
               tuple(pl for _, _, pl in ticks[b:b + 12])) for b in (0, 12)]
    _, blocked = run_pipeline(monitor, _MonitorPipe(), CFG, blocks, False)
    assert len(blocked) == 1 + 24 * SPT // 1024 + 4
    assert blocked == one_by_one


def _moving_cameras_project(path, cams, project_base):
    """Two StreamInputs on ``cams`` into a VideoMixer (fader 0.6) whose
    composite feeds the Monitor's video input; the Monitor hears nothing."""
    from mixlab_tpu_torch.engine.graph import Workspace

    ws = Workspace()
    mon = ws.create_module(tp.ModuleParams("Monitor", None))
    cam_ids = [ws.create_module(tp.ModuleParams("StreamInput", tp.StreamInputParams(
        tp.StreamProtocol.RTMP, cam))) for cam in cams]
    vm = ws.create_module(tp.ModuleParams("VideoMixer", tp.VideoMixerParams(
        a=0, b=1, fader=0.6)))
    for i, cam in enumerate(cam_ids):
        ws.connect(tp.InputId(vm, i), tp.OutputId(cam, 0))
    ws.connect(tp.InputId(mon, 0), tp.OutputId(vm, 0))
    with project_base(path) as base:
        base.write_workspace(ws.to_persist())


def _camera_planes(tick: int, cam: int) -> dict:
    """Camera ``cam``'s picture at ``tick``: it moves from tick to tick."""
    size = (codecs.MONITOR_PICTURE.width, codecs.MONITOR_PICTURE.height)
    return tick_planes(tick + 500 * cam, *size)


def test_mp4_export_video_matches_the_jax_export(tmp_path, monkeypatch):
    """A project with two moving cameras, exported to ``.mp4`` by both
    packages' ``_render_mp4`` for 24 ticks: the JAX CLI's engine runs one
    tick a block, the port's 12-tick blocks.  Each tick gets its own camera
    pictures (published before the tick that reads them), so the port's
    engine must read its feeds and run the VideoMixer once per tick of a
    block: the files are byte-identical, with four distinct video samples
    (a composite every 6 ticks) and silent audio."""
    from mixlab_tpu import render_cli as jrender_cli
    from mixlab_tpu.av.mp4read import Mp4Reader
    from mixlab_tpu.engine.engine import Engine as JaxEngine
    from mixlab_tpu.io_host import source as jsource
    from mixlab_tpu.utils.mtime import MediaDuration as JaxMediaDuration
    from mixlab_tpu.utils.mtime import MediaTime as JaxMediaTime
    from mixlab_tpu_torch import render_cli
    from mixlab_tpu_torch.engine.project import ProjectBase
    from mixlab_tpu_torch.io_host import source as tsource
    from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime

    cams = ("mp4-cam1", "mp4-cam2")
    proj = tmp_path / "cams.mixlab"
    _moving_cameras_project(proj, cams, ProjectBase)
    senders = []

    def publishing(engine_cls, registry, jax_side, n_ticks):
        """``engine_cls.tick_once`` that first publishes each camera's
        picture for every tick of the block."""
        tick_once = engine_cls.tick_once

        def tick(self, *args):
            if not senders or senders[0][0] is not registry:
                senders[:] = [(registry, registry.connect(cam)) for cam in cams]
            for j in range(n_ticks(self)):
                t = self.tick + j
                for c, (_, send) in enumerate(senders):
                    if jax_side:
                        vf = jframe.VideoFrame(video_frame(_camera_planes(t, c), True).picture,
                                               duration_hint=JaxMediaDuration.new(1, 60))
                        at = JaxMediaTime.new(t * SPT, CFG.sample_rate)
                    else:
                        vf = frame.VideoFrame(video_frame(_camera_planes(t, c), False).picture,
                                              duration_hint=MediaDuration.new(1, 60))
                        at = MediaTime.new(t * SPT, CFG.sample_rate)
                    assert send.write_video(at, vf)
            return tick_once(self, *args)

        monkeypatch.setattr(engine_cls, "tick_once", tick)

    monkeypatch.setattr("mixlab_tpu.native._load", lambda: None)
    publishing(JaxEngine, jsource.RTMP_MOUNTPOINTS, True, lambda eng: 1)
    publishing(Engine, tsource.RTMP_MOUNTPOINTS, False, lambda eng: eng.block.n_ticks)
    try:
        jrender_cli._render_mp4(str(proj), CFG_J, 24, str(tmp_path / "jax.mp4"))
        for _, send in senders:
            send.close()
        render_cli.main([str(proj), str(tmp_path / "port.mp4"), "--seconds", "0.4",
                         "--block-ticks", "12", "--device", "cpu"])
    finally:
        for _, send in senders:
            send.close()
    want, got = (tmp_path / "jax.mp4").read_bytes(), (tmp_path / "port.mp4").read_bytes()
    reader = Mp4Reader(got)
    video = [reader.sample_data(s) for s in reader.video_track().samples]
    assert len(video) == 4 and len(set(video)) == 4
    assert got == want


def test_engine_starts_and_stops_the_codec_threads():
    """A Monitor created by a client op gets its codec thread and socket,
    and its indication carries the socket id; deleting the module or
    stopping the engine stops the thread and unregisters the socket."""
    eng = Engine(cfg=CFG, device="cpu")
    sid, _, events = eng.connect_session()
    geo = tp.WindowGeometry()
    for seq in (1, 2):
        eng.update(sid, tp.WorkspaceMessage(seq, tp.CreateModule(
            tp.ModuleParams("Monitor", None), geo)))
    pipelines = dict(eng._monitor_pipelines)
    assert set(pipelines) == {tp.ModuleId(1), tp.ModuleId(2)}
    for mid, pipeline in pipelines.items():
        ind = eng.ws.indications[mid]
        assert ind.kind == "Monitor" and ind.value.socket_id == pipeline.socket_id
        assert monitor.get_socket(pipeline.socket_id) is pipeline.broadcast
        assert pipeline.is_alive() and pipeline.pipe is eng.monitor_pipe(mid)
    eng.tick_once()
    eng.update(sid, tp.WorkspaceMessage(3, tp.DeleteModule(tp.ModuleId(1))))
    gone = pipelines[tp.ModuleId(1)]
    gone.join(5)
    assert not gone.is_alive() and monitor.get_socket(gone.socket_id) is None
    assert set(eng._monitor_pipelines) == {tp.ModuleId(2)}
    eng.stop()
    last = pipelines[tp.ModuleId(2)]
    last.join(5)
    assert not last.is_alive() and monitor.get_socket(last.socket_id) is None
