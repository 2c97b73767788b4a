"""The port's StreamOutput controller (``mixlab_tpu_torch/server/stream_output.py``)
against the JAX package's, on the CPU.

``tests/test_stream_output_media.py``'s StreamOutput cases through the port:
the URL parse and the impulse params step by step against the JAX
controller; a failed connect; the pure tier's broadcast (AAC-LC at 160 kb/s
from its codec process, intra H.264 at 1120x700 on the native CAVLC tier)
over loopback RTMP into the port's and the JAX package's ingest, where the
440 Hz tone and the bright and dark halves of the picture survive; and the
video cadence, read from the published tags' timestamps (steps of 33 and
34 ms at 30 fps of a 60 Hz engine) instead of the JAX case's frames per
wall-clock second.  The pictures fed are the engine's kind: CPU tensors.
"""

import asyncio
import queue
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

import mixlab_tpu.native as jax_native
from mixlab_tpu import protocol as jp
from mixlab_tpu.engine.engine import _MonitorPipe as JaxPipe
from mixlab_tpu.io_host import source as jsource
from mixlab_tpu.io_host.rtmp import server as jserver
from mixlab_tpu.server import stream_output as jso
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.av.codecs import PureAacStream
from mixlab_tpu_torch.av.h264cavlc_fast import NativeCavlcIntraEncoder
from mixlab_tpu_torch.av.h264enc import PureH264Stream
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import _MonitorPipe
from mixlab_tpu_torch.io_host import source as source_mod
from mixlab_tpu_torch.io_host.rtmp import server as rtmp_server
from mixlab_tpu_torch.native import avshim
from mixlab_tpu_torch.server.stream_output import (
    ConnState,
    StreamOutputController,
    parse_rtmp_url,
)
from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame
from tests.loophelp import run_loop_thread, stop_loop_thread

CFG = EngineConfig(sample_rate=44_100)
SPT = CFG.samples_per_tick


@pytest.fixture(autouse=True)
def _jax_python_tier(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)


@pytest.fixture(scope="module", autouse=True)
def _port_native_built():
    """The port's host C++ built before any timed wait: in a fresh checkout
    the first load builds it (tens of seconds, once, under a file lock)."""
    from mixlab_tpu_torch import native

    assert native.available()


@pytest.mark.parametrize("url", ["rtmp://example.com/live", "rtmp://10.0.0.1:19350/app",
                                 "rtmp://h", "http://x/y"])
def test_parse_rtmp_url(url):
    try:
        want = jso.parse_rtmp_url(url)
    except ValueError:
        with pytest.raises(ValueError):
            parse_rtmp_url(url)
        return
    assert parse_rtmp_url(url) == want
    assert parse_rtmp_url("rtmp://10.0.0.1:19350/app") == ("10.0.0.1", 19350, "app")


def test_impulse_param_semantics():
    """The same updates through both packages' controllers: the same
    answers, states and indications, step by step."""
    ctls = {"torch": StreamOutputController(_MonitorPipe(), CFG),
            "jax": jso.StreamOutputController(JaxPipe(), CFG)}
    steps = [
        (dict(seq=1, connect_seq=0, disconnect_seq=0), None),  # stale
        (dict(seq=2, rtmp_url="rtmp://h/app"), None),  # stored, no connect
        (dict(seq=3, rtmp_url="rtmp://other/app"), "live"),  # refused while live
        (dict(seq=4, disconnect_seq=4, rtmp_url="rtmp://h/app"), None),  # disconnect
        (dict(seq=4, rtmp_url="rtmp://x/app"), None),  # stale again
    ]
    for kw, force in steps:
        got = {}
        for name, ctl in ctls.items():
            mod = p if name == "torch" else jp
            if force:
                ctl.state = type(ctl.state)(force)
            got[name] = (ctl.update(mod.StreamOutputParams(**kw)), ctl.state.value,
                         ctl.indication().live.value, ctl.indication().error,
                         ctl.params.rtmp_url)
        assert got["torch"] == got["jax"], kw
    assert ctls["torch"].state == ConnState.OFFLINE


def test_connect_failure_sets_error_indication():
    inds = []
    ctl = StreamOutputController(_MonitorPipe(), CFG, indicate=inds.append)
    ctl.update(p.StreamOutputParams(seq=2, connect_seq=2, rtmp_url="rtmp://127.0.0.1:1/nope",
                                    rtmp_stream_key="k"))
    ctl.join(10)
    assert ctl.state == ConnState.FAILED and ctl.error
    assert [i.value for i in inds] == [
        p.StreamOutputIndication(p.StreamOutputLiveStatus.CONNECTING, False),
        p.StreamOutputIndication(p.StreamOutputLiveStatus.OFFLINE, True)]


@pytest.fixture
def pure_tier(monkeypatch):
    """The port's libavcodec shim reported absent: the pure tier."""
    monkeypatch.setattr(avshim, "available", lambda: False)


class _Ingest:
    """An RTMP ingest server of ``package`` on its own loop thread, decoding
    on its pure tier (the port: on ``factory``), with a listener on
    ``mount``."""

    def __init__(self, package, mount, monkeypatch, factory=rtmp_server.PureTierDecoder):
        self.package = package
        if package == "torch":
            monkeypatch.setattr(rtmp_server, "DECODER_FACTORY", factory)
            self.recv = source_mod.RTMP_MOUNTPOINTS.listen(mount)
        else:
            monkeypatch.setattr(jserver, "DECODER_FACTORY", jserver.PureTierDecoder)
            self.recv = jsource.RTMP_MOUNTPOINTS.listen(mount)
        started, holder = threading.Event(), {}

        async def main():
            async def on_conn(r, w):
                try:
                    if package == "torch":
                        await rtmp_server.accept(r, w, "cpu")
                    else:
                        await jserver.accept(r, w)
                except (ConnectionError, asyncio.IncompleteReadError):
                    pass
                finally:
                    w.close()

            srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
            holder["port"] = srv.sockets[0].getsockname()[1]
            started.set()
            async with srv:
                await srv.serve_forever()

        self.loop, self.thread = run_loop_thread(main)
        assert started.wait(5)
        self.url = f"rtmp://127.0.0.1:{holder['port']}/{mount}"
        self.audio, self.video = [], []

    def drain(self):
        while (f := self.recv.read_audio()) is not None:
            self.audio.append(f)
        while (f := self.recv.read_video()) is not None:
            self.video.append(f)

    def close(self):
        stop_loop_thread(self.loop, self.thread)
        self.recv.close()


def _live(ingest, streams=(PureAacStream, PureH264Stream)) -> StreamOutputController:
    ctl = StreamOutputController(_MonitorPipe(), CFG)
    ctl.update(p.StreamOutputParams(seq=2, connect_seq=2, rtmp_url=ingest.url,
                                    rtmp_stream_key="key"))
    deadline = time.time() + 30
    while ctl.state != ConnState.LIVE and time.time() < deadline:
        time.sleep(0.02)
    assert ctl.state == ConnState.LIVE
    assert isinstance(ctl._aac, streams[0]) and isinstance(ctl._h264, streams[1])
    return ctl


def _split_picture(w=320, h=200):
    """The engine's kind of frame: bright left half, dark right half, as
    CPU tensors."""
    y = torch.zeros((h, w), dtype=torch.uint8)
    y[:, : w // 2] = 210
    return VideoFrame(picture=Picture(PictureSettings(w, h), {
        "y": y, "u": torch.full((h // 2, w // 2), 128, dtype=torch.uint8),
        "v": torch.full((h // 2, w // 2), 128, dtype=torch.uint8)}))


def _planes(frame):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in frame.data.picture.planes.items()}


@pytest.mark.parametrize("package", ["torch", "jax"], ids=["port-ingest", "jax-ingest"])
def test_stream_output_pure_tier_video_loopback(package, monkeypatch, pure_tier):
    """Engine ticks -> the port's controller -> RTMP -> an ingest of either
    package: the 440 Hz tone within 15 Hz, and the picture at 1120x700 with
    its bright and dark halves."""
    ingest = _Ingest(package, f"pureloop-{package}", monkeypatch)
    ctl = _live(ingest)
    if not isinstance(ctl._h264._cavlc, NativeCavlcIntraEncoder):
        pytest.fail("the port's native CAVLC tier did not build")
    _tone_and_picture(ctl, ingest)
    assert ctl._aac is None, "the AAC codec process outlived the connection"


def test_stream_output_shim_tier_video_loopback(monkeypatch):
    """Where the libavcodec shim is, the controller encodes with it (AAC CBR
    160 kb/s, x264 CBR 1.5 Mbps at 1120x700), and the port's ingest decodes
    with it: the 440 Hz tone and the picture's halves survive."""
    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    from mixlab_tpu_torch.av.codecs import ShimAacStream, ShimH264Stream

    ingest = _Ingest("torch", "shimloop", monkeypatch, factory=rtmp_server.ShimDecoder)
    ctl = _live(ingest, (ShimAacStream, ShimH264Stream))
    assert ctl._video_fps == 30
    _tone_and_picture(ctl, ingest)


def _tone_and_picture(ctl, ingest):
    """Feed the tone and the split picture to the live ``ctl`` until the
    ingest has 40 audio frames and a picture; check both."""
    frame = _split_picture()
    t_base = np.arange(SPT) / CFG.sample_rate
    k = 0
    try:
        deadline = time.time() + 40
        while time.time() < deadline and (len(ingest.audio) < 40 or not ingest.video):
            tone = np.sin(2 * np.pi * 440 * (t_base + k * SPT / CFG.sample_rate))
            ctl.pipe.q.put((k * SPT, np.stack([tone, tone], -1).astype(np.float32) * 0.5,
                            frame), timeout=5)
            k += 1
            time.sleep(0.005)
            ingest.drain()
    finally:
        ctl.disconnect()
        ctl.stop()
        ctl.join()
        ingest.close()
    assert len(ingest.audio) >= 40, "no audio over RTMP loopback"
    got = np.concatenate([f.data for f in ingest.audio])[:, 0].astype(np.float32) / 32767.0
    body = got[2048:]
    spec = np.abs(np.fft.rfft(body * np.hanning(len(body))))
    peak_hz = (np.argmax(spec[1:]) + 1) * CFG.sample_rate / len(body)
    assert abs(peak_hz - 440.0) < 15.0, peak_hz
    y = _planes(ingest.video[0])["y"].astype(float)
    hh, ww = y.shape
    assert (ww, hh) == (1120, 700)
    mid = y[hh // 2 - 50: hh // 2 + 50]
    assert mid[:, : ww // 4].mean() > 120 and mid[:, 3 * ww // 4:].mean() < 60


def test_stream_output_pure_tier_publishes_30fps(monkeypatch, pure_tier):
    """The broadcast's video cadence at the reference's 30 fps, read from the
    published tags' timestamps: of 60 Hz ticks fed two at a time, each
    pair's picture arrives with a timestamp 33 or 34 ms after the last one,
    and no frame is dropped (each pair is fed once the last frame is in)."""
    ingest = _Ingest("torch", "pure30", monkeypatch)
    ctl = _live(ingest)
    assert ctl._video_fps == 30
    h, w = 720, 1280
    xx = torch.arange(w).expand(h, w)
    frames = [VideoFrame(picture=Picture(PictureSettings(w, h), {
        "y": ((xx * 255 // (w - 1) + i * 5) % 256).to(torch.uint8),
        "u": torch.full((h // 2, w // 2), 100, dtype=torch.uint8),
        "v": torch.full((h // 2, w // 2), 160, dtype=torch.uint8)})) for i in range(4)]
    silence = np.zeros((SPT, 2), np.float32)
    n_frames = 24
    try:
        for k in range(2 * n_frames):
            ctl.pipe.q.put((k * SPT, silence, frames[k // 2 % 4]), timeout=5)
            if k % 2 == 1:  # a frame is due: wait for it at the ingest
                deadline = time.time() + 20
                while len(ingest.video) < (k + 1) // 2 and time.time() < deadline:
                    time.sleep(0.005)
                    ingest.drain()
    finally:
        ctl.disconnect()
        ctl.stop()
        ctl.join()
        ingest.close()
    assert len(ingest.video) == n_frames and ctl.stats["video_dropped"] == 0
    ms = [f.source_time.frac * 1000 for f in ingest.video]
    # tick 2 is the first picture: 735 samples, 16 ms (1 kHz, floored)
    assert ms[0] == 16 and all(isinstance(t, Fraction) and t.denominator == 1 for t in ms)
    steps = {int(b - a) for a, b in zip(ms, ms[1:])}
    assert steps <= {33, 34} and len(ms) - 1 == n_frames - 1
    assert ms[-1] == (2 * n_frames - 1) * SPT * 1000 // CFG.sample_rate


class _Recorder:
    """Stands in for the RTMP client: records the tags it is given."""

    def __init__(self):
        self.tags = []

    def publish_audio(self, ms, body):
        self.tags.append(("audio", ms, body))
        return True

    def publish_video(self, ms, body):
        self.tags.append(("video", ms, body))
        return True


def test_block_item_publishes_as_one_tick_items():
    """An engine of 4-tick blocks pushes one item of 2,940 samples and four
    pictures: published tick by tick, it gives the tags and the encode queue
    the items of four one-tick items (PCM-FLV audio: no codec process)."""
    frames = [_split_picture(16 * (i + 1), 16) for i in range(4)]
    pcm = np.random.default_rng(2).uniform(-0.5, 0.5, (4 * SPT, 2)).astype(np.float32)
    got = []
    for items in ([(4 * SPT, pcm, tuple(frames))],
                  [((4 + j) * SPT, pcm[j * SPT:(j + 1) * SPT], frames[j]) for j in range(4)]):
        ctl = StreamOutputController(_MonitorPipe(), CFG)
        ctl._client, ctl._aac, ctl._h264, ctl._venc_q = _Recorder(), None, object(), queue.Queue()
        for item in items:
            ctl._publish_item(*item)
        got.append((ctl._client.tags, [ctl._venc_q.get_nowait() for _ in range(2)]))
    (tags_a, venc_a), (tags_b, venc_b) = got
    assert [t[:2] for t in tags_a] == [("audio", 0), ("audio", 16), ("audio", 33), ("audio", 50)]
    assert tags_a == tags_b
    assert [(ms, v is frames[k]) for (ms, v), k in zip(venc_a, (1, 3))] == [(16, True), (50, True)]
    assert [(ms, v is frames[k]) for (ms, v), k in zip(venc_b, (1, 3))] == [(16, True), (50, True)]
