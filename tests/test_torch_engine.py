"""The port's realtime engine against the JAX package's on the CPU.

Both engines run in direct drive (``tick_once``) on the same client ops and
the same ingest (numpy frames and i16 audio made from seeds), each on its own
mountpoint registry.  Both engines' Monitor codec threads are replaced by a
stub that reads nothing, so the tests read each engine's monitor pipe
themselves (``tests/test_torch_monitor.py`` holds the codec threads to each
other).

Tolerances: the broadcast ops are compared as wire bytes (exact); monitor
audio within 2^-11, the documented deviation of the JAX package's jitted
FmSine from op-by-op evaluation (``tests/test_torch_flagship.py``);
composites within 1 LSB, since the letterbox scale sums f32 products in
another order (``tests/test_video.py:197``).
"""

import queue
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as jp
from mixlab_tpu.engine import graph as jgraph
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.engine import Engine as JaxEngine
from mixlab_tpu.engine.engine import SyncEvent as JaxSyncEvent
from mixlab_tpu.io_host import audio_out as jaudio_out
from mixlab_tpu.io_host import source as jsource
from mixlab_tpu.protocol import wire as jwire
from mixlab_tpu.utils.mtime import MediaDuration as JaxMediaDuration
from mixlab_tpu.utils.mtime import MediaTime as JaxMediaTime
from mixlab_tpu.video import frame as jframe
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.engine import graph as tgraph
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import (Busy, Engine, OpClock, Stopped, SyncEvent,
                                             UpdateEvent)
from mixlab_tpu_torch.flagship import realtime_video_ops
from mixlab_tpu_torch.io_host import audio_out as taudio_out
from mixlab_tpu_torch.io_host import source as tsource
from mixlab_tpu_torch.protocol import wire as twire
from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
from mixlab_tpu_torch.video import blend, frame, pattern

CFG = EngineConfig(sample_rate=44_100)
CFG_J = JaxEngineConfig(sample_rate=44_100)
SPT = CFG.samples_per_tick  # 735
AUDIO_ATOL = 2.0 ** -11
# cam1 is the composite's size; cam2 is letterboxed into it (72x54 at x=12)
CAM_SIZES = ((96, 54), (64, 48))


class _NoCodec:
    """Stands in for each engine's Monitor codec thread, which would
    consume the monitor pipe that the tests read."""

    socket_id = "no-codec"

    def __init__(self, pipe, cfg):
        pass

    def start(self):
        pass

    def stop(self):
        pass


@pytest.fixture(autouse=True)
def _no_monitor_codec(monkeypatch):
    monkeypatch.setattr("mixlab_tpu.server.monitor.MonitorPipeline", _NoCodec)
    monkeypatch.setattr("mixlab_tpu_torch.server.monitor.MonitorPipeline", _NoCodec)


def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def _inputs(tick):
    """Tick ``tick``'s ingest: numpy planes of a bars frame (cam1) and a
    gradient frame (cam2), and 735 samples of i16 stereo."""
    (w1, h1), (w2, h2) = CAM_SIZES
    bars = pattern.pattern_picture("bars", w1, h1, tick, device="cpu").to_numpy()
    grad = pattern.pattern_picture("gradient", w2, h2, tick, device="cpu").to_numpy()
    pcm = np.random.default_rng(tick).integers(-3000, 3000, (SPT, 2), dtype=np.int16)
    return [(CAM_SIZES[0], bars), (CAM_SIZES[1], grad)], pcm


class _Side:
    """One package's engine built by the realtime client ops, with the
    publishers of its cameras."""

    def __init__(self, jax: bool, cams, workspace=None):
        """``workspace``: one restored from a checkpoint (built by the same
        ops); its StreamInputs are pointed at ``cams``."""
        self.jax = jax
        self.p = p = jp if jax else tp
        self.eng = (JaxEngine(workspace=workspace, cfg=CFG_J) if jax
                    else Engine(workspace=workspace, cfg=CFG, device="cpu"))
        self.sid, _, self.events = self.eng.connect_session()
        ops, self.ids = realtime_video_ops(p, cams)
        if workspace is not None:
            ops = [p.UpdateModuleParams(mid, p.ModuleParams("StreamInput", p.StreamInputParams(
                p.StreamProtocol.RTMP, cam))) for mid, cam in zip(self.ids["cams"], cams)]
        for seq, op in enumerate(ops, 1):
            self.eng.update(self.sid, p.WorkspaceMessage(seq, op))
        reg = (jsource if jax else tsource).RTMP_MOUNTPOINTS
        self.sends = [reg.connect(c) for c in cams]

    def publish(self, tick):
        frames, pcm = _inputs(tick)
        for send, (size, planes) in zip(self.sends, frames):
            if self.jax:
                t = JaxMediaTime.new(tick * SPT, CFG.sample_rate)
                pic = jframe.Picture(jframe.PictureSettings(*size),
                                     {k: jnp.asarray(v) for k, v in planes.items()})
                vf = jframe.VideoFrame(pic, duration_hint=JaxMediaDuration.new(1, 60))
            else:  # numpy planes, as ingest hands them in
                t = MediaTime.new(tick * SPT, CFG.sample_rate)
                pic = frame.Picture(frame.PictureSettings(*size),
                                    {k: v.copy() for k, v in planes.items()})
                vf = frame.VideoFrame(pic, duration_hint=MediaDuration.new(1, 60))
            assert send.write_audio(t, pcm) and send.write_video(t, vf)

    def tick(self, tick):
        """Publish tick ``tick``'s frames, run it, and return the monitor
        pipe's item as numpy: (t0, audio [735, 2], composite planes or None)."""
        self.publish(tick)
        self.eng.tick_once()
        t0, audio, video = self.eng.monitor_pipe(self.ids["monitor"]).q.get(timeout=5)
        planes = None if video is None else {
            k: np.asarray(v) for k, v in video.picture.planes.items()}
        return t0, np.asarray(audio), planes

    def close(self):
        for send in self.sends:
            send.close()
        self.eng.stop()


def _assert_ticks_match(got, want, what):
    for i, ((t0, a, v), (t0_w, a_w, v_w)) in enumerate(zip(got, want)):
        assert t0 == t0_w, (what, i)
        assert a.shape == a_w.shape == (SPT, 2)
        err = float(np.abs(a - a_w).max())
        assert err <= AUDIO_ATOL, (what, i, err)
        assert v is not None and v_w is not None, (what, i)
        for k in ("y", "u", "v"):
            assert v[k].shape == v_w[k].shape, (what, i, k)
            lsb = int(np.abs(v[k].astype(int) - v_w[k].astype(int)).max())
            assert lsb <= 1, (what, i, k, lsb)


# -- the port of tests/test_video_graph.py -------------------------------------


def test_video_flows_ring_to_monitor():
    """ingest ring -> StreamInput -> VideoMixer -> Monitor on the port."""
    eng = Engine(cfg=CFG, device="cpu")
    sid, _, _ = eng.connect_session()
    geo = tp.WindowGeometry()
    eng.update(sid, tp.WorkspaceMessage(1, tp.CreateModule(tp.ModuleParams(
        "StreamInput", tp.StreamInputParams(tp.StreamProtocol.RTMP, "torch-vtest")), geo)))
    eng.update(sid, tp.WorkspaceMessage(2, tp.CreateModule(tp.ModuleParams(
        "VideoMixer", tp.VideoMixerParams(a=0, b=None, fader=1.0)), geo)))
    eng.update(sid, tp.WorkspaceMessage(3, tp.CreateModule(tp.ModuleParams("Monitor", None), geo)))
    si, vm, mon = tp.ModuleId(1), tp.ModuleId(2), tp.ModuleId(3)
    for seq, (i, o) in enumerate((((vm, 0), (si, 0)), ((mon, 0), (vm, 0)),
                                  ((mon, 1), (si, 1))), 4):
        eng.update(sid, tp.WorkspaceMessage(seq, tp.CreateConnection(
            tp.InputId(*i), tp.OutputId(*o))))

    send = tsource.RTMP_MOUNTPOINTS.connect("torch-vtest")
    vf = frame.VideoFrame(pattern.pattern_picture("bars", 64, 48, device="cpu"),
                          duration_hint=MediaDuration.new(2, CFG.ticks_per_second))
    send.write_audio(MediaTime.zero(), np.ones((SPT, 2), dtype=np.int16) * 1000)
    send.write_video(MediaTime.zero(), vf)
    try:
        eng.tick_once()
        pipe = eng.monitor_pipe(mon)
        t0, audio, video = pipe.q.get(timeout=2.0)
        assert video is not None, "no composited frame reached the monitor"
        assert (video.picture.settings.width, video.picture.settings.height) == (64, 48)
        # fader = 1.0 selects channel A entirely
        a_stored = eng._video_mixers[vm].channels[0].stored
        np.testing.assert_array_equal(video.picture.planes["y"].numpy(),
                                      a_stored.planes["y"].numpy())
        assert abs(float(audio[0, 0]) - 1000 / 32768.0) < 1e-6  # i16 -> f32
        eng.tick_once()  # the 2-tick frame is still active
        assert pipe.q.get(timeout=2.0)[2] is not None
        eng.tick_once()  # expired: no output
        assert pipe.q.get(timeout=2.0)[2] is None
    finally:
        send.close()
        eng.stop()


# -- client ops and their broadcast ---------------------------------------------


def _op_script(p):
    """Client ops: creates, connects (one replacing an earlier one, one
    rejected by type), param edits (one dropping a connection), a geometry
    edit, deletes with cascaded connection deletes, a delete of nothing, and
    an op that fails and rolls back."""
    geo = p.WindowGeometry()
    mod = lambda kind, params=None: p.CreateModule(p.ModuleParams(kind, params), geo)  # noqa: E731
    conn = lambda im, ii, om, oi: p.CreateConnection(  # noqa: E731
        p.InputId(p.ModuleId(im), ii), p.OutputId(p.ModuleId(om), oi))
    return [
        mod("Oscillator", p.OscillatorParams(330.0, p.Waveform.SINE)),       # 1
        mod("Amplifier", p.AmplifierParams(0.5, 0.3)),                       # 2
        mod("Mixer", p.MixerParams.with_channels(2)),                        # 3
        mod("Plotter"),                                                      # 4
        mod("StreamInput", p.StreamInputParams(p.StreamProtocol.RTMP, "ops-cam")),  # 5
        mod("VideoMixer", p.VideoMixerParams(a=0, b=None, fader=0.5)),       # 6
        mod("Oscillator", p.OscillatorParams(110.0, p.Waveform.SQUARE)),     # 7
        conn(2, 0, 1, 1), conn(3, 0, 2, 0), conn(3, 1, 5, 1), conn(4, 0, 3, 0),
        conn(6, 0, 5, 0),
        conn(2, 1, 1, 1),             # rejected: stereo into a mono input
        conn(2, 0, 7, 1),             # replaces osc 1 on the amplifier's input
        conn(9, 0, 1, 0),             # rejected: no such module
        p.UpdateModuleParams(p.ModuleId(1), p.ModuleParams(
            "Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW))),
        p.UpdateModuleParams(p.ModuleId(3), p.ModuleParams(
            "Mixer", p.MixerParams.with_channels(1))),  # drops input 1's connection
        p.UpdateWindowGeometry(p.ModuleId(4), p.WindowGeometry(p.Coords(10, 20), 3)),
        p.UpdateModuleParams(p.ModuleId(2), p.ModuleParams(
            "Mixer", p.MixerParams.with_channels(2))),  # kind mismatch: rolls back
        p.DeleteConnection(p.InputId(p.ModuleId(4), 0)),
        p.DeleteConnection(p.InputId(p.ModuleId(4), 0)),  # already gone
        p.DeleteModule(p.ModuleId(2)),  # cascades the amplifier's connections
        p.DeleteModule(p.ModuleId(42)),
        mod("Trigger", p.GateState.OPEN),
    ]


def test_client_ops_broadcast_byte_identical():
    """One op script through both engines: the broadcast UpdateEvents are
    byte-identical on the wire, the Sync clocks equal, and so are the
    workspaces and a late session's WorkspaceState."""
    sides = []
    try:
        for jax, p, eng in ((True, jp, JaxEngine(cfg=CFG_J)),
                            (False, tp, Engine(cfg=CFG, device="cpu"))):
            sid, state, events = eng.connect_session()
            assert state.modules == []
            for seq, op in enumerate(_op_script(p), 1):
                eng.update(sid, p.WorkspaceMessage(seq, op))
                if seq % 5 == 0:
                    eng.tick_once()
            sides.append((jax, eng, sid, _drain(events)))
        (_, ej, sid_j, ev_j), (_, et, sid_t, ev_t) = sides
        assert sid_j == sid_t
        assert [type(e).__name__ for e in ev_j] == [type(e).__name__ for e in ev_t]
        n_ops = len(_op_script(tp))
        assert sum(isinstance(e, SyncEvent) for e in ev_t) == n_ops
        n_updates = 0
        for a, b in zip(ev_j, ev_t):
            if isinstance(a, JaxSyncEvent):
                assert (a.clock.session_id, a.clock.sequence) == (b.clock.session_id,
                                                                  b.clock.sequence)
            else:
                assert twire.dumps(b.update) == jwire.dumps(a.update)
                n_updates += 1
        assert n_updates >= 15
        kinds = [type(e.update).__name__ for e in ev_t if isinstance(e, UpdateEvent)]
        assert kinds.count("SUDeleteConnection") >= 4 and "SUDeleteModule" in kinds
        assert et.ws.to_persist() == ej.ws.to_persist()
        assert twire.dumps(et.connect_session()[1]) == jwire.dumps(ej.connect_session()[1])
    finally:
        for _, eng, _, _ in sides:
            eng.stop()


def test_engine_left_out_parts_raise_or_stay_silent():
    """Nothing of the engine is left out now: a StreamOutput, which raised
    until its controller was ported, builds with its controller offline, in
    a workspace and by a client op; and a MediaSource whose opener finds no
    media is a silent feed, as in the JAX engine (the engine takes a
    ``media_opener`` since the MediaPlayer was ported)."""
    ws = tgraph.Workspace()
    mid = ws.create_module(tp.ModuleParams("StreamOutput", tp.StreamOutputParams()))
    eng = Engine(workspace=ws, cfg=CFG, device="cpu")
    assert eng.ws.indications[mid] == tp.Indication(
        "StreamOutput", tp.StreamOutputIndication(tp.StreamOutputLiveStatus.OFFLINE, False))
    assert eng._stream_outputs[mid].params == tp.StreamOutputParams()
    sid, _, events = eng.connect_session()
    eng.update(sid, tp.WorkspaceMessage(1, tp.DeleteModule(mid)))
    assert eng.ws.modules == {} and eng._stream_outputs == {}
    eng.stop()

    opened = []
    eng = Engine(cfg=CFG, device="cpu", media_opener=lambda media_id: opened.append(media_id))
    sid, _, events = eng.connect_session()
    geo = tp.WindowGeometry()
    # a client op adds a StreamOutput (module 1), which the MediaSource's
    # chain does not touch
    eng.update(sid, tp.WorkspaceMessage(1, tp.CreateModule(
        tp.ModuleParams("StreamOutput", tp.StreamOutputParams()), geo)))
    assert list(eng._stream_outputs) == [tp.ModuleId(1)]
    assert isinstance(_drain(events)[-1], SyncEvent)
    for seq, op in enumerate((
        tp.CreateModule(tp.ModuleParams("MediaSource", tp.MediaSourceParams(tp.MediaId(3))), geo),
        tp.CreateModule(tp.ModuleParams("Monitor", None), geo),
        tp.CreateConnection(tp.InputId(tp.ModuleId(3), 1), tp.OutputId(tp.ModuleId(2), 1)),
        tp.CreateConnection(tp.InputId(tp.ModuleId(3), 0), tp.OutputId(tp.ModuleId(2), 0)),
    ), 2):
        eng.update(sid, tp.WorkspaceMessage(seq, op))
    eng.tick_once()
    t0, audio, video = eng.monitor_pipe(tp.ModuleId(3)).q.get(timeout=2)
    assert t0 == 0 and video is None and not audio.any()
    assert opened == [tp.MediaId(3)] and eng._media_players == {}
    eng.stop()


def _stream_output_script(p, port):
    """A StreamOutput's life: made, a stale update (refused, the old params
    echoed), a connect to ``port``, whose listener drops the connection
    once the op is applied (Connecting, then Failed with the error flag),
    params changed while offline, deleted."""
    url = f"rtmp://127.0.0.1:{port}/nope"
    so = p.ModuleId(1)
    params = lambda seq, **kw: p.UpdateModuleParams(so, p.ModuleParams(  # noqa: E731
        "StreamOutput", p.StreamOutputParams(seq=seq, rtmp_url=url, rtmp_stream_key="k", **kw)))
    return [
        p.CreateModule(p.ModuleParams("StreamOutput", p.StreamOutputParams()),
                       p.WindowGeometry()),
        params(1),
        params(2, connect_seq=2),
        params(3, disconnect_seq=0),
        p.DeleteModule(so),
    ]


def test_stream_output_indications_match_jax():
    """A workspace with a StreamOutput builds in both engines, and its
    controller's indications (made on its IO thread) and the params echoes
    go out on the wire byte-equal to the JAX engine's."""
    sides = []
    # the connect's failure comes from the IO thread: the listener drops the
    # connection only after the op (and its Sync) went out, so the Failed
    # indication's place among the events is the same in both engines
    listener = socket.create_server(("127.0.0.1", 0))
    listener.settimeout(10)
    try:
        for p, eng in ((jp, JaxEngine(cfg=CFG_J)), (tp, Engine(cfg=CFG, device="cpu"))):
            sid, _, events = eng.connect_session()
            for seq, op in enumerate(_stream_output_script(p, listener.getsockname()[1]), 1):
                eng.update(sid, p.WorkspaceMessage(seq, op))
                if seq == 3:  # the connect: drop it, wait for the IO thread's failure
                    listener.accept()[0].close()
                    ctl = eng._stream_outputs[p.ModuleId(1)]
                    deadline = time.monotonic() + 10
                    while ctl.state.value != "failed" and time.monotonic() < deadline:
                        time.sleep(0.02)
                    assert ctl.state.value == "failed" and ctl.error
                    ctl._io_thread.join(10)
            sides.append((eng, _drain(events)))
        (ej, ev_j), (et, ev_t) = sides
        assert [type(e).__name__ for e in ev_j] == [type(e).__name__ for e in ev_t]
        wire_j = [jwire.dumps(e.update) for e in ev_j if not isinstance(e, JaxSyncEvent)]
        wire_t = [twire.dumps(e.update) for e in ev_t if not isinstance(e, SyncEvent)]
        assert wire_t == wire_j
        inds = [e.update.indication.value for e in ev_t if isinstance(e, UpdateEvent)
                and type(e.update).__name__ == "SUUpdateModuleIndication"]
        assert inds == [tp.StreamOutputIndication(tp.StreamOutputLiveStatus.CONNECTING, False),
                        tp.StreamOutputIndication(tp.StreamOutputLiveStatus.OFFLINE, True)]
        echoes = [e.update.params.params.seq for e in ev_t if isinstance(e, UpdateEvent)
                  and type(e.update).__name__ == "SUUpdateModuleParams"]
        assert echoes == [1, 2, 3]  # the stale seq 1 echoes the module's own params
    finally:
        listener.close()
        for eng, _ in sides:
            eng.stop()


# -- the flagship with live video, and checkpoints across engines ---------------


@pytest.fixture(scope="module")
def flagship_video():
    """Both engines on the flagship-plus-video workspace, 8 ticks each;
    yields (sides, per-tick outputs), the engines left at tick 8."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("mixlab_tpu.server.monitor.MonitorPipeline", _NoCodec)
        mp.setattr("mixlab_tpu_torch.server.monitor.MonitorPipeline", _NoCodec)
        sides = [_Side(True, ("fv-cam1", "fv-cam2")), _Side(False, ("fv-cam1", "fv-cam2"))]
        try:
            outs = [[side.tick(i) for i in range(8)] for side in sides]
            yield sides, outs
        finally:
            for side in sides:
                side.close()


def test_flagship_video_ticks_match_jax(flagship_video):
    (sj, st), (out_j, out_t) = flagship_video
    _assert_ticks_match(out_t, out_j, "8 ticks")
    assert max(float(np.abs(a).max()) for _, a, _ in out_t) > 0.1  # not silent
    # the composite is the 60% fade (153) of the two stored channels
    mixer = st.eng._video_mixers[st.ids["mixer"]]
    a_pic, b_pic = (ch.stored for ch in mixer.channels[:2])
    want = blend.crossfade_picture(a_pic.planes, b_pic.planes, 153)
    for k in ("y", "u", "v"):
        np.testing.assert_array_equal(out_t[-1][2][k], want[k].numpy())
    assert out_t[-1][2]["y"].shape == (54, 96)
    # the letterboxed camera keeps black borders (x < 12) in channel B
    assert not b_pic.planes["y"][:, :12].any()


def test_checkpoints_restore_across_engines(flagship_video):
    """Each engine's checkpoint restores into the other (leaves in
    ``jax.tree.flatten`` order); then 4 more ticks agree."""
    (sj, st), _ = flagship_video
    ck_j, ck_t = sj.eng.checkpoint(), st.eng.checkpoint()
    assert ck_j["tick"] == ck_t["tick"] == 8
    assert ck_t["workspace"] == ck_j["workspace"]
    assert len(ck_t["dsp_state"]) == len(ck_j["dsp_state"]) > 0
    for a, b in zip(ck_t["dsp_state"], ck_j["dsp_state"]):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=AUDIO_ATOL)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("mixlab_tpu.server.monitor.MonitorPipeline", _NoCodec)
        mp.setattr("mixlab_tpu_torch.server.monitor.MonitorPipeline", _NoCodec)
        bj = _Side(True, ("ck-cam1", "ck-cam2"),
                   workspace=jgraph.Workspace.from_persist(ck_t["workspace"]))
        bt = _Side(False, ("ck-cam1", "ck-cam2"),
                   workspace=tgraph.Workspace.from_persist(ck_j["workspace"]))
    try:
        assert bt.eng.restore_dsp_state(ck_j) and bj.eng.restore_dsp_state(ck_t)
        assert bt.eng.tick == bj.eng.tick == 8
        out = {name: [side.tick(i) for i in range(8, 12)]
               for name, side in (("aj", sj), ("at", st), ("bj", bj), ("bt", bt))}
        _assert_ticks_match(out["bt"], out["aj"], "port restored from the JAX checkpoint")
        _assert_ticks_match(out["bj"], out["at"], "JAX restored from the port's checkpoint")
    finally:
        bj.close()
        bt.close()
    bad = {**ck_j, "dsp_state": ck_j["dsp_state"][:-1]}
    assert not st.eng.restore_dsp_state(bad)


# -- the OutputDevice on the file backend ------------------------------------------


def test_output_device_clip_and_lag_match_jax(tmp_path):
    """Oscillator -> Amplifier(1.5) -> OutputDevice on the WAV-file backend
    with its ring drain stopped: the clip indication comes at tick 1 and the
    lag indication once the 65,536-sample ring is full, in both engines."""
    saved = (jaudio_out.get_backend(), taudio_out.get_backend())
    jaudio_out.set_backend(jaudio_out.FileAudioBackend(tmp_path / "jax"))
    taudio_out.set_backend(taudio_out.FileAudioBackend(tmp_path / "port"))
    engines = []
    try:
        for p, eng in ((jp, JaxEngine(cfg=CFG_J)), (tp, Engine(cfg=CFG, device="cpu"))):
            sid, _, _ = eng.connect_session()
            geo = p.WindowGeometry()
            for seq, op in enumerate((
                p.CreateModule(p.ModuleParams(
                    "Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)), geo),
                p.CreateModule(p.ModuleParams("Amplifier", p.AmplifierParams(1.5, 0.0)), geo),
                p.CreateModule(p.ModuleParams("OutputDevice", p.OutputDeviceParams(
                    device="wav-file", left=0, right=1)), geo),
                p.CreateConnection(p.InputId(p.ModuleId(2), 0), p.OutputId(p.ModuleId(1), 1)),
                p.CreateConnection(p.InputId(p.ModuleId(3), 0), p.OutputId(p.ModuleId(2), 0)),
            ), 1):
                eng.update(sid, p.WorkspaceMessage(seq, op))
            stream = eng._audio_streams[p.ModuleId(3)]
            stream._stop.set()  # no drain: the ring fills at 65,536 samples
            stream._consumer.join(timeout=5)
            assert not stream._consumer.is_alive()
            engines.append(eng)
        seen = {0: [], 1: []}
        for tick in range(95):
            for i, eng in enumerate(engines):
                for mid, ind in eng.tick_once().items():
                    enc = (jwire if i == 0 else twire).dumps(ind)
                    seen[i].append((tick, mid.value, enc))
        assert seen[1] == seen[0]
        assert [t for t, _, _ in seen[1]] == [0, 65_536 // SPT]  # clip, then lag
        ind = engines[1].ws.indications[tp.ModuleId(3)].value
        assert ind.clip == ind.lag == tp.TemporalWarningStatus.ACTIVE
        assert ind.default_device == "wav-file"
    finally:
        for eng in engines:
            eng.stop()
        jaudio_out.set_backend(saved[0])
        taudio_out.set_backend(saved[1])


# -- the engine thread ------------------------------------------------------------------


def test_threaded_engine_ticks_and_serves_sessions():
    """``start()``: the 60 Hz thread takes client ops through the bounded
    queue (retrying on Busy), ticks with live video for at most 1 s, and
    ``stop()`` ends it; every queue read has a timeout."""
    eng = Engine(cfg=CFG, device="cpu")
    eng.start()
    sends = []
    try:
        sid, state, events = eng.connect_session()
        ops, ids = realtime_video_ops(tp, ("th-cam1", "th-cam2"))
        for seq, op in enumerate(ops, 1):
            # as a browser session: send, then read the broadcast up to the
            # op's Sync (an unread queue past 64 events drops the session)
            for _ in range(200):
                try:
                    eng.update(sid, tp.WorkspaceMessage(seq, op))
                    break
                except Busy:
                    time.sleep(0.005)
            else:
                raise AssertionError("engine stayed busy")
            while True:
                ev = events.get(timeout=5)
                assert ev is not None, "session dropped"
                if isinstance(ev, SyncEvent):
                    assert ev.clock == OpClock(sid, seq)
                    break
        sends = [tsource.RTMP_MOUNTPOINTS.connect(c) for c in ("th-cam1", "th-cam2")]
        pipe = eng.monitor_pipe(ids["monitor"])
        start_tick, t_end = eng.tick, time.monotonic() + 0.6
        composites = 0
        while time.monotonic() < t_end:
            now_tick = eng.tick
            frames, pcm = _inputs(now_tick)
            for send, (size, planes) in zip(sends, frames):
                t = MediaTime.new(now_tick * SPT, CFG.sample_rate)
                send.write_audio(t, pcm)
                send.write_video(t, frame.VideoFrame(
                    frame.Picture(frame.PictureSettings(*size), planes),
                    duration_hint=MediaDuration.new(1, 60)))
            try:
                composites += pipe.q.get(timeout=0.5)[2] is not None
            except queue.Empty:
                pass
        ticks = eng.tick - start_tick
        assert ticks >= 10, ticks
        assert composites >= 1
        info = eng.performance_info()
        assert isinstance(info, tp.PerformanceInfo) and info.tick_rate == 60
        ck = eng.checkpoint_sync(timeout=5)
        assert ck["tick"] >= start_tick and len(ck["dsp_state"]) > 0
        assert eng.restore_sync(ck, timeout=5)
    finally:
        for send in sends:
            send.close()
        eng.stop()
    assert not eng._thread.is_alive()
    with pytest.raises(Stopped):
        eng.update(1, tp.WorkspaceMessage(99, tp.DeleteModule(tp.ModuleId(1))))


# -- the Workspace's edit half ----------------------------------------------------------


def _edit_script(p):
    """(method, args) steps over a Workspace; ``p`` is a protocol module."""
    mid, iid, oid = p.ModuleId, p.InputId, p.OutputId
    return [
        ("create_module", (p.ModuleParams("Oscillator", p.OscillatorParams(110.0, p.Waveform.SINE)),)),
        ("create_module", (p.ModuleParams("Mixer", p.MixerParams.with_channels(3)),
                           p.WindowGeometry(p.Coords(5, 6), 1))),
        ("create_module", (p.ModuleParams("Amplifier", p.AmplifierParams(0.5, 0.0)),)),
        ("create_module", (p.ModuleParams("Plotter", None),)),
        ("connect", (iid(mid(3), 0), oid(mid(1), 1))),
        ("connect", (iid(mid(2), 0), oid(mid(3), 0))),
        ("connect", (iid(mid(2), 2), oid(mid(1), 1))),
        ("connect", (iid(mid(4), 0), oid(mid(2), 0))),
        ("connect", (iid(mid(2), 0), oid(mid(1), 1))),   # replaces the amplifier
        ("connect", (iid(mid(3), 1), oid(mid(1), 1))),   # TypeMismatch
        ("connect", (iid(mid(9), 0), oid(mid(1), 1))),   # NoInput
        ("connect", (iid(mid(2), 1), oid(mid(9), 0))),   # NoOutput
        ("snapshot", ()),
        ("update_params", (mid(2), p.ModuleParams("Mixer", p.MixerParams.with_channels(2)))),
        ("update_params", (mid(2), p.ModuleParams("Plotter", None))),  # kind mismatch
        ("update_params", (mid(99), p.ModuleParams("Plotter", None))),
        ("disconnect", (iid(mid(4), 0),)),
        ("disconnect", (iid(mid(4), 0),)),
        ("delete_module", (mid(1),)),
        ("delete_module", (mid(1),)),
        ("restore", ()),                                 # back to the snapshot
        ("delete_module", (mid(2),)),
        ("create_module", (p.ModuleParams("Trigger", p.GateState.OPEN),)),
    ]


def _returned(x):
    """A step's return value in package-neutral form."""
    if isinstance(x, list):
        return [(i.module_id.value, i.index) for i in x]
    if x is None or isinstance(x, bool):
        return x
    if hasattr(x, "module_id"):
        return (type(x).__name__, x.module_id.value, x.index)
    return (type(x).__name__, x.value)


def test_workspace_edit_script_matches_jax():
    """One edit script through both Workspaces: the same return values and
    errors, and the same ``to_persist()`` and indications after each step."""
    wss = {"jax": jgraph.Workspace(), "port": tgraph.Workspace()}
    snaps = {}
    for step, ((name, args_j), (_, args_t)) in enumerate(zip(_edit_script(jp),
                                                             _edit_script(tp))):
        results = {}
        for key, args in (("jax", args_j), ("port", args_t)):
            ws = wss[key]
            if name == "snapshot":
                snaps[key] = ws.snapshot()
                res = None
            elif name == "restore":
                ws.restore(snaps[key])
                res = None
            else:
                try:
                    res = _returned(getattr(ws, name)(*args))
                except Exception as e:  # the error itself is compared
                    res = ("raised", type(e).__name__)
            results[key] = res
        assert results["port"] == results["jax"], (step, name)
        assert wss["port"].to_persist() == wss["jax"].to_persist(), (step, name)
        assert ({m.value: i.kind for m, i in wss["port"].indications.items()}
                == {m.value: i.kind for m, i in wss["jax"].indications.items()})
        assert ([m.value for m in wss["port"].run_order()]
                == [m.value for m in wss["jax"].run_order()])
    # the snapshot was not changed by the edits made after it
    assert len(snaps["port"].modules) == 4


def test_carry_state_keeps_eq_poles_across_edits():
    """A param edit and a structural edit both keep the EqThree's poles (the
    port rebuilds the program on every edit and carries state through
    ``carry_state``)."""
    eng = Engine(cfg=CFG, device="cpu")
    sid, _, _ = eng.connect_session()
    geo = tp.WindowGeometry()
    for seq, op in enumerate((
        tp.CreateModule(tp.ModuleParams("Oscillator", tp.OscillatorParams(200.0, tp.Waveform.SINE)), geo),
        tp.CreateModule(tp.ModuleParams("EqThree", tp.EqThreeParams(
            tp.Decibel(4.0), tp.Decibel(0.0), tp.Decibel(4.0))), geo),
        tp.CreateModule(tp.ModuleParams("StereoPanner", None), geo),
        tp.CreateModule(tp.ModuleParams("Plotter", None), geo),
        tp.CreateConnection(tp.InputId(tp.ModuleId(2), 0), tp.OutputId(tp.ModuleId(1), 0)),
        tp.CreateConnection(tp.InputId(tp.ModuleId(3), 0), tp.OutputId(tp.ModuleId(2), 0)),
        tp.CreateConnection(tp.InputId(tp.ModuleId(3), 1), tp.OutputId(tp.ModuleId(2), 0)),
        tp.CreateConnection(tp.InputId(tp.ModuleId(4), 0), tp.OutputId(tp.ModuleId(3), 0)),
    ), 1):
        eng.update(sid, tp.WorkspaceMessage(seq, op))
    for _ in range(3):
        eng.tick_once()
    poles = eng._state["2"]["poles"].clone()
    assert poles.abs().max() > 0
    eng.update(sid, tp.WorkspaceMessage(9, tp.UpdateModuleParams(tp.ModuleId(2), tp.ModuleParams(
        "EqThree", tp.EqThreeParams(tp.Decibel(-3.0), tp.Decibel(0.0), tp.Decibel(0.0))))))
    assert torch.equal(eng._state["2"]["poles"], poles)
    eng.update(sid, tp.WorkspaceMessage(10, tp.CreateModule(
        tp.ModuleParams("Trigger", tp.GateState.OPEN), geo)))
    assert torch.equal(eng._state["2"]["poles"], poles)
    eng.stop()


def test_broadcast_drops_a_lagging_session():
    eng = Engine(cfg=CFG, device="cpu")
    _, _, slow = eng.connect_session()
    assert eng.session_count() == 1
    for i in range(70):
        eng._log_op(tp.SUDeleteModule(tp.ModuleId(i + 1)))
    assert eng.session_count() == 0
    items = _drain(slow)
    assert len(items) == 64 and items[-1] is not None  # the sentinel did not fit
    eng._thread = threading.current_thread()  # as if the engine thread ran
    for i in range(8):
        eng.update(1, tp.WorkspaceMessage(i, tp.DeleteModule(tp.ModuleId(1))))
    with pytest.raises(Busy):
        eng.update(1, tp.WorkspaceMessage(9, tp.DeleteModule(tp.ModuleId(1))))
