"""The live engine's edit path (``mixlab_tpu_torch/engine/engine.py``) on
the CPU: the param-only swap, the async compile-and-swap and issue-ahead,
against the JAX package's engine.

The first three cases are ``tests/test_async_compile.py``'s, run against
the port's ``Engine(device="cpu")``.  Both packages' Monitor codec threads
are replaced by a stub that reads nothing, so the tests read each engine's
monitor pipe themselves: where the JAX case listens for the Monitor's PCM
packets, the port's reads the pipe's audio (the port's Monitor always
encodes AAC).

Tolerances: monitor audio within 2^-11 of the JAX engine's, as in
``tests/test_torch_engine.py`` (the JAX package's jitted FmSine against
op-by-op evaluation); the port against itself exactly.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as jp
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.engine import Engine as JaxEngine
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import Busy, Engine
from mixlab_tpu_torch.flagship import AMP0, EQ, FM, MON, OSC0, realtime_video_ops
from mixlab_tpu_torch.protocol import InputId, OutputId

CFG = EngineConfig(sample_rate=44_100)
CFG_J = JaxEngineConfig(sample_rate=44_100)
SPT = CFG.samples_per_tick
AUDIO_ATOL = 2.0 ** -11


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


def _send(eng, sid, seq, op, retry_s=5.0):
    """``eng.update``, waiting out ``Busy`` (a full command queue)."""
    deadline = time.monotonic() + retry_s
    while True:
        try:
            return eng.update(sid, p.WorkspaceMessage(seq, op))
        except Busy:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.005)


# -- tests/test_async_compile.py against the port ------------------------------


def test_engine_keeps_ticking_through_structural_edit():
    eng = Engine(cfg=CFG, device="cpu")
    eng.start()
    try:
        time.sleep(0.5)
        sid, _, _ = eng.connect_session()
        t_before = eng.tick

        # structural edits: compiled on the engine thread, warmed off it
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
            p.WindowGeometry())))
        eng.update(sid, p.WorkspaceMessage(2, p.CreateModule(
            p.ModuleParams("Monitor", None), p.WindowGeometry())))
        eng.update(sid, p.WorkspaceMessage(3, p.CreateConnection(
            InputId(p.ModuleId(2), 1), OutputId(p.ModuleId(1), 1))))

        # ticks keep flowing at ~60 Hz meanwhile
        time.sleep(1.0)
        assert eng.tick - t_before > 30, "engine stalled during compile"

        # the new program goes live and the monitor gets the sine
        deadline = time.time() + 60
        got_audio = False
        while time.time() < deadline and not got_audio:
            pipe = eng.monitor_pipe(p.ModuleId(2))
            try:
                _, audio, _ = pipe.q.get(timeout=1.0)
            except queue.Empty:
                continue
            got_audio = float(np.abs(audio).max()) > 16000 / 32768
        assert got_audio, "new program never became live"
    finally:
        eng.stop()


def test_edit_storm_never_adopts_stale_patch(monkeypatch):
    """Rapid structural edits while ticking: the engine adopts only a patch
    of the newest generation, and each patch it adopts between ticks runs
    the workspace as it stands then."""
    eng = Engine(cfg=CFG, device="cpu")

    adopted = []
    orig_adopt = Engine._adopt_patch

    def tracking_adopt(self, patch):
        adopted.append((patch.serves(self.ws), self._compile_gen))
        return orig_adopt(self, patch)

    monkeypatch.setattr(Engine, "_adopt_patch", tracking_adopt)

    # slow the warm down so compiles from older edits are still in flight
    # when newer edits land
    orig_warm = Engine._warm_and_stage

    def slow_warm(self, patch, gen, warm_args):
        time.sleep(0.05)
        latest = self._compile_gen
        orig_warm(self, patch, gen, warm_args)
        # a stale warm never stages
        if gen != latest:
            assert self._pending_patch is None or self._pending_patch[1] == latest

    monkeypatch.setattr(Engine, "_warm_and_stage", slow_warm)

    eng.start()
    try:
        sid, _, _ = eng.connect_session()
        seq = 0
        mods = []
        # ~100 structural edits/s for 1.5 s, mixing create/delete
        t_end = time.time() + 1.5
        while time.time() < t_end:
            seq += 1
            try:
                if len(mods) > 4 and seq % 3 == 0:
                    eng.update(sid, p.WorkspaceMessage(seq, p.DeleteModule(mods.pop(0))))
                else:
                    eng.update(sid, p.WorkspaceMessage(seq, p.CreateModule(
                        p.ModuleParams("Oscillator",
                                       p.OscillatorParams(100.0 + seq, p.Waveform.SINE)),
                        p.WindowGeometry())))
                    mods.append(p.ModuleId(eng.ws.module_seq))
            except Exception:
                pass  # Busy is fine under storm
            time.sleep(0.01)
        t_mark = eng.tick
        # let in-flight compiles settle; ticking continues
        time.sleep(3.0)
        assert eng.tick > t_mark + 60, "engine stalled after edit storm"
        want = compile_patch(eng.ws, eng.cfg, eng.block, eng.device).structural_fingerprint
        deadline = time.time() + 60
        while time.time() < deadline and eng._patch.structural_fingerprint != want:
            time.sleep(0.5)
        assert eng._patch.structural_fingerprint == want, (
            "engine never converged to a patch matching the final workspace")
        # every adoption (between ticks) ran the workspace of its moment
        assert adopted and all(serves for serves, _ in adopted), adopted
    finally:
        eng.stop()


def test_create_delete_netting_out_never_adopts_deleted_module(monkeypatch):
    """Create module M (its compile in flight), then delete M before the
    compile lands: the net structure is the running one, so the delete takes
    the param-only path, which must supersede the compile in flight."""
    orig_warm = Engine._warm_and_stage

    def slow_warm(self, patch, gen, warm_args):
        time.sleep(0.6)  # hold the compile in flight past the delete
        return orig_warm(self, patch, gen, warm_args)

    monkeypatch.setattr(Engine, "_warm_and_stage", slow_warm)

    eng = Engine(cfg=CFG, device="cpu")
    eng.start()
    try:
        time.sleep(0.3)
        sid, _, _ = eng.connect_session()
        n0 = len(eng.ws.modules)
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
            p.WindowGeometry())))
        deadline = time.time() + 5
        while len(eng.ws.modules) == n0 and time.time() < deadline:
            time.sleep(0.02)  # the op applies on the engine thread
        assert len(eng.ws.modules) > n0
        mid = p.ModuleId(eng.ws.module_seq)
        time.sleep(0.1)  # the create's compile is now in flight
        eng.update(sid, p.WorkspaceMessage(2, p.DeleteModule(mid)))
        time.sleep(2.0)
        assert mid not in eng.ws.modules
        assert all(m != mid for m in eng._patch.order), (
            "stale patch containing the deleted module was adopted")
        t0 = eng.tick
        time.sleep(1.0)
        assert eng.tick > t0 + 30, "engine thread died or stalled"
    finally:
        eng.stop()


# -- the param-only swap ---------------------------------------------------------


def _flagship_engine(jax: bool, **kw):
    """An engine (direct drive) with the flagship graph built by client ops."""
    pk = jp if jax else p
    eng = JaxEngine(cfg=CFG_J, **kw) if jax else Engine(cfg=CFG, device="cpu", **kw)
    sid, _, _ = eng.connect_session()
    ops, _ = realtime_video_ops(pk, cams=())
    for seq, op in enumerate(ops, 1):
        eng.update(sid, pk.WorkspaceMessage(seq, op))
    return eng, sid


def _param_edits(pk):
    """Param-only edits of the flagship whose continuous params reach the
    program through ``aux`` alone (an amplifier, the EQ's gains)."""
    return [
        pk.UpdateModuleParams(pk.ModuleId(AMP0), pk.ModuleParams(
            "Amplifier", pk.AmplifierParams(amplitude=0.8, mod_depth=0.1))),
        pk.UpdateModuleParams(pk.ModuleId(EQ), pk.ModuleParams(
            "EqThree", pk.EqThreeParams(pk.Decibel(-6.0), pk.Decibel(3.0), pk.Decibel(1.0)))),
        pk.UpdateModuleParams(pk.ModuleId(AMP0 + 2), pk.ModuleParams(
            "Amplifier", pk.AmplifierParams(amplitude=0.2, mod_depth=0.9))),
    ]


def _monitor_pipe(eng):
    return eng.monitor_pipe((jp if isinstance(eng, JaxEngine) else p).ModuleId(MON))


def _monitor_audio(eng, n):
    """``n`` ticks in direct drive; -> the monitor pipe's (t0, audio) items."""
    out = []
    pipe = _monitor_pipe(eng)
    for _ in range(n):
        eng.tick_once()
        out += [(t0, np.asarray(a)) for t0, a, _ in _drain(pipe.q)]
    return out


def test_param_only_edit_keeps_program_and_matches_jax():
    """A param edit keeps ``eng._patch`` (the same object: no
    ``compile_patch`` call) and its state, and gives the JAX engine's
    monitor audio for the same ops."""
    ours, sid = _flagship_engine(False)
    theirs, sid_j = _flagship_engine(True)
    calls = []
    compiler = ours._patch_compiler
    ours._patch_compiler = lambda *a: calls.append(1) or compiler(*a)
    try:
        got, want = _monitor_audio(ours, 3), _monitor_audio(theirs, 3)
        for seq, (op, op_j) in enumerate(zip(_param_edits(p), _param_edits(jp)), 100):
            patch = ours._patch
            ours.update(sid, p.WorkspaceMessage(seq, op))
            theirs.update(sid_j, jp.WorkspaceMessage(seq, op_j))
            assert ours._patch is patch and not calls
            got += _monitor_audio(ours, 3)
            want += _monitor_audio(theirs, 3)
        assert len(got) == len(want) == 12
        for i, ((t0, a), (t0_j, a_j)) in enumerate(zip(got, want)):
            assert t0 == t0_j == i * SPT
            err = float(np.abs(a - a_j).max())
            assert err <= AUDIO_ATOL, (i, err)
        # the edits were heard: the last ticks differ from the first
        assert float(np.abs(got[-1][1] - got[0][1]).max()) > 0.01
    finally:
        ours.stop()
        theirs.stop()


def test_param_only_edit_equals_recompile():
    """Every param-only edit of the flagship, oscillator and FM frequencies
    included, gives exactly the audio of an engine that recompiles at each
    edit: the kept program reads the new params for its host arrays (the
    oscillators' phase bases) too."""
    ours, sid = _flagship_engine(False)
    full_engine, sid_f = _flagship_engine(False)
    full = full_engine
    full._rebuild = lambda full: Engine._rebuild(full_engine, True)
    edits = _param_edits(p) + [
        p.UpdateModuleParams(p.ModuleId(OSC0 + 1), p.ModuleParams(
            "Oscillator", p.OscillatorParams(523.25, p.Waveform.SINE))),
        p.UpdateModuleParams(p.ModuleId(FM), p.ModuleParams(
            "FmSine", p.FmSineParams(300.0, 1200.0))),
    ]
    try:
        got, want = _monitor_audio(ours, 2), _monitor_audio(full, 2)
        for seq, op in enumerate(edits, 100):
            patch = ours._patch
            ours.update(sid, p.WorkspaceMessage(seq, op))
            full.update(sid_f, p.WorkspaceMessage(seq, op))
            assert ours._patch is patch and full._patch is not patch
            got += _monitor_audio(ours, 2)
            want += _monitor_audio(full, 2)
        assert len(got) == len(want) == 2 + 2 * len(edits)
        for (t0, a), (t0_f, a_f) in zip(got, want):
            assert t0 == t0_f
            np.testing.assert_array_equal(a, a_f)
    finally:
        ours.stop()
        full.stop()


def _storm_ops():
    """Structural and param edits on an empty workspace: creates, connects,
    param edits, a create and its delete, and deletes."""
    geo = p.WindowGeometry()
    mod = lambda kind, params=None: p.CreateModule(p.ModuleParams(kind, params), geo)  # noqa: E731
    conn = lambda im, ii, om, oi: p.CreateConnection(  # noqa: E731
        InputId(p.ModuleId(im), ii), OutputId(p.ModuleId(om), oi))
    ops = [mod("Mixer", p.MixerParams.with_channels(4)), mod("Monitor"),
           conn(2, 1, 1, 0)]
    for i in range(12):
        ops += [mod("Oscillator", p.OscillatorParams(100.0 + 10 * i, p.Waveform.SINE)),
                conn(1, i % 4, 3 + i, 1),
                p.UpdateModuleParams(p.ModuleId(1), p.ModuleParams(
                    "Mixer", p.MixerParams.with_channels(4)))]
        if i % 3 == 2:
            ops.append(p.DeleteModule(p.ModuleId(3 + i - 1)))
    return ops


def test_threaded_and_direct_drive_end_on_one_fingerprint():
    """The same ops through a threaded engine (async compile, adopted
    between ticks) and a direct-drive one (compiled at once) end on the same
    workspace and the same program fingerprint."""
    direct = Engine(cfg=CFG, device="cpu")
    threaded = Engine(cfg=CFG, device="cpu")
    threaded.start()
    try:
        sid_d, _, _ = direct.connect_session()
        sid_t, _, _ = threaded.connect_session()
        for seq, op in enumerate(_storm_ops(), 1):
            direct.update(sid_d, p.WorkspaceMessage(seq, op))
            direct.tick_once()
            _send(threaded, sid_t, seq, op)
            time.sleep(0.005)
        want = direct._patch.structural_fingerprint
        deadline = time.time() + 30
        while time.time() < deadline and (threaded._patch.structural_fingerprint != want
                                           or threaded._pending_patch is not None):
            time.sleep(0.05)
        assert threaded._patch.structural_fingerprint == want
        assert threaded.ws.to_persist() == direct.ws.to_persist()
    finally:
        threaded.stop()
        direct.stop()


# -- issue-ahead ------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_depth_routes_the_same_items_later(depth):
    """With ``pipeline_depth`` d the monitor gets depth 0's items, each d
    blocks later, as the JAX engine's ``pipeline_depth`` does in direct
    drive; ``flush_inflight`` routes the last d."""
    n = 6
    runs = {}
    for jax, d in ((False, 0), (False, depth), (True, depth)):
        eng, _ = _flagship_engine(jax, pipeline_depth=d)
        try:
            pipe = _monitor_pipe(eng)
            per_tick = []
            for _ in range(n):
                eng.tick_once()
                per_tick.append([(t0, np.asarray(a)) for t0, a, _ in _drain(pipe.q)])
            eng.flush_inflight()
            runs[jax, d] = per_tick, [(t0, np.asarray(a)) for t0, a, _ in _drain(pipe.q)]
        finally:
            eng.stop()
    (now, _), (later, flushed), (theirs, theirs_flushed) = (
        runs[False, 0], runs[False, depth], runs[True, depth])
    assert all(len(items) == 1 for items in now)
    assert [len(items) for items in later] == [0] * depth + [1] * (n - depth)
    assert len(flushed) == depth
    routed = [items[0] for items in later[depth:]] + flushed
    for i, ((t0, a), (t0_0, a_0)) in enumerate(zip(routed, (items[0] for items in now))):
        assert t0 == t0_0 == i * SPT
        np.testing.assert_array_equal(a, a_0)
    assert [len(items) for items in theirs] == [len(items) for items in later]
    for (t0, a), (t0_j, a_j) in zip(routed, [items[0] for items in theirs[depth:]]
                                    + [(t0, np.asarray(a)) for t0, a in theirs_flushed]):
        assert t0 == t0_j
        assert float(np.abs(a - a_j).max()) <= AUDIO_ATOL


def test_stop_and_checkpoint_flush_the_blocks_in_flight():
    """``checkpoint`` and ``stop`` route the blocks still in flight first."""
    eng, _ = _flagship_engine(False, pipeline_depth=2)
    pipe = eng.monitor_pipe(p.ModuleId(MON))
    for _ in range(3):
        eng.tick_once()
    assert len(_drain(pipe.q)) == 1
    ckpt = eng.checkpoint()
    assert [t0 for t0, _, _ in _drain(pipe.q)] == [SPT, 2 * SPT]
    assert ckpt["tick"] == 3
    eng.tick_once()
    eng.stop()
    assert [t0 for t0, _, _ in _drain(pipe.q)] == [3 * SPT]


def test_failed_warm_is_retried_until_adopted(monkeypatch):
    """A warm that raises is logged and tried again after the retry delay
    until it lands."""
    monkeypatch.setattr(Engine, "WARM_RETRY_S", 0.2)
    failures = []
    orig_warm = Engine._warm_and_stage

    def flaky_warm(self, patch, gen, warm_args):
        if not failures:
            failures.append(gen)
            real_run = patch.run

            def boom(*a):
                patch.run = real_run
                raise RuntimeError("warm failed once")

            patch.run = boom
        return orig_warm(self, patch, gen, warm_args)

    monkeypatch.setattr(Engine, "_warm_and_stage", flaky_warm)
    eng = Engine(cfg=CFG, device="cpu")
    eng.start()
    try:
        sid, _, _ = eng.connect_session()
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
            p.WindowGeometry())))
        deadline = time.time() + 10
        while time.time() < deadline and not eng._patch.order:
            time.sleep(0.05)
        assert failures and [m.value for m in eng._patch.order] == [1]
    finally:
        eng.stop()
    assert not any(t.name == "compile" and t.is_alive() for t in threading.enumerate())


def test_param_edit_of_a_pending_structure_keeps_its_warm(monkeypatch):
    """A param edit of the structure still being warmed does not restart the
    compile (the generation stands, no new ``compile_patch``); the adoption
    then runs the edited params."""
    orig_warm = Engine._warm_and_stage

    def slow_warm(self, patch, gen, warm_args):
        time.sleep(0.4)
        return orig_warm(self, patch, gen, warm_args)

    monkeypatch.setattr(Engine, "_warm_and_stage", slow_warm)
    eng = Engine(cfg=CFG, device="cpu")
    calls = []
    compiler = eng._patch_compiler
    eng._patch_compiler = lambda *a: calls.append(1) or compiler(*a)
    eng.start()
    try:
        sid, _, _ = eng.connect_session()
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Amplifier", p.AmplifierParams(amplitude=0.5, mod_depth=0.3)),
            p.WindowGeometry())))
        deadline = time.time() + 5
        while time.time() < deadline and eng._compiling is None:
            time.sleep(0.01)
        gen = eng._compile_gen
        eng.update(sid, p.WorkspaceMessage(2, p.UpdateModuleParams(p.ModuleId(1), p.ModuleParams(
            "Amplifier", p.AmplifierParams(amplitude=0.25, mod_depth=0.75)))))
        deadline = time.time() + 10
        while time.time() < deadline and not eng._patch.order:
            time.sleep(0.02)
        assert [m.value for m in eng._patch.order] == [1]
        assert eng._compile_gen == gen and len(calls) == 1
        want = eng._patch.prepare_aux(eng.ws)["1"]
        got = eng._aux["1"]
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k
        assert float(torch.as_tensor(got["amplitude"])) == 0.25
    finally:
        eng.stop()


def test_checkpoint_during_a_warm_fits_its_workspace(monkeypatch):
    """A checkpoint taken on the engine thread while a structural edit is
    still being warmed carries the DSP state of its own workspace's
    program: an engine built from that workspace restores it."""
    orig_warm = Engine._warm_and_stage

    def slow_warm(self, patch, gen, warm_args):
        time.sleep(1.0)
        return orig_warm(self, patch, gen, warm_args)

    monkeypatch.setattr(Engine, "_warm_and_stage", slow_warm)
    eng = Engine(cfg=CFG, device="cpu")
    eng.start()
    try:
        sid, _, _ = eng.connect_session()
        geo = p.WindowGeometry()
        for seq, op in enumerate([
                p.CreateModule(p.ModuleParams("Oscillator", p.OscillatorParams(
                    440.0, p.Waveform.SINE)), geo),
                p.CreateModule(p.ModuleParams("EqThree", p.EqThreeParams(
                    p.Decibel(4.0), p.Decibel(-2.0), p.Decibel(3.0))), geo),
                p.CreateConnection(InputId(p.ModuleId(2), 0), OutputId(p.ModuleId(1), 0))], 1):
            _send(eng, sid, seq, op)
        ckpt = eng.checkpoint_sync()
        assert eng._compiling is None and [m.value for m in eng._patch.order] == [1, 2]
        assert len(ckpt["dsp_state"]) > 0
    finally:
        eng.stop()
    from mixlab_tpu_torch.engine.graph import Workspace

    ref = Engine(workspace=Workspace.from_persist(ckpt["workspace"]), cfg=CFG, device="cpu")
    try:
        assert ref.restore_dsp_state(ckpt)
    finally:
        ref.stop()
