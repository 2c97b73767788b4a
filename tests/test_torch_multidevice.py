"""The port over a mesh of several devices against the JAX package on its
8-device virtual CPU mesh (``tests/conftest.py``), on the CPU: the port's
mesh is as many CPU entries (``parallel.make_mesh(n, devices=["cpu"])``).

  * stems (``tests/test_multichip.py:29-100``): the master over 2, 4 and 8
    shards and with stem counts that do not divide the mesh, atol 2e-4, and
    the row-sharded blend at heights that do not divide it, exact;
  * the fleet sharded over 4 shards (``tests/test_fleet.py:68-75``);
  * the live engine over StemsPatch (``tests/test_engine_multichip.py``):
    taps, a structural edit in direct drive and one under the engine
    thread.  Each holds the mesh's taps to N_STEMS x the one-device
    engine's at 1e-6, the JAX test's own check, and to the JAX engine over
    its mesh at N_STEMS x ATOL_SIN: each stem's oscillator differs from the
    JAX package's by up to an ulp of sin (``tests/test_torch_modules.py``).
"""

import json
import time

import numpy as np
import pytest
import torch

from bench import build_16_module_graph as jax_flagship
from mixlab_tpu import protocol as jp
from mixlab_tpu.dsp.base import interleave_tap as jax_interleave
from mixlab_tpu.engine.compiler import compile_patch as jax_compile_patch
from mixlab_tpu.engine.config import BlockSpec as JaxBlockSpec
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.engine import Engine as JaxEngine
from mixlab_tpu.engine.graph import Workspace as JaxWorkspace
from mixlab_tpu.parallel.fleet import Fleet as JaxFleet
from mixlab_tpu.parallel.stems import StemsPatch as JaxStemsPatch
from mixlab_tpu.parallel.stems import make_mesh as jax_mesh
from mixlab_tpu.parallel.stems import row_sharded_blend as jax_row_sharded_blend
from mixlab_tpu.parallel.stems import stem_parallel_step as jax_stem_parallel_step
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.convert import to_numpy
from mixlab_tpu_torch.dsp.base import interleave_tap
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.engine import Engine
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.parallel import make_mesh
from mixlab_tpu_torch.parallel.fleet import Fleet
from mixlab_tpu_torch.parallel.stems import StemsPatch, row_sharded_blend, stem_parallel_step
from test_torch_engine import _NoCodec

CFG = EngineConfig(sample_rate=48_000)
CFG_J = JaxEngineConfig(sample_rate=48_000)
MIX_ATOL = 2e-4     # tests/test_multichip.py:52
ENGINE_TOL = 1e-6   # tests/test_engine_multichip.py:87
ATOL_SIN = 2e-6     # tests/test_torch_modules.py: an ulp of sin between libms
N_STEMS = 5         # not a multiple of the 8-entry mesh


@pytest.fixture(autouse=True)
def _no_monitor_codec(monkeypatch):
    monkeypatch.setattr("mixlab_tpu.server.monitor.MonitorPipeline", _NoCodec)
    monkeypatch.setattr("mixlab_tpu_torch.server.monitor.MonitorPipeline", _NoCodec)


def cpu_mesh(n, axis="stems"):
    return make_mesh(n, axis=axis, devices=["cpu"])


def _flagships():
    ws_j, mon = jax_flagship()
    return ws_j, Workspace.from_persist(json.loads(json.dumps(ws_j.to_persist()))), \
        str(mon.value)


# -- stems (tests/test_multichip.py) ---------------------------------------------


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_stem_parallel_mixdown_matches_jax_mesh(n_devices):
    """One stem a shard (the default), as the JAX step and as the dryrun's
    sweep over mesh sizes: the master equals the JAX mesh's and n x one
    stem, and the port's shards each hold one stem."""
    ws_j, ws, key = _flagships()
    fn_j, args_j, patch_j = jax_stem_parallel_step(ws_j, CFG_J, JaxBlockSpec(2),
                                                   jax_mesh(n_devices), key)
    fn, make_args, _ = stem_parallel_step(ws, CFG, BlockSpec(2), key,
                                          mesh=cpu_mesh(n_devices))
    args = make_args(0)
    assert len(args[0]) == n_devices and all(m.shape == (1,) for m in args[3])
    _, master = fn(*args)
    _, want = fn_j(*args_j(0))
    assert master.shape == (2, CFG.samples_per_tick, 2)
    np.testing.assert_allclose(master.numpy(), np.asarray(want), atol=MIX_ATOL)
    _, taps = patch_j.run(patch_j.prepare_aux(ws_j), patch_j.host_aux(0),
                          patch_j.init_state(ws_j))
    one = jax_interleave(taps[key]["audio"])
    np.testing.assert_allclose(master.numpy(), n_devices * one, atol=MIX_ATOL)


@pytest.mark.parametrize("n_stems,n_devices", [(5, 4), (9, 8), (3, 2), (1, 4)])
def test_stem_count_not_divisible_by_devices(n_stems, n_devices):
    """Pad stems run on their shards and are masked out of the mixdown by
    the shard's position: the masks equal the JAX step's, the master its."""
    ws_j, ws, key = _flagships()
    fn_j, args_j, _ = jax_stem_parallel_step(ws_j, CFG_J, JaxBlockSpec(2), jax_mesh(n_devices),
                                             key, n_stems=n_stems)
    fn, make_args, _ = stem_parallel_step(ws, CFG, BlockSpec(2), key, n_stems=n_stems,
                                          mesh=cpu_mesh(n_devices))
    args, a_j = make_args(0), args_j(0)
    pad = -(-n_stems // n_devices) * n_devices
    mask = torch.cat(args[3]).numpy()
    assert mask.shape == (pad,) and mask.sum() == n_stems
    assert np.array_equal(mask, np.asarray(a_j[3]))
    _, master = fn(*args)
    _, want = fn_j(*a_j)
    np.testing.assert_allclose(master.numpy(), np.asarray(want), atol=MIX_ATOL)


@pytest.mark.parametrize("height", [127, 129, 64 + 17])
def test_row_sharded_blend_uneven_rows(height):
    """Rows padded to a multiple of 8 shards, each shard's rows blended,
    gathered and the padding sliced off: exactly the JAX blend's."""
    rng = np.random.default_rng(height)
    a = rng.integers(0, 256, (height, 320), dtype=np.uint8)
    b = rng.integers(0, 256, (height, 320), dtype=np.uint8)
    blend, blend_j = row_sharded_blend(cpu_mesh(8)), jax_row_sharded_blend(jax_mesh(8))
    for fade in (0, 37, 255):
        out = blend(a, b, fade)
        assert out.shape == (height, 320)
        assert np.array_equal(out.numpy(), np.asarray(blend_j(a, b, fade)))


# -- the fleet (tests/test_fleet.py:68-75) ------------------------------------------


def _fleet_ws(pm, W, freq=440.0, amp=0.5):
    ws = W()
    o = ws.create_module(pm.ModuleParams("Oscillator", pm.OscillatorParams(freq, pm.Waveform.SINE)))
    a = ws.create_module(pm.ModuleParams("Amplifier", pm.AmplifierParams(amplitude=amp)))
    m = ws.create_module(pm.ModuleParams("Monitor", None))
    ws.connect(pm.InputId(a, 0), pm.OutputId(o, 1))
    ws.connect(pm.InputId(m, 1), pm.OutputId(a, 0))
    return ws, m


def test_fleet_sharded_over_mesh():
    """8 instances over 4 shards against the JAX fleet over its 4-device
    mesh: the taps in instance order, each within ATOL_SIN."""
    cfg44, cfg44_j = EngineConfig(sample_rate=44_100), JaxEngineConfig(sample_rate=44_100)
    base, mon = _fleet_ws(p, Workspace)
    base_j, _ = _fleet_ws(jp, JaxWorkspace)
    fleet = Fleet.build(base, n=8, cfg=cfg44, block=BlockSpec(1), mesh=cpu_mesh(4, "fleet"),
                        axis="fleet")
    fleet_j = JaxFleet.build(base_j, n=8, cfg=cfg44_j, block=JaxBlockSpec(1),
                             mesh=jax_mesh(4, axis="fleet"), axis="fleet")
    assert len(fleet.shards) == 4
    for t0 in (0, 735):
        audio = interleave_tap(to_numpy(fleet.run_block(t0))[str(mon.value)]["audio"])
        want = jax_interleave(fleet_j.run_block(t0)[str(mon.value)]["audio"])
        assert audio.shape[0] == 8
        assert np.abs(audio).max() > 0.4
        np.testing.assert_allclose(audio, want, rtol=0, atol=ATOL_SIN)


# -- the live engine (tests/test_engine_multichip.py) --------------------------------


def template(pm=p, W=Workspace):
    ws = W()
    o = ws.create_module(pm.ModuleParams(
        "Oscillator", pm.OscillatorParams(440.0, pm.Waveform.SINE)))
    a = ws.create_module(pm.ModuleParams("Amplifier", pm.AmplifierParams(amplitude=0.5)))
    m = ws.create_module(pm.ModuleParams("Monitor", None))
    ws.connect(pm.InputId(a, 0), pm.OutputId(o, 1))
    ws.connect(pm.InputId(m, 1), pm.OutputId(a, 0))
    return ws, o, a, m


def capture_taps(eng):
    """Wrap ``_route_taps`` to record every block's taps as numpy."""
    captured = []
    orig = eng._route_taps

    def wrapper(t0, S, taps, video_buffers):
        captured.append((t0, {k: {n: tuple(np.asarray(x) for x in v) for n, v in tp.items()}
                              for k, tp in taps.items()}))
        return orig(t0, S, taps, video_buffers)

    eng._route_taps = wrapper
    return captured


def _close(got, want, n):
    """The mesh's taps against n x the port's one-device engine's."""
    np.testing.assert_allclose(got, n * want, rtol=ENGINE_TOL, atol=ENGINE_TOL)


def _engines(block_ticks=2):
    """The port's engine over an 8-entry CPU mesh, its one-device engine and
    the JAX engine over its 8-device mesh, each on a fresh template."""
    multi = Engine(workspace=template()[0], cfg=CFG, block_ticks=block_ticks, device="cpu",
                   patch_compiler=StemsPatch.compiler(cpu_mesh(8), N_STEMS))
    single = Engine(workspace=template()[0], cfg=CFG, block_ticks=block_ticks, device="cpu")
    jax_multi = JaxEngine(workspace=template(jp, JaxWorkspace)[0], cfg=CFG_J,
                          block_ticks=block_ticks,
                          patch_compiler=JaxStemsPatch.compiler(jax_mesh(8), N_STEMS))
    return multi, single, jax_multi


def test_mixdown_tap_matches_single_device_engine():
    engines = _engines()
    caps = [capture_taps(e) for e in engines]
    for _ in range(3):
        for e in engines:
            e.tick_once()
    assert all(len(c) == 3 for c in caps)
    for (t0m, tm), (t0s, ts), (t0j, tj) in zip(*caps):
        assert t0m == t0s == t0j
        (key,) = tm.keys()
        for gm, gs, gj in zip(tm[key]["audio"], ts[key]["audio"], tj[key]["audio"]):
            _close(gm, gs, N_STEMS)
            np.testing.assert_allclose(gm, gj, rtol=0, atol=N_STEMS * ATOL_SIN)
        assert np.any(tm[key]["audio"][0] != 0.0)


def _edit(eng, sid, m, pm):
    eng.client_update(sid, pm.WorkspaceMessage(1, pm.CreateModule(
        pm.ModuleParams("Oscillator", pm.OscillatorParams(220.0, pm.Waveform.SAW)),
        pm.WindowGeometry())))
    new_mid = max(eng.ws.modules, key=lambda mid: mid.value)
    eng.client_update(sid, pm.WorkspaceMessage(2, pm.CreateConnection(
        pm.InputId(m, 1), pm.OutputId(new_mid, 1))))


def test_structural_edit_mid_run_direct_drive():
    """A structural edit rebuilds the sharded program; the engine carries
    on with the new module in the mixdown, each module's state a tuple of
    its 8 shards'."""
    ws, _, _, m = template()
    ws_j, _, _, m_j = template(jp, JaxWorkspace)
    eng = Engine(workspace=ws, cfg=CFG, block_ticks=2, device="cpu",
                 patch_compiler=StemsPatch.compiler(cpu_mesh(8), N_STEMS))
    eng_j = JaxEngine(workspace=ws_j, cfg=CFG_J, block_ticks=2,
                      patch_compiler=JaxStemsPatch.compiler(jax_mesh(8), N_STEMS))
    captured, captured_j = capture_taps(eng), capture_taps(eng_j)
    for e, mod, pm in ((eng, m, p), (eng_j, m_j, jp)):
        sid, _, _ = e.connect_session()
        e.tick_once()
        _edit(e, sid, mod, pm)
        e.tick_once()
    assert len(captured) == len(captured_j) == 2
    (key,) = captured[1][1].keys()
    got = captured[1][1][key]["audio"][0]
    assert all(isinstance(st, tuple) and len(st) == 8 for st in eng._state.values())

    ws_ref, _, _, m_r = template()
    ws_ref.create_module(p.ModuleParams("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW)))
    new_ref = max(ws_ref.modules, key=lambda mid: mid.value)
    ws_ref.connect(p.InputId(m_r, 1), p.OutputId(new_ref, 1))
    ref = Engine(workspace=ws_ref, cfg=CFG, block_ticks=2, device="cpu")
    ref_taps = capture_taps(ref)
    ref.tick_once()
    ref.tick_once()
    (rkey,) = ref_taps[1][1].keys()
    _close(got, ref_taps[1][1][rkey]["audio"][0], N_STEMS)
    np.testing.assert_allclose(got, captured_j[1][1][key]["audio"][0], rtol=0,
                               atol=N_STEMS * ATOL_SIN)


def test_structural_edit_under_realtime_thread():
    """The edit lands through the engine thread's command queue while the
    60 Hz loop runs; the new module is in the running order and the loop
    keeps ticking, each block N_STEMS x the JAX package's one-device render
    of the unchanged audio path."""
    ws, o, a, m = template()
    eng = Engine(workspace=ws, cfg=CFG, block_ticks=6, device="cpu",
                 patch_compiler=StemsPatch.compiler(cpu_mesh(8), N_STEMS))
    captured = capture_taps(eng)
    eng.start()
    try:
        sid, _, _ = eng.connect_session()
        deadline = time.monotonic() + 10
        while not captured and time.monotonic() < deadline:
            time.sleep(0.05)
        assert captured, "engine produced no blocks"
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(
            p.ModuleParams("Trigger", p.GateState.OPEN), p.WindowGeometry())))
        trig_mid = None
        deadline = time.monotonic() + 10
        while trig_mid is None and time.monotonic() < deadline:
            trig_mid = next((mid for mid, e in list(eng.ws.modules.items())
                             if e.params.kind == "Trigger"), None)
            time.sleep(0.05)
        assert trig_mid is not None
        deadline = time.monotonic() + 30
        while trig_mid not in eng._patch.order and time.monotonic() < deadline:
            time.sleep(0.1)
        assert trig_mid in eng._patch.order, "the rebuild was never adopted"
        n_before = len(captured)
        deadline = time.monotonic() + 10
        while len(captured) <= n_before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(captured) > n_before, "engine stalled after the edit"
        assert eng._thread.is_alive()
    finally:
        eng.stop()
    assert not eng._thread.is_alive()
    ws_j, *_ = template(jp, JaxWorkspace)
    patch = jax_compile_patch(ws_j, CFG_J, JaxBlockSpec(6))
    for t0, taps in (captured[0], captured[-1]):
        _, want = patch.run(patch.prepare_aux(ws_j), patch.host_aux(t0), patch.init_state(ws_j))
        key = str(m.value)
        for g, w in zip(taps[key]["audio"], want[key]["audio"]):
            np.testing.assert_allclose(g, N_STEMS * np.asarray(w), rtol=0,
                                       atol=N_STEMS * ATOL_SIN)
