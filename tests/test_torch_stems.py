"""Stems (``mixlab_tpu_torch/parallel/stems.py``) on the CPU: the mixdown
against n x the one-stem render (``tests/test_multichip.py``), against the
JAX ``stem_parallel_step`` on a 4-device virtual CPU mesh with uneven stem
counts (the port over a 4-entry CPU mesh pads to the same multiple), the
sharded step over a mesh against one device, ``StemsPatch`` through the
port's ``Engine(patch_compiler=...)`` over an 8-entry CPU mesh (``tests/
test_engine_multichip.py``), and ``row_sharded_blend`` against the crossfade
twin."""

import json

import numpy as np
import pytest
import torch

from bench import build_16_module_graph as jax_flagship
from mixlab_tpu.engine.config import BlockSpec as JaxBlockSpec
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.parallel.stems import make_mesh
from mixlab_tpu.parallel.stems import stem_parallel_step as jax_stem_parallel_step
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.dsp.base import interleave_tap
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.engine import Engine
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.flagship import build_16_module_graph
from mixlab_tpu_torch.parallel import make_mesh as torch_mesh
from mixlab_tpu_torch.parallel.stems import StemsPatch, row_sharded_blend, stem_parallel_step
from mixlab_tpu_torch.protocol import InputId, OutputId
from mixlab_tpu_torch.video.blend import crossfade_torch

CPU = torch.device("cpu")
CFG = EngineConfig(sample_rate=48_000)
MIX_ATOL = 2e-4  # tests/test_multichip.py:29
N_STEMS = 5


def _one_stem(ws, mon, block):
    p1 = compile_patch(ws, CFG, block, CPU)
    _, taps = p1.run(p1.prepare_aux(ws), p1.host_aux(0), p1.init_state(ws))
    return interleave_tap(taps[str(mon.value)]["audio"])


def test_stem_parallel_mixdown_matches_serial():
    ws, mon = build_16_module_graph()
    block = BlockSpec(2)
    fn, make_args, _ = stem_parallel_step(ws, CFG, block, str(mon.value), n_stems=4,
                                          device="cpu")
    _, master = fn(*make_args(0))
    np.testing.assert_allclose(master.numpy(), 4.0 * _one_stem(ws, mon, block), atol=MIX_ATOL)


@pytest.mark.parametrize("n_stems", [5, 9, 3, 1])
def test_stem_counts_match_jax_mesh(n_stems):
    """The JAX step over a 4-device mesh pads the stems to a multiple of 4
    and masks the pads; the port over a 4-entry CPU mesh pads to the same
    multiple, each shard's mask from its position."""
    ws_j, mon = jax_flagship()
    ws = Workspace.from_persist(json.loads(json.dumps(ws_j.to_persist())))
    fn_j, args_j, _ = jax_stem_parallel_step(
        ws_j, JaxEngineConfig(sample_rate=48_000), JaxBlockSpec(2), make_mesh(4),
        monitor_key=str(mon.value), n_stems=n_stems)
    fn, make_args, _ = stem_parallel_step(ws, CFG, BlockSpec(2), str(mon.value),
                                          n_stems=n_stems, mesh=torch_mesh(4, devices=["cpu"]))
    args, a_j = make_args(0), args_j(0)
    assert np.array_equal(torch.cat(args[3]).numpy(), np.asarray(a_j[3]))
    _, master = fn(*args)
    _, want = fn_j(*a_j)
    np.testing.assert_allclose(master.numpy(), np.asarray(want), atol=MIX_ATOL)
    np.testing.assert_allclose(master.numpy(), n_stems * _one_stem(ws, mon, BlockSpec(2)),
                               atol=MIX_ATOL)


def test_stems_refuse_a_mesh():
    """Once a refusal, now the sharded result: over a 2-entry mesh (the
    ``mesh=`` form and a device list) the master equals the one-device
    step's within MIX_ATOL, and the live StemsPatch's taps equal it too."""
    ws, mon = build_16_module_graph()
    fn, make_args, _ = stem_parallel_step(ws, CFG, BlockSpec(2), str(mon.value), n_stems=3,
                                          device="cpu")
    _, want = fn(*make_args(0))
    for kw in ({"mesh": torch_mesh(2, devices=["cpu"])}, {"mesh": ["cpu", "cpu"]}):
        fn2, make_args2, _ = stem_parallel_step(ws, CFG, BlockSpec(2), str(mon.value),
                                                n_stems=3, **kw)
        args = make_args2(0)
        assert [m.tolist() for m in args[3]] == [[1.0, 1.0], [1.0, 0.0]]
        _, got = fn2(*args)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MIX_ATOL)
    sp = StemsPatch.compiler(torch_mesh(2, devices=["cpu"]), 3)(ws, CFG, BlockSpec(2), CPU)
    _, taps = sp.run(sp.prepare_aux(ws), sp.host_aux(0), sp.init_state(ws))
    got = torch.stack(taps[str(mon.value)]["audio"], dim=-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MIX_ATOL)


def template():
    ws = Workspace()
    o = ws.create_module(p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)))
    a = ws.create_module(p.ModuleParams("Amplifier", p.AmplifierParams(amplitude=0.5)))
    m = ws.create_module(p.ModuleParams("Monitor", None))
    ws.connect(InputId(a, 0), OutputId(o, 1))
    ws.connect(InputId(m, 1), OutputId(a, 0))
    return ws, o, a, m


def capture_taps(eng):
    captured = []
    orig = eng._route_taps

    def wrapper(t0, S, taps, tick_buffers):
        captured.append((t0, taps))
        return orig(t0, S, taps, tick_buffers)

    eng._route_taps = wrapper
    return captured


def test_mixdown_tap_matches_single_engine():
    eng_multi = Engine(workspace=template()[0], cfg=CFG, block_ticks=2, device="cpu",
                       patch_compiler=StemsPatch.compiler(torch_mesh(8, devices=["cpu"]), N_STEMS))
    eng_single = Engine(workspace=template()[0], cfg=CFG, block_ticks=2, device="cpu")
    taps_m, taps_s = capture_taps(eng_multi), capture_taps(eng_single)
    for _ in range(3):
        eng_multi.tick_once()
        eng_single.tick_once()
    assert len(taps_m) == len(taps_s) == 3
    for (t0m, tm), (t0s, ts) in zip(taps_m, taps_s):
        assert t0m == t0s
        (key,) = tm.keys()
        for gm, gs in zip(tm[key]["audio"], ts[key]["audio"]):
            np.testing.assert_allclose(gm.numpy(), N_STEMS * gs.numpy(), rtol=1e-6, atol=1e-6)
        assert torch.any(tm[key]["audio"][0] != 0)


def test_structural_edit_mid_run_direct_drive():
    ws, o, a, m = template()
    eng = Engine(workspace=ws, cfg=CFG, block_ticks=2, device="cpu",
                 patch_compiler=StemsPatch.compiler(torch_mesh(8, devices=["cpu"]), N_STEMS))
    captured = capture_taps(eng)
    sid, _, _ = eng.connect_session()
    eng.tick_once()
    eng.client_update(sid, p.WorkspaceMessage(1, p.CreateModule(
        p.ModuleParams("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW)),
        p.WindowGeometry())))
    new_mid = max(eng.ws.modules, key=lambda mid: mid.value)
    eng.client_update(sid, p.WorkspaceMessage(2, p.CreateConnection(
        InputId(m, 1), OutputId(new_mid, 1))))
    eng.tick_once()
    assert len(captured) == 2
    (key,) = captured[1][1].keys()
    got = captured[1][1][key]["audio"][0].numpy()

    ws_ref, _, _, m_r = template()
    ws_ref.create_module(p.ModuleParams("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW)))
    new_ref = max(ws_ref.modules, key=lambda mid: mid.value)
    ws_ref.connect(InputId(m_r, 1), OutputId(new_ref, 1))
    ref = Engine(workspace=ws_ref, cfg=CFG, block_ticks=2, device="cpu")
    ref_taps = capture_taps(ref)
    ref.tick_once()
    ref.tick_once()
    (rkey,) = ref_taps[1][1].keys()
    want = ref_taps[1][1][rkey]["audio"][0].numpy()
    np.testing.assert_allclose(got, N_STEMS * want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("height", [127, 129, 64 + 17])
def test_row_sharded_blend_uneven_rows(height):
    rng = np.random.default_rng(height)
    a = rng.integers(0, 256, (height, 320), dtype=np.uint8)
    b = rng.integers(0, 256, (height, 320), dtype=np.uint8)
    blend = row_sharded_blend(device="cpu")
    for fade in (0, 37, 255):
        out = blend(a, b, fade)
        assert torch.equal(out, crossfade_torch(torch.from_numpy(a), torch.from_numpy(b), fade))
        want = ((a.astype(np.uint32) * fade + b.astype(np.uint32) * (255 - fade))
                // 255).astype(np.uint8)
        assert np.array_equal(out.numpy(), want)
