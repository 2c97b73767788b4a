"""The port's fleet (``mixlab_tpu_torch/parallel/fleet.py``) against the JAX
package's ``mixlab_tpu.parallel.fleet.Fleet`` on the CPU: the four cases of
``tests/test_fleet.py``, the stacked host arrays, the flagship at 48 kHz in
the fleet's 15-tick blocks with per-instance params over carried blocks
(both fleets start from the same state, carried by ``convert.py``), every
slot against the port's own single-patch render, the batched twins of the
eq and envelope kernels against their single twins, and a 16-tick case where
both fleets take their region programs."""

import json

import jax
import numpy as np
import pytest
import torch

from bench import build_16_module_graph as jax_flagship
from mixlab_tpu import protocol as jp
from mixlab_tpu.engine.config import BlockSpec as JaxBlockSpec
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.parallel.fleet import Fleet as JaxFleet
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.convert import (
    fleet_from_jax,
    fleet_to_numpy,
    to_numpy,
    tree_leaves,
    tree_map,
)
from mixlab_tpu_torch.dsp.audio import _frac
from mixlab_tpu_torch.dsp.base import interleave_tap
from mixlab_tpu_torch.dsp.envelope_cuda import (
    envelope_block_torch,
    envelope_block_torch_batched,
)
from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_torch, eq_cascade_torch_batched
from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.parallel import make_mesh
from mixlab_tpu_torch.parallel.fleet import Fleet, instance_params
from mixlab_tpu_torch.protocol import InputId, OutputId

CPU = torch.device("cpu")
CFG44 = EngineConfig(sample_rate=44_100)
CFG48 = EngineConfig(sample_rate=48_000)
CFG48_J = JaxEngineConfig(sample_rate=48_000)
# the Monitor taps against the JAX package: one ulp of FmSine's f32 phase
# argument, as tests/test_torch_flagship.py:TAP_ATOL (XLA fuses the phase)
TAP_ATOL = 2.0 ** -11
STATE_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_flagship.py
REGION_ATOL = 2e-5  # tests/test_pallas_graph.py:85


def patch_ws(freq=440.0, amp=0.5):
    ws = Workspace()
    o = ws.create_module(p.ModuleParams("Oscillator", p.OscillatorParams(freq, p.Waveform.SINE)))
    a = ws.create_module(p.ModuleParams("Amplifier", p.AmplifierParams(amplitude=amp)))
    m = ws.create_module(p.ModuleParams("Monitor", None))
    ws.connect(InputId(a, 0), OutputId(o, 1))
    ws.connect(InputId(m, 1), OutputId(a, 0))
    return ws, m


def _port(ws_j) -> Workspace:
    return Workspace.from_persist(json.loads(json.dumps(ws_j.to_persist())))


def jax_instances(n):
    """n flagship workspaces (JAX) with their own continuous params: the
    oscillators, amplifiers, FM range, envelope and EQ gains differ."""
    out = []
    for i in range(n):
        ws, _ = jax_flagship()
        for j in range(4):
            ws.update_params(jp.ModuleId(3 + j), jp.ModuleParams(
                "Oscillator", jp.OscillatorParams(110.0 * (j + 1) * (1 + 0.07 * i),
                                                  jp.Waveform.SINE)))
            ws.update_params(jp.ModuleId(8 + j), jp.ModuleParams(
                "Amplifier", jp.AmplifierParams(amplitude=0.5 - 0.05 * i,
                                                mod_depth=0.3 + 0.1 * i)))
        ws.update_params(jp.ModuleId(7), jp.ModuleParams(
            "FmSine", jp.FmSineParams(440.0 + 20 * i, 880.0 - 30 * i)))
        ws.update_params(jp.ModuleId(2), jp.ModuleParams(
            "Envelope", jp.EnvelopeParams(attack_ms=10.0 + 5 * i, decay_ms=50.0 + 10 * i,
                                          sustain_amplitude=0.6 - 0.1 * i,
                                          release_ms=100.0)))
        ws.update_params(jp.ModuleId(12), jp.ModuleParams(
            "EqThree", jp.EqThreeParams(jp.Decibel(4.0 - i), jp.Decibel(0.5 * i),
                                        jp.Decibel(4.0 + i))))
        out.append(ws)
    return out


# -- tests/test_fleet.py's cases ----------------------------------------------


def test_fleet_renders_per_instance_params():
    base, mon = patch_ws()
    freqs = [220.0, 440.0, 660.0, 880.0]
    fleet = Fleet.build(base, n=4, cfg=CFG44, block=BlockSpec(2),
                        per_instance_params=[patch_ws(f)[0] for f in freqs], device="cpu")
    audio = interleave_tap(fleet.run_block(0)[str(mon.value)]["audio"])
    assert audio.shape[0] == 4
    S = 2 * CFG44.samples_per_tick
    for i, f in enumerate(freqs):
        spec = np.abs(np.fft.rfft(audio[i].reshape(S, 2)[:, 0]))
        assert abs(np.argmax(spec) * CFG44.sample_rate / S - f) < 40


def test_fleet_instance_aux_update_no_structure_change():
    base, mon = patch_ws(440.0, 0.5)
    fleet = Fleet.build(base, n=3, cfg=CFG44, block=BlockSpec(1), device="cpu")
    fleet.update_instance_aux(1, patch_ws(440.0, 0.0)[0])
    audio = interleave_tap(fleet.run_block(0)[str(mon.value)]["audio"])
    assert np.abs(audio[0]).max() > 0.4
    assert np.abs(audio[1]).max() == 0.0  # muted instance
    assert np.abs(audio[2]).max() > 0.4


def test_fleet_rejects_mismatched_structure():
    base, _ = patch_ws()
    other = Workspace()
    other.create_module(p.ModuleParams("Trigger", p.GateState.OPEN))
    with pytest.raises(ValueError, match="structural fingerprint"):
        Fleet.build(base, n=2, cfg=CFG44, per_instance_params=[base, other], device="cpu")
    fleet = Fleet.build(base, n=2, cfg=CFG44, device="cpu")
    square = patch_ws()[0]
    square.update_params(p.ModuleId(1), p.ModuleParams(
        "Oscillator", p.OscillatorParams(440.0, p.Waveform.SQUARE)))
    with pytest.raises(ValueError, match="structural fingerprint"):
        fleet.update_instance_aux(0, square)


@pytest.mark.parametrize("where", ["mesh", "devices"])
def test_fleet_refuses_several_devices(where):
    """Once a refusal, now the sharded fleet (tests/test_fleet.py:68-75):
    8 instances over 4 shards (a ``Mesh``, or a device list) give every
    instance's taps exactly as the one-device fleet, in instance order; an
    edit and a state reset land on the instance's own shard."""
    base, mon = patch_ws()
    kw = ({"mesh": make_mesh(4, axis="fleet", devices=["cpu"])} if where == "mesh"
          else {"mesh": ["cpu"] * 4})
    freqs = [110.0 * (i + 1) for i in range(8)]
    inst = [patch_ws(f)[0] for f in freqs]
    fleet = Fleet.build(base, n=8, cfg=CFG44, per_instance_params=inst, **kw)
    one = Fleet.build(base, n=8, cfg=CFG44, per_instance_params=inst, device="cpu")
    assert [(sh.lo, sh.hi) for sh in fleet.shards] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    for f in (fleet, one):
        f.update_instance_aux(5, patch_ws(440.0, 0.0)[0])
        f.run_block(0)
        f.reset_instance_state(5, base)
    assert fleet._dev_aux[2] is not None
    for t0 in (735, 1470):
        got = to_numpy(fleet.run_block(t0))[str(mon.value)]["audio"]
        want = to_numpy(one.run_block(t0))[str(mon.value)]["audio"]
        for g, w in zip(got, want):
            assert g.shape == (8, 1, 735) and np.array_equal(g, w)
        assert np.abs(got[0][5]).max() == 0.0 and np.abs(got[0][4]).max() > 0.4


# -- against the JAX fleet -----------------------------------------------------


def _assert_host_aux_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k] is None) == (want[k] is None), k
        for name, w in (want[k] or {}).items():
            g = got[k][name]
            assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w)), \
                (k, name)


_DAY = 86_400 * 48_000  # samples at 48 kHz


@pytest.mark.parametrize("blocks", [0, 7, "day"])
@pytest.mark.parametrize("ticks", [15, 16])
@pytest.mark.parametrize("per_instance", [False, True])
def test_host_aux_equals_jax(per_instance, ticks, blocks):
    """The stacked host arrays of a block, exactly (the oscillators' and the
    FmSine's phase bases from the fleet's host columns, a broadcast or a
    loop for the rest), at the session's start, 7 blocks in and a day in
    (rounded to a block), in both of the fleet's block sizes."""
    n = 3
    spb = ticks * CFG48.samples_per_tick
    t0 = _DAY // spb * spb if blocks == "day" else blocks * spb
    ws_j = jax_instances(n)
    kw_j = {"per_instance_params": ws_j} if per_instance else {}
    kw = {"per_instance_params": [_port(w) for w in ws_j]} if per_instance else {}
    fj = JaxFleet.build(ws_j[0], n, CFG48_J, JaxBlockSpec(ticks), **kw_j)
    fp = Fleet.build(_port(ws_j[0]), n, CFG48, BlockSpec(ticks), device="cpu", **kw)
    _assert_host_aux_equal(fp.host_aux(t0), fj.host_aux(t0))


_FRAC_CASES = {
    "seeded_1e9": np.random.default_rng(21).uniform(-1e9, 1e9, 100_000),
    "tiny_negative": -np.array([5e-324, 1e-300, 1e-20, 2.0 ** -60, 1e-17, 2.0 ** -53]),
    "zeros": np.array([0.0, -0.0]),
    "2_52_half": np.array([2.0 ** 52 + 0.5, 2.0 ** 52 - 0.5, -(2.0 ** 52 + 0.5),
                           -(2.0 ** 52 - 0.5)]),
    "1e300": np.array([1e300, -1e300]),
}


@pytest.mark.parametrize("case", sorted(_FRAC_CASES))
def test_frac_equals_mod(case):
    """The phase bases' fractional part, ``x - floor(x)``, is
    ``np.mod(x, 1.0)`` bit for bit, in float64 and after the float32 cast."""
    x = _FRAC_CASES[case]
    got, want = _frac(x), np.mod(x, 1.0)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert np.array_equal(got.astype(np.float32).view(np.uint32),
                          want.astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("kind", ["Oscillator", "FmSine"])
def test_host_prepare_columns_equals_single_instance(kind):
    """The fleet's form of the phase bases, over more instances than one pass
    of ``_bases`` takes and a day into the session, equals each instance's
    own ``host_prepare`` (the engine's and the render's form) bit for bit."""
    from mixlab_tpu_torch.dsp import audio

    n = 2 * audio._ROWS + 5
    rng = np.random.default_rng(7)
    if kind == "Oscillator":
        d = audio.OscillatorDef()
        plist = [p.OscillatorParams(float(f), p.Waveform.SINE) for f in rng.uniform(20, 2e4, n)]
    else:
        d = audio.FmSineDef()
        plist = [p.FmSineParams(float(lo), float(lo + w))
                 for lo, w in zip(rng.uniform(20, 2e3, n), rng.uniform(0, 2e3, n))]
    block = BlockSpec(16)
    spb = block.n_samples(CFG48)
    t0 = _DAY // spb * spb
    got = d.host_prepare_columns(d.host_columns(plist), t0, block, CFG48)
    for name, g in got.items():
        want = np.stack([d.host_prepare(q, t0, block, CFG48)[name] for q in plist])
        assert g.dtype == want.dtype and np.array_equal(g, want), name


def test_host_columns_follow_every_edit():
    """The fleet's host columns follow each row written: three sessions'
    params (``update_instance_aux``) and one slot back to the template
    (``set_instance_row``, as ``FleetEngine``'s leave path).  After 3 blocks
    the host arrays equal those of a fleet built from the same params, and
    the JAX fleet's; the columns were built once, never a block."""
    n = 4
    ws_j = jax_instances(n)
    ws_t = [_port(w) for w in ws_j]
    block = BlockSpec(15)
    fleet = Fleet.build(ws_t[0], n, CFG48, block, device="cpu")
    assert fleet.host_column_stats() == {"builds": 1, "row_writes": 0}
    template_row = tree_map(lambda x: x[0].copy(), fleet.aux)
    template_params = instance_params(fleet.patch)
    for i in (1, 2, 3):
        fleet.update_instance_aux(i, ws_t[i])
    fleet.set_instance_row(2, template_row, template_params)
    spb = block.n_samples(CFG48)
    for b in range(3):
        fleet.run_block(b * spb)
    assert fleet.host_column_stats() == {"builds": 1, "row_writes": 4}
    now = [ws_t[0], ws_t[1], ws_t[0], ws_t[3]]
    fresh = Fleet.build(ws_t[0], n, CFG48, block, per_instance_params=now, device="cpu")
    fj = JaxFleet.build(ws_j[0], n, CFG48_J, JaxBlockSpec(15),
                        per_instance_params=[ws_j[0], ws_j[1], ws_j[0], ws_j[3]])
    t0 = 3 * spb
    got = fleet.host_aux(t0)
    _assert_host_aux_equal(got, fresh.host_aux(t0))
    _assert_host_aux_equal(got, fj.host_aux(t0))
    assert not np.array_equal(got["3"]["base"][1], got["3"]["base"][2])  # an edit shows
    for g, w in zip(tree_leaves(fleet.aux), tree_leaves(fresh.aux)):
        assert np.array_equal(g, w)
    assert fleet.host_column_stats() == {"builds": 1, "row_writes": 4}


@pytest.fixture(scope="module")
def flagship_fleets():
    """The JAX and port fleets of the flagship at 48 kHz, 15-tick blocks,
    N = 3 per-instance params, the port started from the JAX fleet's aux and
    state, both run 2 carried blocks."""
    n = 3
    ws_j = jax_instances(n)
    ws_t = [_port(w) for w in ws_j]
    fj = JaxFleet.build(ws_j[0], n, CFG48_J, JaxBlockSpec(15), per_instance_params=ws_j)
    fp = Fleet.build(ws_t[0], n, CFG48, BlockSpec(15), per_instance_params=ws_t,
                     device="cpu")
    fleet_from_jax(fj, fp)
    spb = 15 * CFG48.samples_per_tick
    taps_j = [jax.tree.map(np.asarray, fj.run_block(b * spb)) for b in range(2)]
    taps_t = [to_numpy(fp.run_block(b * spb)) for b in range(2)]
    return ws_t, fj, fp, taps_j, taps_t


def test_flagship_fleet_matches_jax(flagship_fleets):
    ws_t, fj, fp, taps_j, taps_t = flagship_fleets
    key = "16"
    for got, want in zip(taps_t, taps_j):
        for g, w in zip(got[key]["audio"], want[key]["audio"]):
            assert g.shape == w.shape == (3, 15, 800)
            np.testing.assert_allclose(g, w, rtol=0, atol=TAP_ATOL)
        assert np.abs(got[key]["audio"][0]).max() > 0.3
    aux_t, state_t = fleet_to_numpy(fp)
    aux_j, state_j = fleet_to_numpy(fj)
    for g, w in zip(tree_leaves(state_t), tree_leaves(state_j)):
        assert g.shape == w.shape
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **STATE_TOL)
    for g, w in zip(tree_leaves(aux_t), tree_leaves(aux_j)):
        assert np.array_equal(g, w)


def test_flagship_fleet_slots_equal_single_renders(flagship_fleets):
    """Every slot EXACTLY equals the port's own single-patch render of its
    params (the batched program is the regular program under vmap)."""
    ws_t, fj, fp, taps_j, taps_t = flagship_fleets
    spb = 15 * CFG48.samples_per_tick
    for i, ws in enumerate(ws_t):
        patch = compile_patch(ws, CFG48, BlockSpec(15), CPU, mega=False)
        aux, state = patch.prepare_aux(ws), patch.init_state(ws)
        for b in range(2):
            state, taps = patch.run(aux, patch.host_aux(b * spb), state)
            for g, w in zip(taps_t[b]["16"]["audio"], to_numpy(taps)["16"]["audio"]):
                assert np.array_equal(g[i], w), (i, b)


def test_region_blocks_match_jax_region_program(monkeypatch):
    """At 16 ticks (12,800 samples, a multiple of 128) the JAX fleet takes
    its region program under vmap, and so does the port's: its batched
    program is the region program under ``torch.func.vmap``, the region's
    batched twin called once a part (one part a block), and it agrees within
    REGION_ATOL.  The JAX fleet's program runs unjitted here (op by op, the
    region in Pallas interpret mode), as tests/test_torch_region.py runs it:
    jitted, XLA's fused FmSine phase alone moves the taps by up to
    TAP_ATOL."""
    from mixlab_tpu_torch.engine import region_cuda

    n = 2
    ws_j = jax_instances(n)
    fj = JaxFleet.build(ws_j[0], n, CFG48_J, JaxBlockSpec(16), per_instance_params=ws_j)
    assert fj.patch._mega
    fp = Fleet.build(_port(ws_j[0]), n, CFG48, BlockSpec(16),
                     per_instance_params=[_port(w) for w in ws_j], device="cpu")
    assert fp.patch._mega
    fleet_from_jax(fj, fp)
    parts = []
    real = region_cuda.region_part_torch_batched
    monkeypatch.setattr(region_cuda, "region_part_torch_batched",
                        lambda *a: parts.append(a[-1]) or real(*a))
    program, state_j = jax.vmap(fj.patch._fn), fj.state
    spb = 16 * CFG48.samples_per_tick
    for b in range(2):
        state_j, want = program(fj.aux, fj.host_aux(b * spb), state_j)
        got = to_numpy(fp.run_block(b * spb))
        for g, w in zip(got["16"]["audio"], want["16"]["audio"]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=REGION_ATOL)
    assert parts == [n, n]  # one part a block, every session in one call
    for g, w in zip(tree_leaves(fleet_to_numpy(fp)[1]),
                    tree_leaves(jax.tree.map(np.asarray, state_j))):
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=0,
                                   atol=REGION_ATOL)


# -- the kernels' batched twins --------------------------------------------------


@pytest.mark.parametrize("B,S", [(1, 12_000), (3, 12_000), (4, 8_192), (2, 735)])
def test_batched_eq_twin_equals_single(B, S):
    rng = np.random.default_rng(B * S)
    t = lambda *shape, lo=-1.0, hi=1.0: torch.from_numpy(
        rng.uniform(lo, hi, shape).astype(np.float32))
    x, xd, poles, gains = t(B, S), t(B, S), t(B, 4, 2, lo=-0.1, hi=0.1), t(B, 3, lo=0.5, hi=2)
    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    out, po = eq_cascade_torch_batched(x, xd, poles, gains, *f)
    for i in range(B):
        o1, p1 = eq_cascade_torch(x[i], xd[i], poles[i], gains[i], *f)
        assert torch.equal(out[i], o1) and torch.equal(po[i], p1)


@pytest.mark.parametrize("B,S", [(1, 32_768), (3, 12_000), (4, 48_000)])
def test_batched_envelope_twin_equals_single(B, S):
    rng = np.random.default_rng(B + S)
    x = np.full((B, S), 0.5, np.float32)
    for i in range(B):  # gates: dense toggles, sparse edges, open
        edges = np.sort(rng.choice(S, size=(i + 1) * 7, replace=False))
        for j, e in enumerate(edges):
            x[i, e] = float(j % 2 == 0)
    x = torch.from_numpy(x)
    state = {"mode_on": torch.tensor([True, False, True, False][:B]),
             "on_pos": torch.tensor([-5, -(2**30), -100, 0][:B], dtype=torch.int32),
             "off_pos": torch.tensor([-(2**30), -7, -3, -(2**30)][:B], dtype=torch.int32),
             "off_amp": torch.tensor([0.0, 0.7, 0.2, 0.0][:B])}
    params = {"attack_ms": torch.tensor([10.0, 0.0, 3.0, 50.0][:B]),
              "decay_ms": torch.tensor([50.0, 20.0, 0.0, 5.0][:B]),
              "sustain_amplitude": torch.tensor([0.6, 0.3, 1.0, 0.0][:B]),
              "release_ms": torch.tensor([100.0, 0.0, 40.0, 10.0][:B])}
    out, st = envelope_block_torch_batched(x, state, params, 1000.0 / 48_000)
    for i in range(B):
        o1, s1 = envelope_block_torch(x[i], {k: v[i] for k, v in state.items()},
                                      {k: v[i] for k, v in params.items()}, 1000.0 / 48_000)
        torch.testing.assert_close(out[i], o1, rtol=0, atol=0, equal_nan=True)  # NaN == NaN
        for k in s1:
            assert torch.equal(st[k][i], s1[k]), k


@pytest.mark.parametrize("ticks,want_calls", [
    (41, {"eq": 1, "envelope": 1}),
    (15, {"eq": 1, "envelope": 1}),
    (16, {"eq": 0, "envelope": 1}),  # the region program folds the eq
])
def test_offline_sized_fleet_block_goes_through_both_batched_wrappers(monkeypatch, ticks,
                                                                    want_calls):
    """The batched program reaches the wrappers' custom ops, each once a
    block for all sessions, at any length: at 41 ticks (32,800 samples, over
    the single block's gates) and at the fleet server's 15 and 16 ticks (a
    batch takes the envelope's kernel below its single-block gate); every
    slot still equals its single render on the program the fleet chose."""
    from mixlab_tpu_torch.dsp import envelope_cuda, eq_cuda

    calls = {"eq": 0, "envelope": 0}
    for mod, name, key in ((eq_cuda, "eq_cascade_batched", "eq"),
                           (envelope_cuda, "envelope_block_batched", "envelope")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(mod, name, counted)
    ws_t = [_port(w) for w in jax_instances(2)]
    block = BlockSpec(ticks)
    fleet = Fleet.build(ws_t[0], 2, CFG48, block, per_instance_params=ws_t, device="cpu")
    taps = to_numpy(fleet.run_block(0))
    assert calls == want_calls
    for i, ws in enumerate(ws_t):
        patch = compile_patch(ws, CFG48, block, CPU)
        _, want = patch.run(patch.prepare_aux(ws), patch.host_aux(0), patch.init_state(ws))
        for g, w in zip(taps["16"]["audio"], to_numpy(want)["16"]["audio"]):
            assert np.array_equal(g[i], w)
