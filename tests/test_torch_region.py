"""The port's whole-graph region program (``engine/region_graph.py`` and the
plain twin of its kernel, ``engine/region_cuda.py:region_part_torch``)
against the JAX package's mega program (``mixlab_tpu/engine/pallas_graph.py``,
its Pallas kernel in interpret mode) and against the port's own regular
program, and the JAX package's region tests mirrored on the port.

48 kHz with 16-tick blocks: 12,800 samples, 100 chunks of 128.  The JAX
programs run with ``jit=False``: the port evaluates the prelude op by op, and
XLA's fused evaluation of FmSine's f32 phase rounds differently (see
``tests/test_torch_flagship.py``), which would hide the region behind it.
"""

import json

import numpy as np
import pytest
import torch

import bench
from mixlab_tpu.engine import pallas_graph
from mixlab_tpu.engine.compiler import compile_patch as jax_compile_patch
from mixlab_tpu.engine.config import BlockSpec as JaxBlockSpec
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu_torch.dsp.base import OP_NAMES, OP_PEAK, OP_SYNC, RegionPlan
from mixlab_tpu_torch.engine import region_cuda, region_graph
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from test_pallas_graph import _sink_zoo
from torch_support import sink_zoo

CPU = torch.device("cpu")
CFG = EngineConfig(sample_rate=48_000)
CFG_J = JaxEngineConfig(sample_rate=48_000)
TICKS = 16  # 12,800 samples
ATOL = 2e-5  # tests/test_pallas_graph.py:85


def _port(ws_j) -> Workspace:
    """The JAX package's workspace, saved and read back by the port."""
    return Workspace.from_persist(json.loads(json.dumps(ws_j.to_persist())))


def _graph(name):
    """(JAX workspace, port workspace, ext_feeds per block) for one graph."""
    if name == "flagship":
        ws_j = bench.build_16_module_graph()[0]
    elif name == "config2":
        ws_j = bench.build_config2_graph()[0]
    else:
        # built in each package: its OutputDevice has no params, which no
        # project file can hold
        ws_j, si = _sink_zoo()
        ws_t, si_t = sink_zoo()
        assert si_t.value == si.value
        rng = np.random.default_rng(7)
        spb = JaxBlockSpec(TICKS).n_samples(CFG_J)
        feeds = {i: {str(si.value): {"pcm": rng.integers(-32768, 32767, (2, spb))
                                     .astype(np.int16)}} for i in range(3)}
        return ws_j, ws_t, feeds
    return ws_j, _port(ws_j), None


def _run(patch, ws, n_blocks, ext_feeds=None):
    """tests/test_pallas_graph.py:_run (both packages share the API)."""
    aux = patch.prepare_aux(ws)
    state = patch.init_state(ws)
    spb = patch.block.n_samples(patch.cfg)
    taps_out = []
    for i in range(n_blocks):
        ha = patch.host_aux(i * spb, ext_feeds=(ext_feeds or {}).get(i))
        state, taps = patch.run(aux, ha, state)
        taps_out.append(taps)
    return state, taps_out


def _leaves(tree, path=""):
    """(path, numpy array) for every array of a state / taps tree of either
    package; None subtrees hold nothing."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree.detach().cpu().numpy()
    elif tree is not None:
        yield path, np.asarray(tree)


def _assert_tree_close(got, want, atol, what):
    lg, lw = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in lg] == [k for k, _ in lw], what
    for (k, g), (_, w) in zip(lg, lw):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


class _CountParts:
    """Counts the region program's part launches (the twin runs them on the
    CPU, so the kernel's own counter stays put)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = region_cuda.region_part_cuda

        def counted(*args):
            self.n += 1
            return real(*args)

        monkeypatch.setattr(region_cuda, "region_part_cuda", counted)


CASES = {  # name -> (graph, MAX_LAUNCH_S of both packages, parts per block)
    "flagship_single_part": ("flagship", None, 1),
    "flagship_multi_part": ("flagship", 4096, 4),
    "sink_zoo": ("sink_zoo", None, 1),
}


def _setup(case, monkeypatch):
    graph, max_s, parts = CASES[case]
    if max_s is not None:
        monkeypatch.setattr(pallas_graph, "MAX_LAUNCH_S", max_s)
        monkeypatch.setattr(region_graph, "MAX_LAUNCH_S", max_s)
    return _graph(graph) + (parts,)


@pytest.mark.parametrize("case", list(CASES))
def test_region_twin_matches_jax_mega_program(case, monkeypatch):
    """3 carried blocks: taps and state of the port's region program (the
    twin on the CPU) against the JAX mega program, structure and dtypes
    equal, values at the JAX test's own tolerance."""
    ws_j, ws_t, feeds, parts = _setup(case, monkeypatch)
    pj = jax_compile_patch(ws_j, CFG_J, JaxBlockSpec(TICKS), jit=False, mega=True)
    pt = compile_patch(ws_t, CFG, BlockSpec(TICKS), CPU, mega=True)
    assert pj._mega and pt._mega
    count = _CountParts(monkeypatch)
    sj, tj = _run(pj, ws_j, 3, feeds)
    st, tt = _run(pt, ws_t, 3, feeds)
    assert count.n == 3 * parts
    _assert_tree_close(st, sj, ATOL, "state")
    for i, (a, b) in enumerate(zip(tt, tj)):
        _assert_tree_close(a, b, ATOL, f"taps[{i}]")


@pytest.mark.parametrize("case", list(CASES))
def test_region_program_matches_regular_program(case, monkeypatch):
    """The port's two programs on the same graph: drop-in equal."""
    _, ws, feeds, _ = _setup(case, monkeypatch)
    pr = compile_patch(ws, CFG, BlockSpec(TICKS), CPU, mega=False)
    pm = compile_patch(ws, CFG, BlockSpec(TICKS), CPU, mega=True)
    assert pm._mega and not pr._mega
    sr, tr = _run(pr, ws, 3, feeds)
    sm, tm = _run(pm, ws, 3, feeds)
    _assert_tree_close(sm, sr, ATOL, "state")
    for i, (a, b) in enumerate(zip(tm, tr)):
        _assert_tree_close(a, b, ATOL, f"taps[{i}]")


# -- the JAX package's region tests, mirrored -------------------------------


@pytest.mark.parametrize("graph", ["flagship", "sink_zoo"])
def test_selected_region_matches_jax(graph):
    """Same modules in and out of the region as the JAX package picks; on
    the flagship the prelude is the trigger, envelope, oscillators and fm
    and the four amplifiers are absorbed (test_pallas_graph.py:154-171)."""
    ws_j, ws_t, _, = _graph(graph)
    sel = {}
    for pkg, ws, cfg, block in (
            (pallas_graph, ws_j, CFG_J, JaxBlockSpec(64)),
            (region_graph, ws_t, CFG, BlockSpec(64))):
        order = ws.run_order()
        entries = {m: ws.modules[m] for m in order}
        got = pkg._select_region(order, entries, dict(ws.connections), cfg, block)
        assert got is not None
        region, specs = got
        assert set(specs) == region
        sel[pkg] = (sorted(m.value for m in region),
                    sorted(entries[m].params.kind for m in order if m not in region))
    assert sel[region_graph] == sel[pallas_graph]
    if graph == "flagship":
        ws = ws_t
        kinds_in = sorted(ws.modules[m].params.kind
                          for m in ws.modules if m.value in sel[region_graph][0])
        assert sel[region_graph][1] == ["Envelope", "FmSine", "Oscillator", "Oscillator",
                                        "Oscillator", "Oscillator", "Trigger"]
        assert kinds_in.count("Amplifier") == 4 and "EqThree" in kinds_in


ENGAGE = [  # (graph, sample rate, ticks)
    ("flagship", 48_000, 4),    # 3,200 samples < MIN_S
    ("flagship", 48_000, 13),   # 10,400: not whole chunks
    ("flagship", 48_000, 16),   # 12,800 = 100 chunks
    ("flagship", 48_000, 60),   # 48,000 = 375 chunks: the CLI at 48 kHz
    ("flagship", 48_000, 64),
    ("flagship", 44_100, 60),   # the CLI's default: 44,100 % 128 != 0
    ("flagship", 44_100, 128),  # 94,080 = 735 chunks
    ("flagship", 48_000, 300),  # two parts
    ("sink_zoo", 48_000, 16),
    ("sink_zoo", 48_000, 13),
    ("config2", 48_000, 64),    # no EqThree
    ("config2", 48_000, 60),
]


@pytest.mark.parametrize("graph,rate,ticks", ENGAGE,
                         ids=[f"{g}-{r}-{t}" for g, r, t in ENGAGE])
def test_engages_where_jax_does(graph, rate, ticks):
    """``build_mega_program`` and ``compile_patch`` engage, refuse and
    disengage on exactly the graphs and blocks the JAX package's do."""
    ws_j, ws_t, _ = _graph(graph)
    cfg_j, cfg = JaxEngineConfig(sample_rate=rate), EngineConfig(sample_rate=rate)
    want = pallas_graph.build_mega_program(ws_j, cfg_j, JaxBlockSpec(ticks)) is not None
    got = region_graph.build_mega_program(ws_t, cfg, BlockSpec(ticks), CPU) is not None
    assert got == want
    assert compile_patch(ws_t, cfg, BlockSpec(ticks), CPU)._mega == want
    assert not compile_patch(ws_t, cfg, BlockSpec(ticks), CPU, mega=False)._mega
    if want:
        assert compile_patch(ws_t, cfg, BlockSpec(ticks), CPU, mega=True)._mega
    else:
        with pytest.raises(ValueError):
            compile_patch(ws_t, cfg, BlockSpec(ticks), CPU, mega=True)
    if graph == "flagship" and (rate, ticks) == (48_000, 60):
        assert want  # the slice's main path runs the region


@pytest.mark.parametrize("S,max_s", [
    (8192, None), (12_800, None), (48_000, None), (196_608, None), (196_736, None),
    (240_000, None), (480_000, None), (12_800, 4096), (51_200, 16_384), (8064, None),
    (44_100, None), (1_000_064, 65_536),
])
def test_partition_matches_jax(S, max_s, monkeypatch):
    if max_s is not None:
        monkeypatch.setattr(pallas_graph, "MAX_LAUNCH_S", max_s)
        monkeypatch.setattr(region_graph, "MAX_LAUNCH_S", max_s)
    assert region_graph._partition(S) == pallas_graph._partition(S)
    assert (region_graph.MIN_S, region_graph.ALIGN_S) == (pallas_graph.MIN_S,
                                                          pallas_graph.ALIGN_S)


@pytest.mark.parametrize("feed", ["stream_input", "zero_filled"])
def test_clip_tap_is_bool(feed):
    """The output device's clip flag leaves the region as the regular
    program's bool (test_pallas_graph.py:119-125), with the same value: any
    |sample| of its audio above 1."""
    _, ws, feeds, = _graph("sink_zoo")
    if feed == "zero_filled":
        feeds = None  # host_aux zero-fills the StreamInput
    flags = {}
    for mega in (True, False):
        patch = compile_patch(ws, CFG, BlockSpec(TICKS), CPU, mega=mega)
        _, taps = _run(patch, ws, 1, feeds)
        (out,) = [v for v in taps[0].values() if "clip" in v]
        assert out["clip"].dtype == torch.bool and out["clip"].dim() == 0
        flags[mega] = bool(out["clip"])
        assert flags[mega] == bool(max(c.abs().max() for c in out["audio"]) > 1.0)
    assert flags[True] == flags[False]


def test_flagship_plan():
    """The flagship's region as a plan: one EQ (its grid barrier inside the
    op: each CTA reads only its own chunks but the EQ's 3-sample halo), the
    four absorbed amplifiers as modulated amps (each one op: its L is its R),
    the mixer's master as one mix per channel (its cue bus is read by
    nothing, so not computed), the Monitor's stereo tap."""
    ws = _port(bench.build_16_module_graph()[0])
    patch = compile_patch(ws, CFG, BlockSpec(TICKS), CPU)
    plans = []
    real = region_cuda.region_part_cuda
    region_cuda.region_part_cuda = lambda plan, *a: plans.append(plan) or real(plan, *a)
    try:
        _run(patch, ws, 1)
    finally:
        region_cuda.region_part_cuda = real
    (plan,) = plans
    names = [OP_NAMES[code] for code, _ in plan.ops()]
    assert names == ["AMP_MOD"] * 4 + ["EQ", "MIX", "MIX", "TAP", "TAP"]
    assert plan.n_operands == 6  # 4 oscillators, fm, envelope: deduplicated
    assert (plan.n_taps, plan.n_stap, plan.n_ef) == (2, 0, 11)


def _one_op_plan(code, *args, n_operands=2):
    plan = RegionPlan(n_operands, n_pf=0, n_ef=0)
    plan.add(code, *args)
    return plan


def test_twin_peak_lets_nan_through_and_takes_the_largest_magnitude():
    plan = _one_op_plan(OP_PEAK, 0, 0, 1)
    assert [OP_NAMES[c] for c, _ in plan.ops()] == ["SYNC", "PEAK"]
    plan.n_stap = 1
    l = torch.tensor([0.5, -3.0] + [0.0] * 126)
    r = torch.tensor([2.0] + [0.0] * 127)
    _, stap, _ = region_cuda.region_part_cuda(plan, [l, r], torch.zeros(0), torch.zeros(0), 128)
    assert stap.tolist() == [3.0]
    l[5] = float("nan")
    _, stap, _ = region_cuda.region_part_cuda(plan, [l, r], torch.zeros(0), torch.zeros(0), 128)
    assert torch.isnan(stap).all()


def test_twin_refuses_an_unknown_op():
    plan = RegionPlan(0, n_pf=0, n_ef=0)
    plan.words += [99, 2]
    with pytest.raises(ValueError, match="unknown op"):
        region_cuda.region_part_torch(plan, [], torch.zeros(0), torch.zeros(0), 128)
    assert OP_SYNC == 0 and len(OP_NAMES) == 9
