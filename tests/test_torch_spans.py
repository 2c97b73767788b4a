"""The port's spans (``mixlab_tpu_torch/spans.py``) on the CPU: off by
default (one shared no-op, nothing in a profile); on, each span of the fleet
server's block step (``server/fleet_serve.py``, ``parallel/fleet.py``, the
modules under ``torch.func.vmap``) and of the offline render
(``engine/render.py``, ``engine/compiler.py``) recorded the expected number
of times a block, nested in its callers; taps and state bit-identical with
the spans on and off."""

import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mixlab_tpu_torch import spans
from mixlab_tpu_torch.convert import tree_leaves
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.render import render
from mixlab_tpu_torch.flagship import build_16_module_graph
from mixlab_tpu_torch.server import fleet_serve
from mixlab_tpu_torch.server.fleet_serve import FleetEngine

ROOT = Path(__file__).resolve().parents[1]
CFG48 = EngineConfig(sample_rate=48_000)
PREFIX = "t:"
BLOCKS = 3
# the flagship's modules by kind (bench.py build_16_module_graph)
KINDS = {"Trigger": 1, "Envelope": 1, "Oscillator": 4, "FmSine": 1, "Amplifier": 4,
         "EqThree": 1, "StereoSplitter": 1, "StereoPanner": 1, "Mixer": 1, "Monitor": 1}
# the region program's prelude: the modules upstream of the EqThree's region
PRELUDE = {"Trigger": 1, "Envelope": 1, "Oscillator": 4, "FmSine": 1}


def _restore(prefix):
    """Put the spans back as another test in this process had them."""
    if prefix is None:
        spans.disable()
    else:
        spans.enable(prefix=prefix)


@pytest.fixture
def on():
    was = spans._prefix
    spans.enable(prefix=PREFIX)
    try:
        yield
    finally:
        _restore(was)


@pytest.fixture
def off():
    was = spans._prefix
    spans.disable()
    try:
        yield
    finally:
        _restore(was)


def recorded(fn):
    """``fn()`` under a CPU profile: its result, and each span's
    ``(start, end)`` in ns by name (the prefix taken off)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith(PREFIX):
            got[e.name()[len(PREFIX):]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, got


def inside(inner, outer):
    """Every interval of ``inner`` lies inside one of ``outer``."""
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_spans_are_off_by_default(off):
    fresh = subprocess.run([sys.executable, "-c", "from mixlab_tpu_torch import spans; "
                            "print(spans.enabled())"], cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    assert fresh.stdout.split()[-1] == "False", fresh.stderr[-2000:]
    first = spans.span("fleet.upload")
    assert spans.span("module.", "Oscillator") is first
    with first:
        pass

    def run():
        for name in ("fleet.upload", "render.collect"):
            with spans.span(name):
                pass

    _, got = recorded(run)
    assert not got


def test_on_spans_are_record_functions_and_off_again(on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(PREFIX + "outer"), spans.span("inner.", "Kind"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert sorted(names) == [PREFIX + "inner.Kind", PREFIX + "outer"]
    spans.disable()
    assert spans.span("x") is spans.span("y")


def _fleet(ticks):
    eng = FleetEngine(build_16_module_graph()[0], 8, CFG48, block_ticks=ticks, device="cpu")
    got = []
    eng._fan_out = lambda t0, taps: got.append((t0, taps))
    return eng, got


def _blocks(eng):
    for _ in range(BLOCKS):
        with record_function(PREFIX + "block"):
            eng._block_once()


@pytest.mark.parametrize("ticks", [16, 15])
def test_fleet_spans_once_a_block_nested_and_bit_identical(on, ticks):
    """16 ticks: the region program (its prelude's modules under vmap); 15:
    the regular program, every module under vmap."""
    off, off_taps = _fleet(ticks)
    spans.disable()
    _blocks(off)
    spans.enable(prefix=PREFIX)
    eng, taps = _fleet(ticks)
    assert eng.fleet.patch._mega == (ticks == 16)
    _, got = recorded(lambda: _blocks(eng))

    block = got["block"]
    assert len(block) == BLOCKS
    for name in ("fleet.reset", "fleet.upload", "fleet.dispatch", "fleet.gather",
                 "fleet.fetch_start"):
        assert len(got[name]) == BLOCKS, name
        assert inside(got[name], block), name
    assert len(got["fleet.fan_out"]) == BLOCKS - 1  # one block is kept in flight
    for kind, n in KINDS.items():
        assert len(got["fleet.host." + kind]) == n * BLOCKS, kind
        assert inside(got["fleet.host." + kind], block), kind
    modules = {k[len("module."):]: v for k, v in got.items() if k.startswith("module.")}
    assert {k: len(v) for k, v in modules.items()} == {
        k: n * BLOCKS for k, n in (PRELUDE if ticks == 16 else KINDS).items()}
    assert all(inside(v, got["fleet.dispatch"]) for v in modules.values())
    # a batch takes the envelope's kernel route at any length
    assert len(got["envelope.kernel"]) == BLOCKS and "envelope.twin" not in got
    assert inside(got["envelope.kernel"], modules["Envelope"])

    assert [t0 for t0, _ in taps] == [t0 for t0, _ in off_taps]
    for (_, a), (_, b) in zip(taps, off_taps):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(tree_leaves(eng.fleet.state), tree_leaves(off.fleet.state)):
        assert torch.equal(x, y)


class _Event:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_fetch_wait_spans_the_event_wait_alone(on):
    event = _Event()
    out, got = recorded(lambda: fleet_serve._finish_fetch(({"a": torch.ones(2)}, event)))
    assert event.waited == 1 and len(got["fleet.fetch_wait"]) == 1
    np.testing.assert_array_equal(out["a"], np.ones(2, np.float32))
    _, got = recorded(lambda: fleet_serve._finish_fetch(({"a": torch.ones(2)}, None)))
    assert not got  # on the CPU the taps are host memory already: no wait


@pytest.mark.parametrize("n_ticks, compiles", [(32, 1), (28, 2)])
def test_render_spans_a_block_and_bit_identical(on, n_ticks, compiles):
    """Two 16-tick blocks, or one and a 12-tick tail (its own compile)."""
    ws, mon = build_16_module_graph()
    cpu = torch.device("cpu")

    def go():
        return render(ws, n_ticks, CFG48, block_ticks=16, device=cpu).monitor_audio(mon)

    audio, got = recorded(go)
    assert {k: len(v) for k, v in got.items() if not k.startswith("module.")} == {
        "render.compile": compiles, "render.prepare": 1, "patch.host_aux": 2,
        "patch.upload": 2, "patch.dispatch": 2, "render.collect": 2, "render.concat": 1,
        "envelope.twin": 2}  # one unbatched block under the envelope's kernel gate
    modules = [v for k, v in got.items() if k.startswith("module.")]
    assert modules and all(inside(v, got["patch.dispatch"]) for v in modules)
    assert inside(got["envelope.twin"], got["module.Envelope"])
    spans.disable()
    np.testing.assert_array_equal(audio, go())
