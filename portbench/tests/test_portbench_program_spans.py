"""The readers of the program's own spans (``program_spans.py``): each reads
its spans' milliseconds a block from ``Records`` and nothing where the
window recorded none; the spans are turned on by importing
``program_spans.py`` alone, so an untraced run keeps them off."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.trace import Records

ROOT = harness.ROOT
# reader -> its value on the records below, ms a block
EXPECTED = {
    "fleet.host_arrays_ms": (100 + 20 + 30) / 2 * 1e-6,
    "fleet.upload_ms": 40 / 2 * 1e-6,
    "fleet.dispatch_ms": (50 + 70) / 2 * 1e-6,
    "fleet.fetch_wait_ms": 9 / 2 * 1e-6,
}


def _records():
    rec = Records(window=(0, 10_000), units=2)
    for name, spans in {
        "mx.fleet.host.Oscillator": [(0, 100), (500, 20)], "mx.fleet.host.FmSine": [(200, 30)],
        "mx.fleet.upload": [(300, 40)], "mx.fleet.dispatch": [(400, 50), (900, 70)],
        "mx.fleet.fetch_wait": [(990, 9)],
        # the benchmark's own spans, and program spans no new reader reads
        "fleet.host_aux": [(0, 5000)], "fleet.fetch_wait": [(990, 500)],
        "mx.fleet.hostile": [(0, 999)], "mx.module.Oscillator": [(410, 5)],
    }.items():
        rec.spans[name] = spans
    return rec


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_spans_a_block(name):
    reader = harness.metric(name)
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], "ms/block", "program_span", entry["moves"])
    assert reader.read(_records()) == pytest.approx(EXPECTED[name])
    assert reader.read(Records(window=(0, 10_000), units=2)) is None
    no_units = _records()
    no_units.units = 0
    assert reader.read(no_units) is None


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_an_untraced_run_leaves_the_spans_off():
    got = _run("import json, sys\n"
               "from portbench.tests.small import run_small\n"
               "from mixlab_tpu_torch import spans\n"
               "r = run_small('fleet-48k-8192x16', seconds=1.0)\n"
               "print(json.dumps({'correct': r['correct'], 'on': spans.enabled(), "
               "'imported': 'portbench.program_spans' in sys.modules}))")
    assert got == {"correct": True, "on": False, "imported": False}


def test_importing_program_spans_turns_them_on_with_the_prefix():
    got = _run("import json\n"
               "from mixlab_tpu_torch import spans\n"
               "off = spans.enabled()\n"
               "import portbench.program_spans\n"
               "from torch.profiler import profile, ProfilerActivity\n"
               "with profile(activities=[ProfilerActivity.CPU]) as p:\n"
               "    with spans.span('fleet.upload'):\n"
               "        pass\n"
               "names = [e.name() for e in p.profiler.kineto_results.events() "
               "if e.is_user_annotation()]\n"
               "print(json.dumps({'off': off, 'on': spans.enabled(), 'names': names}))")
    assert got == {"off": False, "on": True, "names": ["pb:mx.fleet.upload"]}


def test_a_program_without_spans_reads_none():
    """A program that has no ``spans`` module (an older commit): the readers
    load and read nothing, and raise nothing."""
    got = _run("import json, sys\n"
               "sys.modules['mixlab_tpu_torch.spans'] = None\n"
               "from portbench import harness, program_spans\n"
               "from portbench.trace import Records\n"
               "rec = Records(window=(0, 10), units=1)\n"
               f"print(json.dumps([harness.metric(n).read(rec) for n in {sorted(EXPECTED)!r}] "
               "+ [program_spans.spans]))")
    assert got == [None] * (len(EXPECTED) + 1)
