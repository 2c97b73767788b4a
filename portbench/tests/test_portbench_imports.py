"""What the benchmark loads: no JAX, no JAX package (compared by whole
top-level module names, as ``mixlab_tpu_torch`` begins with ``mixlab_tpu``),
and a reference that loads nothing of the program."""

import json
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    tops = _modules_after(
        "from portbench.tests.small import run_small\n"
        "for cell in ('fleet-48k-8192x16', 'fleet-48k-8192x15'):\n"
        "    assert run_small(cell, seconds=1.0)['correct']\n"
        "import portbench.control, portbench.run\n"
        "from portbench import harness\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.metric(m['name'])\n")
    assert "mixlab_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _modules_after("import portbench.reference.audio, portbench.judge, "
                          "portbench.roofline")
    assert not tops & {"mixlab_tpu_torch", "torch", *harness.FORBIDDEN}


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("mixlab_tpu_torch_lookalike", sys)
    try:
        assert "mixlab_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["mixlab_tpu_torch_lookalike"]


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "fleet-48k-8192x15",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
