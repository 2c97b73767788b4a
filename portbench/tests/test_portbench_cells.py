"""Each cell at a small size on the CPU: the timed path against the plain
reference (correct), the control failing the same limits, and the faults a
cell can have turning ``correct`` false (the harness's look for a card is
skipped; everything else runs as on the card)."""

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.tests.small import SIZES, run_small


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_cell_is_correct_and_its_control_is_not(cell):
    """The program passes; the plain reference in bfloat16, put in its place
    and judged by the same check and limits, fails, and so does the
    reference with bfloat16 signals downstream of the envelope only."""
    r = run_small(cell, controls=control.CONTROLS)
    assert r["correct"], r["checks"]
    for quant in control.CONTROLS:
        assert not r["controls"][quant]["correct"], (quant, r["controls"][quant]["checks"])
    e2e, _ = harness.cell_metrics(harness.benchmark(), cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


def _fleet_step(monkeypatch, broken):
    from mixlab_tpu_torch.parallel.fleet import Fleet

    inner = Fleet.step
    monkeypatch.setattr(Fleet, "step", lambda self, h, s: broken(inner(self, h, s), s))


FAULTS = {
    "state unchanged": {
        "fleet": lambda mp: _fleet_step(mp, lambda out, s: (s, out[1])),
    },
    "half the batch left out": {
        "fleet": lambda mp: _fleet_step(mp, lambda out, s: (out[0], _half(out[1]))),
    },
    "an answer altered": {
        "fleet": lambda mp: _fleet_step(mp, lambda out, s: (out[0], _altered(out[1]))),
    },
}


def _half(taps):
    """The sessions of the batch's second half left out (their PCM zero)."""
    l, r = taps["16"]["audio"]
    n = l.shape[0]
    l, r = l.clone(), r.clone()
    l[n // 2:] = 0
    r[n // 2:] = 0
    return {**taps, "16": {**taps["16"], "audio": (l, r)}}


def _altered(taps):
    """One sample of every session's PCM altered where it is produced."""
    l, r = taps["16"]["audio"]
    l = l.clone()
    l[:, 0, 3] = l[:, 0, 3] // 2 + 9000
    return {**taps, "16": {**taps["16"], "audio": (l, r)}}


CASES = [(fault, cell) for fault, kinds in FAULTS.items() for cell in sorted(SIZES)
         if harness.workload(cell)["driver"] in kinds]


@pytest.mark.parametrize("fault,cell", CASES)
def test_fault_makes_the_cell_incorrect(monkeypatch, fault, cell):
    FAULTS[fault][harness.workload(cell)["driver"]](monkeypatch)
    r = run_small(cell)
    assert not r["correct"], r["checks"]


def test_fleet_sampled_sessions_cover_both_halves():
    r = run_small("fleet-48k-8192x16", seed=2**31 + 17)
    assert r["correct"]
    assert np.isfinite(r["metrics"]["fleet_x_realtime"]["value"])


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """A short run of the first cell, as the benchmark runs it."""
    r = harness.run_cell("fleet-48k-8192x16", 7, 3.0, False)
    assert r["device"]["kind"] == card and r["correct"], r["checks"]
    assert torch.cuda.max_memory_allocated() > 0
