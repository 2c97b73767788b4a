"""The benchmark is driven by data: every configuration, cell, driver and
metric that BENCHMARK.json names is found by name, and a new cell of an
existing driver, or a new metric, is a new file and an entry alone."""

import json
import os
import shutil
import subprocess
import sys

import types

import pytest
import torch

from portbench import harness
from portbench.trace import Records, Tracer

BENCH = harness.benchmark()
ROOT = harness.ROOT


def chips_keep_the_contract(workloads) -> bool:
    """Every cell asks for 1 or 4 chips, and at most ``max(1, cells // 4)``
    of them for 4."""
    return (all(w["chips"] in (1, 4) for w in workloads)
            and sum(w["chips"] == 4 for w in workloads) <= max(1, len(workloads) // 4))


# The contract's checks, each a function of a benchmark dict that reads its
# files through the harness (``harness.ROOT``): they hold for the accepted
# BENCHMARK.json and for any copy that adds cells as files and entries.

def named_files_are_found(bench):
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert harness.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        wl = harness.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["why"]) == (w["config"], w["traffic"], w["why"])
        assert callable(harness.load("drivers", wl["driver"]).setup)
    for m in bench["per_layer"]:
        mod = harness.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["layer"], m["unit"], m["better"], m["source"])
        assert getattr(mod, "MOVES", m["moves"]) == m["moves"]


def cells_report_setup_another_end_to_end_and_a_layer_metric(bench):
    for w in bench["workloads"]:
        e2e, layer = harness.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer and all(m["moves"] in names for m in layer)


def contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in bench["workloads"])
    assert chips_keep_the_contract(bench["workloads"])
    cells = {w["name"] for w in bench["workloads"]}
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    assert all(m["workloads"] and set(m["workloads"]) <= cells
               for m in bench["end_to_end"] + bench["per_layer"] if "workloads" in m)
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(bench, indent=2).encode()) < 64 * 1024


CONTRACT = (named_files_are_found, cells_report_setup_another_end_to_end_and_a_layer_metric,
            contract_shapes)


def test_every_named_file_is_found():
    named_files_are_found(BENCH)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    cells_report_setup_another_end_to_end_and_a_layer_metric(BENCH)


def test_the_contract_shapes():
    contract_shapes(BENCH)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def _copy(src, dst) -> dict:
    """``src``'s ``portbench/`` copied to ``dst``; returns ``src``'s
    BENCHMARK.json as a dict (written to ``dst`` by ``_write``)."""
    shutil.copytree(src / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((src / "BENCHMARK.json").read_text())


def _write(dst, bench) -> dict:
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return bench


def _run_in_copy(tmp_path, cell, seed, trace, device):
    """``harness.run_cell`` of ``cell`` in a process of its own, with the
    copy at ``tmp_path`` first on the path; returns the result and the
    process's standard error."""
    code = ("import json; from portbench import harness; "
            f"r = harness.run_cell({cell!r}, {seed}, 1.0, {trace}, device={device!r}); "
            "print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _add_small_fleet_cell(root, bench, name, config, traffic, chips, why):
    """One more cell of the fleet driver in the copy at ``root``: the
    16-tick fleet cell's workload file at 8 sessions under ``name``, its
    BENCHMARK.json entry, and its name in every metric list that holds the
    16-tick cell."""
    wl = json.loads((root / "portbench/workloads/fleet-48k-8192x16.json").read_text())
    wl.update(name=name, config=config, traffic=traffic, why=why,
              params={**wl["params"], "sessions": 8, "sample_sessions": 4, "warm_blocks": 1})
    (root / f"portbench/workloads/{name}.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": chips, "why": why})
    listed = [m for m in bench["end_to_end"] + bench["per_layer"]
              if "fleet-48k-8192x16" in m.get("workloads", [])]
    assert listed
    for m in listed:
        m["workloads"].append(name)


def test_a_new_cell_is_a_json_file(tmp_path):
    """A copy of the benchmark with one more cell of the fleet driver: its
    workload file and its BENCHMARK.json entries, nothing else, and it runs."""
    bench = _copy(ROOT, tmp_path)
    _add_small_fleet_cell(tmp_path, bench, "fleet-48k-8x16", "flagship-48k", "closed-8x16", 1,
                          "a test's cell")
    _write(tmp_path, bench)
    r, _ = _run_in_copy(tmp_path, "fleet-48k-8x16", 5, False, "cpu")
    assert r["correct"] and "fleet_x_realtime" in r["metrics"]


TOY_DRIVER = '''"""A toy driver of several cards: each of the cell's cards sums its row of
a seeded integer matrix, the cards in turn, each waited for before the next."""

import json
import sys
import time

import numpy as np

from portbench import judge


def setup(cell, config, seed, device, tracer):
    import torch

    print("toy cards " + json.dumps(cell["cards"]), file=sys.stderr)
    rows = np.random.default_rng(seed).integers(-1000, 1000, (len(cell["cards"]),
                                                              int(cell["params"]["n"])))
    parts = [torch.as_tensor(r).to(c) for r, c in zip(rows, cell["cards"])]
    return {"rows": rows, "parts": parts, "sums": [int(p.sum()) for p in parts]}


def window(ctx, seconds, tracer):
    t_open, units = time.perf_counter(), 0
    while not units or time.perf_counter() - t_open < seconds:
        with tracer.span("toy.block"):
            ctx["sums"] = [int(p.sum()) for p in ctx["parts"]]
        units += 1
    rate = units / (time.perf_counter() - t_open)
    return {"end_to_end": {"fleet_x_realtime": rate}, "attempted": units, "failed": 0,
            "units": units}


def release(ctx):
    pass


def check(ctx, control=None):
    return {"sum_gap": {"value": judge.gap(ctx["sums"], ctx["rows"].sum(axis=1)), "limit": 0}}
'''


def _without_four_chip_cells(bench) -> dict:
    """``bench`` with its four-chip cells taken out: their entries, their
    names in every metric's list, a metric whose list they alone made up,
    and a configuration that no cell uses any more."""
    gone = {w["name"] for w in bench["workloads"] if w["chips"] == 4}
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] not in gone]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = [c for c in m["workloads"] if c not in gone]
        bench[kind] = [m for m in bench[kind] if m.get("workloads", True)]
    used = {w["config"] for w in bench["workloads"]}
    bench["configs"] = [c for c in bench["configs"] if c["name"] in used]
    return bench


def _four_chip_copy(tmp_path, n=1 << 16, src=ROOT):
    """A copy of the benchmark at ``src`` whose one four-chip cell is
    ``toy-4chip``: the copy's own four-chip cells taken out, then the toy's
    driver file, its workload file and its BENCHMARK.json entries added,
    nothing else.  Returns the copy's BENCHMARK.json as a dict."""
    bench = _without_four_chip_cells(_copy(src, tmp_path))
    bench["workloads"].append({"name": "toy-4chip", "config": "flagship-48k",
                               "traffic": "toy-sums", "chips": 4, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("fleet_x_realtime", "device_idle_pct.fleet"):
            m["workloads"].append("toy-4chip")
    (tmp_path / "portbench/drivers/toy.py").write_text(TOY_DRIVER)
    (tmp_path / "portbench/workloads/toy-4chip.json").write_text(json.dumps(
        {"name": "toy-4chip", "config": "flagship-48k", "traffic": "toy-sums", "driver": "toy",
         "params": {"n": n}, "why": "a test's cell"}))
    return _write(tmp_path, bench)


def _run_toy(tmp_path, device, trace):
    r, err = _run_in_copy(tmp_path, "toy-4chip", 2**31 + 5, trace, device)
    cards = next(json.loads(line[len("toy cards "):]) for line in err.splitlines()
                 if line.startswith("toy cards "))
    return r, cards


def _holds_the_contract(monkeypatch, root, bench):
    """Every contract check on the copy at ``root``, read through the
    harness as a run there reads it."""
    with monkeypatch.context() as mp:
        mp.setattr(harness, "ROOT", root)
        mp.setattr(harness, "HERE", root / "portbench")
        for check in CONTRACT:
            check(bench)


def _toy_cell_keeps_the_contract_and_runs(monkeypatch, tmp_path, bench):
    """The toy four-chip copy keeps the contract, runs under the harness on
    the CPU with its driver handed four cards, and one four-chip cell more
    than the contract allows breaks it."""
    cells = bench["workloads"]
    assert [w["name"] for w in cells if w["chips"] == 4] == ["toy-4chip"]
    assert chips_keep_the_contract(cells)
    _holds_the_contract(monkeypatch, tmp_path, bench)
    r, cards = _run_toy(tmp_path, "cpu", False)
    assert cards == ["cpu"] * 4
    assert r["correct"] and r["checks"]["sum_gap"]["value"] == 0, r["checks"]
    e2e, _ = harness.cell_metrics(bench, "toy-4chip")
    assert set(r["metrics"]) == {m["name"] for m in e2e} and r["device"]["count"] == 4
    one_chip = [w for w in cells if w["chips"] == 1]
    allowed = max(1, len(cells) // 4)
    assert len(one_chip) >= allowed
    for w in one_chip[:allowed]:
        w["chips"] = 4
    assert not chips_keep_the_contract(cells)


def test_a_four_chip_cell_is_new_files_and_entries(monkeypatch, tmp_path):
    """A four-chip cell added as files and entries alone, to whatever
    benchmark is accepted, runs under the harness on the CPU, its driver
    handed four cards, and keeps the contract's rule; one four-chip cell
    more than the rule allows breaks it."""
    _toy_cell_keeps_the_contract_and_runs(monkeypatch, tmp_path, _four_chip_copy(tmp_path))


STAND_IN_CONFIG, STAND_IN_CELL = "flagship-48k-4card-test", "fleet-48k-4card-test"


def _four_card_fleet_copy(tmp_path, src=ROOT):
    """A copy of the benchmark at ``src`` with one four-chip cell of the
    fleet driver added as files and entries alone, shaped like the
    four-card fleet deployment: the flagship graph with 32,768 fleet slots
    (a configuration file and entry, nothing reduced) and a cell on four
    chips at a small size.  The copy's own four-chip cells are taken out
    first, so that the added cell is its one four-chip cell.  Returns the
    copy's BENCHMARK.json as a dict."""
    bench = _without_four_chip_cells(_copy(src, tmp_path))
    flagship = next(c for c in bench["configs"] if c["name"] == "flagship-48k")
    cfg = json.loads((src / flagship["file"]).read_text())
    cfg.update(name=STAND_IN_CONFIG, fleet_slots=32768,
               assumed={**cfg["assumed"], "fleet_slots": "8,192 sessions on each of four cards"})
    cfg_file = f"portbench/configs/{STAND_IN_CONFIG}.json"
    (tmp_path / cfg_file).write_text(json.dumps(cfg, indent=2))
    bench["configs"].append({**flagship, "name": STAND_IN_CONFIG, "file": cfg_file,
                             "reduced": [], "why": "a test's configuration: 32,768 fleet slots"})
    _add_small_fleet_cell(tmp_path, bench, STAND_IN_CELL, STAND_IN_CONFIG, "closed-8x16-4card", 4,
                          "a test's cell: the fleet on four cards, small")
    return _write(tmp_path, bench)


def test_a_four_card_fleet_cell_is_new_files_and_entries(monkeypatch, tmp_path):
    """A four-chip cell of the fleet driver, added to whatever benchmark is
    accepted as a configuration file, a workload file and BENCHMARK.json
    entries alone: the copy keeps every contract check, the toy four-chip
    copy made from it still holds, and the cell runs under the harness on
    the CPU (four ``cpu`` cards, which the fleet driver runs as one device)
    and reads correct."""
    bench = _four_card_fleet_copy(tmp_path / "fleet")
    assert [w["name"] for w in bench["workloads"] if w["chips"] == 4] == [STAND_IN_CELL]
    _holds_the_contract(monkeypatch, tmp_path / "fleet", bench)
    _toy_cell_keeps_the_contract_and_runs(
        monkeypatch, tmp_path / "toy", _four_chip_copy(tmp_path / "toy", src=tmp_path / "fleet"))
    r, _ = _run_in_copy(tmp_path / "fleet", STAND_IN_CELL, 2**31 + 11, False, "cpu")
    assert r["correct"], r["checks"]
    e2e, _ = harness.cell_metrics(bench, STAND_IN_CELL)
    assert set(r["metrics"]) == {m["name"] for m in e2e} and r["device"]["count"] == 4
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.cuda
def test_a_four_chip_cell_on_four_cards(card, tmp_path):
    """The toy four-chip cell traced on four cards: each card's busy time
    read from its own timeline, by the trace's device index, and the busy
    time and idle share their mean."""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"{torch.cuda.device_count()} cards: the cell needs 4")
    _four_chip_copy(tmp_path, n=1 << 24)
    r, cards = _run_toy(tmp_path, "cuda", True)
    assert cards == [f"cuda:{i}" for i in range(4)] and r["correct"], r["checks"]
    by_card = r["device"]["busy_s_by_card"]
    assert len(by_card) == 4 and all(b > 0 for b in by_card), by_card
    assert r["device"]["busy_s"] == pytest.approx(sum(by_card) / 4)
    idle = 100 * (1 - r["device"]["busy_s"] / r["device"]["window_s"])
    assert r["metrics"]["device_idle_pct.fleet"]["value"] == pytest.approx(idle)
    print(json.dumps(r["device"]), json.dumps(r["breakdown"]["idle_gaps"][:4]))


def test_a_new_metric_is_a_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "kernels.count.py").write_text(
        'LAYER, UNIT, BETTER, SOURCE, MOVES = "kernels", "launches", "lower", '
        '"device_trace", "fleet_x_realtime"\n\n\ndef read(rec):\n'
        '    return rec.kernel_count() or None\n')
    monkeypatch.setattr(harness, "HERE", tmp_path)
    rec = Records(kernels=[("k", 0, 5), ("k", 10, 5)], window=(0, 20), units=1)
    assert harness.metric("kernels.count").read(rec) == 2


def test_a_new_kernel_roofline_is_a_file(tmp_path, monkeypatch):
    """A roofline of a kernel no metric read before: one file that names
    the program's launch wrapper (``LAUNCHES``) and the kernel; the harness
    counts the wrapper's launches and bytes, and no driver changes."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "toy_roofline.py").write_text(
        'from portbench.roofline import launch_share\n'
        'LAYER, UNIT, BETTER, SOURCE = "kernels", "%", "higher", "device_trace"\n'
        'LAUNCHES = {"toy": ("portbench_toy_wrapper", "_launch")}\n\n\n'
        'def read(rec):\n    return launch_share(rec, "toy", ("toy_kernel",))\n')
    toy = types.ModuleType("portbench_toy_wrapper")
    toy._launch = lambda x, state: (x * 2, {"s": state + 1})
    monkeypatch.setitem(sys.modules, "portbench_toy_wrapper", toy)
    monkeypatch.setattr(harness, "HERE", tmp_path)
    reader = harness.metric("toy_roofline")
    counted, tracer = {}, Tracer(True)
    for family, (module, attr) in reader.LAUNCHES.items():
        tracer.count_launches(family, module, attr, counted)
    x, state = torch.zeros(1000), torch.zeros(2)
    toy._launch(x, state)
    toy._launch(x, state)
    tracer.unwrap()
    assert counted == {"toy.launches": 2, "toy.bytes": 2 * (4000 + 4000 + 8 + 8)}
    rec = Records(kernels=[("toy_kernel<1>", 0, 100)], window=(0, 1000), units=1, facts=counted)
    assert reader.read(rec) == pytest.approx(100 * (16032 / 3.35e12) / 100e-9)
    renamed = Records(kernels=[("toy_kernel_v2"[::-1], 0, 100)], window=(0, 1000), facts=counted)
    with pytest.raises(RuntimeError, match="no kernel"):
        reader.read(renamed)
    assert reader.read(Records(window=(0, 1000))) is None  # nothing launched: nothing to read


def test_records_read_as_the_metrics_expect():
    rec = Records(kernels=[("region_rows_kernel", 100, 50), ("eq_rows_kernel", 120, 60)],
                  copies=[("Memcpy HtoD (Pageable -> Device)", 300, 100)],
                  window=(0, 1000), units=2,
                  facts={"region.launches": 2, "region.bytes": 3.35e3, "eq.launches": 2,
                         "eq.bytes": 1.0, "sessions": 1, "samples_per_block": 1,
                         "state_bytes": 0, "param_bytes": 0})
    rec.spans["fleet.host_aux"] = [(0, 90), (500, 10)]
    rec.spans["fleet.block"] = [(0, 1000)]
    assert rec.device_intervals() == [(100, 180), (300, 400)]
    assert rec.busy_s() == pytest.approx(180e-9)
    read = lambda name: harness.metric(name).read(rec)  # noqa: E731
    assert read("device_idle_pct.fleet") == pytest.approx(82.0)
    assert read("fleet.host_aux_ms") == pytest.approx(1e3 * 100e-9 / 2)
    assert read("region_roofline") == pytest.approx(100 * (3.35e3 / 3.35e12) / 50e-9)
    assert read("fleet_block_roofline") == pytest.approx(100 * (2 * 4 / 3.35e12) / 110e-9)
    b = rec.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", 100e-9]
    assert b["idle_gaps"][0] == ["fleet.block", 600e-9]
    assert read("eq_roofline") is not None
    assert harness.metric("eq_roofline").read(Records(window=(0, 1))) is None
