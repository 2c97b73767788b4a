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


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        wl = harness.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["why"]) == (w["config"], w["traffic"], w["why"])
        assert callable(harness.load("drivers", wl["driver"]).setup)
    for m in BENCH["per_layer"]:
        mod = harness.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["layer"], m["unit"], m["better"], m["source"])
        assert getattr(mod, "MOVES", m["moves"]) == m["moves"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e, layer = harness.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer and all(m["moves"] in names for m in layer)


def test_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_a_new_cell_is_a_json_file(tmp_path):
    """A copy of the benchmark with one more cell of the render driver: its
    workload file and its BENCHMARK.json entry, nothing else, and it runs."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "offline-48k-short", "config": "flagship-48k",
                               "traffic": "render-4s", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "offline-48k" in m.get("workloads", []):
            m["workloads"].append("offline-48k-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((ROOT / "portbench/workloads/offline-48k.json").read_text())
    wl.update(name="offline-48k-short", traffic="render-4s", why="a test's cell",
              params={"projects": 2, "project_ticks": 240, "block_ticks": 60})
    (tmp_path / "portbench/workloads/offline-48k-short.json").write_text(json.dumps(wl))
    code = ("import json; from portbench import harness; "
            "r = harness.run_cell('offline-48k-short', 5, 1.0, False, device='cpu'); "
            "print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and "render_x_realtime" in r["metrics"]


def test_a_new_metric_is_a_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "kernels.count.py").write_text(
        'LAYER, UNIT, BETTER, SOURCE, MOVES = "kernels", "launches", "lower", '
        '"device_trace", "render_x_realtime"\n\n\ndef read(rec):\n'
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
    assert read("device_idle_pct.render") == pytest.approx(82.0)
    assert read("fleet.host_aux_ms") == pytest.approx(1e3 * 100e-9 / 2)
    assert read("region_roofline") == pytest.approx(100 * (3.35e3 / 3.35e12) / 50e-9)
    assert read("fleet_block_roofline") == pytest.approx(100 * (2 * 4 / 3.35e12) / 110e-9)
    assert read("render.launches") is None  # no blocks recorded: nothing to read
    b = rec.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", 100e-9]
    assert b["idle_gaps"][0] == ["fleet.block", 600e-9]
    assert read("eq_roofline") is not None
    assert harness.metric("eq_roofline").read(Records(window=(0, 1))) is None
