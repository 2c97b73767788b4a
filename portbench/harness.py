"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result's last line.

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and its driver
(``drivers/<driver>.py``); ``BENCHMARK.json`` names the metrics each cell
reports, and a per-layer metric is read by ``metrics/<metric>.py``.  A
driver is a module with ``setup(cell, config, seed, device, tracer)``
(``cell["cards"]`` lists the devices of the cell's cards),
``window(ctx, seconds, tracer)``, ``release(ctx)`` and
``check(ctx, control)``; a metric is a module with ``LAYER``, ``UNIT``,
``BETTER``, ``SOURCE`` and ``read(records)``, with ``MOVES`` where one
end-to-end metric is all it moves, and ``LAUNCHES`` (``{family: (module,
wrapper)}``) where it reads launches counted at the program's wrapper.  A
quantity split by the end-to-end metric it moves (``<quantity>.<suffix>``)
may share one reader, ``metrics/<quantity>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench import judge
from portbench.trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mixlab_tpu")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a missing file, a forbidden
    module): exit non-zero, print no result."""


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"{path} is missing")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return read_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(HERE / "configs" / f"{name}.json")


def load(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (the name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    the shared reader of its quantity, ``metrics/<name up to its first
    dot>.py``."""
    if not (HERE / "metrics" / f"{name}.py").is_file() and "." in name:
        return load("metrics", name.split(".")[0])
    return load("metrics", name)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def require_cards(n: int) -> List[str]:
    """The devices of the cell's ``n`` cards, ``cuda:0`` up."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell needs {n} cards, {torch.cuda.device_count()} present")
    return [f"cuda:{i}" for i in range(n)]


def device_info(device: str, n: int) -> dict:
    import torch

    if device == "cpu":  # the tests' runs: never a result of the card
        return {"platform": "cpu", "kind": "cpu", "count": n, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(n))}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, sizes: Optional[dict] = None,
             config_sizes: Optional[dict] = None, controls=()) -> dict:
    """One run; returns the result line as a dict.  ``sizes`` and
    ``config_sizes`` override the cell's traffic params and its
    configuration's keys (the CPU tests' small runs).  Each of ``controls``
    (a ``quant`` of the plain reference) is judged as the program is, with
    the reference at that precision in the program's place, once the
    program's own check is done: ``result["controls"][quant]`` holds its
    ``correct`` and its numbers (``control.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise Refused(f"BENCHMARK.json has no cell {cell!r}")
    wl = workload(cell)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise Refused(f"workloads/{cell}.json and BENCHMARK.json name other configs or mixes")
    if sizes:
        wl = {**wl, "params": {**wl["params"], **sizes}}
    cfg = {**config(wl["config"]), **(config_sizes or {})}
    driver = load("drivers", wl["driver"])
    cards = ["cpu"] * entry["chips"] if device == "cpu" else require_cards(entry["chips"])
    wl = {**wl, "cards": cards}
    e2e, layer = cell_metrics(bench, cell)
    readers = {m["name"]: metric(m["name"]) for m in layer} if trace else {}

    tracer = Tracer(trace)
    ctx = driver.setup(wl, cfg, seed, device, tracer)
    setup_s = time.perf_counter() - t_start
    counted: Dict[str, float] = {}
    launches = {f: w for r in readers.values() for f, w in getattr(r, "LAUNCHES", {}).items()}
    records = None
    for attempt in range(2):  # a profile with no device record is taken once more
        tracer.unwrap()  # each window puts its own spans and counters in
        counted.clear()
        for family, (module, attr) in launches.items():
            tracer.count_launches(family, module, attr, counted)
        with tracer.profile() as got:
            out = driver.window(ctx, seconds, tracer)
        if not trace:
            break
        records = got[0]
        records.units, records.facts = out["units"], {**out.get("facts", {}), **counted}
        records.cards = entry["chips"]
        if records.kernels or records.copies:
            break
        print(f"portbench: the profile of window {attempt + 1} holds no device record",
              file=sys.stderr)
    else:
        raise RuntimeError("two profiles in this process held no device record")
    tracer.unwrap()
    t_window = time.perf_counter()
    dev = device_info(device, entry["chips"])
    driver.release(ctx)
    checks = driver.check(ctx)
    print(f"portbench: set-up {setup_s:.3f} s, window and trace "
          f"{t_window - t_start - setup_s:.3f} s, check {time.perf_counter() - t_window:.3f} s",
          file=sys.stderr)

    metrics: Dict[str, dict] = {}
    if trace:
        for m in layer:
            value = readers[m["name"]].read(records)
            if value is not None:
                if not math.isfinite(value):
                    raise RuntimeError(f"metric {m['name']} read {value}")
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = records.busy_s()
        dev["window_s"] = records.window_s
        if entry["chips"] > 1:
            dev["busy_s_by_card"] = records.card_busy_s()
        if dev["busy_s"] <= 0:
            raise RuntimeError("the traced window recorded no device time")
    else:
        values = {**out["end_to_end"], "setup_s": setup_s}
        for m in e2e:
            if m["name"] not in values:
                raise RuntimeError(f"cell {cell} did not measure {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    result = {"correct": judge.verdict(checks), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = records.breakdown()
    if controls:
        result["controls"] = {}
        for quant in controls:
            c = driver.check(ctx, control=quant)
            result["controls"][quant] = {"correct": judge.verdict(c), "checks": c}
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
