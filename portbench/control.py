"""The limits' two readings in one process: ``python3 -m portbench.control
--workload <cell> --seconds <s> --seeds <n,n,...>`` runs the cell once a
seed, as ``portbench.run`` does, and prints for each the harness's verdict
and numbers for the program (the lower reading) and for each control (the
upper reading): the plain reference put in the program's place and judged
by the same check and limits, at ``bf16`` (every module's output in
bfloat16, the step below the configuration's float32) and at
``bf16-after-env`` (every output but the envelope's).  The benchmark's own
runs never run a control."""

import json
import sys
import time

from portbench.harness import run_cell

CONTROLS = ("bf16", "bf16-after-env")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, controls=CONTROLS)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t,
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "attempted": r["attempted"], "failed": r["failed"],
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                          "correct": r["correct"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()},
                          "controls": {q: {"correct": c["correct"],
                                           "checks": {k: v["value"] for k, v in c["checks"].items()}}
                                       for q, c in r["controls"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
