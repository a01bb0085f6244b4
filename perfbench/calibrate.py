"""Readings that a cell's limits are set from, many seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds <s>

For each seed, one run of the cell as ``run.py`` makes it (set-up, the
window, the check), printing one JSON line: the numbers the check
compared (the lower readings), the same numbers for the control — the
reference computed through float8 e4m3 in the program's place (the upper
readings) — and, for a training cell, the learner's numbers for the
reference fed half of each batch in the program's place (a fault the
check must catch). Runs on the card, as ``run.py`` does, and exits
non-zero without one. Not part of a benchmark run: the limits in
``perfbench/limits/<workload>.json`` are set from its readings, as
PERF.md records.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    from perfbench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, cfg_doc, mix, limits, _, _ = harness.cell(bench, args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(cfg_doc, mix, limits, workload=args.workload,
                          seed=seed, seconds=args.seconds, trace=False,
                          device="cuda", root=ROOT, t_start=t0,
                          metrics=[], control=True)
        r = res["readings"]
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "failed": res["failed"], "units": res["attempted"],
            "program": {k: v["value"] for k, v in res["checks"].items()},
            "control": r.get("control"),
            "fault_half_batch": r.get("fault_half_batch"),
            "judged": r.get("judged"), "evaluations": r.get("evaluations"),
            "window_s": res["run"].elapsed, "totals": res["run"].totals,
            "unit_ms": [round(1e3 * t, 1) for t in res["run"].unit_s],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
