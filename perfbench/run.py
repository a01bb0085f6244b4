"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Prints the run's result as the last line
of standard output (one JSON object: correct, attempted, failed, metrics,
device, with ``--trace 1`` breakdown, and last the numbers the check
compared, each beside its limit) and those numbers again as the last
lines of standard error. With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Exits
non-zero, printing no result, without CUDA or with fewer cards than the
cell asks for, and when JAX or the JAX package is loaded once the window
has closed.

The kernels build into ``build/kernels/`` inside the checkout (the
program's own fixed cache directory), so only a checkout's first run
calls nvcc.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "alphafive_tpu")


def loaded_forbidden() -> list:
    """The top-level names of loaded modules that are JAX, flax or the JAX
    package, compared whole (``alphafive_tpu_torch`` is not
    ``alphafive_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    import torch
    from perfbench import harness
    w, cfg_doc, mix, limits, e2e, layer = harness.cell(bench, args.workload,
                                                       ROOT)
    if not torch.cuda.is_available():
        print("perfbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(w["chips"]):
        print(f"perfbench: {args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    metrics = layer if args.trace else e2e
    sources = {m["name"]: m["source"]
               for m in bench["end_to_end"] + bench["per_layer"]}
    res = harness.run(cfg_doc, mix, limits, workload=args.workload,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", root=ROOT,
                      t_start=T_START, metrics=metrics,
                      stretch=not args.trace and any(
                          sources[m] == "device_trace" for m in metrics))
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    rec = res["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(w["chips"]),
              "memory_peak_bytes": int(res["peak"]),
              "power": power_limit()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": {},
            "device": device}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name, value in res["values"].items():
        line["metrics"][name] = {"value": value, "unit": units[name]}
    if args.trace:
        prof = rec.profile
        device["busy_s"], device["window_s"] = prof["busy_s"], \
            prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["spans"]["idle_gaps"]}
        info = {"counters": counters(), "timers_s": rec.timers,
                "window_units": rec.units, "window_s": rec.elapsed,
                "profiled_units": prof["units"],
                "device_events": prof["device_events"],
                "spans": {k: v for k, v in prof["spans"].items()
                          if k != "idle_gaps"},
                "reduce_s": prof["reduce_s"]}
        print(json.dumps({"trace": info}))
    line["info"] = {"setup_s": rec.setup_s,
                    "setup_phases": rec.setup_phases,
                    "window_s": rec.elapsed,
                    "units": rec.units, "totals": rec.totals,
                    "unit_ms": [round(1e3 * t, 1) for t in rec.unit_s],
                    "evaluations": res["readings"].get("evaluations"),
                    "judged": res["readings"].get("judged")}
    if rec.device:
        line["info"]["stretch"] = {k: rec.device[k] for k in
                                   ("busy_s", "window_s", "units", "totals",
                                    "stretch_s")}
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def counters() -> dict:
    """The program's own exact counts, since the process started."""
    from alphafive_tpu_torch.mcts import search_capped
    from alphafive_tpu_torch.ops import resblock as rb
    from alphafive_tpu_torch.ops import select
    return {"resblock_launches": rb.resblock_launches,
            "variant_launches": dict(rb.variant_launches),
            "pack_launches": rb.pack_launches,
            "backup_scatters": search_capped.backup_scatters,
            "select_launches": select.select_launches}


if __name__ == "__main__":
    sys.exit(main())
