"""Run one cell once: set-up, the measured window, the device stretch
where an end-to-end metric of the run reads the device's trace, with
``--trace 1`` the traced window and the profiled sub-window, then the
check that decides ``correct``. ``perfbench/run.py`` is the command; this module is
what it and the tests call.

Everything a cell is made of is found by name:

* ``BENCHMARK.json``: the cell (its configuration and traffic mix) and
  the metrics it reports;
* ``perfbench/configs/<config>.json``: the model (env and net), the
  presets and weights bundles of its roles;
* ``perfbench/archs/<arch>.py``: the architecture the configuration
  names (``"arch"``, ``resnet`` where it names none): the reference net,
  its weights, FLOPs and the kernels it spans (``generator.Arch``);
* ``perfbench/traffic/<mix>.json``: the kind of traffic, its ``--set``
  overrides, what it records for the check and the units of its
  profiled sub-window;
* ``perfbench/kinds/<kind>.py``: the kind, the class ``Kind`` that runs
  the mix's units and names the numbers its check compares;
* ``perfbench/limits/<workload>.json``: the limit of each number the
  check compares;
* ``perfbench/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  returning a number or None when it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import os
import time
from typing import Dict, List, Optional

import torch

from perfbench import checks, generator, tracing, yardstick

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Run:
    """What a reader of a metric reads."""

    workload: str
    cfg_doc: Dict
    mix: Dict
    cfg: object                      # the program's RunConfig
    setup_s: float
    elapsed: float = 0.0             # the window's seconds
    units: int = 0
    totals: Dict = dataclasses.field(default_factory=dict)
    timers: Dict = dataclasses.field(default_factory=dict)
    profile: Optional[Dict] = None
    work: Optional[Dict] = None      # the window's work, for the yardstick
    unit_s: List[float] = dataclasses.field(default_factory=list)
    setup_phases: Dict = dataclasses.field(default_factory=dict)
    device: Optional[Dict] = None    # the device stretch's reading


class Context:
    """What a traffic kind builds from: the configuration, the mix, the seed
    and the instrumentation installed on the program for this run."""

    def __init__(self, cfg_doc, mix, seed, device, root):
        self.cfg_doc, self.mix, self.seed = cfg_doc, mix, seed
        self.device, self.root = device, root
        self.cfg = generator.run_config(cfg_doc, mix)
        self.kind = generator.load_kind(mix["kind"])
        self.arch = generator.Arch(cfg_doc)
        self.patches = tracing.Patches()
        self.inst = tracing.Instruments(mix.get("timed", ()), self.sync)
        self.probe = checks.Probe(self)
        self.weights = generator.load_weights(self)

    def sync(self):
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def patch(self, owner, attr: str, name: str):
        self.patches.wrap(owner, attr, lambda fn: self.inst.wrap(name, fn))

    def instrument_search(self):
        """Spans (and timers, where the mix names them) on the layers
        every kind runs and on the architecture's kernels, and the probe
        on the env step and on the searches' random draws."""
        from alphafive_tpu_torch.env import vector
        from alphafive_tpu_torch.mcts import gumbel, search, search_capped
        self.patches.wrap(search_capped, "dirichlet_noise",
                          self.probe.wrap_draw("noise"))
        self.patches.wrap(gumbel, "_gumbel_noise",
                          self.probe.wrap_draw("gumbel"))
        self.patch(search_capped, "_select_lanes", "descent")
        self.patch(search, "_select_one", "descent")
        self.patch(search_capped, "_backup", "backup")
        for span, target in self.arch.kernels():
            module, attr = target.split(":")
            self.patch(importlib.import_module(module), attr, span)
        self.patches.wrap(search_capped, "run_mcts_capped",
                          self.probe.wrap_search)
        self.patches.wrap(search_capped, "_select_lanes",
                          self.probe.wrap_select)
        self.patches.wrap(vector, "step", self.probe.wrap_step)
        self.patch(vector, "step", "env_step")


def load_metric(name: str, root: str = HERE):
    return generator.load_module(os.path.join(root, "metrics"), name).read


def cell(bench: Dict, workload: str, root: str) -> tuple:
    """(workload entry, configuration, mix, limits, e2e names, per-layer
    names) of `workload`, each file found by its name."""
    (w,) = [x for x in bench["workloads"] if x["name"] == workload]
    (c,) = [x for x in bench["configs"] if x["name"] == w["config"]]
    cfg_doc = generator.load_json(os.path.join(root, c["file"]))
    mix = generator.load_json(os.path.join(HERE, "traffic",
                                         f"{w['traffic']}.json"))
    limits = generator.load_json(os.path.join(HERE, "limits",
                                            f"{workload}.json"))
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m["name"] for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])]
    return w, cfg_doc, mix, limits, e2e, layer


def run(cfg_doc: Dict, mix: Dict, limits: Dict, *, workload: str,
        seed: int, seconds: float, trace: bool, device: str, root: str,
        t_start: float, metrics: List[str], control: bool = False,
        stretch: bool = False) -> Dict:
    """One run of a cell; returns the result (the keys of the result
    line, and ``checks`` with each number beside its limit). `stretch`:
    run the device stretch after the window (a metric of `metrics` reads
    the device's trace)."""
    ctx = Context(cfg_doc, mix, seed, device, root)
    t_ctx = time.perf_counter()
    probe = ctx.probe
    try:
        traffic = ctx.kind(ctx)
        ctx.sync()
        if str(device).startswith("cuda"):
            # the window's peak: the program's state and its work, not
            # the set-up's passing allocations
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = Run(workload, cfg_doc, mix, ctx.cfg, setup_s=t0 - t_start)
        # where set-up went: process start to the built context, then
        # the traffic's own state (and its phases, where it times them)
        rec.setup_phases = {"context_s": t_ctx - t_start,
                            "traffic_s": t0 - t_ctx,
                            **getattr(traffic, "setup_phases", {})}
        probe.start_window(getattr(traffic, "envs", None))
        ctx.inst.timing = trace
        units, totals, ends = 0, {}, []
        while True:
            probe.start_unit()
            out = traffic.unit()
            ctx.sync()
            ends.append(time.perf_counter() - t0)
            probe.end_unit()
            units += 1
            for k, v in out.items():
                totals[k] = totals.get(k, 0) + v
            if time.perf_counter() - t0 >= seconds:
                break
        rec.elapsed = time.perf_counter() - t0
        rec.units, rec.totals = units, totals
        rec.unit_s = [b - a for a, b in zip([0.0] + ends, ends)]
        probe.active = False
        ctx.inst.timing = False
        rec.timers = dict(ctx.inst.seconds)
        rec.work = work(ctx, traffic, units, totals)
        peak = (torch.cuda.max_memory_allocated()
                if str(device).startswith("cuda") else 0)
        probe.after_window()
        if stretch:
            rec.device = device_stretch(ctx, traffic)
        if trace:
            rec.profile = profile_units(ctx, traffic)
        traffic.release()
        del traffic
        gc.collect()
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()
        readings = probe.judge(ctx.weights, control=control)
    finally:
        ctx.patches.restore()
    checked = {}
    for name in ctx.kind.NUMBERS:
        value = readings.get(name)
        checked[name] = {"value": value, "limit": limits[name]}
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in checked.values())
    failed = probe.failed_units()
    values = {}
    for name in metrics:
        v = load_metric(name)(rec)
        if v is not None:
            values[name] = v
    return {"correct": bool(correct and failed == 0), "attempted": units,
            "failed": failed, "values": values, "peak": peak,
            "checks": checked, "readings": readings, "run": rec}


def traced(ctx: Context, traffic, units: int, spans: bool) -> tuple:
    """`units` whole units under ``torch.profiler``: the raw kineto
    events, the wall seconds and the units' totals. With `spans` the
    host's activity and the benchmark's spans are traced too, else the
    device alone. Units whose trace holds no device event (CUPTI has been
    seen to drop a whole trace) are traced again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    cuda = str(ctx.device).startswith("cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    totals: Dict = {}
    for _ in range(3 if cuda else 1):
        ctx.sync()
        with profile(activities=acts if spans else acts[-1:]) as prof:
            ctx.inst.spanning = spans
            t0 = time.perf_counter()
            with torch.profiler.record_function("pb.window"):
                for _ in range(units):
                    with torch.profiler.record_function(
                            "pb." + traffic.unit_name):
                        out = traffic.unit()
                    for k, v in out.items():
                        totals[k] = totals.get(k, 0) + v
                ctx.sync()
            wall = time.perf_counter() - t0
            ctx.inst.spanning = False
        events = prof.profiler.kineto_results.events()
        if any(str(e.device_type()).endswith("CUDA") for e in events):
            break
    return events, wall, totals


def profile_units(ctx: Context, traffic) -> Dict:
    """The profiled sub-windows, with the timers off. First
    ``profile_units`` whole units tracing the device alone: the device's
    busy time over the sub-window's wall time and the operations that
    took most time. Then ``span_units`` units with the host's spans on as
    well: where the device's idle gaps fall and the device time launched
    inside each span."""
    n = int(ctx.mix["profile_units"])
    events, wall, totals = traced(ctx, traffic, n, spans=False)
    t1 = time.perf_counter()
    red = tracing.device_reading(events)
    red.update(window_s=wall, units=n, totals=totals,
               reduce_s=time.perf_counter() - t1)
    m = int(ctx.mix["span_units"])
    events, _, totals = traced(ctx, traffic, m, spans=True)
    t2 = time.perf_counter()
    spans = tracing.span_reading(events)
    red["spans"] = dict(spans, units=m, **work(ctx, traffic, m, totals))
    red["reduce_s"] += time.perf_counter() - t2
    return red


def device_stretch(ctx: Context, traffic) -> Dict:
    """The device stretch, read by the end-to-end metrics whose source is
    the device's trace: ``device_units`` whole units from the kind's
    ``device_start()`` (work fixed for every seed, in a seeded order),
    tracing the device alone. Its busy time follows the device's work,
    not the host's speed, which the window's wall time does."""
    t0 = time.perf_counter()
    traffic.device_start()
    n = int(ctx.mix["device_units"])
    events, wall, totals = traced(ctx, traffic, n, spans=False)
    red = tracing.device_reading(events)
    red.update(window_s=wall, units=n, totals=totals,
               stretch_s=time.perf_counter() - t0)
    return red


def work(ctx: Context, traffic, n: int, totals: Dict) -> Dict:
    """The work the configuration needs in `n` units, for the yardstick:
    ``flops``, the FLOPs of the forwards (and of the learner's steps:
    forward and backward, 3 forwards' worth), and ``bounds_s``, the least
    time of each of the architecture's kernels' work, by span."""
    arch = ctx.arch
    nf = arch.flops_per_position()
    rows = totals.get("learner_steps", 0) * ctx.cfg.replay.batch_size
    flops = n * traffic.positions_per_unit() * nf + 3 * rows * nf
    bounds = {}
    for span, _ in arch.kernels():
        bound = 0.0
        for batch, calls in traffic.forward_batches():
            for f, b, dtype, k in arch.kernel_work(span, batch):
                bound += n * calls * k * yardstick.bound_s(f, b, dtype)
        bounds[span] = bound
    return {"flops": flops, "bounds_s": bounds}
