"""The benchmark's own instrumentation, from outside the program: wrappers
installed on the program's module attributes for the length of a run.

* ``Patches`` installs wrappers and takes them out again.
* ``Instruments``: synchronised timers, used over the whole window of a
  traced run, and ``torch.profiler.record_function`` ranges named
  ``pb.<name>``, used only inside the profiled sub-window.
* ``device_reading``: from a ``torch.profiler`` trace of the device
  alone, its busy time (the union of its operations' intervals) and the
  operations that took most time.
* ``span_reading``: from a trace with the host's spans, the idle gaps by
  the span the host was in, and the device time of the operations
  launched inside each span.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch


class Patches:
    """Module attributes replaced by wrappers, restored by ``restore``."""

    def __init__(self):
        self._saved: List = []

    def wrap(self, owner, name: str, make: Callable[[Callable], Callable]):
        old = getattr(owner, name)
        self._saved.append((owner, name, old))
        setattr(owner, name, make(old))

    def restore(self) -> None:
        while self._saved:
            owner, name, old = self._saved.pop()
            setattr(owner, name, old)


class Instruments:
    """Wrappers that, while ``timing`` is on, time the calls whose name is
    in ``timed`` between two synchronises (seconds summed by name), and
    while ``spanning`` is on, open a ``pb.<name>`` profiler range around
    every call. Off, a wrapper costs one Python call."""

    def __init__(self, timed, sync: Callable[[], None]):
        self.timed = set(timed)
        self.sync = sync
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.timing = self.spanning = False

    def wrap(self, name: Callable[..., str] | str, fn: Callable):
        def run(*args, **kw):
            if not (self.timing or self.spanning):
                return fn(*args, **kw)
            key = name(*args, **kw) if callable(name) else name
            if self.spanning:
                with torch.profiler.record_function("pb." + key):
                    return fn(*args, **kw)
            if key not in self.timed:
                return fn(*args, **kw)
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.sync()
            self.seconds[key] += time.perf_counter() - t0
            self.calls[key] += 1
            return out
        return run


def _union(intervals):
    """(total covered, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def device_reading(events, top: int = 10) -> Dict:
    """busy_s (the union of the device operations' intervals), the
    operations that took most time [[name, s]] and their count, from raw
    kineto events (``prof.profiler.kineto_results.events()``)."""
    device = [(ev.start_ns(), ev.end_ns(), ev.name()) for ev in events
              if str(ev.device_type()).endswith("CUDA")
              and not ev.is_user_annotation()]
    busy_ns, _ = _union([(s, e) for s, e, _ in device])
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_name[name[:120]] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_ns / 1e9, "device_ops": [[k, v] for k, v in ops],
            "device_events": len(device)}


def span_reading(events, top: int = 10) -> Dict:
    """From raw kineto events of a trace with host spans, over the span
    ``pb.window``: idle_gaps [[span, s]] (the device's idle time summed
    by the innermost ``pb.`` span open on the host when each gap began)
    and span_device_s {span: s} (the device time of the operations
    launched while that span was open on the host: the CUDA API call that
    shares an operation's correlation id dates it, or else the host op it
    is linked to)."""
    device, launch, frontend, spans = [], {}, {}, []
    for ev in events:
        dt = str(ev.device_type())
        if dt.endswith("CUDA"):
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.end_ns(),
                               ev.correlation_id(),
                               ev.linked_correlation_id()))
            continue
        if not ev.is_user_annotation() and ev.name().startswith("cu"):
            # a CUDA API call (cudaLaunchKernel, cudaLaunchKernelExC,
            # cuLaunchKernel, cudaMemcpyAsync ...)
            launch[ev.correlation_id()] = ev.start_ns()
        elif ev.linked_correlation_id() == 0:
            frontend[ev.correlation_id()] = ev.start_ns()
        if ev.is_user_annotation() and ev.name().startswith("pb."):
            spans.append((ev.start_ns(), ev.end_ns(), ev.name()[3:]))
    window = [(s, e) for s, e, name in spans if name == "window"]
    if len(window) != 1:
        raise ValueError("the trace needs exactly one pb.window span")
    t_start_ns, t_end_ns = window[0]
    _, merged = _union([(max(s, t_start_ns), min(e, t_end_ns))
                        for s, e, _, _ in device
                        if e > t_start_ns and s < t_end_ns])
    timeline = _span_timeline(spans)
    cuts = [t for t, _ in timeline]

    def stack_at(t):
        """The names of the spans open on the host at time t, outermost
        first."""
        i = bisect.bisect_right(cuts, t) - 1
        return timeline[i][1] if i >= 0 else ()

    gaps: Dict[str, float] = defaultdict(float)
    edges = [t_start_ns] + [x for iv in merged for x in iv] + [t_end_ns]
    for i in range(0, len(edges), 2):
        lo, hi = edges[i], edges[i + 1]
        if hi > lo:
            st = stack_at(lo)
            gaps[st[-1] if st else "none"] += (hi - lo) / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]

    span_device: Dict[str, float] = defaultdict(float)
    dated = 0
    for s, e, corr, link in device:
        t = launch.get(corr, frontend.get(link))
        if t is not None:
            dated += 1
            for name in set(stack_at(t)):
                span_device[name] += (e - s) / 1e9
    return {"window_s": (t_end_ns - t_start_ns) / 1e9,
            "idle_gaps": [[k, v] for k, v in idle],
            "span_device_s": dict(span_device),
            "device_events": len(device), "dated_events": dated}


def _span_timeline(spans):
    """[(time, names of the open spans, outermost first)] at every span
    boundary of properly nested host spans (start, end, name)."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    open_, out = [], []
    for t, is_start, i in marks:
        if is_start:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
        out.append((t, tuple(spans[j][2] for j in open_)))
    return out
