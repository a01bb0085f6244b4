"""Shared arithmetic of the metric readers (``perfbench/metrics/``).

Each reader takes the run record (``harness.Run``) and returns a number,
or None where the run holds nothing to read (no traced window, no such
timer, no device time in the span): the harness then leaves the metric
out of the result line. None is never replaced by 0.
"""

from __future__ import annotations

from typing import Optional

from perfbench import yardstick


def rate(run, key: str) -> Optional[float]:
    """`key` per second over the whole window."""
    n = run.totals.get(key)
    return n / run.elapsed if n and run.elapsed > 0 else None


def timer_ms_per_unit(run, name: str) -> Optional[float]:
    """A synchronised timer's milliseconds per unit of the traced
    window."""
    s = run.timers.get(name)
    if s is None or not run.units:
        return None
    return 1e3 * s / run.units


def roofline(run, span: str = "resblock") -> Optional[float]:
    """% of the least time of the work of `span`'s kernel (one of the
    architecture's kernels) the configuration needs in the spans'
    sub-window, over the device time of what was launched inside the
    span."""
    p = run.profile and run.profile["spans"]
    t = p and p["span_device_s"].get(span)
    if not t or span not in p["bounds_s"]:
        return None
    return 100.0 * p["bounds_s"][span] / t


def mfu(run) -> Optional[float]:
    """% of the bf16 peak: the FLOPs the configuration needs in the
    traced window (its timers cost a few synchronises a unit) over the
    window's wall seconds. Read only in a traced run on the card (a
    trace in which the device ran something)."""
    if (run.profile is None or not run.profile["busy_s"] or not run.work
            or run.elapsed <= 0):
        return None
    return 100.0 * run.work["flops"] / run.elapsed / yardstick.PEAK_FLOPS[
        "bfloat16"]


def idle_share(run) -> Optional[float]:
    """% of the profiled sub-window in which no operation ran on the
    device."""
    p = run.profile
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
