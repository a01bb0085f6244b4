"""Timing a call on the card: device time by CUDA-graph replay, eager
CUDA-event time, and host time per call.

A kernel of a few microseconds launched from Python is enqueued no faster
than the host can prepare it (allocations, checks, a ctypes call), so
CUDA events around an eager loop of such calls measure the host.
``graph_ms`` captures the calls into one CUDA graph and times its replays:
the host prepares nothing then, and the window holds the device's work
and the launches' own cost. Calls that wait on the host (a ``.item()``,
an ``.all()`` in a loop) cannot be captured; ``eager_ms`` times those.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

WINDOWS, ITERS, WARMUP = 5, 20, 3   # median of 5 windows of 20 calls
HOST_CALLS = 400                    # one packed search's select launches


def _windows(run: Callable[[], None], per: int) -> Tuple[float, float]:
    """Median ms per call over WINDOWS event windows of `run` (which makes
    `per` calls), and the spread (slowest - fastest window)."""
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    times.sort()
    return times[len(times) // 2], times[-1] - times[0]


def graph_ms(fn: Callable[[], object]) -> Tuple[float, float]:
    """Device ms per call of `fn`: WARMUP eager calls on a side stream,
    then ITERS calls captured into one CUDA graph (their ``torch.empty``
    outputs come from the graph's pool, their launches go to the capture
    stream), one untimed replay, and the median and spread of WINDOWS
    timed replays. A call that cannot be captured raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = _windows(graph.replay, ITERS)
    del graph
    return out


def eager_ms(fn: Callable[[], object]) -> Tuple[float, float]:
    """ms per call of `fn` between CUDA events around eager loops of ITERS
    calls (after WARMUP calls): median and spread of WINDOWS windows."""
    for _ in range(WARMUP):
        fn()

    def loop():
        for _ in range(ITERS):
            fn()
    return _windows(loop, ITERS)


def host_us_per_call(fn: Callable[[], object],
                     calls: int = HOST_CALLS) -> float:
    """Wall µs per call over `calls` unsynchronised calls and one final
    synchronize: what a loop that launches `fn` once per step pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6
