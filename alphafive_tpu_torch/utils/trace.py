"""Spans and counters: the port's one tracing system.

Counters are always on. ``count(name, n)`` adds to an exact integer, and
every host read of a device value on the hot path goes through a sync
site (``read_bool``, ``read_int``, ``read_float``, ``read_list``), which
counts ``syncs.<site>``.

Spans are off by default; ``enable()`` turns them on. Off, ``span(name)``
returns one shared no-op context manager: a global check, no allocation,
no clock read. On:

* a span records its name, its start and end in ns and the index of its
  enclosing span. The clock is ``time.time_ns()``, the one
  ``torch.profiler``'s kineto events carry. While a profiler is active a
  span also opens ``record_function("af." + name)``, so a device trace
  puts each span on the device's timeline;
* a sync site's blocking read is the span ``sync.<site>``, a child of the
  enclosing span: a span's self time is the host issuing work, its
  ``sync.*`` descendants the host waiting;
* ``count_device(name, t)`` adds the sum of `t` into an accumulator on
  its device, with no host read.

``snapshot()`` returns ``{"spans": {name: {"calls", "total_s", "self_s",
"wait_s"}}, "counters": {name: int}}``: self time is the duration less
the child spans', ``wait_s`` the time in ``sync.*`` spans beneath; the
counters hold the sync counts and the device counters, read in one read
a device; ``counter(name)`` reads one host counter alone. ``reset()``
clears spans and counters, ``disable()`` stops recording spans. ``cli train --profile-iters`` turns spans on for the
profiled iterations; README.md lists the span names.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List

import torch

_on = False
_spans: List[list] = []            # [name, start_ns, end_ns, parent index]
_open: List[int] = []              # indices of the open spans, innermost last
_counts: Dict[str, int] = {}
_syncs: Dict[str, int] = {}
_device: Dict[str, torch.Tensor] = {}


_OFF = contextlib.nullcontext()   # every span while off


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name: str):
        self.rec = [name, 0, 0, -1]
        self.range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("af." + self.rec[0])
            self.range.__enter__()
        self.rec[3] = _open[-1] if _open else -1
        _open.append(len(_spans))
        _spans.append(self.rec)
        self.rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        if _open:
            _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager timing the block as span `name` (no-op when
    off)."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The host counter `name` (0 before its first count)."""
    return _counts.get(name, 0)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the sum of `t` into the device counter `name`, with no host
    read; only while spans are on."""
    if not _on:
        return
    total = t.detach().sum(dtype=torch.int64)
    acc = _device.get(name)
    if acc is None:
        _device[name] = total
    else:
        acc.add_(total)


def _reader(convert: Callable) -> Callable:
    def read(site: str, t: torch.Tensor):
        _syncs[site] = _syncs.get(site, 0) + 1
        if not _on:
            return convert(t)
        with _Span("sync." + site):
            return convert(t)
    return read


read_bool = _reader(bool)
read_int = _reader(int)
read_float = _reader(float)
read_list = _reader(torch.Tensor.tolist)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    _spans.clear()
    _open.clear()
    _counts.clear()
    _syncs.clear()
    _device.clear()


def snapshot() -> Dict:
    n = len(_spans)
    child, wait = [0] * n, [0] * n
    for name, s, e, parent in _spans:
        if e and parent >= 0:
            child[parent] += e - s
            if name.startswith("sync."):
                while parent >= 0:
                    wait[parent] += e - s
                    parent = _spans[parent][3]
    spans: Dict[str, Dict] = {}
    for i, (name, s, e, _) in enumerate(_spans):
        if not e:      # still open
            continue
        agg = spans.setdefault(name, {"calls": 0, "total_s": 0.0,
                                      "self_s": 0.0, "wait_s": 0.0})
        agg["calls"] += 1
        agg["total_s"] += (e - s) / 1e9
        agg["self_s"] += (e - s - child[i]) / 1e9
        agg["wait_s"] += wait[i] / 1e9
    counters = dict(_counts)
    counters.update(("syncs." + k, v) for k, v in _syncs.items())
    by_device: Dict[torch.device, List[str]] = {}
    for name, t in _device.items():
        by_device.setdefault(t.device, []).append(name)
    for names in by_device.values():
        values = torch.stack([_device[k] for k in names]).tolist()
        counters.update(zip(names, values))
    return {"spans": spans, "counters": counters}
