"""Read a weights bundle: ``config.json`` and ``model.msgpack``.

``model.msgpack`` is flax's ``serialization.to_bytes`` of ``{"params",
"batch_stats"}``: nested string-keyed msgpack maps whose leaves are ext
type 1 payloads, each a msgpack ``(shape, dtype name, raw C-order
bytes)`` triple. This reads that subset of msgpack and raises on anything
outside it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

_NDARRAY_EXT = 1
_DTYPES = ("float32", "float64", "float16", "int8", "int16", "int32",
           "int64", "uint8", "uint16", "uint32", "uint64", "bool")
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return bytes(self.take(t & 0x1F)).decode()
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode()
            return getattr(self, kind)(n)
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code != _NDARRAY_EXT:
            raise ValueError(f"unsupported msgpack ext code {code}")
        shape, name, raw = unpackb(data)
        name = name.decode() if isinstance(name, bytes) else name
        if name not in _DTYPES:
            raise ValueError(f"unsupported ndarray dtype {name!r}")
        return np.frombuffer(raw, dtype=np.dtype(name)).reshape(
            [int(s) for s in shape])


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load(directory: str) -> Tuple[Dict[str, Any], Dict[str, Any],
                                  Dict[str, Any]]:
    """(params, batch_stats, saved config dict) of a bundle directory,
    as flax-layout trees of numpy arrays."""
    with open(os.path.join(directory, "config.json")) as f:
        meta = json.load(f)
    with open(os.path.join(directory, "model.msgpack"), "rb") as f:
        payload = unpackb(f.read())
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{directory}: not an exported model payload")
    return payload["params"], payload.get("batch_stats", {}), meta["config"]
