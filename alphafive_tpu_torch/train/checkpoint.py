"""Bundled-model loading (the read side of ``alphafive_tpu/train/checkpoint.py``).

A bundle directory holds ``config.json`` (the RunConfig it was trained
with) and ``model.msgpack``, written by flax's ``serialization.to_bytes``:
nested string-keyed msgpack maps whose leaves are ext type 1 payloads, each
itself a msgpack ``(shape, dtype name, raw C-order bytes)`` triple. The host
that runs the port has neither flax nor msgpack, so this module decodes
that subset of msgpack itself and raises on anything outside it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

from alphafive_tpu_torch.config import RunConfig

_NDARRAY_EXT = 1  # flax serialization._MsgpackExtType.ndarray
_DTYPES = ("float32", "float64", "float16", "int8", "int16", "int32",
           "int64", "uint8", "uint16", "uint32", "uint64", "bool")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

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
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"),
                 0xC6: ("bin", ">I"), 0xD9: ("str", ">B"),
                 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"),
                 0xC9: ("ext", ">I")}
        if t in sized:
            kind, fmt = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

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
        return _ndarray(data)


def _ndarray(data: bytes) -> np.ndarray:
    r = _Reader(data)
    triple = r.value()
    if r.pos != len(data) or not (isinstance(triple, list)
                                  and len(triple) == 3):
        raise ValueError("malformed ndarray payload")
    shape, name, raw = triple
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name not in _DTYPES:
        raise ValueError(f"unsupported ndarray dtype {name!r}")
    arr = np.frombuffer(raw, dtype=np.dtype(name))
    return arr.reshape([int(s) for s in shape])


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the subset flax writes)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_model(directory: str
               ) -> Tuple[Dict[str, Any], Dict[str, Any], RunConfig]:
    """(params, batch_stats, RunConfig) of a bundle directory; params and
    batch stats are nested dicts of numpy arrays in flax's key layout."""
    with open(os.path.join(directory, "config.json")) as f:
        meta = json.load(f)
    cfg = RunConfig.from_json(json.dumps(meta["config"]))
    with open(os.path.join(directory, "model.msgpack"), "rb") as f:
        payload = unpackb(f.read())
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{directory}: not an exported model payload")
    return payload["params"], payload.get("batch_stats", {}), cfg
