"""Bundles and full-state training checkpoints (port of
``alphafive_tpu/train/checkpoint.py``).

**Bundles** (``export_model`` / ``load_model``). A bundle directory holds
``config.json`` (the RunConfig it was trained with, plus extra keys such
as the iteration) and ``model.msgpack``, flax's ``serialization.to_bytes``
of ``{"params", "batch_stats"}``: nested string-keyed msgpack maps whose
leaves are ext type 1 payloads, each itself a msgpack ``(shape, dtype
name, raw C-order bytes)`` triple. The host that runs the port has
neither flax nor msgpack, so this module reads and writes that subset of
msgpack itself (``unpackb``, ``packb``) and raises on anything outside
it. ``export_model`` writes the bytes flax writes for the same tree (keys
below the top level sorted, as ``jax.device_get`` leaves them), so each
package reads the other's bundles.

**Full-state checkpoints** (``make_manager``, ``save``, ``restore``,
``read_meta``, ``restore_train_state``) capture the whole training state,
as the JAX package's orbax checkpoints do, so a resume is bit-reproducible.
Orbax cannot be read or written without JAX, so the port has a format of
its own, one directory a step::

    <dir>/<step>/meta.json   config JSON, ladder JSON, iteration, the
                             world size that wrote it (+ extra)
    <dir>/<step>/model.pt    the train state: the net's parameters and
                             buffers, the optimizer's count and moments,
                             the step and lr_scale
    <dir>/<step>/carry.pt    the rest of TrainCarry: envs, the ring with
                             its host ptr/size, the staged recordings,
                             has_pending and the generator's state

written by ``torch.save`` into ``<step>.tmp``, flushed to disk and renamed,
so a killed save never leaves a step behind; the newest ``max_to_keep``
steps are kept. ``restore_train_state`` reads ``meta.json`` and
``model.pt`` alone, so a checkpoint written on the card restores on the
CPU. A JAX (orbax) step directory is refused with a pointer to ``cli
export``: the msgpack bundle is the format both packages share.

Under a process group (``parallel/distributed.py``) ``save`` and
``restore`` are collective, as orbax's are: rank 0 writes ``meta.json``
and ``model.pt`` (the train state is replicated) and each rank ``r``
writes its envs, ring, staging buffer and generator as
``carry.rank{r}.pt``; the rename follows a barrier, so a step exists only
with every shard in it. A world of one writes ``carry.pt``, the
one-device layout. The shards are not re-sharded: restoring at another
world size raises and names both. The step directories must lie on a
filesystem every rank sees.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from alphafive_tpu_torch.config import RunConfig
from alphafive_tpu_torch.parallel import distributed
from alphafive_tpu_torch.utils.elo import LadderState

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


def _pack_int(n: int, out: bytearray) -> None:
    """msgpack-python's choice: the smallest format, unsigned when >= 0."""
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out += struct.pack(">b", n)
    else:
        for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"),
                                  (-0x80, -1, 0xD0, ">b"),
                                  (0, 0xFFFF, 0xCD, ">H"),
                                  (-0x8000, -1, 0xD1, ">h"),
                                  (0, 0xFFFFFFFF, 0xCE, ">I"),
                                  (-0x80000000, -1, 0xD2, ">i"),
                                  (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                                  (-0x8000000000000000, -1, 0xD3, ">q")):
            if lo <= n <= hi:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix: Optional[int], fix_max: int,
              codes: Tuple[int, ...]) -> None:
    """A length header: the fix form below `fix_max`, else 8/16/32-bit
    (`codes` from the narrowest; None where the type has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(len(obj), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack map key {k!r} is not a string")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.name not in _DTYPES:
            raise TypeError(f"unsupported ndarray dtype {obj.dtype.name!r}")
        # flax serialization._ndarray_to_bytes
        data = packb((obj.shape, obj.dtype.name, obj.tobytes("C")))
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixext:
            out.append(fixext[len(data)])
        else:
            _pack_len(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _NDARRAY_EXT)
        out += data
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode one object as msgpack-python's ``packb(use_bin_type=True)``
    does, ndarrays as flax's ext type 1: the inverse of ``unpackb``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _host_tree(tree) -> Dict[str, Any]:
    """A flax-layout tree (tensors or arrays) as numpy with its keys
    sorted at every level, as ``jax.device_get`` rebuilds it."""
    return {k: _host_tree(tree[k]) if isinstance(tree[k], dict) else
            (tree[k].detach().cpu().numpy() if isinstance(tree[k],
                                                          torch.Tensor)
             else np.asarray(tree[k]))
            for k in sorted(tree)}


def export_model(directory: str, params, batch_stats, cfg: RunConfig,
                 extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a bundle: ``model.msgpack`` byte-equal to flax's
    ``to_bytes`` of the same trees and ``config.json`` as the JAX package
    writes it. `params`/`batch_stats` are flax-layout trees
    (the training net's ``to_flax()``)."""
    os.makedirs(directory, exist_ok=True)
    payload = {"params": _host_tree(params),
               "batch_stats": _host_tree(batch_stats)}
    with open(os.path.join(directory, "model.msgpack"), "wb") as f:
        f.write(packb(payload))
    meta = {"config": json.loads(cfg.to_json()), **(extra or {})}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)


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


# --- full-state checkpoints ---------------------------------------------

META, MODEL, CARRY = "meta.json", "model.pt", "carry.pt"
# what an orbax step directory of the JAX package holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "state")


class CheckpointManager:
    """The step directories under `directory` (the port's counterpart of
    orbax's ``CheckpointManager``)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Every complete step, ascending. A ``<step>.tmp`` left by a
        killed save is not a step; a JAX (orbax) step raises."""
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if not name.isdigit():
                continue
            path = os.path.join(self.directory, name)
            if not os.path.exists(os.path.join(path, META)):
                if any(os.path.exists(os.path.join(path, m))
                       for m in _ORBAX_MARKERS):
                    raise ValueError(
                        f"{path} is an orbax checkpoint of the JAX package, "
                        "which the port cannot read. Export it with the JAX "
                        "package's `cli export --workdir <run> --out <dir>` "
                        "and pass the bundle directory to the port "
                        "(--workdir for eval/play, --init-from for train).")
                raise ValueError(f"{path}: not a checkpoint step (no {META})")
            steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def _fields(obj) -> Dict[str, Any]:
    """A dataclass's fields by name, the tensors themselves (no copy)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _train_state_dict(ts) -> Dict[str, Any]:
    st = ts.opt_state
    return {"net": ts.net.state_dict(),
            "opt_state": {"count": st.count, "mu": list(st.mu),
                          "nu": list(st.nu)},
            "step": ts.step, "lr_scale": ts.lr_scale}


def _carry_dict(carry) -> Dict[str, Any]:
    return {"env_state": _fields(carry.env_state),
            "buffer": _fields(carry.buffer),
            "pending": _fields(carry.pending),
            "has_pending": carry.has_pending,
            "generator": carry.generator.get_state(),
            "generator_device": carry.generator.device.type}


def _write_durably(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _shard(world: int, rank: int) -> str:
    """The file of a rank's carry shard: the one-device name at world 1."""
    return CARRY if world == 1 else f"carry.rank{rank}.pt"


def save(mgr: CheckpointManager, iteration: int, carry, cfg: RunConfig,
         ladder: LadderState, extra: Optional[Dict[str, Any]] = None
         ) -> bool:
    """Write step `iteration` of `carry` (a ``parallel.TrainCarry``, this
    rank's), then drop all but the newest ``mgr.max_to_keep`` steps. A
    step at or below the latest saved one is skipped (orbax's rule) and
    False returned. Collective under a process group: every rank calls
    it; rank 0 decides the skip, writes the metadata and the train state
    and commits the step once every shard is written."""
    world, rank = distributed.world(), distributed.rank()
    latest = distributed.broadcast_object(mgr.latest_step() if rank == 0
                                          else None)
    if latest is not None and latest >= iteration:
        return False
    final = mgr.step_dir(iteration)
    tmp = final + ".tmp"
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    distributed.barrier("checkpoint-open")
    _write_durably(os.path.join(tmp, _shard(world, rank)),
                   lambda f: torch.save(_carry_dict(carry), f))
    if rank == 0:
        meta = {"config": cfg.to_json(),
                "ladder": json.dumps(dataclasses.asdict(ladder)),
                "iteration": iteration, "world": world, **(extra or {})}
        _write_durably(os.path.join(tmp, META),
                       lambda f: f.write(json.dumps(meta).encode()))
        _write_durably(os.path.join(tmp, MODEL),
                       lambda f: torch.save(
                           _train_state_dict(carry.train_state), f))
    distributed.barrier("checkpoint-written")
    if rank == 0:
        os.rename(tmp, final)
        for step in mgr.all_steps()[:-mgr.max_to_keep]:
            shutil.rmtree(mgr.step_dir(step))
    distributed.barrier("checkpoint-committed")
    return True


def _ladder_from_dict(lad: Dict[str, Any]) -> LadderState:
    """Rebuild LadderState tolerating fields added after a save (e.g.
    ``max_rollouts``: dropping it would silently revert a customised
    anchor cap on resume)."""
    defaults = LadderState()
    return LadderState(
        level=lad["level"],
        base_rollouts=lad["base_rollouts"],
        promote_score=lad["promote_score"],
        max_rollouts=lad.get("max_rollouts", defaults.max_rollouts),
        history=lad["history"])


def _step(mgr: CheckpointManager, iteration: Optional[int]) -> int:
    step = iteration if iteration is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
    return step


def _read_meta(mgr: CheckpointManager, step: int) -> Dict[str, Any]:
    with open(os.path.join(mgr.step_dir(step), META)) as f:
        return json.load(f)


def read_meta(mgr: CheckpointManager, iteration: Optional[int] = None
              ) -> Tuple[int, RunConfig, LadderState]:
    """(iteration, RunConfig, LadderState) of a checkpoint's metadata
    (the latest step unless `iteration` is given)."""
    meta = _read_meta(mgr, _step(mgr, iteration))
    return (int(meta["iteration"]), RunConfig.from_json(meta["config"]),
            _ladder_from_dict(json.loads(meta["ladder"])))


def _load(mgr: CheckpointManager, step: int, name: str, device):
    return torch.load(os.path.join(mgr.step_dir(step), name),
                      map_location=device, weights_only=True)


@torch.no_grad()
def _copy_into(dst: Dict[str, Any], src: Dict[str, Any], what: str) -> None:
    """Copy saved tensors into the live ones, refusing a shape or dtype
    that does not fit (a checkpoint of another configuration)."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: saved fields {sorted(src)} differ from "
                         f"{sorted(dst)}")
    for k, t in dst.items():
        if not isinstance(t, torch.Tensor):
            continue
        s = src[k]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"{what}.{k}: saved {s.dtype}{list(s.shape)} "
                             f"does not fit {t.dtype}{list(t.shape)}")
        t.copy_(s)


@torch.no_grad()
def _load_train_state(ts, saved: Dict[str, Any]) -> None:
    ts.net.load_state_dict(saved["net"])
    st, opt = ts.opt_state, saved["opt_state"]
    if (len(opt["mu"]), len(opt["nu"])) != (len(st.mu), len(st.nu)):
        raise ValueError("saved optimizer moments do not fit the optimizer")
    _copy_into(dict(enumerate(st.mu + st.nu)),
               dict(enumerate(opt["mu"] + opt["nu"])), "opt_state")
    st.count = int(opt["count"])
    ts.step = int(saved["step"])
    ts.lr_scale.copy_(saved["lr_scale"])


def restore(mgr: CheckpointManager, carry_like, iteration: Optional[int] = None
            ) -> Tuple[int, Any, RunConfig, LadderState]:
    """Restore a step (the latest unless `iteration` is given) into
    `carry_like`, a carry of the same configuration, in place on its
    device: the train state and this rank's shard. Returns (iteration,
    carry, saved RunConfig, LadderState). The generator's state restores
    onto a generator of the device type that saved it. A step written by
    another world size raises."""
    step = _step(mgr, iteration)
    world, rank = distributed.world(), distributed.rank()
    saved_world = int(_read_meta(mgr, step).get("world", 1))
    if saved_world != world:
        raise ValueError(
            f"{mgr.step_dir(step)} holds the shards of a world of "
            f"{saved_world} rank(s); this run has a world of {world}. "
            f"Resume with {saved_world} rank(s): checkpoints are not "
            "re-sharded")
    it, cfg, ladder = read_meta(mgr, step)
    _load_train_state(carry_like.train_state,
                      _load(mgr, step, MODEL, "cpu"))
    saved = _load(mgr, step, _shard(world, rank), "cpu")
    c = carry_like
    _copy_into(_fields(c.env_state), saved["env_state"], "env_state")
    _copy_into(_fields(c.buffer), saved["buffer"], "buffer")
    c.buffer.ptr, c.buffer.size = (int(saved["buffer"]["ptr"]),
                                   int(saved["buffer"]["size"]))
    _copy_into(_fields(c.pending), saved["pending"], "pending")
    c.has_pending = bool(saved["has_pending"])
    if saved["generator_device"] != c.generator.device.type:
        raise ValueError(f"the checkpoint's generator ran on "
                         f"{saved['generator_device']}; the carry's is on "
                         f"{c.generator.device.type}")
    c.generator.set_state(saved["generator"])
    return it, c, cfg, ladder


def restore_train_state(mgr: CheckpointManager,
                        iteration: Optional[int] = None, device="cuda"):
    """Model-only restore from any preset: the train state alone, built
    from the checkpoint's own saved config on `device` (``meta.json`` and
    ``model.pt``; no envs, ring or generator). Returns (train_state,
    saved RunConfig)."""
    from alphafive_tpu_torch.models import nets
    from alphafive_tpu_torch.train import learner

    step = _step(mgr, iteration)
    _, cfg, _ = read_meta(mgr, step)
    saved = _load(mgr, step, MODEL, device)
    net = nets.build(cfg.env, cfg.net, device)
    ts = learner.TrainState(
        net=net, opt_state=learner.init_opt_state(cfg.train,
                                                  list(net.parameters())),
        step=0, lr_scale=torch.ones((), device=device))
    _load_train_state(ts, saved)
    return ts, cfg
