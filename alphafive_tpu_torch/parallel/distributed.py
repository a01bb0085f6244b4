"""Multi-process initialisation and helpers (port of
``alphafive_tpu/parallel/distributed.py``).

The data-parallel program runs one rank per GPU: every rank runs the same
loop on its shard of the envs and the ring, and the learner's gradients,
batch-norm statistics and metrics cross ranks through ``torch.distributed``
collectives (``parallel/mesh.py``, ``train/learner.py``). Rank 0 writes
the logs, the ladder sidecar and the exports; every rank writes its own
checkpoint shard (``train/checkpoint.py``).

Launch one process per GPU, either with torchrun::

    torchrun --nproc-per-node 4 -m alphafive_tpu_torch.cli train \\
        --multihost --preset host_15x15 --workdir runs/host

or with explicit flags on every process (``--coordinator host:port
--num-processes N --process-id r``).

Differences from the JAX module, by design:

* ``torch.distributed`` in place of ``jax.distributed``: NCCL between
  CUDA ranks, gloo on the CPU. ``backend=`` picks another explicitly (gloo
  between CUDA tensors lets two ranks share one card, which NCCL refuses
  as a duplicate GPU); nothing falls back to another backend.
* With no flags under ``--multihost`` the ranks come from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), the counterpart of JAX's auto-detected coordinator on
  TPU pods. A rank's card is ``LOCAL_RANK``, else its rank modulo the
  cards of its host.
* Host-side synchronisation (``barrier``, ``broadcast_object``: the
  checkpoint commit, rank 0's eval decision) runs on a second, gloo group
  with a timeout of ``HOST_TIMEOUT``. Ranks that wait while rank 0 plays
  the ladder eval wait there, with no NCCL work in flight, so the NCCL
  watchdog (which times only NCCL work) cannot end a healthy run.
* The tensor collectives flatten their tensors into one buffer, one call
  each, and take a mean as a sum divided by the world size (gloo has no
  average).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from alphafive_tpu_torch.utils import trace

# the host group's timeout: long enough for rank 0's ladder eval, which the
# other ranks wait out (2 games against the 200-rollout anchor took
# 175-323 s on one H100 80GB HBM3 at 700 W, PERF.md; the anchor's
# rollouts double a ladder level, and the presets play 32 games)
HOST_TIMEOUT = datetime.timedelta(hours=6)

# the gloo group of host-side synchronisation, made by ``initialize``
_host_group = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> None:
    """Join the process group: NCCL when `device` is CUDA, gloo on the
    CPU, unless `backend` names one. A no-op for one process without an
    explicit `backend` (a world of one under NCCL needs one). Without
    any of the three flags, torchrun's environment gives them. On CUDA
    the rank's card becomes the current device. A group already up with
    the same world and rank is kept."""
    global _host_group
    if num_processes is not None and num_processes <= 1 and backend is None:
        return
    flags = (coordinator_address, num_processes, process_id)
    if all(v is None for v in flags):
        env = os.environ
        if not {"RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"} <= set(env):
            raise ValueError(
                "--multihost needs --coordinator, --num-processes and "
                "--process-id, or torchrun's environment (RANK, WORLD_SIZE, "
                "MASTER_ADDR, MASTER_PORT)")
        init, world_size, rank_ = ("env://", int(env["WORLD_SIZE"]),
                                   int(env["RANK"]))
    elif any(v is None for v in flags):
        raise ValueError("give all of --coordinator, --num-processes and "
                         "--process-id, or none of them under torchrun")
    else:
        init, world_size, rank_ = (f"tcp://{coordinator_address}",
                                   num_processes, process_id)
    if world_size <= 1 and backend is None:
        return
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank_):
            raise RuntimeError(
                f"a process group of world {dist.get_world_size()} rank "
                f"{dist.get_rank()} is already up; asked for world "
                f"{world_size} rank {rank_}")
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank_ % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init, world_size=world_size, rank=rank_)
    _host_group = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def group():
    """The default process group, or None in a process without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes logs, the sidecar and exports."""
    return rank() == 0


def barrier(name: str = "alphafive") -> None:
    """Block until every rank reaches this point (on the host group)."""
    if world() > 1:
        try:
            dist.monitored_barrier(group=_host_group, timeout=HOST_TIMEOUT)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e


def scale_for_processes(n: int) -> int:
    """Each rank's share of a global count `n` (which must divide)."""
    p = world()
    if n % p:
        raise ValueError(f"global count {n} does not divide over {p} "
                         "processes")
    return n // p


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s `obj` on every rank (pickled, on the host group)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group)
    return box[0]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in like]), like)]


def all_reduce_mean(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """The mean over `group`'s ranks of each tensor (one dtype), as new
    tensors: one all-reduce of a sum, then a division by the world."""
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return _unflat(flat, tensors)


def all_reduce_sum(values: Sequence[float], group, device) -> List[float]:
    """The sums over `group`'s ranks of host numbers, in f64 (one
    all-reduce of a tensor on `device`, which NCCL needs on the card)."""
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return trace.read_list("all_reduce_sum", t)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Copy rank `src`'s tensors (one dtype) into every rank's, in
    place: one broadcast."""
    flat = _flat(tensors)
    dist.broadcast(flat, src=src, group=group)
    for t, x in zip(tensors, _unflat(flat, tensors)):
        t.copy_(x)
