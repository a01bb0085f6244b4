"""Batched PUCT descent over a packed tree: CUDA kernel wrapper and plain
version.

Port of ``alphafive_tpu/ops/pallas_select.py``. The tree of every env is
one f32 array ``packed[E, NN, 8, A_pad]`` whose section axis holds

    0: N(node, a)      edge visit counts
    1: W(node, a)      edge value sums
    2: P(node, a)      prior, sign-masked (illegal and pad cells store -1)
    3: child(node, a)  child node id as a float (-1 = unexpanded)
    4: meta            slot 0: the node's terminal flag (1.0 / 0.0)
    5-7: unused

with ``A_pad`` the action count rounded up to 128, the TPU kernel's
layout, kept so both packages share one interface. From each env's root
the descent takes the PUCT argmax (ties to the lowest action; the root
forced-playout gate scores +inf) until it reaches an unexpanded edge, a
terminal node or the depth cap. ``select_batch`` checks the tree against
the kernel's contract on every device, then launches the hand-written
kernel ``csrc/select.cu`` on CUDA tensors and runs
``select_batch_reference`` on CPU tensors; on any other device it raises.
The two are bit-equal: one flipped argmax would change the visit counts.
Kernel launches are counted as ``select_launches`` (``utils/trace.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from alphafive_tpu_torch.utils import trace

# packed-section indices
SEC_N, SEC_W, SEC_P, SEC_CHILD, SEC_META = 0, 1, 2, 3, 4
NUM_SEC = 8


def __getattr__(name: str):
    """``select_launches`` as a module attribute: a view of the counter,
    as ``perfbench/run.py`` reads it."""
    if name == "select_launches":
        return trace.counter(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def pad_actions(a: int) -> int:
    return ((a + 127) // 128) * 128


def select_batch_reference(packed: torch.Tensor, num_actions: int,
                           depth_limit: int, c_puct: float,
                           forced_k: float = 0.0
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: the body of the TPU kernel's
    ``_select_kernel`` as a loop over descent steps for all envs at once,
    with the same op order (one host sync per step)."""
    e, _, _, a_pad = packed.shape
    d = depth_limit
    dev = packed.device
    earange = torch.arange(e, device=dev)
    lane = torch.arange(a_pad, device=dev)
    cur = torch.zeros(e, dtype=torch.long, device=dev)
    act = torch.full((e,), -1, dtype=torch.long, device=dev)
    stop = torch.zeros(e, dtype=torch.bool, device=dev)
    depth = torch.zeros(e, dtype=torch.long, device=dev)
    pn = torch.zeros((e, d), dtype=torch.int32, device=dev)
    pa = torch.zeros((e, d), dtype=torch.int32, device=dev)
    it = 0
    while it < d and not bool(stop.all()):
        rows = packed[earange, cur]                            # [E, 8, A_pad]
        n, w = rows[:, SEC_N], rows[:, SEC_W]
        p_signed, child_f = rows[:, SEC_P], rows[:, SEC_CHILD]
        revisit = (rows[:, SEC_META, 0] > 0.5) | (depth >= d)
        legal = (p_signed >= 0) & (lane < num_actions)
        pp = p_signed.clamp(min=0.0)
        q = torch.where(n > 0, w / n.clamp(min=1.0), 0.0)
        ns = 1.0 + n.sum(dim=-1, keepdim=True)   # integer sums: exact
        u = c_puct * pp * torch.sqrt(ns) / (1.0 + n)
        score = torch.where(legal, q + u, float("-inf"))
        forced = (legal & (depth == 0)[:, None] & (n > 0)
                  & (n * n < forced_k * pp * (ns - 1.0)))
        score = torch.where(forced, float("inf"), score)
        amax = score.argmax(dim=-1)              # first maximum on ties
        ch = child_f[earange, amax].long()

        live = ~stop
        newly_stop = live & (revisit | (ch < 0))
        rec = live & ~revisit
        pn[:, it] = torch.where(rec, cur, 0).int()
        pa[:, it] = torch.where(rec, amax, 0).int()
        depth = depth + rec.long()
        nxt = torch.where(stop | newly_stop, cur, ch)
        act = torch.where(stop, act, torch.where(revisit, -1, amax))
        stop = stop | newly_stop
        cur = nxt
        it += 1
    # lanes that never stopped hit the depth cap: revisit their node
    act = torch.where(stop, act, -1)
    return cur.int(), act.int(), depth.int(), pn, pa


def _check(packed: torch.Tensor, num_actions: int, depth_limit: int):
    if packed.dim() != 4 or packed.shape[2] != NUM_SEC:
        raise ValueError(f"packed must be [E, NN, {NUM_SEC}, A_pad], got "
                         f"{tuple(packed.shape)}")
    e, nn, _, a_pad = packed.shape
    if packed.dtype != torch.float32:
        raise TypeError(f"packed must be float32, got {packed.dtype}")
    if a_pad != pad_actions(num_actions) or num_actions < 1:
        raise ValueError(f"A_pad {a_pad} != pad_actions({num_actions})")
    if not 1 <= depth_limit <= nn:
        raise ValueError(f"depth_limit {depth_limit} not in [1, {nn}]")
    if nn >= 1 << 24:
        raise ValueError("child ids are exact in f32 only below 2^24 nodes")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.data_ptr() % 16:   # the kernel loads 16 B per lane
        raise ValueError("packed must be 16-byte aligned")


def select_batch(packed: torch.Tensor, num_actions: int, depth_limit: int,
                 c_puct: float, forced_k: float = 0.0
                 ) -> Tuple[torch.Tensor, ...]:
    """packed f32[E, NN, 8, A_pad] → (leaf i32[E], act i32[E] (-1 =
    revisit), depth i32[E], path nodes i32[E, D], path actions i32[E, D]),
    path entries zero beyond each env's depth."""
    _check(packed, num_actions, depth_limit)
    if packed.device.type == "cpu":
        return select_batch_reference(packed, num_actions, depth_limit,
                                      c_puct, forced_k)
    if packed.device.type != "cuda":
        raise RuntimeError(f"no select kernel for device {packed.device}")
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    e, nn, _, a_pad = packed.shape
    i32 = dict(dtype=torch.int32, device=packed.device)
    leaf, act, depth = (torch.empty(e, **i32) for _ in range(3))
    pn = torch.empty((e, depth_limit), **i32)
    pa = torch.empty((e, depth_limit), **i32)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.alphafive_select(
        packed.data_ptr(), e, nn, a_pad, num_actions, depth_limit,
        float(c_puct), float(forced_k), leaf.data_ptr(), act.data_ptr(),
        depth.data_ptr(), pn.data_ptr(), pa.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"select kernel launch failed: CUDA error {err}")
    trace.count("select_launches")
    return leaf, act, depth, pn, pa
