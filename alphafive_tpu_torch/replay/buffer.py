"""On-device ring replay buffer (port of ``alphafive_tpu/replay/buffer.py``).

Entries store the compact position (int8 flat board, to-play, last move,
bf16 π, int8 z and the validity flags) in fixed-capacity tensors on the
device; features are encoded and a random dihedral symmetry applied at
sample time (``utils/symmetry.py``). Writes are a wrap-around scatter at a
running pointer; sampling is a uniform gather over the filled prefix.
``z_valid`` marks positions whose game finished inside the collected chunk
(the learner masks the value loss by it); ``pi_valid`` marks π from a
full-budget search.

The port updates the ring in place (JAX returns a new buffer) and keeps
``ptr`` and ``size`` as host integers, so writing and sampling never wait
on the device. Randomness comes from a ``torch.Generator``; ``sample``
also takes the indices and symmetries as tensors, so a test can hand both
packages the same draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from alphafive_tpu_torch.config import EnvConfig, ReplayConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.utils import symmetry


@dataclasses.dataclass
class ReplayBuffer:
    board: torch.Tensor      # int8[C, A]
    to_play: torch.Tensor    # int8[C]
    last_move: torch.Tensor  # int32[C]
    pi: torch.Tensor         # bfloat16[C, A]
    z: torch.Tensor          # int8[C]
    z_valid: torch.Tensor    # bool[C]
    pi_valid: torch.Tensor   # bool[C] (π from a full-budget search)
    ptr: int = 0             # next write slot
    size: int = 0            # filled entries (<= C)


def init(env: EnvConfig, cfg: ReplayConfig, capacity: Optional[int] = None,
         device="cuda") -> ReplayBuffer:
    c = capacity if capacity is not None else cfg.capacity
    a = env.num_actions
    z = lambda shape, dt, fill=0: torch.full(shape, fill, dtype=dt,
                                             device=device)
    return ReplayBuffer(
        board=z((c, a), torch.int8), to_play=z((c,), torch.int8, 1),
        last_move=z((c,), torch.int32, -1), pi=z((c, a), torch.bfloat16),
        z=z((c,), torch.int8), z_valid=z((c,), torch.bool),
        pi_valid=z((c,), torch.bool))


def write(buf: ReplayBuffer, board, to_play, last_move, pi, z, z_valid,
          pi_valid=None) -> ReplayBuffer:
    """Append M entries (leading axis M <= capacity) with wrap-around, in
    place; returns `buf`."""
    c, m = buf.board.shape[0], board.shape[0]
    if m > c:
        raise ValueError(f"chunk {m} larger than buffer {c}")
    idx = (buf.ptr + torch.arange(m, device=buf.board.device)) % c
    if pi_valid is None:
        pi_valid = torch.ones(m, dtype=torch.bool, device=buf.board.device)
    buf.board[idx] = board.to(torch.int8)
    buf.to_play[idx] = to_play.to(torch.int8)
    buf.last_move[idx] = last_move.to(torch.int32)
    buf.pi[idx] = pi.to(torch.bfloat16)
    buf.z[idx] = z.to(torch.int8)
    buf.z_valid[idx] = z_valid.to(torch.bool)
    buf.pi_valid[idx] = pi_valid.to(torch.bool)
    buf.ptr = (buf.ptr + m) % c
    buf.size = min(buf.size + m, c)
    return buf


def sample(env: EnvConfig, buf: ReplayBuffer, batch_size: int,
           generator: Optional[torch.Generator] = None, *,
           idx: Optional[torch.Tensor] = None,
           sym: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Uniform minibatch with a random dihedral symmetry per example, both
    drawn from `generator` unless given as `idx` / `sym` [B].

    Returns (features[B,S,S,4] f32, pi[B,A] f32, z[B] f32, z_valid[B] f32,
    pi_valid[B] f32)."""
    dev = buf.board.device
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch_size,),
                            generator=generator, device=dev)
    if sym is None:
        sym = torch.randint(0, symmetry.NUM_SYMMETRIES, (batch_size,),
                            generator=generator, device=dev)
    s = env.board_size
    board = symmetry.apply_symmetry(s, sym, buf.board[idx])
    pi = symmetry.apply_symmetry(s, sym, buf.pi[idx].float())
    last = symmetry.apply_symmetry_index(s, sym, buf.last_move[idx])
    feats = vector.features(env, board, buf.to_play[idx], last)
    return (feats, pi, buf.z[idx].float(), buf.z_valid[idx].float(),
            buf.pi_valid[idx].float())
