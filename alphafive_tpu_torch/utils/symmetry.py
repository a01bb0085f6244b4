"""8-fold dihedral symmetry of square boards as gather permutations (port
of ``alphafive_tpu/utils/symmetry.py``).

Augmentation happens at sample time: one gather with a precomputed
permutation per symmetry element, applied identically to the flat board
and π (both are fields over cells), so the replay ring stores each
position once. Tables, built once per board size and device:

  perm[k, i] = flat source cell of destination cell i under symmetry k
  inv[k, j]  = destination cell of source cell j (for last-move indices)
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

NUM_SYMMETRIES = 8


def _np_tables(size: int) -> Tuple[np.ndarray, np.ndarray]:
    base = np.arange(size * size).reshape(size, size)
    perms = []
    for flip in (False, True):
        m = np.fliplr(base) if flip else base
        for rot in range(4):
            perms.append(np.rot90(m, rot).reshape(-1))
    perm = np.stack(perms)                                   # [8, A]
    inv = np.empty_like(perm)
    for k in range(NUM_SYMMETRIES):
        inv[k, perm[k]] = np.arange(size * size)
    return perm, inv


@functools.lru_cache(maxsize=None)
def dihedral_tables(size: int, device="cpu") -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(perm, inv) int64 [8, size²] on `device`."""
    return tuple(torch.from_numpy(t).to(torch.device(device))
                 for t in _np_tables(size))


def apply_symmetry(size: int, k: torch.Tensor,
                   field: torch.Tensor) -> torch.Tensor:
    """Permute per-cell field[B, A] by symmetry k[B] (one gather)."""
    perm, _ = dihedral_tables(size, field.device)
    return field.gather(1, perm[k.long()])


def apply_symmetry_index(size: int, k: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Map flat cell indices idx[B] (−1 passes through) under symmetry
    k[B]."""
    _, inv = dihedral_tables(size, idx.device)
    mapped = inv[k.long(), idx.long().clamp(min=0)].to(idx.dtype)
    return torch.where(idx < 0, idx, mapped)
