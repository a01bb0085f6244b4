"""Vectorized Gomoku/Renju engine on torch tensors.

Port of ``alphafive_tpu/env/vector.py``: ``E`` boards step in lockstep as
flat ``int8[E, A]`` tensors. Win detection is the same local line scan —
only the 4 lines through the placed stone can complete a run, so each step
gathers a fixed 11-cell window per direction from precomputed index and
validity tables and measures the run through the center.

The JAX engine picks the window cells with a one-hot slab and an int8
matmul (a TPU gather workaround); here they are one ``torch.gather`` of the
``line_tables`` indices, which gives the same cells bit for bit. All three
rule sets (freestyle, renju_lite, renju) are kept in exact lockstep with
the scalar oracle ``alphafive_tpu/env/scalar.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from alphafive_tpu_torch.config import EnvConfig, FREESTYLE, RENJU, RENJU_LITE

WINDOW = 11  # offsets -5..5 through the placed stone
HALF = WINDOW // 2
_DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


@dataclasses.dataclass
class EnvState:
    """Batched game state. All tensors lead with the env axis E."""

    board: torch.Tensor      # int8[E, A]  (+1 black, -1 white, 0 empty)
    to_play: torch.Tensor    # int8[E]     (+1 / -1)
    last_move: torch.Tensor  # int32[E]    (flat action, -1 before first move)
    move_count: torch.Tensor  # int32[E]
    done: torch.Tensor       # bool[E]
    winner: torch.Tensor     # int8[E]     (+1 / -1 / 0)

    def map(self, fn) -> "EnvState":
        """EnvState with `fn` applied to every field."""
        return EnvState(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})


@functools.lru_cache(maxsize=None)
def line_tables(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-action gather tables for the 4 lines through each cell.

    Returns (idx, ok): int32[A, 4, WINDOW] flat indices (clamped in-bounds)
    and bool[A, 4, WINDOW] validity masks. Host-side, cached per board size.
    """
    a = size * size
    idx = np.zeros((a, 4, WINDOW), dtype=np.int32)
    ok = np.zeros((a, 4, WINDOW), dtype=bool)
    for act in range(a):
        r, c = divmod(act, size)
        for d, (dr, dc) in enumerate(_DIRECTIONS):
            for w in range(WINDOW):
                o = w - HALF
                rr, cc = r + o * dr, c + o * dc
                valid = 0 <= rr < size and 0 <= cc < size
                ok[act, d, w] = valid
                idx[act, d, w] = (rr * size + cc) if valid else 0
    return idx, ok


@functools.lru_cache(maxsize=None)
def _device_tables(size: int, device: torch.device):
    idx, ok = line_tables(size)
    return (torch.from_numpy(idx).long().to(device),
            torch.from_numpy(ok).to(device))


def init(cfg: EnvConfig, num_envs: int,
         device: torch.device | str = "cpu") -> EnvState:
    a = cfg.num_actions
    return EnvState(
        board=torch.zeros((num_envs, a), dtype=torch.int8, device=device),
        to_play=torch.ones((num_envs,), dtype=torch.int8, device=device),
        last_move=torch.full((num_envs,), -1, dtype=torch.int32,
                             device=device),
        move_count=torch.zeros((num_envs,), dtype=torch.int32, device=device),
        done=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        winner=torch.zeros((num_envs,), dtype=torch.int8, device=device),
    )


def _line_cells(cfg: EnvConfig, board: torch.Tensor, action: torch.Tensor):
    """(cells int8[E,4,W], ok bool[E,4,W]) for the 4 lines through action.
    Out-of-board window cells read cell 0 and are masked by `ok`."""
    e = board.shape[0]
    idx_t, ok_t = _device_tables(cfg.board_size, board.device)
    a = action.long()
    cells = torch.gather(board, 1, idx_t[a].reshape(e, -1))
    return cells.reshape(e, 4, WINDOW), ok_t[a]


def _runs_from_cells(cells: torch.Tensor, ok: torch.Tensor,
                     player: torch.Tensor) -> torch.Tensor:
    own = (cells == player[:, None, None].to(torch.int8)) & ok
    total = torch.zeros(own.shape[:-1], dtype=torch.int32,
                        device=own.device)
    acc = torch.ones(own.shape[:-1], dtype=torch.bool, device=own.device)
    for k in range(1, HALF + 1):         # offsets +1..+5
        acc = acc & own[..., HALF + k]
        total = total + acc.int()
    acc = torch.ones(own.shape[:-1], dtype=torch.bool, device=own.device)
    for k in range(1, HALF + 1):         # offsets -1..-5
        acc = acc & own[..., HALF - k]
        total = total + acc.int()
    return 1 + total


def runs_through(cfg: EnvConfig, board: torch.Tensor, action: torch.Tensor,
                 player: torch.Tensor) -> torch.Tensor:
    """int32[E, 4]: longest run of `player` through `action`, per direction.

    `board` must already contain the placed stone. Exact for runs <= 6 (and
    lower-bounded by 6 beyond), which is all the rules need.
    """
    cells, ok = _line_cells(cfg, board, action)
    return _runs_from_cells(cells, ok, player)


def _renju_doubles(cells: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """bool[E]: the just-placed BLACK stone (window center) made a
    double-four or double-three — mirror of scalar._renju_line_counts (the
    oracle, whose docstring defines both)."""
    blk = (cells == 1) & ok
    emp = (cells == 0) & ok
    bi, ei = blk.int(), emp.int()

    # fours: 5-windows s..s+4 (s in 1..5 keeps the center inside)
    cand4 = torch.stack([
        ((bi[..., s:s + 5].sum(-1) == 4) & (ei[..., s:s + 5].sum(-1) == 1)
         & ~blk[..., s - 1] & ~blk[..., s + 5])   # completion is exact 5
        for s in range(1, 6)], dim=-1)            # bool[E, 4, 5]
    fours = cand4.int().sum(-1)
    for s in range(1, 5):  # straight four = same stones in s and s+1
        fours = fours - (cand4[..., s - 1] & cand4[..., s]
                         & blk[..., s + 1:s + 5].all(-1)).int()

    # open threes: 4-windows t..t+3 (t in 2..5 keeps the center inside)
    cand3 = torch.stack([
        ((bi[..., t:t + 4].sum(-1) == 3) & (ei[..., t:t + 4].sum(-1) == 1)
         & emp[..., t - 1] & emp[..., t + 4]      # straight-four ends open
         & ~blk[..., t - 2] & ~blk[..., t + 5])   # both fives exact
        for t in range(2, 6)], dim=-1)            # bool[E, 4, 4]
    threes = cand3.int().sum(-1)
    for t in range(2, 5):  # consecutive three = same stones in t and t+1
        threes = threes - (cand3[..., t - 2] & cand3[..., t - 1]
                           & blk[..., t + 1:t + 4].all(-1)).int()

    return (fours.sum(-1) >= 2) | (threes.sum(-1) >= 2)


def _outcome(cfg: EnvConfig, runs: torch.Tensor, player: torch.Tensor,
             cells: torch.Tensor, ok: torch.Tensor):
    """(win, forbidden) bool[E] — mirrors the scalar oracle exactly."""
    n = cfg.n_in_row
    if cfg.rules == FREESTYLE:
        return (runs >= n).any(-1), torch.zeros_like(runs[..., 0],
                                                     dtype=torch.bool)
    white = player < 0
    any_ge = (runs >= n).any(-1)
    exact = (runs == n).any(-1)
    over = (runs > n).any(-1)
    win = torch.where(white, any_ge, exact)
    if cfg.rules == RENJU_LITE:
        return win, (~white) & over & ~exact
    if cfg.rules != RENJU:
        raise ValueError(f"unknown rules {cfg.rules!r}")
    doubles = _renju_doubles(cells, ok)
    return win, (~white) & ~exact & (over | doubles)


def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor) -> EnvState:
    """Place `action[E]` for each env's player-to-move.

    Already-done envs are frozen (no-op) — callers auto-reset instead.
    Illegal actions on live envs are a caller bug (masked upstream).
    """
    e = state.board.shape[0]
    player = state.to_play
    board = state.board.clone()
    board[torch.arange(e, device=board.device), action.long()] = player
    cells, ok = _line_cells(cfg, board, action)
    runs = _runs_from_cells(cells, ok, player)
    win, forbidden = _outcome(cfg, runs, player, cells, ok)
    count = state.move_count + 1
    done = win | forbidden | (count >= cfg.num_actions)
    winner = torch.where(win, player,
                         torch.where(forbidden, -player, 0)).to(torch.int8)

    frozen = state.done
    return EnvState(
        board=torch.where(frozen[:, None], state.board, board),
        to_play=torch.where(frozen, state.to_play, -player).to(torch.int8),
        last_move=torch.where(frozen, state.last_move,
                              action.to(torch.int32)),
        move_count=torch.where(frozen, state.move_count, count),
        done=frozen | done,
        winner=torch.where(frozen, state.winner, winner),
    )


def reset_where(cfg: EnvConfig, state: EnvState,
                mask: torch.Tensor) -> EnvState:
    """Reset envs where mask[E] is True (lockstep auto-reset)."""
    m = mask
    return EnvState(
        board=torch.where(m[:, None], 0, state.board).to(torch.int8),
        to_play=torch.where(m, 1, state.to_play).to(torch.int8),
        last_move=torch.where(m, -1, state.last_move).to(torch.int32),
        move_count=torch.where(m, 0, state.move_count).to(torch.int32),
        done=state.done & ~m,
        winner=torch.where(m, 0, state.winner).to(torch.int8),
    )


def legal_mask(state: EnvState) -> torch.Tensor:
    """bool[E, A]: empty cells of live games."""
    return (state.board == 0) & ~state.done[:, None]


def features(cfg: EnvConfig, board: torch.Tensor, to_play: torch.Tensor,
             last_move: torch.Tensor) -> torch.Tensor:
    """float32[E, S, S, 4] NHWC planes: own, opp, last-move, black-to-play.

    The JAX package's layout, kept at this public function so both
    packages compare like with like.
    """
    s = cfg.board_size
    e = board.shape[0]
    tp = to_play[:, None].to(torch.int8)
    own = (board == tp).float()
    opp = (board == -tp).float()
    last = torch.zeros((e, cfg.num_actions), dtype=torch.float32,
                       device=board.device)
    last[torch.arange(e, device=board.device),
         last_move.long().clamp(min=0)] = (last_move >= 0).float()
    black = (to_play > 0).float()[:, None].expand(e, cfg.num_actions)
    planes = torch.stack([own, opp, last, black], dim=-1)  # [E, A, 4]
    return planes.reshape(e, s, s, 4)


def state_features(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    return features(cfg, state.board, state.to_play, state.last_move)
