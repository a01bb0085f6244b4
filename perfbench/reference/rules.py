"""One move of Gomoku, freestyle or Renju, one board at a time (NumPy).

Stones are +1 (black, moves first) and −1 (white); a board is a flat
``int8[S²]``, an action the flat index ``r · S + c``.

* freestyle: a run of ``n_in_row`` or more wins.
* renju: white wins with a run of five or more; black wins with exactly
  five. Otherwise a black move that makes an overline (six or more), two
  fours or two open threes is forbidden and loses. Fours and threes are
  counted per line from the 11 cells through the new stone: a four is a
  5-window with 4 black and 1 empty whose completion is an exact five; an
  open three a 4-window with 3 black and 1 empty, both ends empty and the
  cells beyond them not black; a straight four and a consecutive three,
  which match two windows with the same stones, count once. The
  recursive exception (a three counts only if its four point is not
  itself forbidden) is not part of these rules.
* A game also ends, drawn, when the board is full. A finished game
  takes no further move.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


class Game(NamedTuple):
    board: np.ndarray   # int8[S²]
    to_play: int
    last: int
    count: int
    done: bool
    winner: int


def _run(board2, r, c, dr, dc, player, size) -> int:
    n = 1
    for sgn in (1, -1):
        rr, cc = r + sgn * dr, c + sgn * dc
        while 0 <= rr < size and 0 <= cc < size and board2[rr, cc] == player:
            n += 1
            rr += sgn * dr
            cc += sgn * dc
    return n


def _line_counts(blk: np.ndarray, emp: np.ndarray):
    """(fours, open threes) the new black stone (index 5) makes on one
    11-cell line; `blk`/`emp` are False off the board."""
    cand4 = np.zeros(7, dtype=bool)
    for s in range(1, 6):
        w = slice(s, s + 5)
        if (blk[w].sum() == 4 and emp[w].sum() == 1
                and not blk[s - 1] and not blk[s + 5]):
            cand4[s] = True
    fours = int(cand4.sum())
    for s in range(1, 5):
        if cand4[s] and cand4[s + 1] and blk[s + 1:s + 5].all():
            fours -= 1
    cand3 = np.zeros(7, dtype=bool)
    for t in range(2, 6):
        w = slice(t, t + 4)
        if (blk[w].sum() == 3 and emp[w].sum() == 1
                and emp[t - 1] and emp[t + 4]
                and not blk[t - 2] and not blk[t + 5]):
            cand3[t] = True
    threes = int(cand3.sum())
    for t in range(2, 5):
        if cand3[t] and cand3[t + 1] and blk[t + 1:t + 4].all():
            threes -= 1
    return fours, threes


def outcome(board: np.ndarray, action: int, player: int, size: int,
            n_in_row: int, rules: str):
    """(win, forbidden) of `player`'s stone just placed at `action` on
    the flat `board` (which holds it)."""
    b2 = board.reshape(size, size)
    r, c = divmod(int(action), size)
    runs = [_run(b2, r, c, dr, dc, player, size) for dr, dc in DIRECTIONS]
    if rules == "freestyle" or player < 0:
        return max(runs) >= n_in_row, False
    if rules != "renju":
        raise ValueError(f"no reference for rules {rules!r}")
    if any(n == 5 for n in runs):
        return True, False
    fours = threes = 0
    for dr, dc in DIRECTIONS:
        blk = np.zeros(11, dtype=bool)
        emp = np.zeros(11, dtype=bool)
        for w in range(11):
            rr, cc = r + (w - 5) * dr, c + (w - 5) * dc
            if 0 <= rr < size and 0 <= cc < size:
                blk[w] = b2[rr, cc] == 1
                emp[w] = b2[rr, cc] == 0
        f, t = _line_counts(blk, emp)
        fours += f
        threes += t
    return False, any(n >= 6 for n in runs) or fours >= 2 or threes >= 2


def step(g: Game, action: int, size: int, n_in_row: int,
         rules: str) -> Game:
    """`g` after the player to move places a stone at `action` (`g`
    unchanged when the game is over). Raises ValueError on an occupied
    cell."""
    if g.done:
        return g
    if g.board[action] != 0:
        raise ValueError(f"illegal move {action}: cell occupied")
    board = g.board.copy()
    board[action] = g.to_play
    win, forbidden = outcome(board, action, g.to_play, size, n_in_row,
                             rules)
    count = g.count + 1
    winner = g.to_play if win else (-g.to_play if forbidden else 0)
    done = win or forbidden or count >= size * size
    return Game(board, -g.to_play, int(action), count, bool(done),
                int(winner))
