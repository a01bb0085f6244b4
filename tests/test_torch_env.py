"""Vectorized env: the torch port against ``alphafive_tpu.env.vector``.

Random legal games (numpy-seeded moves) step through both engines under
all three rule sets at 9×9, 15×15 and 19×19; every field is bit-equal at
every ply, and so are the features. The renju golden positions of
tests/test_renju.py are replayed on the port and on the JAX engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.env import vector as jvector
from alphafive_tpu_torch.config import (FREESTYLE, RENJU, RENJU_LITE,
                                        EnvConfig)
from alphafive_tpu_torch.env import vector

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(vector.EnvState)]


def assert_same(st_t, st_j, msg):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=f"{name} {msg}")


@pytest.mark.parametrize("rules", [FREESTYLE, RENJU_LITE, RENJU])
@pytest.mark.parametrize("size", [9, 15, 19])
def test_random_games_bit_equal(rules, size):
    e = 6
    cfg_t = EnvConfig(board_size=size, rules=rules)
    cfg_j = JEnvConfig(board_size=size, rules=rules)
    step_j = jax.jit(jvector.step, static_argnums=0)
    feat_j = jax.jit(jvector.features, static_argnums=0)
    reset_j = jax.jit(jvector.reset_where, static_argnums=0)
    rng = np.random.default_rng(size * 7 + len(rules))
    st_t, st_j = vector.init(cfg_t, e), jvector.init(cfg_j, e)
    finished = 0
    for ply in range(3 * size * size // 2):
        legal = vector.legal_mask(st_t).numpy()
        np.testing.assert_array_equal(legal,
                                      np.asarray(jvector.legal_mask(st_j)))
        # uniform legal move per live env (done envs get a dummy 0)
        u = rng.random(legal.shape) * legal
        act = u.argmax(-1).astype(np.int32)
        st_t = vector.step(cfg_t, st_t, torch.from_numpy(act))
        st_j = step_j(cfg_j, st_j, jnp.asarray(act))
        assert_same(st_t, st_j, f"ply {ply}")
        np.testing.assert_array_equal(
            vector.state_features(cfg_t, st_t).numpy(),
            np.asarray(feat_j(cfg_j, st_j.board, st_j.to_play,
                              st_j.last_move)))
        # reset a few finished games, keep the rest frozen for a while
        done = st_t.done.numpy()
        finished += int(done.sum())
        mask = done & (rng.random(e) < 0.5)
        st_t = vector.reset_where(cfg_t, st_t, torch.from_numpy(mask))
        st_j = reset_j(cfg_j, st_j, jnp.asarray(mask))
        assert_same(st_t, st_j, f"reset ply {ply}")
    assert finished > 0


def test_runs_through_matches_jax():
    cfg_t, cfg_j = EnvConfig(board_size=9), JEnvConfig(board_size=9)
    rng = np.random.default_rng(0)
    board = rng.integers(-1, 2, size=(16, 81)).astype(np.int8)
    act = rng.integers(0, 81, size=16).astype(np.int32)
    player = rng.choice([-1, 1], size=16).astype(np.int8)
    board[np.arange(16), act] = player
    got = vector.runs_through(cfg_t, torch.from_numpy(board),
                              torch.from_numpy(act), torch.from_numpy(player))
    want = jvector.runs_through(cfg_j, jnp.asarray(board), jnp.asarray(act),
                                jnp.asarray(player))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (blacks, whites, to_play, move, done, winner) — tests/test_renju.py
GOLDEN = [
    ([(7, 5), (7, 6), (5, 7), (6, 7)], [(0, 0), (0, 1), (0, 2), (0, 3)],
     1, (7, 7), True, -1),                               # double three
    ([(7, 3), (7, 4), (7, 5), (4, 7), (5, 7), (6, 7)],
     [(0, c) for c in range(6)], 1, (7, 7), True, -1),   # double four
    ([(7, 1), (7, 2), (7, 3), (7, 7), (7, 8), (7, 9)],
     [(0, c) for c in range(6)], 1, (7, 5), True, -1),   # same-line 4-4
    ([(7, 4), (7, 5), (7, 6), (5, 7), (6, 7)],
     [(7, 3), (0, 0), (0, 1), (0, 2)], 1, (7, 7), False, 0),  # four-three
    ([(7, 4), (7, 5), (7, 6)], [(0, 0), (0, 1), (0, 2)],
     1, (7, 7), False, 0),                               # straight four
    ([(7, 3), (7, 4), (7, 5), (7, 6), (5, 7), (6, 7)],
     [(0, c) for c in range(6)], 1, (7, 7), True, 1),    # exact five wins
    ([(7, 2), (7, 3), (7, 4), (7, 5), (7, 6)],
     [(0, c) for c in range(5)], 1, (7, 7), True, -1),   # overline
    ([(0, c) for c in range(4)], [(7, 5), (7, 6), (5, 7), (6, 7)],
     -1, (7, 7), False, 0),                              # white 3-3 legal
    ([(0, c) for c in range(5)], [(7, 2), (7, 3), (7, 4), (7, 5), (7, 6)],
     -1, (7, 7), True, -1),                              # white overline
    ([(7, 5), (7, 8), (5, 7), (6, 7)], [(0, 0), (0, 1), (0, 2), (0, 3)],
     1, (7, 7), True, -1),                               # broken three
    ([(0, 0), (0, 1), (5, 3), (6, 3)],
     [(14, 0), (14, 1), (14, 2), (14, 3)], 1, (0, 2), False, 0),  # edge
    ([(7, 5), (7, 6), (5, 7), (4, 7)],
     [(14, 0), (14, 1), (14, 2), (14, 3)], 1, (7, 7), True, -1),  # open 3
]


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_renju_golden_positions(case):
    blacks, whites, to_play, (r, c), done, winner = GOLDEN[case]
    board = np.zeros((1, 225), np.int8)
    for rr, cc in blacks:
        board[0, rr * 15 + cc] = 1
    for rr, cc in whites:
        board[0, rr * 15 + cc] = -1
    fields = dict(board=board, to_play=np.array([to_play], np.int8),
                  last_move=np.array([-1], np.int32),
                  move_count=np.array([len(blacks) + len(whites)], np.int32),
                  done=np.array([False]), winner=np.array([0], np.int8))
    act = np.array([r * 15 + c], np.int32)
    st_t = vector.step(EnvConfig(board_size=15, rules=RENJU),
                       vector.EnvState(**{k: torch.from_numpy(v)
                                          for k, v in fields.items()}),
                       torch.from_numpy(act))
    st_j = jvector.step(JEnvConfig(board_size=15, rules=RENJU),
                        jvector.EnvState(**{k: jnp.asarray(v)
                                            for k, v in fields.items()}),
                        jnp.asarray(act))
    assert_same(st_t, st_j, f"golden {case}")
    assert bool(st_t.done[0]) == done and int(st_t.winner[0]) == winner
