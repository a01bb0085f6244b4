"""The Gumbel root search at full width: the torch port against the NumPy
oracle (``reference.run_gumbel_reference``) and the JAX package.

The frozen evaluator is tests/test_gumbel.py's: non-zero integer logit
table divided by 4, integer board value divided by 8, so logits, values
and value sums are exact in f32 on every side. The Gumbel noise is that
file's injected table (``_gumbel_table``): JAX's random streams cannot be
reproduced in torch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import MCTSConfig as JMCTSConfig
from alphafive_tpu.env.scalar import ScalarGomoku
from alphafive_tpu.mcts import gumbel as jgumbel
from alphafive_tpu.mcts import reference
from alphafive_tpu_torch.config import RENJU, EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import gumbel
from tests.test_gumbel import _gumbel_table, _logit_table, jax_eval, np_eval
from tests.test_mcts import random_midgame, to_env_state

torch.set_num_threads(1)

# (size, n_in_row, sims, plies, m): tests/test_gumbel.py's fixtures
FIXTURES = [
    (5, 4, 30, 0, 8),    # empty board, full halving
    (5, 4, 17, 8, 8),    # odd budget: 1-lane remainder group
    (5, 4, 30, 18, 16),  # fewer legal moves than m: duplicate lanes
    (9, 5, 32, 10, 16),
]


def torch_eval(size):
    """Torch twin of tests/test_gumbel.py's ``jax_eval``/``np_eval``."""
    lt = torch.from_numpy(_logit_table(size))
    weights = torch.from_numpy((np.arange(size * size) % 5 - 2)
                               .astype(np.int64))

    def evaluate(board, to_play, last):
        s = (board.long() * weights).sum(-1)
        v = ((s % 7) - 3).float() / 8.0
        return lt.expand(board.shape[0], -1), v
    return evaluate


def torch_state(games):
    """EnvState of scalar games (all live)."""
    return vector.EnvState(
        board=torch.from_numpy(np.stack([g.board.reshape(-1)
                                         for g in games]).astype(np.int8)),
        to_play=torch.tensor([g.to_play for g in games], dtype=torch.int8),
        last_move=torch.tensor([g.last_move for g in games],
                               dtype=torch.int32),
        move_count=torch.tensor([g.move_count for g in games],
                                dtype=torch.int32),
        done=torch.zeros(len(games), dtype=torch.bool),
        winner=torch.zeros(len(games), dtype=torch.int8))


def fixture(size, n_in_row, plies):
    return [random_midgame(size, n_in_row, plies, seed)
            for seed in (1, 2, 3, 4)]


def assert_matches_oracle(res, games, size, sims, m, gtab):
    for i, g in enumerate(games):
        ref_n, ref_a, ref_pi = reference.run_gumbel_reference(
            g, np_eval(size), sims, c_puct=5.0, gumbel=gtab[i], m=m)
        np.testing.assert_array_equal(res.visits[i].numpy(), ref_n,
                                      err_msg=f"env {i}")
        assert int(res.action[i]) == ref_a, f"env {i}"
        np.testing.assert_allclose(res.pi_target[i].numpy(), ref_pi,
                                   atol=1e-5, err_msg=f"env {i}")
        assert abs(float(res.pi_target[i].sum()) - 1.0) < 1e-5


def win_in_one():
    """Black to move on 5×5 (four in a row): 5 or 9 completes row 1."""
    g = ScalarGomoku(5, 4)
    for mov in [6, 0, 7, 1, 8, 2]:
        g.step(mov)
    return [g]


def renju_trap():
    """tests/test_gumbel.py's position: (7, 7) is a double three, legal
    to play but an instant loss for black; an evaluator that loves it."""
    from tests.test_renju import SIZE, make_position, rc
    g, _ = make_position(blacks=[(7, 5), (7, 6), (5, 7), (6, 7)],
                         whites=[(0, 0), (0, 1), (0, 2), (0, 3)])
    trap = rc(7, 7)

    def evaluate(board, to_play, last):
        logits = torch.zeros((board.shape[0], SIZE * SIZE))
        logits[:, trap] = 4.0
        return logits, torch.zeros(board.shape[0])
    return g, trap, evaluate, EnvConfig(board_size=SIZE, rules=RENJU)


@pytest.mark.parametrize("budget,m", [
    (400, 16), (64, 16), (32, 16), (16, 16), (8, 16), (5, 4), (7, 16),
    (1, 16), (240, 16), (3, 2)])
def test_build_schedule_matches_jax(budget, m):
    sched = gumbel.build_schedule(budget, m)
    assert sched == jgumbel.build_schedule(budget, m)
    assert sum(lanes * p for lanes, p in sched) == budget
    # lowsim_15x15: one pass of 16 lanes
    assert gumbel.build_schedule(16, 16) == [(16, 1)]


@pytest.mark.parametrize("size,n_in_row,sims,plies,m", FIXTURES)
def test_gumbel_matches_oracle(size, n_in_row, sims, plies, m):
    games = fixture(size, n_in_row, plies)
    gtab = _gumbel_table(size, len(games))
    env = EnvConfig(board_size=size, n_in_row=n_in_row)
    cfg = MCTSConfig(num_simulations=sims, c_puct=5.0, gumbel_m=m,
                     root_selection="gumbel")
    res = gumbel.run_gumbel_mcts(env, cfg, torch_eval(size),
                                 torch_state(games),
                                 gumbel=torch.from_numpy(gtab))
    assert_matches_oracle(res, games, size, sims, m, gtab)


@pytest.mark.parametrize("size,n_in_row,sims,plies,m", FIXTURES[1:3])
def test_gumbel_matches_jax_bf16_int16(size, n_in_row, sims, plies, m):
    """The lowsim_15x15 storage types (bf16 priors, 1/64 fixed-point W):
    every output equal to the JAX search's."""
    kw = dict(num_simulations=sims, c_puct=5.0, gumbel_m=m, max_depth=16,
              root_selection="gumbel", prior_dtype="bfloat16",
              value_dtype="int16")
    games = fixture(size, n_in_row, plies)
    gtab = _gumbel_table(size, len(games))
    rj = jax.jit(functools.partial(
        jgumbel.run_gumbel_mcts, JEnvConfig(board_size=size,
                                            n_in_row=n_in_row),
        JMCTSConfig(**kw), jax_eval(size)))(
            to_env_state(games), jax.random.key(0), gumbel=jnp.asarray(gtab))
    rt = gumbel.run_gumbel_mcts(
        EnvConfig(board_size=size, n_in_row=n_in_row), MCTSConfig(**kw),
        torch_eval(size), torch_state(games), gumbel=torch.from_numpy(gtab))
    for name in ("visits", "action", "root_value"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(rt.priors.numpy(), np.asarray(rj.priors),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rt.pi_target.numpy(),
                               np.asarray(rj.pi_target), atol=1e-5)


def test_gumbel_win_in_one():
    cfg = MCTSConfig(num_simulations=32, root_selection="gumbel")
    res = gumbel.run_gumbel_mcts(EnvConfig(board_size=5, n_in_row=4), cfg,
                                 torch_eval(5), torch_state(win_in_one()),
                                 add_noise=False)
    assert int(res.action[0]) in (5, 9)
    assert float(res.pi_target[0, 5] + res.pi_target[0, 9]) > 0.5


def test_gumbel_eval_deterministic():
    """g = 0 without noise: no generator is read, and the result equals
    an injected zero table."""
    env = EnvConfig(board_size=5, n_in_row=4)
    cfg = MCTSConfig(num_simulations=16, root_selection="gumbel")
    st = torch_state([random_midgame(5, 4, 6, 11)])
    runs = [gumbel.run_gumbel_mcts(env, cfg, torch_eval(5), st, g,
                                   add_noise=False)
            for g in (None, torch.Generator().manual_seed(7))]
    zero = gumbel.run_gumbel_mcts(env, cfg, torch_eval(5), st,
                                  gumbel=torch.zeros(1, 25))
    for r in runs[1:] + [zero]:
        assert torch.equal(r.visits, runs[0].visits)
        assert torch.equal(r.action, runs[0].action)
        assert torch.equal(r.pi_target, runs[0].pi_target)


def test_gumbel_noise_draws_from_the_generator():
    """add_noise draws g from the generator: equal seeds give equal
    searches, and every visit stays on a legal move."""
    env = EnvConfig(board_size=5, n_in_row=4)
    cfg = MCTSConfig(num_simulations=12, gumbel_m=8, root_selection="gumbel")
    st = torch_state(fixture(5, 4, 6))
    a, b = (gumbel.run_gumbel_mcts(env, cfg, torch_eval(5), st,
                                   torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a.visits, b.visits) and torch.equal(a.action, b.action)
    assert (a.visits.sum(-1) == 12).all()
    assert (a.visits[st.board != 0] == 0).all()
    assert (st.board.gather(1, a.action.long()[:, None]) == 0).all()


def test_gumbel_avoids_renju_forbidden_trap():
    g, trap, evaluate, env = renju_trap()
    res = gumbel.run_gumbel_mcts(
        env, MCTSConfig(num_simulations=16, root_selection="gumbel"),
        evaluate, torch_state([g]), add_noise=False)
    assert int(res.action[0]) != trap
    assert float(res.visits[0, trap]) >= 1.0   # explored ...
    assert float(res.pi_target[0, trap]) < 0.01  # ... and rejected
