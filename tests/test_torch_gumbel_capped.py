"""The Gumbel root search over the branch-capped slot tree: the torch
port against the NumPy oracle, the JAX package and its own full-width
search (tests/test_torch_gumbel.py's evaluator, tables and fixtures)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import MCTSConfig as JMCTSConfig
from alphafive_tpu.mcts import gumbel as jgumbel
from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.mcts import gumbel
from tests.test_gumbel import _gumbel_table, jax_eval
from tests.test_mcts import random_midgame, to_env_state
from test_torch_gumbel import (FIXTURES, assert_matches_oracle, fixture,
                               renju_trap, torch_eval, torch_state,
                               win_in_one)

torch.set_num_threads(1)


@pytest.mark.parametrize("size,n_in_row,sims,plies,m", FIXTURES)
def test_capped_full_width_matches_oracle(size, n_in_row, sims, plies, m):
    """branch_cap == A: the slot-tree search (forced root slots,
    search_capped._run_pass) matches the oracle bit for bit."""
    games = fixture(size, n_in_row, plies)
    gtab = _gumbel_table(size, len(games))
    cfg = MCTSConfig(num_simulations=sims, c_puct=5.0, gumbel_m=m,
                     root_selection="gumbel", branch_cap=size * size)
    res = gumbel.run_gumbel_mcts(
        EnvConfig(board_size=size, n_in_row=n_in_row), cfg, torch_eval(size),
        torch_state(games), gumbel=torch.from_numpy(gtab))
    assert_matches_oracle(res, games, size, sims, m, gtab)


def test_capped_packed_matches_uncapped_int16():
    """Packed s32 stats, bf16 priors, int16 values: the capped search at
    full width equals the uncapped one under the same quantization, and
    both equal the JAX capped search."""
    size, sims, m = 5, 24, 8
    env = EnvConfig(board_size=size, n_in_row=4)
    kw = dict(num_simulations=sims, c_puct=5.0, gumbel_m=m,
              root_selection="gumbel", prior_dtype="bfloat16",
              value_dtype="int16")
    games = [random_midgame(size, 4, p, seed)
             for p, seed in [(0, 1), (6, 2), (10, 3)]]
    st = torch_state(games)
    gtab = _gumbel_table(size, len(games))
    r_un, r_cap = (gumbel.run_gumbel_mcts(env, MCTSConfig(**kw, **cap),
                                          torch_eval(size), st,
                                          gumbel=torch.from_numpy(gtab))
                   for cap in ({}, {"branch_cap": size * size}))
    assert torch.equal(r_un.visits, r_cap.visits)
    assert torch.equal(r_un.action, r_cap.action)
    np.testing.assert_allclose(r_un.pi_target.numpy(),
                               r_cap.pi_target.numpy(), atol=1e-5)
    rj = jax.jit(functools.partial(
        jgumbel.run_gumbel_mcts, JEnvConfig(board_size=size, n_in_row=4),
        JMCTSConfig(**kw, branch_cap=size * size), jax_eval(size)))(
            to_env_state(games), jax.random.key(0), gumbel=jnp.asarray(gtab))
    np.testing.assert_array_equal(r_cap.visits.numpy(), np.asarray(rj.visits))
    np.testing.assert_array_equal(r_cap.action.numpy(), np.asarray(rj.action))


def test_capped_binding_cap_matches_jax():
    """branch_cap < A (the cap binds below the root): the budget is spent
    exactly, visits and the played action land on legal moves, π' is a
    legal-masked distribution, and all of it equals the JAX search;
    m > branch_cap clamps to the cap."""
    size, sims, m = 9, 32, 16
    kw = dict(num_simulations=sims, gumbel_m=m, root_selection="gumbel",
              branch_cap=24, prior_dtype="bfloat16", value_dtype="int16")
    games = [random_midgame(size, 5, p, seed)
             for p, seed in [(0, 1), (10, 2), (20, 3), (30, 4)]]
    st = torch_state(games)
    gtab = _gumbel_table(size, len(games))
    env = EnvConfig(board_size=size, n_in_row=5)
    res = gumbel.run_gumbel_mcts(env, MCTSConfig(**kw), torch_eval(size), st,
                                 gumbel=torch.from_numpy(gtab))
    np.testing.assert_array_equal(res.visits.sum(-1).numpy(), sims)
    assert (res.visits[st.board != 0] == 0).all()
    assert (st.board.gather(1, res.action.long()[:, None]) == 0).all()
    np.testing.assert_allclose(res.pi_target.sum(-1).numpy(), 1.0, atol=1e-5)
    assert (res.pi_target[st.board != 0] == 0).all()
    rj = jax.jit(functools.partial(
        jgumbel.run_gumbel_mcts, JEnvConfig(board_size=size, n_in_row=5),
        JMCTSConfig(**kw), jax_eval(size)))(
            to_env_state(games), jax.random.key(0), gumbel=jnp.asarray(gtab))
    np.testing.assert_array_equal(res.visits.numpy(), np.asarray(rj.visits))
    np.testing.assert_array_equal(res.action.numpy(), np.asarray(rj.action))
    np.testing.assert_allclose(res.pi_target.numpy(),
                               np.asarray(rj.pi_target), atol=1e-5)
    small_cap = MCTSConfig(num_simulations=sims, gumbel_m=16,
                           root_selection="gumbel", branch_cap=8)
    res2 = gumbel.run_gumbel_mcts(env, small_cap, torch_eval(size), st,
                                  torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(res2.visits.sum(-1).numpy(), sims)


def test_capped_win_in_one_and_renju_trap():
    cfg = MCTSConfig(num_simulations=32, root_selection="gumbel",
                     branch_cap=16)
    res = gumbel.run_gumbel_mcts(EnvConfig(board_size=5, n_in_row=4), cfg,
                                 torch_eval(5), torch_state(win_in_one()),
                                 add_noise=False)
    assert int(res.action[0]) in (5, 9)
    assert float(res.pi_target[0, 5] + res.pi_target[0, 9]) > 0.5

    g, trap, evaluate, env = renju_trap()
    res = gumbel.run_gumbel_mcts(
        env, MCTSConfig(num_simulations=16, root_selection="gumbel",
                        branch_cap=64), evaluate, torch_state([g]),
        add_noise=False)
    assert int(res.action[0]) != trap
    assert float(res.visits[0, trap]) >= 1.0
    assert float(res.pi_target[0, trap]) < 0.01


def test_lowsim_single_pass_capped_equals_uncapped():
    """lowsim_15x15's budget (16 sims, m = 16: one pass, every lane stops
    at its root edge) on 15×15 midgames: the capped search at branch cap
    225 equals the full-width one bit for bit, as chip_smoke.py checks on
    the card with the bundled net."""
    size = 15
    kw = dict(num_simulations=16, max_depth=16, gumbel_m=16,
              root_selection="gumbel", prior_dtype="bfloat16",
              value_dtype="int16")
    games = [random_midgame(size, 5, p, seed)
             for p, seed in [(0, 1), (9, 2), (30, 3)]]
    st = torch_state(games)
    gtab = torch.from_numpy(_gumbel_table(size, len(games)))
    env = EnvConfig(board_size=size)
    r_un, r_cap = (gumbel.run_gumbel_mcts(env, MCTSConfig(**kw, **cap),
                                          torch_eval(size), st, gumbel=gtab)
                   for cap in ({}, {"branch_cap": 225}))
    for name in ("visits", "action", "root_value", "pi_target"):
        assert torch.equal(getattr(r_un, name), getattr(r_cap, name)), name
    assert (r_un.visits.sum(-1) == 16).all()
    assert (r_un.visits.max(-1).values == 1).all()
