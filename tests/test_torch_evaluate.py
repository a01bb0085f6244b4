"""Evaluation matches, the rollout anchor and the Elo ladder: the torch
port against the JAX package.

Greedy players with frozen dyadic evaluators are deterministic (a Gumbel
side plays its halving winner at g = 0), so whole games must end on the
same boards in both packages; one side searches the packed tree (the select kernel's path, its plain version on the CPU and
the Pallas kernel in interpret mode on the JAX side).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import MCTSConfig as JMCTSConfig
from alphafive_tpu.env.scalar import ScalarGomoku
from alphafive_tpu.models.evaluator import rollout_evaluator as j_rollout
from alphafive_tpu.train.evaluate import play_games as j_play_games
from alphafive_tpu.utils import elo as jelo
from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.models.evaluator import (rollout_evaluator,
                                                  uniform_evaluator)
from alphafive_tpu_torch.train.evaluate import (evaluate_vs, play_games,
                                                random_openings)
from alphafive_tpu_torch.utils import elo, trace
from test_torch_search import (frozen_weights, jax_frozen_evaluator,
                               jax_state, torch_frozen_evaluator)

torch.set_num_threads(1)


@pytest.mark.parametrize("size,sims_b,sims_w,lb_w,packed_black", [
    (5, 16, 24, 4, True), (7, 32, 24, 1, False)])
def test_play_games_matches_jax(size, sims_b, sims_w, lb_w, packed_black):
    """Three games from distinct two-ply openings, black and white with
    different evaluators, configs and budgets; the packed side is black in
    one case and white in the other."""
    env_j, env_t = (JEnvConfig(board_size=size, n_in_row=4),
                    EnvConfig(board_size=size, n_in_row=4))
    packed = dict(select_impl="pallas", max_depth=8)
    full = dict(leaf_batch=lb_w, max_depth=8)
    kw_b, kw_w = (packed, full) if packed_black else (full, packed)
    wb, ww = (frozen_weights(size * size, seed=s) for s in (size, size + 1))
    st = vector.init(env_t, 3, "cpu")
    for acts in ([0, 1, 2], [size + 1, size * size - 1, 3 * size]):
        st = vector.step(env_t, st, torch.tensor(acts, dtype=torch.int32))
    fj = j_play_games(env_j, JMCTSConfig(), jax_frozen_evaluator(*wb),
                      jax_frozen_evaluator(*ww), sims_b, sims_w, 3,
                      jax.random.key(0), mcts_black=JMCTSConfig(**kw_b),
                      mcts_white=JMCTSConfig(**kw_w),
                      init_state=jax_state(st))
    ft = play_games(env_t, MCTSConfig(), torch_frozen_evaluator(*wb),
                    torch_frozen_evaluator(*ww), sims_b, sims_w, 3,
                    mcts_black=MCTSConfig(**kw_b),
                    mcts_white=MCTSConfig(**kw_w), init_state=st,
                    device="cpu")
    assert trace.snapshot()["counters"].get("select_launches", 0) == 0
    for f in dataclasses.fields(ft):
        np.testing.assert_array_equal(getattr(ft, f.name).numpy(),
                                      np.asarray(getattr(fj, f.name)),
                                      err_msg=f.name)
    assert bool(ft.done.all())


def one_empty_positions():
    """Live 5×5 (four in a row) positions with one empty cell, and one
    full board: random games that reached move 24 without a winner."""
    games = []
    for seed in (3, 7, 11, 16, 42, 51):
        g = ScalarGomoku(5, 4)
        rng = np.random.default_rng(seed)
        while g.move_count < 24:
            la = g.legal_actions()
            g.step(int(la[rng.integers(len(la))]))
        assert not g.done
        games.append(g)
    board = np.stack([g.board.reshape(-1) for g in games]).astype(np.int8)
    to_play = np.array([g.to_play for g in games], np.int8)
    last = np.array([g.last_move for g in games], np.int32)
    full = board[0].copy()
    full[full == 0] = to_play[0]
    return (np.concatenate([board, full[None]]),
            np.concatenate([to_play, to_play[:1]]),
            np.concatenate([last, last[:1]]))


def test_rollout_values_match_jax():
    """With one empty cell every playout is the same single move, so the
    value is deterministic: the mover's win, loss or draw (0 on a full
    board, which the evaluator guards)."""
    board, to_play, last = one_empty_positions()
    env_j, env_t = (JEnvConfig(board_size=5, n_in_row=4),
                    EnvConfig(board_size=5, n_in_row=4))
    _, vj = j_rollout(env_j, num_rollouts=3)(
        jax.numpy.asarray(board), jax.numpy.asarray(to_play),
        jax.numpy.asarray(last), jax.random.key(0))
    logits, vt = rollout_evaluator(
        env_t, 3, torch.Generator().manual_seed(0))(
            torch.from_numpy(board), torch.from_numpy(to_play),
            torch.from_numpy(last))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt[-1] == 0 and (logits == 0).all()
    assert set(vt.tolist()) <= {-1.0, 0.0, 1.0}


def test_rollout_value_is_a_mean_of_outcomes():
    env = EnvConfig(board_size=5, n_in_row=4)
    st = vector.init(env, 4, "cpu")
    _, v = rollout_evaluator(env, 8, torch.Generator().manual_seed(1))(
        st.board, st.to_play, st.last_move)
    assert ((v * 8).round() == v * 8).all() and (v.abs() <= 1).all()


def test_evaluate_counts_consistent():
    env = EnvConfig(board_size=5, n_in_row=4)
    u = uniform_evaluator(env)
    res = evaluate_vs(env, MCTSConfig(), u, u, 8, 8, 6, device="cpu")
    assert res["games"] == 6
    assert res["wins"] + res["losses"] + res["draws"] == 6
    assert 0.0 <= res["score"] <= 1.0


def test_evaluate_rejects_odd_games():
    env = EnvConfig(board_size=5, n_in_row=4)
    u = uniform_evaluator(env)
    with pytest.raises(ValueError):
        evaluate_vs(env, MCTSConfig(), u, u, 4, 4, 5, device="cpu")


def test_gumbel_side_vs_puct_matches_jax():
    """A Gumbel side (halving winner at g = 0) against a PUCT side, both
    deterministic, from the same two-ply openings: the games end on the
    same boards in both packages, and evaluate_vs scores such a match."""
    size = 5
    env_j, env_t = (JEnvConfig(board_size=size, n_in_row=4),
                    EnvConfig(board_size=size, n_in_row=4))
    g_kw = dict(num_simulations=12, root_selection="gumbel", gumbel_m=8)
    wb, ww = (frozen_weights(size * size, seed=s) for s in (3, 4))
    st = vector.init(env_t, 3, "cpu")
    for acts in ([0, 6, 12], [24, 18, 2]):
        st = vector.step(env_t, st, torch.tensor(acts, dtype=torch.int32))
    fj = j_play_games(env_j, JMCTSConfig(), jax_frozen_evaluator(*wb),
                      jax_frozen_evaluator(*ww), 12, 12, 3,
                      jax.random.key(0), mcts_black=JMCTSConfig(**g_kw),
                      mcts_white=JMCTSConfig(), init_state=jax_state(st))
    ft = play_games(env_t, MCTSConfig(), torch_frozen_evaluator(*wb),
                    torch_frozen_evaluator(*ww), 12, 12, 3,
                    mcts_black=MCTSConfig(**g_kw), mcts_white=MCTSConfig(),
                    init_state=st, device="cpu")
    for f in dataclasses.fields(ft):
        np.testing.assert_array_equal(getattr(ft, f.name).numpy(),
                                      np.asarray(getattr(fj, f.name)),
                                      err_msg=f.name)
    assert bool(ft.done.all())
    u = uniform_evaluator(env_t)
    res = evaluate_vs(env_t, MCTSConfig(num_simulations=12), u, u, 12, 12, 4,
                      torch.Generator().manual_seed(2),
                      mcts_a=MCTSConfig(**g_kw), opening_plies=2,
                      device="cpu")
    assert res["games"] == 4 and 0.0 <= res["score"] <= 1.0


def test_random_openings_and_per_side_configs():
    """Openings are distinct live boards with black to move; a 64-sim side
    beats a 1-sim side with the same evaluator, so per-side budgets and
    configs reach the right player."""
    env = EnvConfig(board_size=7, n_in_row=5)
    st = random_openings(env, 8, 4, torch.Generator().manual_seed(0),
                         "cpu")
    assert not bool(st.done.any())
    assert (st.move_count == 4).all() and (st.to_play == 1).all()
    assert len({bytes(b.numpy()) for b in st.board}) > 1
    with pytest.raises(ValueError):
        random_openings(env, 2, 3, torch.Generator(), "cpu")
    u = uniform_evaluator(env)
    base = MCTSConfig()
    res = evaluate_vs(env, base, u, u, 64, 1, 8,
                      torch.Generator().manual_seed(1),
                      mcts_a=dataclasses.replace(base, max_depth=16),
                      mcts_b=dataclasses.replace(base, max_depth=2),
                      opening_plies=4, device="cpu")
    assert res["games"] == 8 and res["score"] >= 0.6, res


@pytest.mark.parametrize("games", [None, 8, 64])
def test_elo_matches_jax(games):
    for score in np.linspace(0.0, 1.0, 21):
        for anchor in (0.0, 215.0, 645.0):
            assert elo.performance_elo(float(score), anchor, games) == \
                jelo.performance_elo(float(score), anchor, games)
    assert elo.ANCHOR_STEP_ELO == jelo.ANCHOR_STEP_ELO


def test_ladder_matches_jax():
    results = [{"score": s, "games": 8, "wins": int(8 * s), "losses": 0,
                "draws": 0} for s in (0.9, 0.5, 1.0, 0.875, 0.2)]
    lt = elo.LadderState(base_rollouts=100, promote_score=0.8,
                         max_rollouts=400)
    lj = jelo.LadderState(base_rollouts=100, promote_score=0.8,
                          max_rollouts=400)
    for step, r in enumerate(results):
        assert elo.update_ladder(lt, dict(r), step) == \
            jelo.update_ladder(lj, dict(r), step)
        assert (lt.level, lt.anchor_rollouts, lt.anchor_elo) == \
            (lj.level, lj.anchor_rollouts, lj.anchor_elo)
    assert lt.history == lj.history and lt.level == 2  # capped at 400
