"""Evaluation: pit two searchers in lockstep games (port of
``alphafive_tpu/train/evaluate.py``).

All games of one colour assignment run batched; both players are array-MCTS
searches (the pure-MCTS anchor is the same search with the rollout
evaluator), searching greedily (no noise; the argmax of the visits, or a
Gumbel root's halving winner). Eval games
never auto-reset, so every live env has the same ply parity and "whose
turn" is a Python ``if`` on the ply index (a ``lax.cond`` in JAX). Finished
envs are still searched and then stepped as a no-op. The host checks for
the end of all games after every ``plies_per_call`` plies, as the JAX
package does after each device call.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts import gumbel, search


def _search_action(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                   evaluate: Callable, sims: int, state: EnvState,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy match-play action int32[E]: the visit argmax, or with the
    Gumbel root the halving winner at g = 0."""
    if mcts_cfg.root_selection == "gumbel":
        return gumbel.run_gumbel_mcts(env_cfg, mcts_cfg, evaluate, state,
                                      generator, num_simulations=sims,
                                      add_noise=False).action
    res = search.run_mcts(env_cfg, mcts_cfg, evaluate, state, generator,
                          num_simulations=sims, add_noise=False)
    return res.visits.argmax(dim=-1).int()


def _play_plies(env_cfg: EnvConfig, mcts_black: MCTSConfig,
                mcts_white: MCTSConfig, eval_black: Callable,
                eval_white: Callable, sims_black: int, sims_white: int,
                plies_per_call: int, state: EnvState,
                generator: Optional[torch.Generator],
                ply0: int) -> EnvState:
    """Advance all games by `plies_per_call` plies (done envs freeze)."""
    for i in range(plies_per_call):
        if (ply0 + i) % 2 == 0:
            action = _search_action(env_cfg, mcts_black, eval_black,
                                    sims_black, state, generator)
        else:
            action = _search_action(env_cfg, mcts_white, eval_white,
                                    sims_white, state, generator)
        state = vector.step(env_cfg, state, action)
    return state


def random_openings(env_cfg: EnvConfig, num_games: int, plies: int,
                    generator: torch.Generator,
                    device="cuda") -> EnvState:
    """Board states after `plies` uniformly random legal moves. `plies`
    must be even (black to move) and below 2·n_in_row − 1, so no opening
    is terminal. `generator` lives on `device`."""
    if plies % 2 or plies >= 2 * env_cfg.n_in_row - 1:
        raise ValueError(f"opening plies must be even and < "
                         f"{2 * env_cfg.n_in_row - 1}, got {plies}")
    state = vector.init(env_cfg, num_games, device)
    for _ in range(plies):
        u = torch.rand(state.board.shape, generator=generator,
                       device=state.board.device)
        acts = torch.where(state.board == 0, u, -1.0).argmax(-1).int()
        state = vector.step(env_cfg, state, acts)
    return state


def play_games(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
               eval_black: Callable, eval_white: Callable,
               sims_black: int, sims_white: int, num_games: int,
               generator: Optional[torch.Generator] = None,
               plies_per_call: int = 2,
               mcts_black: Optional[MCTSConfig] = None,
               mcts_white: Optional[MCTSConfig] = None,
               init_state: Optional[EnvState] = None,
               device="cuda") -> EnvState:
    """Black = eval_black searcher, white = eval_white. Returns the final
    state. Per-side search configs default to `mcts_cfg`; `init_state`
    (e.g. random_openings, black to move) replaces the empty boards.
    `generator` is handed to the searches (greedy searches draw nothing)."""
    state = (vector.init(env_cfg, num_games, device) if init_state is None
             else init_state)
    ply = 0
    while ply < env_cfg.num_actions and not bool(state.done.all()):
        state = _play_plies(env_cfg, mcts_black or mcts_cfg,
                            mcts_white or mcts_cfg, eval_black, eval_white,
                            sims_black, sims_white, plies_per_call, state,
                            generator, ply)
        ply += plies_per_call
    return state


def evaluate_vs(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                eval_a: Callable, eval_b: Callable,
                sims_a: int, sims_b: int, num_games: int,
                generator: Optional[torch.Generator] = None,
                mcts_a: Optional[MCTSConfig] = None,
                mcts_b: Optional[MCTSConfig] = None,
                opening_plies: int = 0,
                plies_per_call: int = 2,
                device="cuda") -> Dict[str, float]:
    """A plays black in half the games, white in the other half. Returns
    win/draw/loss counts and score for A. `opening_plies` > 0 starts both
    halves from the same random openings (drawn from `generator`), which
    deterministic players need to produce distinct games."""
    if num_games % 2 or num_games < 2:
        raise ValueError(
            f"num_games must be even and >= 2 (got {num_games}): each side "
            "plays both colors the same number of times")
    # per-side configs are honoured verbatim; int16 value sums beyond
    # their range fall back to f32 inside run_mcts itself
    mcts_a = mcts_a if mcts_a is not None else mcts_cfg
    mcts_b = mcts_b if mcts_b is not None else mcts_cfg
    half = num_games // 2
    init = (random_openings(env_cfg, half, opening_plies, generator, device)
            if opening_plies else None)
    fa = play_games(env_cfg, mcts_cfg, eval_a, eval_b, sims_a, sims_b, half,
                    generator, plies_per_call, mcts_black=mcts_a,
                    mcts_white=mcts_b, init_state=init, device=device)
    fb = play_games(env_cfg, mcts_cfg, eval_b, eval_a, sims_b, sims_a, half,
                    generator, plies_per_call, mcts_black=mcts_b,
                    mcts_white=mcts_a, init_state=init, device=device)
    wa, wb = fa.winner.cpu(), fb.winner.cpu()
    wins = int((wa == 1).sum() + (wb == -1).sum())
    losses = int((wa == -1).sum() + (wb == 1).sum())
    draws = int((wa == 0).sum() + (wb == 0).sum())
    n = wins + losses + draws
    return {
        "games": n,
        "wins": wins,
        "losses": losses,
        "draws": draws,
        "score": (wins + 0.5 * draws) / max(n, 1),
    }
