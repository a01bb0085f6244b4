"""Lockstep self-play actor (port of ``alphafive_tpu/train/actor.py``).

E envs play in lockstep with masked auto-reset: each ply searches every
env's position, records (position, π), samples the move (τ = 1 for the
first ``temperature_moves`` plies of a game, greedy after) and steps.
``resolve_chunk`` backfills each position's outcome z with a reverse scan
over the chunk. The JAX ``lax.scan``s are Python loops here.

Playout cap randomization (``small_simulations > 0``) flips one coin per
ply, as in the JAX package. The Gumbel root (``root_selection="gumbel"``)
is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts import search


def prune_forced_visits(visits: torch.Tensor, priors: torch.Tensor,
                        forced_k: float) -> torch.Tensor:
    """Policy target pruning (KataGo §3.4): subtract the forced share
    sqrt(k·p·Σn) from every non-best root child before normalizing π."""
    if forced_k <= 0:
        return visits
    n_sum = visits.sum(-1, keepdim=True)
    n_forced = torch.sqrt(forced_k * priors * n_sum)
    is_best = torch.nn.functional.one_hot(
        visits.argmax(dim=-1), visits.shape[-1]).bool()
    pruned = (visits - n_forced).clamp(min=0.0)
    pruned = torch.where(pruned < 1.0, 0.0, pruned)
    return torch.where(is_best, visits, pruned)


@dataclasses.dataclass
class Trajectory:
    """Flattened chunk of T×E positions (leading axis T*E)."""

    board: torch.Tensor     # int8[M, A]
    to_play: torch.Tensor   # int8[M]
    last_move: torch.Tensor  # int32[M]
    pi: torch.Tensor        # f32[M, A]
    z: torch.Tensor         # int8[M] (outcome from mover's perspective)
    z_valid: torch.Tensor   # bool[M]
    pi_valid: torch.Tensor  # bool[M] (full-budget search — π is a target)


@dataclasses.dataclass
class Recordings:
    """Raw per-ply recordings of a chunk before z resolution ([T, E]).
    `board/to_play/last_move` are the position the mover faced;
    `done/winner` the env after the recorded move."""

    board: torch.Tensor     # int8[T, E, A]
    to_play: torch.Tensor   # int8[T, E]
    last_move: torch.Tensor  # int32[T, E]
    pi: torch.Tensor        # f32[T, E, A]
    done: torch.Tensor      # bool[T, E]
    winner: torch.Tensor    # int8[T, E]
    pi_valid: torch.Tensor  # bool[T, E]


class SelfplayStats(NamedTuple):
    games_finished: int
    env_steps: int
    black_wins: int
    white_wins: int
    draws: int
    mean_root_value: float


def selfplay_record(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Callable,
    state: EnvState,
    generator: torch.Generator,
    num_plies: int,
    num_simulations: Optional[int] = None,
    observe: Optional[Callable] = None,
) -> Tuple[EnvState, Recordings, SelfplayStats]:
    """Play `num_plies` lockstep plies in every env (auto-resetting),
    returning the raw recordings (z not yet resolved — see resolve_chunk).
    `generator` lives on the device of `state` and drives the noise, the
    PCR coin and the move sampling. `observe(state, result, action)`, when
    given, sees each ply's searched position, SearchResult and move."""
    if mcts_cfg.root_selection == "gumbel":
        raise NotImplementedError(
            "the Gumbel root search is not ported yet: ROADMAP Queue 1 "
            "item 8")
    small = int(mcts_cfg.small_simulations or 0)
    full_budget = int(num_simulations or mcts_cfg.num_simulations)
    use_pcr = 0 < small < full_budget
    e = state.board.shape[0]
    dev = state.board.device

    recs = []
    for _ in range(num_plies):
        full = True
        if use_pcr:
            # one coin per lockstep ply; only full searches carry noise
            coin = torch.rand((), generator=generator, device=dev)
            full = bool(coin < mcts_cfg.full_sim_fraction)
        res = search.run_mcts(
            env_cfg, mcts_cfg, evaluate, state, generator,
            add_noise=full,
            num_simulations=num_simulations if full else small)
        target = prune_forced_visits(res.visits, res.priors,
                                     float(mcts_cfg.forced_playouts_k))
        pi_target = target / target.sum(-1, keepdim=True).clamp(min=1.0)
        greedy = state.move_count >= mcts_cfg.temperature_moves
        pi_act = search.pi_from_visits(
            res.visits, torch.ones(e, device=dev), greedy)
        action = search.sample_actions(generator, pi_act)
        if observe is not None:
            observe(state, res, action)
        nxt = vector.step(env_cfg, state, action)
        recs.append((state.board, state.to_play, state.last_move, pi_target,
                     nxt.done, nxt.winner, res.root_value,
                     torch.full((e,), full, dtype=torch.bool, device=dev)))
        state = vector.reset_where(env_cfg, nxt, nxt.done)

    (boards, to_plays, lasts, pis, dones, winners, root_vals,
     pi_valids) = (torch.stack(x) for x in zip(*recs))
    recordings = Recordings(
        board=boards, to_play=to_plays, last_move=lasts, pi=pis,
        done=dones, winner=winners, pi_valid=pi_valids)
    stats = SelfplayStats(
        games_finished=int(dones.sum()),
        env_steps=num_plies * e,
        black_wins=int((winners == 1).sum()),
        white_wins=int((winners == -1).sum()),
        draws=int(((winners == 0) & dones).sum()),
        mean_root_value=float(root_vals.mean()),
    )
    return state, recordings, stats


def resolve_chunk(env_cfg: EnvConfig, recs: Recordings,
                  lookahead: Optional[Recordings] = None) -> Trajectory:
    """z-resolve recordings into a flat Trajectory ([T*E]). The winner
    backfill runs in reverse over the chunk (and `lookahead`, the
    chronologically next chunk, when given); only this chunk's plies are
    emitted."""
    t = recs.done.shape[0]
    dones, winners = recs.done, recs.winner
    if lookahead is not None:
        dones = torch.cat([dones, lookahead.done])
        winners = torch.cat([winners, lookahead.winner])
    w = torch.zeros_like(winners[0])
    have = torch.zeros_like(dones[0])
    ws, valids = [None] * t, [None] * t
    for i in range(dones.shape[0] - 1, -1, -1):
        w = torch.where(dones[i], winners[i], w)
        have = dones[i] | have
        if i < t:
            ws[i], valids[i] = w, have
    zs = (torch.stack(ws) * recs.to_play).to(torch.int8)
    a = env_cfg.num_actions
    return Trajectory(
        board=recs.board.reshape(-1, a),
        to_play=recs.to_play.reshape(-1),
        last_move=recs.last_move.reshape(-1),
        pi=recs.pi.reshape(-1, a),
        z=zs.reshape(-1),
        z_valid=torch.stack(valids).reshape(-1),
        pi_valid=recs.pi_valid.reshape(-1),
    )


def selfplay_chunk(
    env_cfg: EnvConfig,
    mcts_cfg: MCTSConfig,
    evaluate: Callable,
    state: EnvState,
    generator: torch.Generator,
    num_plies: int,
    num_simulations: Optional[int] = None,
    observe: Optional[Callable] = None,
) -> Tuple[EnvState, Trajectory, SelfplayStats]:
    """Play `num_plies` lockstep plies and z-resolve within the chunk."""
    state, recs, stats = selfplay_record(
        env_cfg, mcts_cfg, evaluate, state, generator, num_plies,
        num_simulations, observe)
    return state, resolve_chunk(env_cfg, recs), stats
