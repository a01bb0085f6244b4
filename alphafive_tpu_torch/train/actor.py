"""Lockstep self-play actor (port of ``alphafive_tpu/train/actor.py``).

E envs play in lockstep with masked auto-reset: each ply searches every
env's position, records (position, π), samples the move (τ = 1 for the
first ``temperature_moves`` plies of a game, greedy after) and steps.
``resolve_chunk`` backfills each position's outcome z with a reverse scan
over the chunk. The JAX ``lax.scan``s are Python loops here.

Playout cap randomization (``small_simulations > 0``) flips one coin per
ply, as in the JAX package. With the Gumbel root (``root_selection=
"gumbel"``, ``mcts/gumbel.py``) every search samples Gumbel noise, cheap
PCR plies too; the move is the halving winner and π is the improved
policy π', with no temperature and no forced-visit pruning.

Spans (``utils/trace.py``): ``ply`` (a lockstep ply) / the search's
``search``, and ``env_step`` (the real move); sync sites ``pcr_coin`` and
``selfplay_stats`` (the chunk's stats).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts import gumbel, search
from alphafive_tpu_torch.utils import trace


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


def init_recordings(env_cfg: EnvConfig, num_plies: int, num_envs: int,
                    device="cuda") -> Recordings:
    """Zeroed staging buffer ([T, E]), used before the first chunk exists:
    `to_play` ones and `last_move` -1, as the JAX package stages it."""
    t, e, a = num_plies, num_envs, env_cfg.num_actions
    z = lambda shape, dt, fill=0: torch.full(shape, fill, dtype=dt,
                                             device=device)
    return Recordings(
        board=z((t, e, a), torch.int8), to_play=z((t, e), torch.int8, 1),
        last_move=z((t, e), torch.int32, -1),
        pi=z((t, e, a), torch.float32), done=z((t, e), torch.bool),
        winner=z((t, e), torch.int8), pi_valid=z((t, e), torch.bool))


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
    given, sees each ply's searched position, result (a SearchResult, or
    a GumbelResult with the Gumbel root) and move."""
    use_gumbel = mcts_cfg.root_selection == "gumbel"
    small = int(mcts_cfg.small_simulations or 0)
    full_budget = int(num_simulations or mcts_cfg.num_simulations)
    use_pcr = 0 < small < full_budget
    e = state.board.shape[0]
    dev = state.board.device

    recs = []
    for _ in range(num_plies):
        with trace.span("ply"):
            full = True
            if use_pcr:
                # one coin per lockstep ply; only full searches carry noise
                coin = torch.rand((), generator=generator, device=dev)
                full = trace.read_bool("pcr_coin",
                                       coin < mcts_cfg.full_sim_fraction)
            sims = num_simulations if full else small
            if use_gumbel:
                # Gumbel noise is the exploration, on cheap plies too
                res = gumbel.run_gumbel_mcts(env_cfg, mcts_cfg, evaluate,
                                             state, generator,
                                             num_simulations=sims,
                                             add_noise=True)
                pi_target, action = res.pi_target, res.action
            else:
                res = search.run_mcts(env_cfg, mcts_cfg, evaluate, state,
                                      generator, add_noise=full,
                                      num_simulations=sims)
                target = prune_forced_visits(
                    res.visits, res.priors, float(mcts_cfg.forced_playouts_k))
                pi_target = target / target.sum(-1, keepdim=True).clamp(
                    min=1.0)
                greedy = state.move_count >= mcts_cfg.temperature_moves
                pi_act = search.pi_from_visits(
                    res.visits, torch.ones(e, device=dev), greedy)
                action = search.sample_actions(generator, pi_act)
            if observe is not None:
                observe(state, res, action)
            with trace.span("env_step"):
                nxt = vector.step(env_cfg, state, action)
                recs.append((state.board, state.to_play, state.last_move,
                             pi_target, nxt.done, nxt.winner,
                             res.root_value, torch.full(
                                 (e,), full, dtype=torch.bool, device=dev)))
                state = vector.reset_where(env_cfg, nxt, nxt.done)

    (boards, to_plays, lasts, pis, dones, winners, root_vals,
     pi_valids) = (torch.stack(x) for x in zip(*recs))
    recordings = Recordings(
        board=boards, to_play=to_plays, last_move=lasts, pi=pis,
        done=dones, winner=winners, pi_valid=pi_valids)
    site = "selfplay_stats"
    stats = SelfplayStats(
        games_finished=trace.read_int(site, dones.sum()),
        env_steps=num_plies * e,
        black_wins=trace.read_int(site, (winners == 1).sum()),
        white_wins=trace.read_int(site, (winners == -1).sum()),
        draws=trace.read_int(site, ((winners == 0) & dones).sum()),
        mean_root_value=trace.read_float(site, root_vals.mean()),
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
