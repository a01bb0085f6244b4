"""Leaf evaluators for the array MCTS (port of
``alphafive_tpu/models/evaluator.py``).

An evaluator maps ``(board int8[E, A], to_play int8[E], last int32[E])`` to
``(logits f32[E, A], value f32[E])``. JAX's evaluators also take a PRNG
key; the port drops it, and the one evaluator that draws random numbers,
``rollout_evaluator``, holds a ``torch.Generator`` instead.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.models import nets
from alphafive_tpu_torch.utils import trace


def net_evaluator(env_cfg: EnvConfig, net_cfg: NetConfig, params,
                  batch_stats=None, device="cuda") -> Callable:
    """Policy-value-net leaf evaluator of the configured net
    (``models/nets.py``). ``net_cfg.use_pallas`` selects the fused forward
    (the port's kernels on CUDA), as it selects the Pallas forward in the
    JAX package.

    `params`/`batch_stats` are flax-layout trees, or `params` is a live
    training net (`batch_stats` None): the evaluator is then built
    from a snapshot of its weights on its own device (`device` is not
    read), as the JAX iteration rebuilds its evaluator from the learner's
    weights each iteration. The span ``features`` (``utils/trace.py``)
    times the input planes; the net's own spans follow."""
    if isinstance(params, torch.nn.Module):
        if net_cfg.use_pallas:
            model = nets.fused_from_module(env_cfg, net_cfg, params)
        else:
            model = copy.deepcopy(params)
    elif net_cfg.use_pallas:
        model = nets.fused(env_cfg, net_cfg, params, batch_stats, device)
    else:
        model = nets.from_flax(env_cfg, net_cfg, params, batch_stats, device)

    def evaluate(board, to_play, last):
        with trace.span("features"):
            x = vector.features(env_cfg, board, to_play, last)
        return model(x)

    return evaluate


def uniform_evaluator(env_cfg: EnvConfig) -> Callable:
    """Uniform legal priors, zero values (structural tests)."""

    def evaluate(board, to_play, last):
        e = board.shape[0]
        return (torch.zeros((e, env_cfg.num_actions), dtype=torch.float32,
                            device=board.device),
                torch.zeros((e,), dtype=torch.float32, device=board.device))

    return evaluate


def rollout_evaluator(env_cfg: EnvConfig, num_rollouts: int = 1,
                      generator: Optional[torch.Generator] = None
                      ) -> Callable:
    """Net-free evaluator: uniform priors + value from random playouts.

    The pure-MCTS Elo anchor. A playout plays uniformly random legal
    moves to the end; the value is the mean outcome over `num_rollouts`
    playouts from the leaf player's side. All E × `num_rollouts` playouts
    step together, one host sync per ply (``done.all()``). `generator`
    draws the moves; it must live on the device of the boards it gets
    (a fresh seed-0 generator by default)."""
    a = env_cfg.num_actions

    def evaluate(board, to_play, last):
        nonlocal generator
        if generator is None:
            generator = torch.Generator(device=board.device).manual_seed(0)
        e = board.shape[0]
        count = (board != 0).sum(-1).int()
        # leaves handed to the evaluator are never terminal (the search
        # substitutes exact values), but a full board would never end
        full = count >= a
        rep = lambda x: x.repeat((num_rollouts,) + (1,) * (x.dim() - 1))
        st = EnvState(board=rep(board), to_play=rep(to_play),
                      last_move=rep(last), move_count=rep(count),
                      done=rep(full),
                      winner=torch.zeros(e * num_rollouts, dtype=torch.int8,
                                         device=board.device))
        while not bool(st.done.all()):
            u = torch.rand(st.board.shape, generator=generator,
                           device=board.device)
            acts = torch.where(st.board == 0, u, -1.0).argmax(-1).int()
            st = vector.step(env_cfg, st, acts)
        # outcome from the perspective of the player to move at the leaf
        vals = (st.winner * rep(to_play)).float().reshape(num_rollouts, e)
        value = torch.where(full, 0.0, vals.mean(0))
        return (torch.zeros((e, a), dtype=torch.float32, device=board.device),
                value)

    return evaluate
