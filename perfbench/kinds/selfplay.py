"""selfplay: ``train.actor.selfplay_chunk`` (one lockstep ply a unit) with
``models.evaluator.net_evaluator``.

Before the first ply the envs are staggered, so that the window sees the
mix of game phases of a long self-play run and not only openings: env j
plays d_j moves, the d_j an even spread over ``0 … stagger_plies − 1``
dealt to the envs in an order drawn from the seed (every seed plays the
same set of depths), each move drawn from the plain reference net's
policy over the empty cells (the configuration's architecture's), by a
generator seeded from the seed. An env whose game would end there stops
a move short.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from perfbench import generator
from perfbench.reference import net as ref_net


class Kind(generator.Base):
    unit_name = "ply"
    NUMBERS = ("policy_tv", "value_gap", "search_faults", "rule_faults",
               "descent_faults")

    def __init__(self, ctx):
        from alphafive_tpu_torch.env import vector
        from alphafive_tpu_torch.models.evaluator import net_evaluator
        from alphafive_tpu_torch.train import actor
        self.ctx, self.actor, self.vector = ctx, actor, vector
        cfg = ctx.cfg
        self.envs = cfg.train.num_envs
        params, stats = ctx.weights
        ctx.instrument_search()
        net_eval = net_evaluator(cfg.env, cfg.net, params, stats, ctx.device)
        self.evaluate = ctx.probe.wrap_evaluate(ctx.inst.wrap(
            lambda b, t, l: ("root_forward" if b.shape[0] == self.envs
                             else "leaf_forward"), net_eval))
        t = time.perf_counter()
        self.state = self.stagger(vector.init(cfg.env, self.envs, ctx.device))
        ctx.sync()
        self.setup_phases = {"stagger_s": time.perf_counter() - t}
        self.gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        t = time.perf_counter()
        for _ in range(int(ctx.mix.get("warmup_units", 1))):
            self.unit()
        ctx.sync()
        self.setup_phases["warmup_s"] = time.perf_counter() - t

    @staticmethod
    def depths(envs: int, n: int, seed: int) -> torch.Tensor:
        """Each env's depth: an even spread over 0 … n − 1, dealt in an
        order drawn from `seed`."""
        order = torch.randperm(envs, generator=torch.Generator().manual_seed(
            seed))
        return ((torch.arange(envs) * n) // envs)[order]

    def stagger(self, state):
        ctx, n = self.ctx, int(self.ctx.mix.get("stagger_plies", 0))
        if n <= 0:
            return state
        size = ctx.cfg.env.board_size
        depth = self.depths(self.envs, n, ctx.seed).to(ctx.device)
        arch = ctx.arch
        p, s = (ref_net.tree_to_torch(t, ctx.device) for t in ctx.weights)
        gen = torch.Generator(device=ctx.device).manual_seed(
            (ctx.seed * 2654435761 + 97) % (2 ** 63))
        for k in range(int(depth.max())):
            logits, _ = arch.forward(p, s, arch.features(
                size, state.board, state.to_play, state.last_move))
            logp = ref_net.masked_log_softmax(logits, state.board == 0)
            a = torch.multinomial(logp.exp(), 1, generator=gen)[:, 0]
            nxt = self.vector.step(ctx.cfg.env, state, a.int())
            take = (depth > k) & ~nxt.done
            state = type(state)(**{
                f.name: torch.where(
                    take.reshape((-1,) + (1,) * (getattr(state, f.name).dim()
                                                 - 1)),
                    getattr(nxt, f.name), getattr(state, f.name))
                for f in dataclasses.fields(state)})
        return state

    @staticmethod
    def greedy(state, mcts):
        return state.move_count >= mcts.temperature_moves

    def forward_batches(self):
        m = self.ctx.cfg.mcts
        lb = max(1, int(m.leaf_batch))
        while m.num_simulations % lb:
            lb -= 1
        return [(self.envs, 1), (self.envs * lb, m.num_simulations // lb)]

    def unit(self) -> Dict:
        cfg = self.ctx.cfg
        self.state, _, stats = self.actor.selfplay_chunk(
            cfg.env, cfg.mcts, self.evaluate, self.state, self.gen, 1,
            observe=self.ctx.probe.observe)
        return {"env_steps": stats.env_steps}

    def release(self):
        self.state = self.evaluate = None
