"""play: ``cli play``'s AI move, ``mcts.search.run_mcts`` on one env
without noise and the most visited move, then ``env.vector.step``. The AI
plays both sides; each game opens with ``opening_stones`` stones drawn
from the seed among the empty cells of the central ``opening_span`` ×
``opening_span`` square, and a new game starts when one ends. The device
stretch plays the games whose openings ``device_seed`` draws, the same
positions for every seed.
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from perfbench import generator


class Kind(generator.Base):
    unit_name = "move"
    NUMBERS = ("policy_tv", "value_gap", "search_faults", "rule_faults",
               "descent_faults")

    def __init__(self, ctx):
        from alphafive_tpu_torch.env import vector
        from alphafive_tpu_torch.mcts import search
        from alphafive_tpu_torch.models.evaluator import net_evaluator
        self.ctx, self.vector, self.search = ctx, vector, search
        cfg = ctx.cfg
        params, stats = ctx.weights
        ctx.instrument_search()
        net_eval = net_evaluator(cfg.env, cfg.net, params, stats, ctx.device)
        self.evaluate = ctx.probe.wrap_evaluate(
            ctx.inst.wrap("forward", net_eval))
        # cli play seeds its generator with 0; no noise draws from it
        self.gen = torch.Generator(device=ctx.device).manual_seed(0)
        self.openings = random.Random(ctx.seed)
        self.new_game()
        for _ in range(int(ctx.mix.get("warmup_units", 1))):
            self.unit()

    def new_game(self):
        cfg, mix = self.ctx.cfg, self.ctx.mix
        self.st = self.vector.init(cfg.env, 1, self.ctx.device)
        s, span = cfg.env.board_size, int(mix["opening_span"])
        lo = (s - span) // 2
        cells = [(lo + r) * s + lo + c for r in range(span)
                 for c in range(span)]
        for a in self.openings.sample(cells, int(mix["opening_stones"])):
            self.st = self.vector.step(cfg.env, self.st, torch.tensor(
                [a], dtype=torch.int32, device=self.ctx.device))

    def device_start(self):
        """The device stretch's start: a new game from the first opening
        that ``device_seed`` draws, and each later game from the next."""
        self.openings = random.Random(int(self.ctx.mix["device_seed"]))
        self.new_game()

    def forward_batches(self):
        m = self.ctx.cfg.mcts
        lb = max(1, int(m.leaf_batch))
        while m.num_simulations % lb:
            lb -= 1
        return [(1, 1), (lb, m.num_simulations // lb)]

    def unit(self) -> Dict:
        cfg = self.ctx.cfg
        res = self.search.run_mcts(cfg.env, cfg.mcts, self.evaluate, self.st,
                                   self.gen, add_noise=False)
        a = int(res.visits[0].argmax())
        action = torch.tensor([a], dtype=torch.int32, device=self.ctx.device)
        self.ctx.probe.observe(self.st, res, action)
        self.st = self.vector.step(cfg.env, self.st, action)
        if bool(self.st.done[0]):
            self.new_game()
        return {"moves": 1}

    def release(self):
        self.st = self.evaluate = None
