"""train: ``parallel.mesh.init_carry`` and ``make_train_iteration`` from
the bundle's weights, one iteration a unit (a chunk of self-play, the
ring write, the learner's steps). The ``setup_iterations`` before the
window stage the first chunk and take the learner's first steps, which
the reference follows.
"""

from __future__ import annotations

from typing import Dict

from perfbench import generator


class Kind(generator.Base):
    unit_name = "iteration"
    NUMBERS = ("policy_tv", "value_gap", "search_faults", "rule_faults",
               "search_tv", "ring_faults", "batch_faults", "loss_gap",
               "grad_gap", "change_gap_median")
    EVAL_IN_SETUP = True
    RECORDS_GAMES = True

    def __init__(self, ctx):
        from alphafive_tpu_torch.parallel import mesh
        from alphafive_tpu_torch.replay import buffer
        from alphafive_tpu_torch.train import actor, learner
        self.ctx = ctx
        cfg = ctx.cfg
        params, stats = ctx.weights
        self.envs = cfg.train.num_envs
        ctx.instrument_search()
        ctx.patch(mesh, "learner_phase", "learner")
        ctx.patch(actor, "selfplay_record", "selfplay")
        ctx.patch(learner, "train_step", "train_step")
        ctx.patch(buffer, "write", "ring_write")
        probe = ctx.probe

        def evaluator(make):
            def build(env_cfg, net_cfg, net, *args, **kw):
                probe.note_actor(net)
                return probe.wrap_evaluate(ctx.inst.wrap(
                    lambda b, t, l: ("root_forward"
                                     if b.shape[0] == self.envs
                                     else "leaf_forward"),
                    make(env_cfg, net_cfg, net, *args, **kw)))
            return build
        ctx.patches.wrap(mesh, "net_evaluator", evaluator)

        def with_observe(fn):
            def run(*args, **kw):
                kw["observe"] = probe.observe
                return fn(*args, **kw)
            return run
        ctx.patches.wrap(actor, "selfplay_record", with_observe)
        probe.watch_learner(ctx.patches, learner)
        probe.watch_sampler(ctx.patches, buffer)
        self.carry = mesh.init_carry(cfg, ctx.device, params=params,
                                     batch_stats=stats, seed=ctx.seed)
        self.iteration = mesh.make_train_iteration(cfg)
        probe.setup_phase = True
        for _ in range(int(ctx.mix["setup_iterations"])):
            self.unit()
        probe.setup_phase = False

    def forward_batches(self):
        cfg = self.ctx.cfg
        t = cfg.train.selfplay_plies_per_iter
        lanes = min(cfg.mcts.gumbel_m, cfg.mcts.num_simulations)
        return [(self.envs, t), (self.envs * lanes, t)]

    def unit(self) -> Dict:
        ptr = self.carry.buffer.ptr
        self.carry, metrics = self.iteration(self.carry)
        self.ctx.probe.after_iteration(self.carry, ptr)
        return {"env_steps": int(metrics["env_steps"]),
                "learner_steps": int(metrics["executed_steps"])}

    def release(self):
        self.carry = self.iteration = None
