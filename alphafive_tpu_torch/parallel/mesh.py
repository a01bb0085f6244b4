"""The actor-learner iteration on one device (port of
``alphafive_tpu/parallel/mesh.py``'s ``_local_iteration`` at one device).

One iteration, in the JAX package's order:

1. a leaf evaluator built from the learner's weights as they stand at the
   start of the iteration (with ``net.use_pallas`` batch norm is refolded
   on the device and self-play runs the resblock kernel);
2. ``selfplay_plies_per_iter`` lockstep plies (``actor.selfplay_record``);
3. the staged chunk z-resolved with this chunk as lookahead and written
   into the ring, except on the first iteration, when the staging buffer
   holds no data; this chunk becomes the staged one;
4. once the ring holds ``min_fill`` rows, ``learner_steps_per_iter``
   steps, each on a freshly sampled batch, with the KL probe against the
   phase-start policy on one probe batch: with ``kl_stop_factor`` > 0 the
   step that takes the KL past ``kl_stop_factor · kl_target`` is kept and
   the later ones do not run. The aux metrics are averaged over the steps
   that ran, then ``adapt_lr_scale`` reads the probe KL.

Differences from the JAX program, by design: no mesh, ``shard_map`` or
collectives (one device; the multi-device program is ROADMAP item 15);
the carry is updated in place; the staged recordings stay T-major
(``[T, E]``: nothing shards them); one ``torch.Generator`` in the carry
draws the Gumbel tables, the sampled batches and their symmetries; the
ring's ``ptr``/``size`` and the KL stop are read on the host (one device
read per learner step when the stop is on). Metrics come back as host
floats under the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from alphafive_tpu_torch.config import RunConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.resnet import PolicyValueNet, init_params
from alphafive_tpu_torch.replay import buffer as replay_buffer
from alphafive_tpu_torch.replay.buffer import ReplayBuffer
from alphafive_tpu_torch.train import actor, learner
from alphafive_tpu_torch.train.learner import TrainState

# the learner's metrics, zero on an iteration without update
AUX_KEYS = learner.AUX_KEYS + ("grad_norm", "lr_scale", "kl_update",
                               "executed_steps")


@dataclasses.dataclass
class TrainCarry:
    train_state: TrainState
    env_state: EnvState
    buffer: ReplayBuffer
    # the previous chunk's raw recordings ([T, E]), staged until the next
    # chunk gives them lookahead; has_pending gates the first write (the
    # zeroed staging buffer is not data)
    pending: actor.Recordings
    has_pending: bool
    generator: torch.Generator


def init_carry(cfg: RunConfig, device="cuda", params=None, batch_stats=None,
               seed: Optional[int] = None) -> TrainCarry:
    """The initial carry on `device`: the train state from flax-layout
    trees (by default a random net from `seed`), fresh envs, an empty
    ring, a zeroed staging buffer and a generator seeded with `seed`
    (default ``cfg.train.seed``)."""
    seed = cfg.train.seed if seed is None else seed
    if params is None:
        params, batch_stats = init_params(cfg.env, cfg.net, seed)
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, params,
                                  batch_stats, device)
    return TrainCarry(
        train_state=ts,
        env_state=vector.init(cfg.env, cfg.train.num_envs, device),
        buffer=replay_buffer.init(cfg.env, cfg.replay, device=device),
        pending=actor.init_recordings(cfg.env,
                                      cfg.train.selfplay_plies_per_iter,
                                      cfg.train.num_envs, device),
        has_pending=False,
        generator=torch.Generator(device=device).manual_seed(seed))


def policy_logp(net: PolicyValueNet, features: torch.Tensor) -> torch.Tensor:
    """Log-policy of the eval-mode forward (running statistics)."""
    return torch.log_softmax(net(features)[0], dim=-1)


def learner_phase(cfg: RunConfig, ts: TrainState, buf: ReplayBuffer,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The K learner steps of an iteration with the KL probe, the early
    stop and ``adapt_lr_scale``, in place on `ts`; returns the aux
    metrics averaged over the steps that ran."""
    bs, tc = cfg.replay.batch_size, cfg.train
    probe = replay_buffer.sample(cfg.env, buf, bs, generator)[0]
    old_logp = policy_logp(ts.net, probe)
    p_old = old_logp.exp()

    def probe_kl():
        new_logp = policy_logp(ts.net, probe)
        return (p_old * (old_logp - new_logp)).sum(-1).mean()

    auxs = []
    for _ in range(tc.learner_steps_per_iter):
        batch = replay_buffer.sample(cfg.env, buf, bs, generator)
        ts, aux = learner.train_step(cfg.env, cfg.net, tc, ts, batch)
        auxs.append(aux)
        if (tc.kl_stop_factor > 0
                and bool(probe_kl() > tc.kl_stop_factor * tc.kl_target)):
            break
    aux = {k: torch.stack([a[k] for a in auxs]).sum() / len(auxs)
           for k in auxs[0]}
    aux["executed_steps"] = float(len(auxs))
    kl = probe_kl()
    learner.adapt_lr_scale(ts, kl, tc.kl_target, tc.lr_scale_max)
    aux["kl_update"] = kl
    return aux


def make_train_iteration(cfg: RunConfig) -> Callable[
        [TrainCarry], Tuple[TrainCarry, Dict[str, float]]]:
    """Returns `iteration(carry) -> (carry, metrics)`: one chunk of
    self-play, the ring write and the learner phase, in place on `carry`.
    `metrics` are host floats under the JAX iteration's keys."""

    def iteration(carry: TrainCarry):
        ts, buf, gen = carry.train_state, carry.buffer, carry.generator
        evaluate = net_evaluator(cfg.env, cfg.net, ts.net)
        env_state, recs, stats = actor.selfplay_record(
            cfg.env, cfg.mcts, evaluate, carry.env_state, gen,
            cfg.train.selfplay_plies_per_iter)
        traj = actor.resolve_chunk(cfg.env, carry.pending, lookahead=recs)
        wrote = carry.has_pending
        if wrote:
            replay_buffer.write(buf, traj.board, traj.to_play,
                                traj.last_move, traj.pi, traj.z,
                                traj.z_valid, traj.pi_valid)
        do_update = buf.size >= cfg.replay.min_fill
        if do_update:
            aux = learner_phase(cfg, ts, buf, gen)
        else:
            aux = dict.fromkeys(AUX_KEYS, 0.0)
        aux["z_valid_frac"] = (traj.z_valid.float().mean() if wrote
                               else 0.0)
        # one device read for every tensor-valued metric
        names = [k for k, v in aux.items() if isinstance(v, torch.Tensor)]
        if names:
            values = torch.stack([aux[k].float() for k in names]).tolist()
            aux.update(zip(names, values))
        metrics = dict(
            aux,
            games_finished=float(stats.games_finished),
            env_steps=float(stats.env_steps),
            black_wins=float(stats.black_wins),
            white_wins=float(stats.white_wins),
            draws=float(stats.draws),
            mean_root_value=stats.mean_root_value,
            buffer_size=float(buf.size),
            updated=float(do_update),
            step=float(ts.step))
        carry.env_state, carry.pending = env_state, recs
        carry.has_pending = True
        return carry, metrics

    return iteration
