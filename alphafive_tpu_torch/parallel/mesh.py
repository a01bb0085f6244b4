"""The data-parallel actor-learner iteration (port of
``alphafive_tpu/parallel/mesh.py``: ``init_carry`` and the
``shard_map``-ped ``make_train_iteration``).

One iteration, in the JAX package's order, on every rank:

1. a leaf evaluator built from the learner's weights as they stand at the
   start of the iteration (with ``net.use_pallas`` batch norm is refolded
   on the device and self-play runs the resblock kernel);
2. ``selfplay_plies_per_iter`` lockstep plies of the rank's envs
   (``actor.selfplay_record``);
3. the staged chunk z-resolved with this chunk as lookahead and written
   into the rank's ring, except on the first iteration, when the staging
   buffer holds no data; this chunk becomes the staged one;
4. once the rings hold ``min_fill`` rows together, ``learner_steps_per_iter``
   steps, each on a freshly sampled batch of ``batch_size / world`` rows
   from the rank's own ring, with the KL probe against the phase-start
   policy on one probe batch: with ``kl_stop_factor`` > 0 the step that
   takes the KL past ``kl_stop_factor · kl_target`` is kept and the later
   ones do not run. The aux metrics are averaged over the steps that ran,
   then ``adapt_lr_scale`` reads the probe KL.

With a process group (``parallel/distributed.py``) each rank holds
``num_envs / world`` envs, a ring of ``capacity / world`` rows with its
own ``ptr``/``size`` and the staging buffer of its envs; params and
optimizer state are replicated. What crosses ranks is what JAX's
``psum``/``pmean`` cross: the ring fill for the learner gate (a sum), the
learner's gradients, updated batch-norm statistics and aux metrics (a
mean, in ``learner.train_step``), the probe KL (a mean), and the
metrics (games, env steps and results summed; ``mean_root_value`` and
``z_valid_frac`` averaged; ``buffer_size`` the global fill). Every branch
on the host reads a value that is equal on every rank (the gate, the KL
stop, ``wrote``, the step count), so every rank makes the same
collectives in the same order. Equal averaged gradients and statistics
keep the ranks' weights bit-identical.

Differences from the JAX program, by design: collectives of
``torch.distributed`` (each a flattened buffer) in place of ``pmean``;
the carry is updated in place; the staged recordings stay T-major
(``[T, E]``: each rank holds its own); one ``torch.Generator`` a rank
draws the Gumbel tables, the sampled batches and their symmetries, seeded
from ``(seed, rank)`` in place of ``fold_in(key, rank)`` (rank 0 keeps
``seed`` itself, so a world of one is the one-device run bit for bit);
the initial weights are broadcast from rank 0; the ring's ``ptr``/``size``
and the KL stop are read on the host (one device read per learner step
when the stop is on); steps after a KL stop are not run at all (JAX
computes and discards them; the state is the same). Metrics come back as
host floats under the JAX package's keys.

Spans (``utils/trace.py``): ``iteration`` / ``selfplay``,
``resolve_chunk``, ``ring_write``, ``learner_phase`` / ``sample``,
``train_step``, ``kl_probe``; sync sites ``kl_probe`` (the KL stop's read)
and ``iteration_metrics`` (the metrics' one read).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alphafive_tpu_torch.config import RunConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.nets import init_params
from alphafive_tpu_torch.parallel import distributed
from alphafive_tpu_torch.replay import buffer as replay_buffer
from alphafive_tpu_torch.replay.buffer import ReplayBuffer
from alphafive_tpu_torch.train import actor, learner
from alphafive_tpu_torch.train.learner import TrainState
from alphafive_tpu_torch.utils import trace

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


def mixed_seed(*words: int) -> int:
    """A generator seed from `words` (numpy's SeedSequence mixes them, so
    nearby tuples give unrelated streams)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)


def _world_rank(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def broadcast_train_state(ts: TrainState, group) -> None:
    """Rank 0's weights and batch-norm statistics onto every rank of
    `group`, in place (one broadcast)."""
    net = ts.net
    distributed.broadcast_(
        list(net.parameters()) + [t for _, _, m in net.conv_bns()
                                  for t in (m.bn.running_mean,
                                            m.bn.running_var)], group)


def init_carry(cfg: RunConfig, device="cuda", params=None, batch_stats=None,
               seed: Optional[int] = None, group=None) -> TrainCarry:
    """The initial carry of this rank on `device`: the train state from
    flax-layout trees (by default a random net from `seed`), broadcast
    from rank 0 of `group`; the rank's ``num_envs / world`` fresh envs,
    an empty ring of ``capacity / world`` rows, a zeroed staging buffer
    and a generator seeded from (`seed`, rank) (rank 0 and no group:
    `seed`, by default ``cfg.train.seed``). The world must divide the
    envs, the capacity and the batch, as JAX's ``init_carry`` asserts."""
    world, rank = _world_rank(group)
    for name, n in (("train.num_envs", cfg.train.num_envs),
                    ("replay.capacity", cfg.replay.capacity),
                    ("replay.batch_size", cfg.replay.batch_size)):
        if n % world:
            raise ValueError(f"{name}={n} does not divide over a world of "
                             f"{world} ranks")
    seed = cfg.train.seed if seed is None else seed
    if params is None:
        params, batch_stats = init_params(cfg.env, cfg.net, seed)
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, params,
                                  batch_stats, device)
    if group is not None:
        broadcast_train_state(ts, group)
    envs = cfg.train.num_envs // world
    return TrainCarry(
        train_state=ts,
        env_state=vector.init(cfg.env, envs, device),
        buffer=replay_buffer.init(cfg.env, cfg.replay,
                                  capacity=cfg.replay.capacity // world,
                                  device=device),
        pending=actor.init_recordings(cfg.env,
                                      cfg.train.selfplay_plies_per_iter,
                                      envs, device),
        has_pending=False,
        generator=torch.Generator(device=device).manual_seed(
            seed if rank == 0 else mixed_seed(seed, rank)))


def policy_logp(net: torch.nn.Module, features: torch.Tensor) -> torch.Tensor:
    """Log-policy of the eval-mode forward (running statistics)."""
    return torch.log_softmax(net(features)[0], dim=-1)


def learner_phase(cfg: RunConfig, ts: TrainState, buf: ReplayBuffer,
                  generator: torch.Generator, group=None
                  ) -> Dict[str, torch.Tensor]:
    """The K learner steps of an iteration with the KL probe, the early
    stop and ``adapt_lr_scale``, in place on `ts`, each step on
    ``batch_size / world`` rows of the rank's ring; returns the aux
    metrics averaged over the steps that ran. With `group` the probe KL
    is the mean over its ranks, so they stop together."""
    world, _ = _world_rank(group)
    bs, tc = cfg.replay.batch_size // world, cfg.train
    with trace.span("learner_phase"):
        with trace.span("sample"):
            probe = replay_buffer.sample(cfg.env, buf, bs, generator)[0]
        with trace.span("kl_probe"):
            old_logp = policy_logp(ts.net, probe)
            p_old = old_logp.exp()

        def probe_kl():
            new_logp = policy_logp(ts.net, probe)
            kl = (p_old * (old_logp - new_logp)).sum(-1).mean()
            return (kl if group is None
                    else distributed.all_reduce_mean([kl], group)[0])

        auxs = []
        for _ in range(tc.learner_steps_per_iter):
            with trace.span("sample"):
                batch = replay_buffer.sample(cfg.env, buf, bs, generator)
            with trace.span("train_step"):
                ts, aux = learner.train_step(cfg.env, cfg.net, tc, ts, batch,
                                             group=group)
            auxs.append(aux)
            if tc.kl_stop_factor > 0:
                with trace.span("kl_probe"):
                    stop = trace.read_bool(
                        "kl_probe",
                        probe_kl() > tc.kl_stop_factor * tc.kl_target)
                if stop:
                    break
        with trace.span("kl_probe"):
            aux = {k: torch.stack([a[k] for a in auxs]).sum() / len(auxs)
                   for k in auxs[0]}
            aux["executed_steps"] = float(len(auxs))
            kl = probe_kl()
            learner.adapt_lr_scale(ts, kl, tc.kl_target, tc.lr_scale_max)
            aux["kl_update"] = kl
        return aux


def make_train_iteration(cfg: RunConfig, group=None) -> Callable[
        [TrainCarry], Tuple[TrainCarry, Dict[str, float]]]:
    """Returns `iteration(carry) -> (carry, metrics)`: one chunk of
    self-play, the ring write and the learner phase, in place on `carry`
    (this rank's, from ``init_carry`` with the same `group`). `metrics`
    are host floats under the JAX iteration's keys, equal on every rank.
    Under ``torch.autograd``'s anomaly mode (``cli --debug-nans``) a
    non-finite metric raises ``FloatingPointError``."""

    def iteration(carry: TrainCarry):
        with trace.span("iteration"):
            ts, buf, gen = carry.train_state, carry.buffer, carry.generator
            dev = buf.board.device
            evaluate = net_evaluator(cfg.env, cfg.net, ts.net)
            with trace.span("selfplay"):
                env_state, recs, stats = actor.selfplay_record(
                    cfg.env, cfg.mcts, evaluate, carry.env_state, gen,
                    cfg.train.selfplay_plies_per_iter)
            with trace.span("resolve_chunk"):
                traj = actor.resolve_chunk(cfg.env, carry.pending,
                                           lookahead=recs)
            wrote = carry.has_pending
            if wrote:
                with trace.span("ring_write"):
                    replay_buffer.write(buf, traj.board, traj.to_play,
                                        traj.last_move, traj.pi, traj.z,
                                        traj.z_valid, traj.pi_valid)
            global_size = (buf.size if group is None else int(
                distributed.all_reduce_sum([buf.size], group, dev)[0]))
            do_update = global_size >= cfg.replay.min_fill
            if do_update:
                aux = learner_phase(cfg, ts, buf, gen, group)
            else:
                aux = dict.fromkeys(AUX_KEYS, 0.0)
            aux["z_valid_frac"] = (traj.z_valid.float().mean() if wrote
                                   else 0.0)
            # one device read for every tensor-valued metric
            names = [k for k, v in aux.items() if isinstance(v, torch.Tensor)]
            if names:
                values = trace.read_list("iteration_metrics", torch.stack(
                    [aux[k].float() for k in names]))
                aux.update(zip(names, values))
            # the chunk's metrics: summed over the ranks, two then averaged
            chunk = dict(games_finished=stats.games_finished,
                         env_steps=stats.env_steps,
                         black_wins=stats.black_wins,
                         white_wins=stats.white_wins, draws=stats.draws,
                         mean_root_value=stats.mean_root_value,
                         z_valid_frac=aux.pop("z_valid_frac"))
            if group is not None:
                world = dist.get_world_size(group)
                chunk = dict(zip(chunk, distributed.all_reduce_sum(
                    list(chunk.values()), group, dev)))
                chunk["mean_root_value"] /= world
                chunk["z_valid_frac"] /= world
            metrics = dict(
                aux, **{k: float(v) for k, v in chunk.items()},
                buffer_size=float(global_size),
                updated=float(do_update),
                step=float(ts.step))
            if torch.is_anomaly_enabled():
                bad = [k for k, v in metrics.items() if not math.isfinite(v)]
                if bad:
                    raise FloatingPointError(f"non-finite iteration metric "
                                             f"{bad[0]!r} (all: {bad})")
            carry.env_state, carry.pending = env_state, recs
            carry.has_pending = True
            return carry, metrics

    return iteration
