"""The training pipeline on the host: self-play → train → evaluate (port
of ``alphafive_tpu/train/loop.py``, in its order of operations).

Each iteration runs ``parallel.make_train_iteration`` (self-play, the ring
write, the learner) and logs one ``iter`` record. A checkpoint is written
every ``checkpoint_every_iters`` BEFORE the eval: the eval is the longest
part of an iteration, and a run that dies in it resumes after the
iteration, not a checkpoint interval back. Every ``eval_every_iters`` the
net plays the pure-MCTS anchor ladder (``run_eval``), the ladder goes to a
sidecar (``<workdir>/ladder.json``), and the best-model gate runs: a new
best ladder Elo promotes, or, once the ladder is maxed and swept, a
net-vs-net match against ``<workdir>/best_model`` (``_eval_vs_best``).
A promotion saves the full state to ``<workdir>/best`` and exports
``best_model/``. A final checkpoint is written at ``total``.

Under a process group (``parallel/distributed.py``; ``cli train
--multihost``) every rank runs this loop on its shard of the envs and the
ring (``parallel/mesh.py``), and rank 0 alone writes ``metrics.jsonl``,
the sidecar, ``best_model/`` and the profile; the checkpoints are
collective (``train/checkpoint.py``). Rank 0 alone plays the eval and
decides the gate; its ladder, Elo and decision are broadcast on the host
group before any save, so float differences cannot split the ranks, and
the other ranks wait for them there (``distributed.HOST_TIMEOUT``), with
no NCCL work in flight.

Differences from the JAX loop, by design:

* randomness: the carry's generator drives self-play and the learner
  (``parallel/mesh.py``); each eval gets a generator of its own, seeded
  from ``(train.seed, iteration)`` (and a tag for the net-vs-net match
  and the transfer init), the counterpart of JAX's dedicated eval key and
  ``fold_in``. No eval draw touches the carry's stream, so a resume stays
  bit-reproducible without saving an eval key;
* a loaded ladder (checkpoint or sidecar) has each history entry's Elo
  recomputed from its stored score and games at its level, so an entry
  rated under the old fixed clamp cannot stall promotion (the JAX loop
  keeps it as stored);
* the eval runs on rank 0 alone (JAX's SPMD program runs it on every
  process, each with the same result);
* a profile still running when the loop ends is stopped and written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import torch

from alphafive_tpu_torch import parallel
from alphafive_tpu_torch.config import MCTSConfig, RunConfig
from alphafive_tpu_torch.models.evaluator import (net_evaluator,
                                                  rollout_evaluator)
from alphafive_tpu_torch.parallel import distributed
from alphafive_tpu_torch.parallel.mesh import broadcast_train_state, mixed_seed
from alphafive_tpu_torch.train import checkpoint as ckpt
from alphafive_tpu_torch.train.evaluate import evaluate_vs
from alphafive_tpu_torch.utils.elo import (ANCHOR_STEP_ELO, LadderState,
                                           performance_elo, update_ladder)
from alphafive_tpu_torch.utils import trace
from alphafive_tpu_torch.utils.logging import MetricsLogger

# generator tags: JAX's fold_in constants for the net-vs-net match and the
# transfer init
BEST_TAG, TRANSFER_TAG = 0xBE57, 0x5117


def _generator(device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from `words`."""
    return torch.Generator(device=device).manual_seed(mixed_seed(*words))


def train(cfg: RunConfig, workdir: Optional[str] = None,
          total_iters: Optional[int] = None, resume: bool = False,
          logger: Optional[MetricsLogger] = None, profile_iters: int = 0,
          init_from: Optional[str] = None, device="cuda"):
    """Run the pipeline on `device`. Returns (carry, ladder).

    Under a process group this is the rank's part of the run, and the
    world takes the place of ``mesh.data`` (as in JAX's multi-process
    loop); without one, ``mesh.data`` > 1 raises with the launch command.
    profile_iters > 0 captures a ``torch.profiler`` trace of iterations
    [start + 2, start + 2 + profile_iters) into ``<workdir>/profile``,
    with the program's spans on (``af.`` ranges in the trace, and a
    ``trace`` record of their times and the counters in the metrics).
    init_from warm-starts a fresh run's net from an exported model through
    function-preserving surgery (``models/surgery.py``); a resumed
    checkpoint takes precedence (the warm start happened in that run)."""
    total = total_iters if total_iters is not None else cfg.train.total_iters
    group, primary = distributed.group(), distributed.is_primary()
    if group is None and cfg.mesh.data > 1:
        raise ValueError(
            f"mesh.data={cfg.mesh.data} needs {cfg.mesh.data} processes, one "
            f"a GPU: torchrun --nproc-per-node {cfg.mesh.data} -m "
            "alphafive_tpu_torch.cli train --multihost ... (or --set "
            "mesh.data=1 for one device)")
    log = logger or MetricsLogger(workdir if primary else None,
                                  quiet=not primary)
    mgr = ckpt.make_manager(f"{workdir}/ckpt") if workdir else None

    carry = parallel.init_carry(cfg, device, group=group)
    ladder = LadderState(max_rollouts=cfg.train.max_anchor_rollouts)
    start_iter = 0

    if resume and mgr is not None and mgr.latest_step() is not None:
        start_iter, carry, cfg_saved, ladder = ckpt.restore(mgr, carry)
        if cfg_saved.env != cfg.env:
            raise ValueError("resume with a different env config: "
                             f"{cfg_saved.env} saved, {cfg.env} given")
        # evals run after the checkpoint within an iteration, so their
        # ladder changes persist in the sidecar; prefer it when it is at
        # least as new as the checkpoint
        side = _read_ladder_sidecar(workdir)
        if side is not None and side[0] >= start_iter:
            ladder = side[1]
        _rescore_history(ladder)
        # the current config's anchor cap wins over a saved ladder that
        # already promoted past it
        ladder.max_rollouts = min(ladder.max_rollouts,
                                  cfg.train.max_anchor_rollouts)
        while ladder.level > 0 and ladder.anchor_rollouts > ladder.max_rollouts:
            ladder.level -= 1
        log.log({"kind": "resume", "iter": start_iter})
    elif init_from is not None:
        carry = _apply_transfer_init(cfg, carry, init_from, device)
        if group is not None:
            broadcast_train_state(carry.train_state, group)
        log.log({"kind": "transfer_init", "src": init_from})

    iteration = parallel.make_train_iteration(cfg, group)
    sims = cfg.mcts.num_simulations
    n_chips = distributed.world()
    prof = None
    dev = torch.device(device)
    profile = bool(profile_iters and workdir and primary)

    for it in range(start_iter, total):
        if profile and it == start_iter + 2:
            prof = _start_profile(dev)
        if profile and it == start_iter + 2 + profile_iters:
            _stop_profile(prof, workdir, log)
            prof = None
        t0 = time.time()
        carry, metrics = iteration(carry)
        dt = time.time() - t0   # the metrics' read waited for the device
        env_steps = metrics["env_steps"]
        log.log({
            "kind": "iter", "iter": it, **metrics,
            "iter_seconds": dt,
            "env_steps_per_s": env_steps / dt,
            "env_steps_per_s_per_chip": env_steps / dt / n_chips,
            "sims_per_s": env_steps * sims / dt,
            # canaries: the KL controller pinned at its 0.1 floor, or at
            # its upper cap (train.lr_scale_max); a sustained rolling
            # mean near 1.0 of either is the alarm (the JAX loop's
            # comments give the runs that showed them)
            "lr_at_floor": 1.0 if metrics.get("lr_scale", 1.0) <= 0.101
            else 0.0,
            "lr_at_ceiling": 1.0 if metrics.get("lr_scale", 1.0)
            >= cfg.train.lr_scale_max * 0.999 else 0.0,
        })

        do_eval = (cfg.train.eval_every_iters
                   and (it + 1) % cfg.train.eval_every_iters == 0)
        if mgr is not None and (it + 1) % cfg.train.checkpoint_every_iters == 0:
            ckpt.save(mgr, it + 1, carry, cfg, ladder)
            log.log({"kind": "checkpoint", "iter": it + 1})
        if do_eval:
            best_model_dir = f"{workdir}/best_model" if workdir else None
            elo = promote = None
            if primary:
                elo = run_eval(cfg, carry, ladder, it, log, device)
                if workdir:
                    _write_ladder_sidecar(workdir, it + 1, ladder)
                promote = _best_gate(cfg, carry, ladder, elo, best_model_dir,
                                     it, log, device)
            elo, promote, ladder = distributed.broadcast_object(
                (elo, promote, ladder))
            if promote:
                ckpt.save(ckpt.make_manager(f"{workdir}/best",
                                            max_to_keep=1),
                          it + 1, carry, cfg, ladder)
                if primary:
                    params, batch_stats = carry.train_state.net.to_flax()
                    ckpt.export_model(best_model_dir, params, batch_stats,
                                      cfg, extra={"iteration": it + 1})
                log.log({"kind": "best", "iter": it + 1, "elo": elo})

    if prof is not None:
        _stop_profile(prof, workdir, log)
    if mgr is not None:
        ckpt.save(mgr, total, carry, cfg, ladder)
    return carry, ladder


def _best_gate(cfg: RunConfig, carry, ladder: LadderState,
               elo: Optional[float], best_model_dir: Optional[str], it: int,
               log: MetricsLogger, device) -> bool:
    """Whether this eval promotes the net to best, decided in one place.
    Two regimes: while the ladder is live, a new best performance Elo;
    once it is maxed and swept (the anchors carry no more signal), a
    net-vs-net match against the stored best model, promoted at
    ``train.best_gate_score``. No workdir, no promotion. Under a process
    group rank 0 alone calls it, and ``train`` broadcasts the decision,
    so that every rank enters the best save together."""
    if best_model_dir is None:
        return False
    maxed = ladder.anchor_rollouts * 2 > ladder.max_rollouts
    swept = (ladder.history
             and ladder.history[-1]["score"] >= ladder.promote_score)
    have_best = os.path.exists(f"{best_model_dir}/model.msgpack")
    if maxed and swept and have_best:
        score = _eval_vs_best(cfg, carry, best_model_dir, it, log, device)
        return score >= cfg.train.best_gate_score
    best_so_far = max((h["elo"] for h in ladder.history[:-1]), default=-1e9)
    return elo is not None and elo > best_so_far


def _apply_transfer_init(cfg: RunConfig, carry, init_from: str, device):
    """Replace the fresh carry's net with a surgery-transferred one and a
    fresh optimizer state for it (moments of the random init would be
    meaningless); envs, ring and staging stay as they are."""
    from alphafive_tpu_torch.models import surgery
    from alphafive_tpu_torch.train import learner

    src_params, src_bs, src_cfg = ckpt.load_model(init_from)
    variables = surgery.transfer(
        {"params": src_params, "batch_stats": src_bs},
        src_cfg.env, src_cfg.net, cfg.env, cfg.net,
        _generator("cpu", cfg.train.seed, TRANSFER_TAG))
    carry.train_state = learner.init_train_state(
        cfg.env, cfg.net, cfg.train, variables["params"],
        variables["batch_stats"], device)
    return carry


def _rescore_history(ladder: LadderState) -> None:
    """Recompute each history entry's Elo from its stored score and
    games at its level (the clamp at the sample resolution), in place."""
    for h in ladder.history:
        if "score" in h and "level" in h:
            h["elo"] = performance_elo(h["score"], ANCHOR_STEP_ELO * h["level"],
                                       games=h.get("games"))


def _write_ladder_sidecar(workdir: str, iteration: int,
                          ladder: LadderState) -> None:
    tmp = f"{workdir}/ladder.json.tmp"
    with open(tmp, "w") as f:
        json.dump({"iter": iteration,
                   "ladder": dataclasses.asdict(ladder)}, f)
    os.replace(tmp, f"{workdir}/ladder.json")


def _read_ladder_sidecar(workdir: Optional[str]):
    path = f"{workdir}/ladder.json" if workdir else None
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return int(d["iter"]), ckpt._ladder_from_dict(d["ladder"])


def _eval_vs_best(cfg: RunConfig, carry, best_model_dir: str, it: int,
                  log: MetricsLogger, device) -> float:
    """The current net against the stored best model, the same search
    config on both sides (isolates net quality), from random openings
    because both players are deterministic. Returns the current net's
    score."""
    cur = net_evaluator(cfg.env, cfg.net, carry.train_state.net)
    bp, bbs, bcfg = ckpt.load_model(best_model_dir)
    best = net_evaluator(cfg.env, bcfg.net, bp, bbs, device)
    sims = cfg.train.eval_simulations or cfg.mcts.num_simulations
    res = evaluate_vs(cfg.env, cfg.mcts, cur, best, sims, sims,
                      cfg.train.eval_games,
                      _generator(device, cfg.train.seed, it, BEST_TAG),
                      mcts_a=cfg.mcts, mcts_b=cfg.mcts,
                      opening_plies=2, plies_per_call=2, device=device)
    log.log({"kind": "eval_best", "iter": it, **res,
             "best_iteration": _best_iteration(best_model_dir)})
    return res["score"]


def _best_iteration(best_model_dir: str):
    with open(f"{best_model_dir}/config.json") as f:
        return json.load(f).get("iteration")


def run_eval(cfg: RunConfig, carry, ladder: LadderState, it: int,
             log: MetricsLogger, device="cuda"):
    """Current net-MCTS vs the pure-MCTS anchor; updates the ladder and
    returns the Elo estimate. The anchor always searches with the
    canonical exact config (sequential PUCT, no depth cap), so its
    strength, and the Elo scale, is preset-independent; only the net side
    uses the preset's search config."""
    gen = _generator(device, cfg.train.seed, it)
    net_eval = net_evaluator(cfg.env, cfg.net, carry.train_state.net)
    anchor = rollout_evaluator(cfg.env, generator=gen)
    eval_sims = cfg.train.eval_simulations or cfg.mcts.num_simulations
    result = evaluate_vs(
        cfg.env, cfg.mcts, net_eval, anchor,
        eval_sims, ladder.anchor_rollouts, cfg.train.eval_games, gen,
        mcts_a=cfg.mcts, mcts_b=MCTSConfig(),
        plies_per_call=1 if ladder.anchor_rollouts >= 3_200 else 2,
        device=device)
    elo = update_ladder(ladder, result, it)
    log.log({"kind": "eval", "iter": it, **result, "elo": elo,
             "anchor_rollouts": ladder.history[-1]["anchor_rollouts"],
             "level": ladder.history[-1]["level"]})
    return elo


def _start_profile(device: torch.device):
    """A ``torch.profiler`` run with the program's spans on: the trace
    carries them as ``af.<span>`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    trace.reset()
    trace.enable()
    return prof


def _stop_profile(prof, workdir: str, log: MetricsLogger) -> None:
    """Export the trace to ``<workdir>/profile/trace.json`` and log the
    spans and counters of the profiled iterations as a ``trace``
    record."""
    trace.disable()
    prof.stop()
    out = f"{workdir}/profile"
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(f"{out}/trace.json")
    log.log({"kind": "profile", "dir": out})
    log.log({"kind": "trace", **trace.snapshot()})
