"""The training loop: the port's ``train/loop.py`` against the JAX
package's ``train`` (records, files, resume) and its own guarantees
(twins of ``tests/test_train.py``'s loop tests)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.train import loop as jloop
from alphafive_tpu.utils.elo import update_ladder as j_update_ladder
from alphafive_tpu.utils.logging import MetricsLogger as JMetricsLogger
from alphafive_tpu_torch.config import EnvConfig, NetConfig, get_preset
from alphafive_tpu_torch.models.resnet import init_params
from alphafive_tpu_torch.train import checkpoint as ckpt
from alphafive_tpu_torch.train import loop
from alphafive_tpu_torch.utils import trace
from alphafive_tpu_torch.utils.elo import LadderState, update_ladder
from alphafive_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)


def small(cfg, **train):
    """tiny_test at short chunks: 6 plies, learner batches of 8."""
    return cfg.replace(
        train=dataclasses.replace(cfg.train, selfplay_plies_per_iter=6,
                                  **train),
        replay=dataclasses.replace(cfg.replay, min_fill=8, batch_size=8))


def records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def quiet():
    return MetricsLogger(None, quiet=True)


def test_kill_and_resume_bit_reproducible(tmp_path):
    """Interrupted after 2 iterations and resumed to 4, the run ends in
    the state of an uninterrupted 4-iteration run: every weight, moment,
    statistic, ring row, env and the generator."""
    cfg = small(get_preset("tiny_test"), eval_every_iters=0,
                checkpoint_every_iters=2)
    a, _ = loop.train(cfg, str(tmp_path / "a"), 4, logger=quiet(),
                      device="cpu")
    wd = str(tmp_path / "b")
    loop.train(cfg, wd, 2, logger=quiet(), device="cpu")
    b, _ = loop.train(cfg, wd, 4, resume=True, logger=quiet(), device="cpu")
    for (k, v), w in zip(a.train_state.net.state_dict().items(),
                         b.train_state.net.state_dict().values()):
        assert torch.equal(v, w), k
    for v, w in zip(a.train_state.opt_state.mu, b.train_state.opt_state.mu):
        assert torch.equal(v, w)
    assert torch.equal(a.buffer.board, b.buffer.board)
    assert a.buffer.size == b.buffer.size > 0
    assert torch.equal(a.env_state.board, b.env_state.board)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert ckpt.make_manager(f"{wd}/ckpt").all_steps() == [2, 4]


def test_ladder_sidecar_roundtrip(tmp_path):
    assert loop._read_ladder_sidecar(str(tmp_path)) is None
    lad = LadderState(level=3, history=[{"step": 1, "elo": 42.0}])
    loop._write_ladder_sidecar(str(tmp_path), 50, lad)
    it, back = loop._read_ladder_sidecar(str(tmp_path))
    assert it == 50 and back == lad


# eval results by 0-based iteration, the same for both packages
SCRIPT = {1: 0.5, 3: 0.75, 5: 0.25}


def scripted(ladder, it, log, update):
    wins = int(SCRIPT[it] * 4)
    result = {"score": SCRIPT[it], "games": 4, "wins": wins,
              "losses": 4 - wins, "draws": 0}
    elo = update(ladder, result, it)
    log.log({"kind": "eval", "iter": it, **result, "elo": elo})
    return elo


def test_records_and_files_match_jax(tmp_path, monkeypatch):
    """The same schedule in both packages (checkpoints and evals every 2
    iterations, 4 iterations, then a resume to 6; the anchor evals
    scripted alike): the same (kind, iter) records with the same keys,
    and the same files, checkpoint steps and best steps."""
    monkeypatch.setattr(jloop, "run_eval",
                        lambda cfg, carry, ladder, it, key, log:
                        scripted(ladder, it, log, j_update_ladder))
    monkeypatch.setattr(loop, "run_eval",
                        lambda cfg, carry, ladder, it, log, device:
                        scripted(ladder, it, log, update_ladder))
    sched = dict(eval_every_iters=2, checkpoint_every_iters=2)
    jcfg = small(j_get_preset("tiny_test"), **sched)
    jcfg = jcfg.replace(mesh=dataclasses.replace(jcfg.mesh, data=1))
    cfg = small(get_preset("tiny_test"), **sched)
    jwd, wd = str(tmp_path / "jax"), str(tmp_path / "port")
    for total, resume in ((4, False), (6, True)):
        jloop.train(jcfg, jwd, total, resume=resume,
                    logger=JMetricsLogger(jwd, quiet=True,
                                          tensorboard=False))
        loop.train(cfg, wd, total, resume=resume,
                   logger=MetricsLogger(wd, quiet=True, tensorboard=False),
                   device="cpu")
    got, want = records(wd), records(jwd)
    assert [(r["kind"], r.get("iter")) for r in got] == \
        [(r["kind"], r.get("iter")) for r in want]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["kind"] for r in got].count("best") == 2
    iters = [r for r in got if r["kind"] == "iter"]
    assert all(r["lr_at_floor"] in (0.0, 1.0)
               and r["lr_at_ceiling"] in (0.0, 1.0) for r in iters)
    assert iters[-1]["updated"] == 1.0
    assert sorted(os.listdir(wd)) == sorted(os.listdir(jwd))
    for sub in ("ckpt", "best"):
        assert sorted(os.listdir(f"{wd}/{sub}")) == \
            sorted(os.listdir(f"{jwd}/{sub}")), sub
    assert sorted(os.listdir(f"{wd}/best_model")) == \
        sorted(os.listdir(f"{jwd}/best_model"))
    for side in (wd, jwd):
        with open(f"{side}/ladder.json") as f:
            assert json.load(f)["iter"] == 6


def test_best_gate_switches_to_net_vs_net(tmp_path, monkeypatch):
    """Once the ladder is maxed and swept, the first promotion exports
    best_model by Elo and the next eval plays a real net-vs-net match
    against it, logged as eval_best (twin of the JAX test)."""
    def sweep(cfg, carry, ladder, it, log, device):
        result = {"score": 1.0, "games": 4, "wins": 4, "losses": 0,
                  "draws": 0}
        elo = update_ladder(ladder, result, it)
        log.log({"kind": "eval", "iter": it, **result, "elo": elo})
        return elo

    monkeypatch.setattr(loop, "run_eval", sweep)
    cfg = get_preset("tiny_test")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, eval_every_iters=1, checkpoint_every_iters=1000,
        eval_simulations=8, max_anchor_rollouts=200))
    loop.train(cfg, str(tmp_path), 2, device="cpu",
               logger=MetricsLogger(str(tmp_path), quiet=True,
                                    tensorboard=False))
    assert (tmp_path / "best_model" / "model.msgpack").exists()
    rows = records(str(tmp_path))
    assert "best" in [r["kind"] for r in rows]
    eb = [r for r in rows if r["kind"] == "eval_best"]
    assert len(eb) == 1 and eb[0]["games"] == 4
    assert 0.0 <= eb[0]["score"] <= 1.0 and eb[0]["best_iteration"] == 1
    iters = [r for r in rows if r["kind"] == "iter"]
    assert all("lr_at_floor" in r for r in iters)
    assert all(r.get("lr_at_ceiling") in (0.0, 1.0) for r in iters)


def test_resume_recomputes_legacy_elo(tmp_path, monkeypatch):
    """A sidecar history entry rated under the old fixed 1e-3 clamp (a
    32-game sweep at level 0: +1200) is re-rated at its sample
    resolution (+720) on resume, so a sweep one level up (215 + 720)
    promotes instead of stalling below the stale +1200."""
    cfg = small(get_preset("tiny_test"), eval_every_iters=0,
                checkpoint_every_iters=1)
    wd = str(tmp_path)
    loop.train(cfg, wd, 1, logger=quiet(), device="cpu")
    legacy = LadderState(level=1, history=[{
        "step": 0, "level": 0, "anchor_rollouts": 200, "games": 32,
        "wins": 32, "losses": 0, "draws": 0, "score": 1.0,
        "elo": 1200.0}])
    loop._write_ladder_sidecar(wd, 1, legacy)

    def sweep(cfg, carry, ladder, it, log, device):
        result = {"score": 1.0, "games": 32, "wins": 32, "losses": 0,
                  "draws": 0}
        return update_ladder(ladder, result, it)

    monkeypatch.setattr(loop, "run_eval", sweep)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                eval_every_iters=1))
    log = MetricsLogger(wd, quiet=True, tensorboard=False)
    _, ladder = loop.train(cfg, wd, 2, resume=True, logger=log,
                           device="cpu")
    assert ladder.history[0]["elo"] == pytest.approx(
        -400 * np.log10(1 / (1 - 1 / 64) - 1))
    assert ladder.history[1]["elo"] > ladder.history[0]["elo"]
    assert [r["kind"] for r in records(wd)][-1] == "best"


def test_run_eval_keeps_the_carry_stream(tmp_path):
    """A real ladder eval: the JAX record's keys, the ladder updated, and
    the carry's generator untouched (each eval draws from its own)."""
    cfg = get_preset("tiny_test")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_games=2))
    carry, _ = loop.train(cfg, None, 1, logger=quiet(), device="cpu")
    before = carry.generator.get_state().clone()
    ladder = LadderState(base_rollouts=8)   # a cheap anchor
    log = MetricsLogger(str(tmp_path), quiet=True, tensorboard=False)
    elo = loop.run_eval(cfg, carry, ladder, 0, log, "cpu")
    assert torch.equal(carry.generator.get_state(), before)
    (rec,) = records(str(tmp_path))
    assert set(rec) == {"t", "kind", "iter", "games", "wins", "losses",
                        "draws", "score", "elo", "anchor_rollouts", "level"}
    assert rec["games"] == 2 and rec["elo"] == elo == ladder.history[0]["elo"]


def test_train_init_from_transfer(tmp_path):
    """init_from warm-starts a fresh run by surgery: after one iteration
    the stem's first 8 filters are still the source model's (twin of
    the JAX test), and the run logs transfer_init."""
    src_cfg = get_preset("tiny_test").replace(
        env=EnvConfig(board_size=4, n_in_row=4),
        net=NetConfig(blocks=1, channels=8, value_hidden=16,
                      compute_dtype="float32"))
    params, stats = init_params(src_cfg.env, src_cfg.net, seed=11)
    src = str(tmp_path / "src_model")
    ckpt.export_model(src, params, stats, src_cfg)
    wd = str(tmp_path / "run")
    carry, _ = loop.train(get_preset("tiny_test"), wd, 1, init_from=src,
                          device="cpu",
                          logger=MetricsLogger(wd, quiet=True,
                                               tensorboard=False))
    got = carry.train_state.net.to_flax()[0]["stem_conv"]["kernel"]
    want = params["stem_conv"]["kernel"]
    assert np.abs(got[..., :8] - want).mean() < 0.5 * np.abs(want).mean()
    assert [r["kind"] for r in records(wd)][0] == "transfer_init"


def test_profile_iters_writes_a_trace(tmp_path):
    cfg = small(get_preset("tiny_test"), eval_every_iters=0,
                checkpoint_every_iters=1000)
    wd = str(tmp_path)
    loop.train(cfg, wd, 4, profile_iters=1, device="cpu",
               logger=MetricsLogger(wd, quiet=True, tensorboard=False))
    assert os.path.getsize(f"{wd}/profile/trace.json") > 0
    kinds = [(r["kind"], r.get("iter")) for r in records(wd)]
    assert kinds.index(("profile", None)) == kinds.index(("iter", 2)) + 1
    # the program's spans ran for the profiled iteration: af. ranges in
    # the trace, their times and the counters in a trace record
    with open(f"{wd}/profile/trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"af.iteration", "af.selfplay", "af.ply", "af.search",
            "af.descent", "af.learner_phase", "af.train_step"} <= names
    (rec,) = [r for r in records(wd) if r["kind"] == "trace"]
    assert kinds.index(("trace", None)) == kinds.index(("profile", None)) + 1
    assert rec["spans"]["iteration"]["calls"] == 1
    assert rec["counters"]["syncs.iteration_metrics"] == 1
    assert trace.span("x") is trace.span("y")   # off again after it
