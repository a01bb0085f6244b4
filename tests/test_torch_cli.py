"""The port's CLI: eval through the packed search, console play with
scripted stdin, bench, and the bundled-model resolution, against the JAX
CLI's surface."""

import builtins
import dataclasses
import json
import os

import pytest
import torch

from alphafive_tpu import cli as jcli
from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu_torch import cli
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.ops import select as ps

torch.set_num_threads(1)

# the keys `python -m alphafive_tpu.cli eval` prints (cli.py::_cmd_eval)
JAX_EVAL_KEYS = {"games", "wins", "losses", "draws", "score",
                 "anchor_rollouts", "elo_vs_anchor"}
PACKED = ["--set", "mcts.select_impl=pallas", "--set", "mcts.branch_cap=none",
          "--set", "mcts.leaf_batch=1"]


def test_eval_through_the_packed_search(capsys):
    rc = cli.main(["eval", "--preset", "tiny_test", "--device", "cpu",
                   "--games", "2", "--anchor-rollouts", "8", *PACKED])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and set(out) == JAX_EVAL_KEYS
    assert out["games"] == out["wins"] + out["losses"] + out["draws"] == 2
    assert out["anchor_rollouts"] == 8
    assert ps.select_launches == 0  # the plain descent on CPU tensors


def test_play_pure_opponent_scripted(monkeypatch, capsys):
    """Console play vs the rollout MCTS: an invalid move, two moves, then
    EOF (the clean-exit path)."""
    moves = iter(["9 9", "2 2", "1 1"])

    def fake_input(prompt=""):
        try:
            return next(moves)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)
    rc = cli.main(["play", "--preset", "tiny_test", "--device", "cpu",
                   "--opponent", "pure", "--sims", "8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "invalid move" in out and "AI plays" in out and "bye" in out


def test_play_gumbel_root_scripted(monkeypatch, capsys):
    """Console play against the Gumbel root (a fresh tiny_test net): the
    AI plays its halving winner at g = 0 and prints the root value."""
    moves = iter(["2 2", "0 0"])

    def fake_input(prompt=""):
        try:
            return next(moves)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)
    rc = cli.main(["play", "--preset", "tiny_test", "--device", "cpu",
                   "--set", "mcts.root_selection=gumbel"])
    out = capsys.readouterr().out
    ai = [line for line in out.splitlines() if line.startswith("AI plays")]
    assert rc == 0 and len(ai) == 2 and "bye" in out
    assert all("(value " in line for line in ai)
    assert "(2, 2)" not in "".join(ai) and "(0, 0)" not in "".join(ai)


def test_bench_selfplay_and_unported_commands(capsys):
    rc = cli.main(["bench", "--preset", "tiny_test", "--device", "cpu",
                   "--plies", "1", "--set", "train.num_envs=2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["device"] == "cpu" and out["sims_per_s"] > 0
    for argv in (["train"], ["export", "--out", "x"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main([*argv, "--preset", "tiny_test", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main(["eval", "--preset", "tiny_test"])


# the keys `python -m alphafive_tpu.cli bench --mode iteration` prints
# (benchmarks/selfplay_bench.py::run_iteration)
JAX_ITERATION_KEYS = {"preset", "mode", "board", "num_envs",
                      "num_simulations", "plies", "learner_steps", "chips",
                      "seconds", "compile_seconds", "env_steps_per_s",
                      "env_steps_per_s_per_chip", "sims_per_s", "updated"}


def test_bench_iteration(capsys):
    """`bench --mode iteration` runs the actor-learner iteration: the JAX
    CLI's keys plus impl and device; tiny_test's ring passes min_fill
    from the second iteration on, so the timed ones update. Refused
    without CUDA unless --device cpu."""
    rc = cli.main(["bench", "--mode", "iteration", "--preset", "tiny_test",
                   "--device", "cpu", "--set",
                   "train.selfplay_plies_per_iter=9"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and set(out) == JAX_ITERATION_KEYS | {"impl", "device"}
    assert (out["mode"], out["device"], out["chips"]) == ("iteration", "cpu",
                                                          1)
    assert out["updated"] == 1.0 and out["plies"] == 9
    assert out["env_steps_per_s"] == pytest.approx(4 * 9 / out["seconds"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main(["bench", "--mode", "iteration", "--preset",
                      "tiny_test"])


def test_pretrained_dir_matches_jax():
    """15×15 resolves to the strength-ranked `15x15_lowsim`, 19×19 to
    `19x19_10b`, 9×9 to its plain dir, an unshipped board to None — the
    JAX CLI's choices, from the same directory."""
    for name in ("train_15x15", "train_19x19", "train_9x9", "tiny_test"):
        got, want = (cli._pretrained_dir(get_preset(name)),
                     jcli._pretrained_dir(j_get_preset(name)))
        assert got == want, name
    assert os.path.basename(cli._pretrained_dir(
        get_preset("chip_15x15"))) == "15x15_lowsim"


def test_load_model(tmp_path):
    cfg = get_preset("train_9x9")
    bundle = cli._pretrained_dir(cfg)
    params, _, net_cfg = cli._load_model(cfg, bundle)   # an export dir
    assert net_cfg.channels == params["stem_conv"]["kernel"].shape[-1]
    # no workdir: the bundled model for the board
    assert cli._load_model(cfg, None)[2] == net_cfg
    # an empty workdir: a fresh net from the preset, never the bundle
    fresh = cli._load_model(cfg, str(tmp_path))
    assert fresh[2] == cfg.net
    (tmp_path / "ckpt" / "100").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        cli._load_model(cfg, str(tmp_path))
    wrong = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env,
                                                             board_size=15))
    with pytest.raises(ValueError, match="board"):
        cli._load_model(wrong, bundle)
