"""The port's CLI: eval through the packed search, console play with
scripted stdin, bench, and the bundled-model resolution, against the JAX
CLI's surface."""

import builtins
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from alphafive_tpu import cli as jcli
from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.train import checkpoint as jckpt
from alphafive_tpu_torch import cli, parallel
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.train import checkpoint as ckpt
from alphafive_tpu_torch.utils import trace
from alphafive_tpu_torch.utils.elo import LadderState

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
    # the plain descent on CPU tensors
    assert trace.snapshot()["counters"].get("select_launches", 0) == 0


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


def test_bench_selfplay_and_unported_commands(capsys, monkeypatch):
    rc = cli.main(["bench", "--preset", "tiny_test", "--device", "cpu",
                   "--plies", "1", "--set", "train.num_envs=2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["device"] == "cpu" and out["sims_per_s"] > 0
    # --multihost joins a process group (tests/test_torch_distributed_cli.py
    # runs two); with no world to join it says how to launch one, and
    # bench times the iteration across ranks, not self-play alone
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    for flags, refusal in ((["--multihost"], "torchrun"),
                           (["--multihost", "--coordinator", "localhost:1"],
                            "--process-id")):
        with pytest.raises(ValueError, match=refusal):
            cli.main(["train", *flags, "--preset", "tiny_test", "--device",
                      "cpu"])
    with pytest.raises(SystemExit, match="--mode iteration"):
        cli.main(["bench", "--multihost", "--preset", "tiny_test",
                  "--device", "cpu"])
    if not torch.cuda.is_available():
        for argv in (["eval"], ["train"], ["export", "--out", "x"]):
            with pytest.raises(SystemExit):
                cli.main([*argv, "--preset", "tiny_test"])


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


def assert_trees_equal(got, want, path=""):
    if isinstance(want, (dict, tuple)):
        items = want.items() if isinstance(want, dict) else enumerate(want)
        assert len(got) == len(want), path
        for k, v in items:
            assert_trees_equal(got[k], v, f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=path)


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
    # a step directory that is not a checkpoint is refused, never skipped
    (tmp_path / "ckpt" / "100").mkdir(parents=True)
    with pytest.raises(ValueError, match="not a checkpoint"):
        cli._load_model(cfg, str(tmp_path))
    # a training checkpoint: restored against its own saved config
    (tmp_path / "ckpt" / "100").rmdir()
    small = cfg.replace(
        net=dataclasses.replace(cfg.net, blocks=1, channels=16),
        train=dataclasses.replace(cfg.train, num_envs=2),
        replay=dataclasses.replace(cfg.replay, capacity=64))
    carry = parallel.init_carry(small, "cpu")
    ckpt.save(ckpt.make_manager(str(tmp_path / "ckpt")), 100, carry, small,
              LadderState())
    params, stats, net_cfg = cli._load_model(cfg, str(tmp_path))
    assert net_cfg == small.net
    assert_trees_equal((params, stats), carry.train_state.net.to_flax())
    wrong = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env,
                                                             board_size=15))
    with pytest.raises(ValueError, match="board"):
        cli._load_model(wrong, bundle)


def test_train_export_and_eval_a_workdir(tmp_path, capsys):
    """`train` on tiny_test writes ckpt/ and metrics.jsonl, `--resume`
    continues it, `export` writes a bundle that JAX's load_model reads
    bit-equal, and `eval --workdir` plays the checkpoint."""
    wd, out = str(tmp_path / "run"), str(tmp_path / "model")
    common = ["--preset", "tiny_test", "--device", "cpu", "--workdir", wd,
              "--set", "train.selfplay_plies_per_iter=6",
              "--set", "replay.min_fill=8", "--set", "replay.batch_size=8"]
    assert cli.main(["train", *common, "--iters", "2"]) == 0
    assert cli.main(["train", *common, "--iters", "3", "--resume"]) == 0
    assert ckpt.make_manager(f"{wd}/ckpt").all_steps() == [2, 3]
    with open(f"{wd}/metrics.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["iter", "iter", "resume", "iter"]
    assert cli.main(["export", "--workdir", wd, "--out", out, "--device",
                     "cpu"]) == 0
    with open(f"{out}/config.json") as f:
        meta = json.load(f)
    assert (meta["iteration"], meta["train_step"]) == (3, 2)
    ts, _ = ckpt.restore_train_state(ckpt.make_manager(f"{wd}/ckpt"),
                                     device="cpu")
    jp, js, _ = jckpt.load_model(out)
    assert_trees_equal((jp, js), ts.net.to_flax())
    capsys.readouterr()
    assert cli.main(["eval", *common[:4], "--workdir", wd, "--games", "2",
                     "--anchor-rollouts", "4", *PACKED]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == JAX_EVAL_KEYS and res["games"] == 2
