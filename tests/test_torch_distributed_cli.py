"""Multi-process training end to end on the CPU: ``cli train --multihost``
as two processes with explicit coordinator flags (checkpoint shards, a
resume, metrics from rank 0 alone, a refused resume at another world
size, ``cli export`` of the result), and the loop's eval gate across two
ranks (twins of ``tests/test_distributed.py``'s two-process cluster)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_distributed_worker as worker
from alphafive_tpu_torch import cli
from alphafive_tpu_torch.config import apply_overrides, get_preset
from alphafive_tpu_torch.train import checkpoint as ckpt
from alphafive_tpu_torch.train import loop
from alphafive_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# tiny_test at short chunks (the loop tests' `small`) over two ranks
SETS = ["train.selfplay_plies_per_iter=6", "replay.min_fill=8",
        "replay.batch_size=8", f"mesh.data={WORLD}",
        "train.checkpoint_every_iters=2", "train.eval_every_iters=0"]
# a process: interpreter, torch, rank 0's TensorBoard import, 3 iterations
PROCESS_TIMEOUT_S = 240


def cli_ranks(tmp_path, tag, *args):
    """`cli train` on tiny_test as WORLD processes with explicit
    coordinator flags; returns their stderr."""
    port = worker.free_port()
    argv = [sys.executable, "-m", "alphafive_tpu_torch.cli", "train",
            "--preset", "tiny_test", "--device", "cpu", "--multihost",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(WORLD), *args]
    for s in SETS:
        argv += ["--set", s]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"{tag}.rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen([*argv, "--process-id", str(r)], cwd=ROOT,
                              env=env, stdout=f, stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=PROCESS_TIMEOUT_S)
    finally:
        for p in procs:
            p.kill()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} ({tag}):\n{out[-3000:]}"
    return outs


def records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [(r["kind"], r.get("iter")) for r in map(json.loads, f)]


def test_cli_train_two_ranks(tmp_path):
    """Two ranks train 3 iterations with a checkpoint at 2 and at the
    end; every step holds model.pt and both shards; metrics.jsonl has
    one iter row an iteration (rank 0 writes it alone); a resume at two
    ranks continues to 4; a resume at one rank raises naming both world
    sizes; `cli export` of the result loads with the checkpoint's
    weights."""
    wd = str(tmp_path / "run")
    outs = cli_ranks(tmp_path, "train", "--workdir", wd, "--iters", "3")
    assert "[iter]" in outs[0] and "[iter]" not in outs[1]
    assert records(wd) == [("iter", 0), ("iter", 1), ("checkpoint", 2),
                           ("iter", 2)]
    mgr = ckpt.make_manager(f"{wd}/ckpt")
    assert mgr.all_steps() == [2, 3]
    shards = ["carry.rank0.pt", "carry.rank1.pt", "meta.json", "model.pt"]
    for step in (2, 3):
        assert sorted(os.listdir(mgr.step_dir(step))) == shards
        with open(os.path.join(mgr.step_dir(step), "meta.json")) as f:
            assert json.load(f)["world"] == WORLD

    cli_ranks(tmp_path, "resume", "--workdir", wd, "--iters", "4",
              "--resume")
    assert records(wd)[4:] == [("resume", 3), ("iter", 3), ("checkpoint", 4)]
    assert mgr.all_steps() == [2, 3, 4]
    assert sorted(os.listdir(mgr.step_dir(4))) == shards
    iters = [json.loads(line) for line in open(f"{wd}/metrics.jsonl")]
    iters = [r for r in iters if r["kind"] == "iter"]
    assert all(r["env_steps"] == 4 * 6 for r in iters)
    assert iters[-1]["updated"] == 1.0 and iters[-1]["step"] > 0

    cfg = apply_overrides(get_preset("tiny_test"),
                          SETS[:-3] + ["train.eval_every_iters=0"])
    with pytest.raises(ValueError, match=r"world of 2 rank\(s\); this run "
                                         r"has a world of 1"):
        loop.train(cfg, wd, 5, resume=True,
                   logger=MetricsLogger(None, quiet=True), device="cpu")

    out = str(tmp_path / "model")
    assert cli.main(["export", "--workdir", wd, "--out", out, "--device",
                     "cpu"]) == 0
    params, stats, saved = ckpt.load_model(out)
    ts, _ = ckpt.restore_train_state(mgr, device="cpu")
    want_p, want_s = ts.net.to_flax()
    got = {**worker.flat_tree(params, "p/"), **worker.flat_tree(stats, "s/")}
    want = {**worker.flat_tree(want_p, "p/"),
            **worker.flat_tree(want_s, "s/")}
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert saved.env == cfg.env


def test_loop_eval_gate_two_ranks(tmp_path):
    """The loop across two ranks with a ladder eval every 2 iterations
    (scripted): rank 0 alone plays the evals; both ranks end with rank
    0's ladder and bit-identical weights; each promotion's save is
    collective (best/ holds model.pt and both shards) and best_model/ is
    exported; metrics.jsonl is rank 0's records alone."""
    cfg = apply_overrides(get_preset("tiny_test"),
                          SETS[:-1] + ["train.eval_every_iters=2"])
    wd = str(tmp_path / "run")
    worker.spawn_ranks(worker.run_loop, (WORLD, worker.free_port(),
                                         cfg.to_json(), wd, 4,
                                         str(tmp_path)), WORLD)
    outs = [dict(np.load(tmp_path / f"out_rank{r}.npz"))
            for r in range(WORLD)]
    assert list(outs[0]["evals"]) == [1, 3] and len(outs[1]["evals"]) == 0
    ladders = [json.loads(str(o["ladder"])) for o in outs]
    assert ladders[0] == ladders[1]
    assert [h["step"] for h in ladders[0]["history"]] == [1, 3]
    for k in outs[0]:
        if k.startswith(("params/", "batch_stats/")):
            assert np.array_equal(outs[0][k], outs[1][k]), k
    assert records(wd) == [
        ("iter", 0), ("iter", 1), ("checkpoint", 2), ("eval", 1),
        ("best", 2), ("iter", 2), ("iter", 3), ("checkpoint", 4),
        ("eval", 3), ("best", 4)]
    best = ckpt.make_manager(f"{wd}/best")
    assert best.all_steps() == [4]
    assert sorted(os.listdir(best.step_dir(4))) == [
        "carry.rank0.pt", "carry.rank1.pt", "meta.json", "model.pt"]
    with open(f"{wd}/best_model/config.json") as f:
        assert json.load(f)["iteration"] == 4
    with open(f"{wd}/ladder.json") as f:
        assert json.load(f)["iter"] == 4
