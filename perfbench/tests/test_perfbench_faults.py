"""A run whose timed path is broken underneath comes out not correct, and
so does the control: the reference computed through float8 in the
program's place. Small sizes on the CPU, each against the limits of the
cell whose traffic it runs; the chip test reads the control at the
cells' own sizes."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, cell_limits, run_tiny


def step_unchanged(monkeypatch):
    """env.vector.step returns the state it was given."""
    from alphafive_tpu_torch.env import vector
    monkeypatch.setattr(vector, "step", lambda cfg, state, action: state)


def half_batch_forward(monkeypatch):
    """The fused net evaluates the first half of its batch; the rest get
    the mean of those outputs."""
    from alphafive_tpu_torch.models.resnet import FusedPolicyValueNet
    real = FusedPolicyValueNet.forward

    def forward(self, feats):
        n = feats.shape[0]
        h = max(1, n // 2)
        logits, value = real(self, feats[:h])
        fill = lambda x: torch.cat(
            [x, x.mean(0, keepdim=True).expand((n - h,) + x.shape[1:])])
        return fill(logits), fill(value)
    monkeypatch.setattr(FusedPolicyValueNet, "forward", forward)


def visits_altered(monkeypatch):
    """The search's answer gains one visit where it is produced."""
    from alphafive_tpu_torch.mcts import gumbel, search

    def alter(fn):
        def run(*args, **kw):
            res = fn(*args, **kw)
            v = res.visits.clone()
            v.scatter_add_(1, v.argmax(-1, keepdim=True),
                           torch.ones_like(v[:, :1]))
            return res._replace(visits=v)
        return run
    monkeypatch.setattr(search, "run_mcts", alter(search.run_mcts))
    monkeypatch.setattr(gumbel, "run_gumbel_mcts",
                        alter(gumbel.run_gumbel_mcts))


def learner_unchanged(monkeypatch):
    """A learner step that returns its state unchanged."""
    from alphafive_tpu_torch.train import learner
    real = learner.train_step

    def train_step(env_cfg, net_cfg, train_cfg, ts, batch, *args, **kw):
        params = [p.detach().clone() for p in ts.net.parameters()]
        st = copy.deepcopy((ts.opt_state.count, ts.opt_state.mu,
                            ts.opt_state.nu))
        ts, aux = real(env_cfg, net_cfg, train_cfg, ts, batch, *args, **kw)
        with torch.no_grad():
            for p, old in zip(ts.net.parameters(), params):
                p.copy_(old)
        ts.opt_state.count, ts.opt_state.mu, ts.opt_state.nu = st
        return ts, aux
    monkeypatch.setattr(learner, "train_step", train_step)


def learner_half_batch(monkeypatch):
    """A learner step on the first half of its batch, the mean taken over
    those rows alone."""
    from alphafive_tpu_torch.train import learner
    real = learner.train_step

    def train_step(env_cfg, net_cfg, train_cfg, ts, batch, *args, **kw):
        half = [t[:t.shape[0] // 2] for t in batch]
        return real(env_cfg, net_cfg, train_cfg, ts, half, *args, **kw)
    monkeypatch.setattr(learner, "train_step", train_step)


def descent_ignores_prior(monkeypatch):
    """The capped descent scores every legal child as if its prior were
    uniform."""
    from alphafive_tpu_torch.mcts import search_capped
    real = search_capped._puct_scores_n

    def scores(nf, w_row, p_row, legal, c_puct):
        flat = legal.float() / legal.sum(-1, keepdim=True).clamp(min=1)
        return real(nf, w_row, flat, legal, c_puct)
    monkeypatch.setattr(search_capped, "_puct_scores_n", scores)


def descent_ignores_value(monkeypatch):
    """The capped descent reads every value sum as 0."""
    from alphafive_tpu_torch.mcts import search_capped
    real = search_capped._puct_scores_n
    monkeypatch.setattr(
        search_capped, "_puct_scores_n",
        lambda nf, w_row, p_row, legal, c_puct: real(
            nf, torch.zeros_like(w_row), p_row, legal, c_puct))


def gumbel_uniform_target(monkeypatch):
    """The Gumbel root's policy target is uniform over the empty
    cells."""
    from alphafive_tpu_torch.mcts import gumbel
    monkeypatch.setattr(
        gumbel, "_pi_target",
        lambda logits, legal, *a, **k: legal.float()
        / legal.sum(-1, keepdim=True).clamp(min=1))


def stale_actor(monkeypatch):
    """The actor keeps the weights folded at its first iteration."""
    from alphafive_tpu_torch.parallel import mesh
    real, first = mesh.net_evaluator, []

    def net_evaluator(*args, **kw):
        if not first:
            first.append(real(*args, **kw))
        return first[0]
    monkeypatch.setattr(mesh, "net_evaluator", net_evaluator)


def sampler_ignores_symmetry(monkeypatch):
    """The learner's batches are built without the symmetries the
    sampler is handed."""
    from alphafive_tpu_torch.replay import buffer
    real = buffer.sample

    def sample(env, buf, batch_size, generator=None, *, idx=None, sym=None):
        return real(env, buf, batch_size, generator, idx=idx,
                    sym=None if sym is None else torch.zeros_like(sym))
    monkeypatch.setattr(buffer, "sample", sample)


# (kind, rules, fault, the numbers of which one at least must fail)
FAULTS = [("selfplay", "freestyle", step_unchanged, ["rule_faults"]),
          ("selfplay", "renju", step_unchanged, ["rule_faults"]),
          ("selfplay", "freestyle", half_batch_forward,
           ["policy_tv", "value_gap"]),
          ("selfplay", "freestyle", visits_altered, ["search_faults"]),
          ("play", "renju", step_unchanged, ["rule_faults"]),
          ("play", "renju", half_batch_forward, ["policy_tv", "value_gap"]),
          ("play", "renju", visits_altered, ["search_faults"]),
          ("train", "freestyle", learner_unchanged, ["change_gap_median"]),
          ("train", "freestyle", learner_unchanged, ["grad_gap"]),
          ("train", "freestyle", learner_half_batch, ["loss_gap"]),
          ("train", "freestyle", half_batch_forward,
           ["policy_tv", "value_gap"]),
          ("train", "freestyle", visits_altered, ["search_faults"]),
          ("selfplay", "freestyle", descent_ignores_prior,
           ["descent_faults"]),
          ("selfplay", "renju", descent_ignores_value, ["descent_faults"]),
          ("play", "renju", descent_ignores_prior, ["descent_faults"]),
          ("play", "renju", descent_ignores_value, ["descent_faults"]),
          ("train", "freestyle", gumbel_uniform_target, ["search_tv"]),
          ("train", "freestyle", stale_actor, ["policy_tv"]),
          ("train", "freestyle", sampler_ignores_symmetry,
           ["batch_faults"])]


@pytest.mark.parametrize(
    "kind,rules,fault,numbers", FAULTS,
    ids=[f"{k}-{r}-{f.__name__}-{n[0]}" for k, r, f, n in FAULTS])
def test_broken_path_is_not_correct(kind, rules, fault, numbers,
                                    monkeypatch):
    fault(monkeypatch)
    res = run_tiny(kind, rules=rules)
    assert res["correct"] is False, res["checks"]
    checks = res["checks"]
    assert any(checks[n]["value"] > checks[n]["limit"] for n in numbers), \
        checks


@pytest.mark.parametrize("kind", ["selfplay", "play", "train"])
def test_sound_small_run_is_correct(kind):
    res = run_tiny(kind, rules="renju" if kind == "play" else "freestyle")
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("kind", ["selfplay", "play", "train"])
def test_control_is_not_correct(kind):
    """The reference through float8 (e4m3) in the program's place fails
    one of the cell's numbers."""
    res = run_tiny(kind, control=True)
    limits = cell_limits(kind)
    control = res["readings"]["control"]
    assert any(v is not None and v > limits[k] for k, v in control.items()
               if k in limits), (control, limits)


@pytest.mark.chip
@pytest.mark.parametrize("workload", [
    "gomoku15_4x64.selfplay400", "renju19_10x128.selfplay400",
    "gomoku15_4x64.gumbel16_train", "renju19_10x128.play400"])
def test_control_at_cell_size(chip, workload):
    """The control at the cell's own size, on three seeds: each fails one
    of the cell's numbers."""
    out = subprocess.run(
        [sys.executable, "perfbench/calibrate.py", "--workload", workload,
         "--seeds", "2147483659,2147483677,2147483693", "--seconds", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(os.path.join(ROOT, "perfbench", "limits",
                           f"{workload}.json")) as f:
        limits = json.load(f)
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert line["correct"], line
        assert any(v is not None and v > limits[k]
                   for k, v in line["control"].items() if k in limits), line
