"""The architecture seam: ``archs/resnet.py`` gives every number the
harness read before the seam (weights, FLOPs, the residual blocks'
bounds, the learner's trees), and a configuration naming another
architecture gets the reference net, weights, FLOPs, bounds and spans
from that architecture's file alone."""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, cell_limits, tiny
from perfbench import generator, harness, yardstick

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = {c["name"]: generator.load_json(os.path.join(ROOT, c["file"]))
           for c in BENCH["configs"]}
SMALL = {"env": {"board_size": 9, "n_in_row": 5, "rules": "freestyle"},
         "net": {"blocks": 2, "channels": 16, "value_hidden": 16,
                 "compute_dtype": "bfloat16"}}


def old_random_weights(env, net, seed):
    """``generator.random_weights`` as it was before the seam."""
    rng = np.random.default_rng(seed)
    c, a, hid = net["channels"], env["board_size"] ** 2, net["value_hidden"]
    f32 = np.float32

    def conv(k, cin, cout):
        return {"kernel": (rng.standard_normal((k, k, cin, cout))
                           * (2.0 / (k * k * cin)) ** 0.5).astype(f32)}

    def dense(cin, cout):
        return {"kernel": (rng.standard_normal((cin, cout))
                           * cin ** -0.5).astype(f32),
                "bias": (0.1 * rng.standard_normal(cout)).astype(f32)}

    def bn(n):
        return ({"scale": (1 + 0.1 * rng.standard_normal(n)).astype(f32),
                 "bias": (0.1 * rng.standard_normal(n)).astype(f32)},
                {"mean": (0.1 * rng.standard_normal(n)).astype(f32),
                 "var": (1 + 0.2 * rng.random(n)).astype(f32)})

    params, stats = {"stem_conv": conv(3, 4, c)}, {}
    params["stem_bn"], stats["stem_bn"] = bn(c)
    for i in range(net["blocks"]):
        p, s = {}, {}
        p["conv1"], p["conv2"] = conv(3, c, c), conv(3, c, c)
        (p["bn1"], s["bn1"]), (p["bn2"], s["bn2"]) = bn(c), bn(c)
        params[f"block{i}"], stats[f"block{i}"] = p, s
    params["policy_conv"] = conv(1, c, 2)
    params["policy_bn"], stats["policy_bn"] = bn(2)
    params["policy_fc"] = dense(2 * a, a)
    params["value_conv"] = conv(1, c, 1)
    params["value_bn"], stats["value_bn"] = bn(1)
    params["value_fc1"], params["value_fc2"] = dense(a, hid), dense(hid, 1)
    return params, stats


def old_flax_name(torch_name):
    """``checks.flax_name`` as it was before the seam."""
    parts = torch_name.split(".")
    if parts[0] == "blocks":
        j = int(parts[2]) + 1
        conv, bn, rest = (f"block{parts[1]}/conv{j}", f"block{parts[1]}/bn{j}",
                          parts[3:])
    elif parts[0] in ("stem", "policy", "value") and parts[1] in ("conv",
                                                                  "bn"):
        conv, bn, rest = f"{parts[0]}_conv", f"{parts[0]}_bn", parts[1:]
    else:
        return f"{parts[0]}/{'kernel' if parts[1] == 'weight' else 'bias'}"
    if rest[0] == "conv":
        return f"{conv}/kernel"
    return f"{bn}/{'scale' if rest[1] == 'weight' else 'bias'}"


def old_net_trees(net):
    """``checks.net_trees`` as it was before the seam."""
    params, stats = {}, {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    with torch.no_grad():
        for name, v in net.named_parameters():
            path = old_flax_name(name).split("/")
            t = v.detach().float().clone()
            if path[-1] == "kernel":
                t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()
            put(params, path, t.contiguous())
        for name, v in net.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("running_mean", "running_var"):
                path = old_flax_name(name.rsplit(".", 1)[0]
                                     + ".weight").split("/")[:-1]
                put(stats, path + [leaf[len("running_"):]],
                    v.detach().float().clone())
    return params, stats


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_arch_found_by_name():
    """A configuration names its architecture, ``resnet`` where it names
    none; a name with no file under ``archs/`` fails at set-up."""
    doc = dict(SMALL)
    assert generator.Arch(doc).mod.__file__ == os.path.join(
        ROOT, "perfbench", "archs", "resnet.py")
    assert generator.Arch(dict(doc, arch="resnet")).name == "resnet"
    with pytest.raises(FileNotFoundError):
        generator.Arch(dict(doc, arch="no_such_arch"))


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["small"])
@pytest.mark.parametrize("seed", [0, 3])
def test_resnet_weights_are_the_old_draw(config, seed):
    doc = CONFIGS.get(config, SMALL)
    got = generator.Arch(doc).random_weights(seed)
    want = old_random_weights(doc["env"], doc["net"], seed)
    for g, w in zip(got, want):
        g, w = flat(g), flat(w)
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() \
                == w[k].tobytes(), k


@pytest.mark.parametrize("config,flops", [("gomoku15_4x64", 134065028),
                                          ("renju19_10x128", 2133436484)])
def test_resnet_flops_are_the_configurations(config, flops):
    doc = CONFIGS[config]
    assert generator.Arch(doc).flops_per_position() \
        == doc["net_flops_per_position"] == flops


@pytest.mark.parametrize("workload", WORKLOADS)
def test_resnet_bounds_are_the_residual_blocks(workload):
    """``harness.work`` through the seam: the FLOPs and the resblock
    span's bound of each cell's forwards, as computed before it."""
    _, cfg_doc, mix, _, _, _ = harness.cell(BENCH, workload, ROOT)
    cfg = generator.run_config(cfg_doc, mix)
    ctx = types.SimpleNamespace(arch=generator.Arch(cfg_doc), cfg=cfg)
    kind = generator.load_kind(mix["kind"])
    traffic = kind.__new__(kind)
    traffic.ctx, traffic.envs = ctx, cfg.train.num_envs
    n, totals = 7, {"learner_steps": 4}
    got = harness.work(ctx, traffic, n, totals)
    env, net = cfg_doc["env"], cfg_doc["net"]
    bound = 0.0
    for batch, calls in traffic.forward_batches():
        f, b = yardstick.resblock_work(batch, env["board_size"],
                                       net["channels"], net["compute_dtype"])
        bound += n * calls * net["blocks"] * yardstick.bound_s(
            f, b, net["compute_dtype"])
    assert got["bounds_s"] == {"resblock": bound} and bound > 0
    nf = yardstick.net_flops(env["board_size"], net["blocks"],
                             net["channels"], net["value_hidden"])
    rows = totals["learner_steps"] * cfg.replay.batch_size
    assert got["flops"] == n * traffic.positions_per_unit() * nf \
        + 3 * rows * nf


def test_resnet_program_trees_are_the_old_net_trees():
    from alphafive_tpu_torch.config import EnvConfig, NetConfig
    from alphafive_tpu_torch.models.resnet import PolicyValueNet
    torch.manual_seed(5)
    module = PolicyValueNet(EnvConfig(board_size=7),
                            NetConfig(blocks=2, channels=8, value_hidden=8))
    with torch.no_grad():
        for name, v in module.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                v.uniform_(0.5, 1.5)
    arch = generator.Arch(SMALL)
    for got, want in zip(arch.program_trees(module), old_net_trees(module)):
        got, want = flat(got), flat(want)
        assert list(got) == list(want) and len(want) > 10
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for name, _ in module.named_parameters():
        assert arch.leaf_name(name) == old_flax_name(name)


# an architecture as a later change would add it, a file of its own:
# resnet's net under another kernel span, each call noted with the names
# of the functions on the stack
RECORDED = '''"""recorded: resnet's, each call noted."""
import importlib.util
import json
import sys

from perfbench.reference import net as ref_net

_spec = importlib.util.spec_from_file_location("recorded_base", {resnet!r})
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)


def _note(name):
    f, stack = sys._getframe(2), []
    while f is not None:
        stack.append(f.f_code.co_name)
        f = f.f_back
    with open({log!r}, "a") as out:
        out.write(json.dumps([name, stack]) + "\\n")


def random_weights(env, net, seed):
    _note("random_weights")
    return base.random_weights(env, net, seed)


def check_bundle(saved, env, net):
    _note("check_bundle")
    base.check_bundle(saved, env, net)


def features(size, board, to_play, last):
    _note("features")
    return ref_net.features(size, board, to_play, last)


def forward(params, stats, feats, quant=None):
    _note("forward")
    return base.forward(params, stats, feats, quant)


def forward_train(params, feats, quant=None):
    _note("forward_train")
    return base.forward_train(params, feats, quant)


def program_trees(module):
    _note("program_trees")
    return base.program_trees(module)


def leaf_name(name):
    _note("leaf_name")
    return base.leaf_name(name)


def flops_per_position(env, net):
    _note("flops_per_position")
    return base.flops_per_position(env, net)


def kernels(env, net):
    _note("kernels")
    return [("recorded", "alphafive_tpu_torch.ops.resblock:fused_resblock")]


def kernel_work(span, batch, env, net):
    _note("kernel_work")
    assert span == "recorded"
    return base.kernel_work("resblock", batch, env, net)
'''

# (kind, the calls that must come through the architecture: its function,
# and a function of the harness on the stack when it was called)
THROUGH = {
    "selfplay": [("random_weights", "load_weights"),
                 ("kernels", "instrument_search"),
                 ("flops_per_position", "work"), ("kernel_work", "work"),
                 ("kernel_work", "profile_units"),
                 ("forward", "stagger"), ("features", "stagger"),
                 ("forward", "_judge_evals"), ("features", "_judge_evals")],
    "train": [("random_weights", "load_weights"),
              ("kernels", "instrument_search"),
              ("flops_per_position", "work"), ("kernel_work", "work"),
              ("forward", "_judge_evals"), ("forward", "_judge_roots"),
              ("features", "batch_from_rows"),
              ("forward_train", "_judge_learner"),
              ("program_trees", "_weights_key"),
              ("leaf_name", "train_step")],
}


@pytest.mark.parametrize("kind", ["selfplay", "train"])
def test_a_new_architecture_comes_through_the_seam(kind, tmp_path,
                                                   monkeypatch):
    """A small cell whose configuration names an architecture that is one
    new file: its weights, FLOPs, bounds, spans, the reference's
    evaluations, the stagger and the learner's records all come through
    that file."""
    log = tmp_path / "calls.jsonl"
    (tmp_path / "recorded.py").write_text(RECORDED.format(
        resnet=os.path.join(ROOT, "perfbench", "archs", "resnet.py"),
        log=str(log)))
    monkeypatch.setattr(generator, "ARCHS", str(tmp_path))
    cfg_doc, mix = tiny(kind)
    cfg_doc["arch"] = "recorded"
    mix["timed"] = list(mix["timed"]) + ["recorded"]
    res = harness.run(cfg_doc, mix, cell_limits(kind), workload="tiny",
                      seed=2 ** 31 + 29, seconds=3.0,
                      trace=kind == "selfplay", device="cpu", root=ROOT,
                      t_start=time.perf_counter(), metrics=["setup_s"])
    assert res["correct"] is True, res["checks"]
    calls = [json.loads(x) for x in log.read_text().splitlines()]
    for name, via in THROUGH[kind]:
        assert any(n == name and via in st for n, st in calls), (name, via)
    rec = res["run"]
    assert set(rec.work["bounds_s"]) == {"recorded"}
    assert rec.work["bounds_s"]["recorded"] > 0
    if kind == "selfplay":   # traced: the timers on, the profiled units
        assert rec.timers["recorded"] > 0   # the span wrapped the kernel
        assert set(rec.profile["spans"]["bounds_s"]) == {"recorded"}
    else:
        assert res["readings"]["learner_steps_checked"] == 3
