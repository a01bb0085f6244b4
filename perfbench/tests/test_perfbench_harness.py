"""The harness finds each piece by name, its yardstick's arithmetic, each
kind of traffic at small sizes on the CPU, and BENCHMARK.json's form."""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import pytest
import torch

from conftest import ROOT, run_tiny
from perfbench import generator, harness, tracing, yardstick
from perfbench.reference import net as ref_net
from perfbench.reference import rules as ref_rules
from perfbench.reference import search as ref_search

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    w, cfg_doc, mix, limits, e2e, layer = harness.cell(BENCH, workload, ROOT)
    kind = generator.load_kind(mix["kind"])
    assert mix["role"] in cfg_doc["roles"]
    assert set(limits) == set(kind.NUMBERS)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    cfg = generator.run_config(cfg_doc, mix)
    assert cfg.env.board_size == cfg_doc["env"]["board_size"]
    assert cfg.net.channels == cfg_doc["net"]["channels"]
    assert cfg.net.use_pallas


@pytest.mark.parametrize("kind", ["selfplay", "play", "train"])
def test_kind_found_by_name(kind):
    """A kind is the class ``Kind`` of ``kinds/<kind>.py``, found by its
    name alone."""
    cls = generator.load_kind(kind)
    assert issubclass(cls, generator.Base) and cls.NUMBERS
    assert {"policy_tv", "rule_faults", "search_faults"} <= set(cls.NUMBERS)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    read = harness.load_metric(metric)
    rec = harness.Run("x", {}, {}, None, setup_s=1.0)
    value = read(rec)   # nothing traced: only setup_s reads a number
    assert (value == 1.0) if metric == "setup_s" else value is None


def test_benchmark_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + METRICS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith("perfbench/")
        assert generator.load_json(os.path.join(ROOT, c["file"]))["reduced"] \
            == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        (moved,) = [x for x in BENCH["end_to_end"] if x["name"] == m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    WORKLOADS))
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("board,blocks,channels,flops", [
    (15, 4, 64, 134.07e6), (19, 10, 128, 2.1334e9)])
def test_net_flops(board, blocks, channels, flops):
    got = yardstick.net_flops(board, blocks, channels, 64)
    assert got == pytest.approx(flops, rel=5e-5)


@pytest.mark.parametrize("config", ["gomoku15_4x64", "renju19_10x128"])
def test_config_flops_match_yardstick(config):
    doc = generator.load_json(os.path.join(ROOT, "perfbench", "configs",
                                         f"{config}.json"))
    env, net = doc["env"], doc["net"]
    assert doc["net_flops_per_position"] == yardstick.net_flops(
        env["board_size"], net["blocks"], net["channels"],
        net["value_hidden"])
    assert generator.Arch(doc).flops_per_position() \
        == doc["net_flops_per_position"]


@pytest.mark.parametrize("batch,board,channels,ms", [
    (2048, 15, 64, 0.0687), (4096, 19, 128, 0.8818), (8, 19, 128, 0.00172)])
def test_resblock_bound(batch, board, channels, ms):
    """The bounds chip_smoke.py prints beside the kernel's rows."""
    f, b = yardstick.resblock_work(batch, board, channels, "bfloat16")
    assert yardstick.bound_s(f, b, "bfloat16") * 1e3 == pytest.approx(
        ms, rel=2e-2)


@pytest.mark.parametrize("kind,rules", [
    ("selfplay", "freestyle"), ("selfplay", "renju"), ("play", "renju"),
    ("train", "freestyle")])
def test_traffic_runs_small(kind, rules):
    # long enough for the ring rows of a training window's second unit
    res = run_tiny(kind, rules=rules, seconds=3.0)
    r = res["readings"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert r["search_faults"] == 0 and r["rule_faults"] == 0
    assert r["judged"]["env_steps"] > 0 and r["evaluations"] > 0
    assert math.isfinite(r["policy_tv"]) and math.isfinite(r["value_gap"])
    assert res["values"]["setup_s"] > 0
    if kind == "train":
        assert r["ring_faults"] == 0 and r["batch_faults"] == 0
        assert r["judged"]["ring_rows"] > 0
        assert r["learner_steps_checked"] == 3


def test_traced_run_small():
    """--trace 1 on the CPU: the profiled sub-window reduces (no device
    events here, so the device readers find nothing)."""
    res = run_tiny("selfplay", trace=True)
    prof = res["run"].profile
    assert prof["window_s"] > 0 and prof["busy_s"] == 0
    assert prof["spans"]["window_s"] > 0
    assert res["run"].timers["descent"] > 0
    rec = res["run"]
    for name in ("mfu.selfplay", "resblock_roofline.selfplay",
                 "device_idle_share.selfplay"):
        assert harness.load_metric(name)(rec) is None
    assert harness.load_metric("descent_ms_per_ply.selfplay")(rec) > 0


def test_device_stretch_small():
    """The device stretch on the CPU: its units after the window, from
    the same positions whatever the seed; no device events here, so
    move_device_ms finds nothing to read."""
    from conftest import tiny
    res = run_tiny("play", rules="renju", stretch=True)
    rec = res["run"]
    assert rec.device["units"] == 2 and rec.device["totals"]["moves"] == 2
    assert rec.device["busy_s"] == 0 and rec.device["window_s"] > 0
    assert harness.load_metric("move_device_ms")(rec) is None
    assert res["correct"] and res["failed"] == 0
    boards = []
    for seed in (5, 2 ** 31 + 7):
        cfg_doc, mix = tiny("play", "renju")
        ctx = harness.Context(cfg_doc, mix, seed, "cpu", ROOT)
        try:
            traffic = ctx.kind(ctx)
            traffic.device_start()
            boards.append(traffic.st.board.clone())
        finally:
            ctx.patches.restore()
    assert torch.equal(boards[0], boards[1]) and boards[0].any()


def test_span_reading_attributes_device_time():
    """Device time goes to the spans open when its launch ran on the
    host; idle gaps to the innermost span open when they began."""
    class Ev:
        def __init__(self, name, dev, s, e, corr, link, ann=False,
                     kind="cpu_op"):
            self.v = (name, dev, s, e, corr, link, ann, kind)

        def name(self): return self.v[0]
        def device_type(self): return self.v[1]
        def start_ns(self): return self.v[2]
        def end_ns(self): return self.v[3]
        def correlation_id(self): return self.v[4]
        def linked_correlation_id(self): return self.v[5]
        def is_user_annotation(self): return self.v[6]

    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    evs = [Ev("pb.window", cpu, 0, 1000, 1, 0, True),
           Ev("pb.resblock", cpu, 100, 200, 2, 0, True),
           Ev("cudaLaunchKernel", cpu, 110, 120, 77, 1,
              kind="cuda_runtime"),
           Ev("pb.descent", cpu, 300, 600, 4, 0, True),
           Ev("aten::add", cpu, 310, 320, 5, 0),
           Ev("kernel_a", cuda, 150, 250, 77, 1, kind="kernel"),
           Ev("kernel_b", cuda, 400, 500, 10, 5, kind="kernel"),
           Ev("pb.descent", cuda, 300, 600, 11, 0, True,
              "gpu_user_annotation")]
    red = tracing.span_reading(evs)
    assert red["window_s"] == pytest.approx(1e-6)
    assert red["span_device_s"]["resblock"] == pytest.approx(100e-9)
    assert red["span_device_s"]["descent"] == pytest.approx(100e-9)
    assert red["span_device_s"]["window"] == pytest.approx(200e-9)
    gaps = dict(red["idle_gaps"])
    assert gaps["window"] == pytest.approx(300e-9)    # 0-150, 250-400
    assert gaps["descent"] == pytest.approx(500e-9)   # 500-1000
    dev = tracing.device_reading(evs)
    assert dev["busy_s"] == pytest.approx(200e-9)
    assert dev["device_events"] == 2


@pytest.mark.parametrize("size,rules", [(7, "freestyle"), (9, "renju")])
def test_reference_agrees_across_blocks(size, rules):
    """The reference gives the same answers whatever its block of rows."""
    cfg = {"board_size": size, "n_in_row": 5, "rules": rules}
    arch = generator.Arch({"env": cfg, "net": {
        "blocks": 2, "channels": 16, "value_hidden": 16}})
    params, stats = arch.random_weights(3)
    p, s = (ref_net.tree_to_torch(t, "cpu") for t in (params, stats))
    g = torch.Generator().manual_seed(5)
    n, a = 37, size * size
    board = torch.randint(-1, 2, (n, a), generator=g).to(torch.int8)
    to_play = (torch.randint(0, 2, (n,), generator=g) * 2 - 1).to(torch.int8)
    last = torch.randint(-1, a, (n,), generator=g).to(torch.int32)
    one = arch.evaluate(p, s, size, board, to_play, last, block=n)
    for block in (1, 5, 16):
        many = arch.evaluate(p, s, size, board, to_play, last, block=block)
        for x, y in zip(one, many):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def _search_setup(rules: str, overrides, roots: int = 5):
    """(config, the reference net as both sides call it, staggered roots
    on a 9×9 board, a seeded generator)."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.env import vector
    size = 9
    env = {"board_size": size, "n_in_row": 5, "rules": rules}
    params, stats = generator.Arch({"env": env, "net": {
        "blocks": 2, "channels": 16, "value_hidden": 16}}).random_weights(7)
    p, s = (ref_net.tree_to_torch(t, "cpu") for t in (params, stats))

    def t_eval(board, to_play, last):
        return ref_net.forward(p, s, ref_net.features(size, board, to_play,
                                                      last))

    def n_eval(board, to_play, last):
        lg, v = t_eval(*(torch.from_numpy(np.ascontiguousarray(x))
                         for x in (board, to_play, last)))
        return lg.numpy(), v.numpy()
    cfg = apply_overrides(get_preset(overrides[0]), [
        f"env.board_size={size}", f"env.rules={rules}"] + overrides[1:])
    g = torch.Generator().manual_seed(3)
    st = vector.init(cfg.env, roots, "cpu")
    for k in range(14):
        a = torch.multinomial((st.board == 0).float(), 1, generator=g)
        nxt = vector.step(cfg.env, st, a[:, 0].int())
        st = st if bool(nxt.done.any()) else nxt
    games = [ref_rules.Game(st.board[i].numpy().copy(), int(st.to_play[i]),
                            int(st.last_move[i]), int(st.move_count[i]),
                            False, 0) for i in range(roots)]
    return cfg, t_eval, n_eval, st, games, g


@pytest.mark.parametrize("kind,rules,sets", [
    ("selfplay", "freestyle", []),
    ("selfplay", "renju", ["mcts.forced_playouts_k=2.0"]),
    ("selfplay", "freestyle", ["mcts.backup_interval=2"]),
    ("play", "renju", ["mcts.leaf_batch=4"])])
def test_followed_search_has_no_faults(kind, rules, sets):
    """The reference's step-by-step account of the program's capped
    search finds no fault in a sound run (forced playouts and deferred
    backup too)."""
    res = run_tiny(kind, rules=rules, sets=sets, seconds=3.0)
    assert res["readings"]["judged"]["roots"] >= 2
    assert res["readings"]["descent_faults"] == 0


@pytest.mark.parametrize("rules", ["freestyle", "renju"])
def test_reference_gumbel_root_follows_the_program(rules):
    from alphafive_tpu_torch.mcts import gumbel
    cfg, t_eval, n_eval, st, games, g = _search_setup(
        rules, ["train_lowsim_15x15"])
    draw = -torch.log(-torch.log(torch.rand(st.board.shape, generator=g)
                                 .clamp(min=1e-30)))
    res = gumbel.run_gumbel_mcts(cfg.env, cfg.mcts, t_eval, st, g,
                                 add_noise=True, gumbel=draw)
    pi, action = ref_search.gumbel_root(games, draw.numpy(), n_eval,
                                        ref_search.gumbel_config(cfg.env,
                                                                 cfg.mcts))
    np.testing.assert_allclose(res.pi_target.numpy(), pi, atol=1e-6)
    np.testing.assert_array_equal(res.action.numpy(), action)


def test_selfplay_envs_are_staggered():
    """Every seed deals the same depths, in its own order; each env
    plays its depth, or stops a move short of a game's end."""
    from alphafive_tpu_torch.env import vector
    from conftest import tiny
    cfg_doc, mix = tiny("selfplay")
    selfplay = generator.load_kind("selfplay")
    dealt = []
    for seed in (2 ** 31 + 5, 2 ** 31 + 6):
        ctx = harness.Context(cfg_doc, mix, seed, "cpu", ROOT)
        kind = selfplay.__new__(selfplay)
        kind.ctx, kind.envs, kind.vector = ctx, ctx.cfg.train.num_envs, vector
        want = selfplay.depths(kind.envs, mix["stagger_plies"], seed)
        st = kind.stagger(vector.init(ctx.cfg.env, kind.envs, "cpu"))
        assert not bool(st.done.any())
        assert (st.move_count.long() <= want).all()
        assert int((st.move_count.long() == want).sum()) >= kind.envs - 1
        dealt.append(sorted(want.tolist()))
    assert dealt[0] == dealt[1] == sorted(
        (i * mix["stagger_plies"]) // len(dealt[0])
        for i in range(len(dealt[0])))
