"""The port's spans and counters (``alphafive_tpu_torch/utils/trace.py``):
off by default with the counters still counting, self and wait times,
where the search, the actor and the iteration put their spans, results
bit-identical with spans on and off, and the spans on the profiler's
clock."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from alphafive_tpu_torch.config import (EnvConfig, MCTSConfig, NetConfig,
                                        get_preset)
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import gumbel, search, search_capped
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.resnet import init_params
from alphafive_tpu_torch import parallel
from alphafive_tpu_torch.train import actor
from alphafive_tpu_torch.utils import trace

ENV = EnvConfig(board_size=7, n_in_row=4)
NET = NetConfig(blocks=1, channels=16, value_hidden=16,
                compute_dtype="float32")
CAPPED = MCTSConfig(num_simulations=32, leaf_batch=4, branch_cap=8,
                    max_depth=8, value_dtype="int16")
PASS_SPANS = ("descent", "leaf_env_step", "leaf_forward", "expand", "backup")
# the searches every traced path runs: capped (with deferred backup too),
# full width, and the Gumbel root over each tree
SEARCHES = {
    "capped": CAPPED,
    "capped_deferred": dataclasses.replace(CAPPED, backup_interval=2),
    "full_width": MCTSConfig(num_simulations=16, leaf_batch=2),
    "gumbel_capped": dataclasses.replace(CAPPED, root_selection="gumbel",
                                         gumbel_m=4),
    "gumbel_full_width": MCTSConfig(num_simulations=8,
                                    root_selection="gumbel", gumbel_m=4),
}


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def evaluator(seed: int = 0):
    params, stats = init_params(ENV, NET, seed)
    return net_evaluator(ENV, NET, params, stats, "cpu")


def opened(envs: int = 3, moves: int = 3) -> vector.EnvState:
    """`envs` boards a few moves in, each on its own cells."""
    st = vector.init(ENV, envs, "cpu")
    for k in range(moves):
        st = vector.step(ENV, st, torch.arange(envs, dtype=torch.int32)
                         * 7 + 3 * k + 1)
    return st


def run_search(name: str, evaluate, st):
    cfg = SEARCHES[name]
    gen = torch.Generator().manual_seed(5)
    if cfg.root_selection == "gumbel":
        return gumbel.run_gumbel_mcts(ENV, cfg, evaluate, st, gen)
    return search.run_mcts(ENV, cfg, evaluate, st, gen)


def test_off_records_no_span_and_counters_count():
    evaluate, st = evaluator(), opened()
    with trace.span("outer"):
        assert trace.read_bool("site", torch.tensor(True))
    run_search("capped", evaluate, st)
    snap = trace.snapshot()
    c = snap["counters"]
    assert snap["spans"] == {}
    assert c["syncs.site"] == 1 and c["passes"] == 8
    assert c["leaves"] == 8 * 3 * 4 and c["backup_scatters"] == 8
    assert c["syncs.descent_drain"] == 8
    assert c["syncs.descent_step"] == c["wavefront_steps"] > 0
    assert "expanded" not in c            # device counters only while on
    assert trace.span("x") is trace.span("y")   # one shared no-op


def test_self_and_wait_times_of_nested_spans():
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.01)
        with trace.span("inner"):
            time.sleep(0.01)
            trace.read_int("site", torch.tensor(3))
        with trace.span("inner"):
            pass
    spans = trace.snapshot()["spans"]
    outer, inner = spans["outer"], spans["inner"]
    sync = spans["sync.site"]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert sync["calls"] == 1 and sync["self_s"] == sync["total_s"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert inner["self_s"] == pytest.approx(
        inner["total_s"] - sync["total_s"], abs=1e-9)
    assert outer["wait_s"] == inner["wait_s"] == sync["total_s"]
    assert outer["self_s"] >= 0.009 and inner["total_s"] >= 0.01
    assert trace.snapshot()["counters"]["syncs.site"] == 1


@pytest.mark.parametrize("interval", [1, 2])
def test_capped_search_spans_and_counters(interval, monkeypatch):
    """One descent, leaf env step, leaf forward, expand and backup a pass,
    each a child of the search; a sync read per wavefront step and one
    draining read a pass; the device counter of expansions equal to the
    child links the search wrote."""
    trees = []
    init = search_capped._capped_tree_init

    def keep(*args):
        trees.append(init(*args))
        return trees[-1]

    monkeypatch.setattr(search_capped, "_capped_tree_init", keep)
    cfg = dataclasses.replace(CAPPED, backup_interval=interval)
    e, passes = 3, 8
    trace.enable()
    search.run_mcts(ENV, cfg, evaluator(), opened(e),
                    torch.Generator().manual_seed(1))
    snap = trace.snapshot()
    spans, c = snap["spans"], snap["counters"]
    records = list(trace._spans)
    names = [r[0] for r in records]
    parent = lambda r: names[r[3]] if r[3] >= 0 else None
    assert spans["search"]["calls"] == spans["root_forward"]["calls"] == 1
    for name in PASS_SPANS:
        assert spans[name]["calls"] == passes, name
    for r in records:
        want = {"search": None, "root_forward": "search",
                "sync.descent_drain": "descent",
                "sync.descent_step": "descent",
                "features": ("root_forward", "leaf_forward"),
                "stem": ("root_forward", "leaf_forward"),
                "heads": ("root_forward", "leaf_forward")}.get(r[0],
                                                               "search")
        assert parent(r) in (want if isinstance(want, tuple) else (want,)), r
    assert c["passes"] == c["syncs.descent_drain"] == passes
    assert c["syncs.descent_step"] == c["wavefront_steps"]
    assert c["leaves"] == passes * e * cfg.leaf_batch
    assert c["backup_scatters"] == (passes if interval == 1 else passes // 2)
    (tree,) = trees
    assert c["expanded"] == int((tree.child >= 0).sum())
    assert 0 < c["expanded"] <= c["leaves"]


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_results_bit_identical_with_spans_on(name):
    evaluate, st = evaluator(), opened()
    off = run_search(name, evaluate, st)
    trace.enable()
    on = run_search(name, evaluate, st)
    assert trace.snapshot()["spans"]["search"]["calls"] == 1
    for field, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, field)


def tiny_iteration_cfg():
    """tiny_test as train_lowsim_15x15 runs: a Gumbel root, the fused net,
    the KL stop on, the learner from the second iteration."""
    cfg = get_preset("tiny_test")
    return cfg.replace(
        net=dataclasses.replace(cfg.net, use_pallas=True),
        mcts=dataclasses.replace(cfg.mcts, num_simulations=4,
                                 root_selection="gumbel", gumbel_m=4,
                                 max_depth=4),
        train=dataclasses.replace(cfg.train, selfplay_plies_per_iter=3,
                                  learner_steps_per_iter=2,
                                  kl_stop_factor=4.0),
        replay=dataclasses.replace(cfg.replay, min_fill=8, batch_size=8))


def run_iterations(on: bool, n: int = 3):
    cfg = tiny_iteration_cfg()
    carry = parallel.init_carry(cfg, "cpu", seed=3)
    it = parallel.make_train_iteration(cfg)
    if on:
        trace.enable()
    out = [it(carry)[1] for _ in range(n)]
    trace.disable()
    return carry, out


def test_iteration_bit_identical_with_spans_on():
    a, ma = run_iterations(False)
    trace.reset()
    b, mb = run_iterations(True)
    assert ma == mb and ma[-1]["updated"] == 1.0
    snap = trace.snapshot()
    spans, c = snap["spans"], snap["counters"]
    for name in ("iteration", "selfplay", "resolve_chunk", "ring_write",
                 "learner_phase", "sample", "train_step", "kl_probe", "ply",
                 "search", "env_step"):
        assert spans[name]["calls"] > 0, name
    # the first iteration has no learner step and no ring write to read
    assert c["syncs.iteration_metrics"] == 2 and c["syncs.kl_probe"] > 0
    tensors = lambda x: {f.name: getattr(x, f.name)
                         for f in dataclasses.fields(x)}
    for part in ("env_state", "buffer", "pending"):
        for k, v in tensors(getattr(a, part)).items():
            w = tensors(getattr(b, part))[k]
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else v == w), (part, k)
    for (k, v), (_, w) in zip(a.train_state.net.state_dict().items(),
                              b.train_state.net.state_dict().items()):
        assert torch.equal(v, w), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_spans_share_the_profilers_clock():
    """Under a CPU torch.profiler each span is an ``af.`` range whose
    start and end lie within 1 ms of the span's own."""
    from torch.profiler import ProfilerActivity, profile
    evaluate, st = evaluator(), opened()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("start-up"):
            pass   # the profiler's first range pays its start-up
        run_search("capped", evaluate, st)
    trace.disable()
    ranges = sorted((ev.start_ns(), ev.end_ns(), ev.name()[3:])
                    for ev in prof.profiler.kineto_results.events()
                    if ev.is_user_annotation()
                    and ev.name().startswith("af."))
    spans = sorted((s, e, name) for name, s, e, _ in trace._spans)
    assert len(ranges) == len(spans) > 0
    for (rs, re_, rname), (s, e, name) in zip(ranges, spans):
        assert rname == name
        assert abs(rs - s) < 1e6 and abs(re_ - e) < 1e6, name


def test_ply_spans_cover_the_hosts_time():
    """In a self-play ply the search and the env step hold the host's
    time: the ply keeps at most a tenth of it as self time."""
    evaluate, st = evaluator(), opened(4, 1)
    gen = torch.Generator().manual_seed(2)
    actor.selfplay_chunk(ENV, CAPPED, evaluate, st, gen, 1)   # warm-up
    trace.reset()
    trace.enable()
    actor.selfplay_chunk(ENV, CAPPED, evaluate, st, gen, 2)
    spans = trace.snapshot()["spans"]
    ply = spans["ply"]
    assert ply["calls"] == 2 and spans["env_step"]["calls"] == 2
    assert spans["search"]["calls"] == 2
    assert ply["self_s"] <= 0.1 * ply["total_s"]
    assert trace.snapshot()["counters"]["syncs.selfplay_stats"] == 5


@pytest.mark.parametrize("module,name,counters,want", [
    ("resblock", "resblock_launches", {"resblock_launches": 3}, 3),
    ("resblock", "pack_launches", {"pack_launches": 2}, 2),
    ("resblock", "variant_launches", {"variant_launches.split": 4},
     {"streaming": 0, "resident": 0, "tiled": 0, "general": 0, "split": 4}),
    ("select", "select_launches", {"select_launches": 5}, 5),
    ("search_capped", "backup_scatters", {"backup_scatters": 6}, 6),
])
def test_old_counter_attributes_read_the_registry(module, name, counters,
                                                  want):
    """The five counters that were module globals read as module
    attributes still (the benchmark's `counters()` reads them so), each a
    view of the registry."""
    from alphafive_tpu_torch.ops import resblock, select
    mod = {"resblock": resblock, "select": select,
           "search_capped": search_capped}[module]
    zero = dict.fromkeys(want, 0) if isinstance(want, dict) else 0
    assert getattr(mod, name) == zero
    for k, n in counters.items():
        trace.count(k, n)
    assert getattr(mod, name) == want
    trace.reset()
    assert getattr(mod, name) == zero
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_counter")
