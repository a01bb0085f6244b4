"""The capped descent's wavefront step (``search_capped._descent_step``),
which CUDA replays as a graph and every other device runs eagerly, and
the tree workspace kept across searches (``_capped_tree_init``).

On the CPU the step runs eagerly, so these tests hold the math that the
graph replays: the step loop against the loop it replaced, over the trees
of real searches (packed and f32 value sums, with and without the Gumbel
search's forced slots and the deferred fold's pending results); steps
after every lane has stopped as no-ops; searches through the kept tree
against searches on a fresh one; and the counters that say which way the
steps ran. ``chip_smoke.py``'s ``descent_graph`` phase holds the graph
against the eager step on the card.
"""

from __future__ import annotations

import collections
import dataclasses

import pytest
import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig, NetConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import gumbel, search, search_capped
from alphafive_tpu_torch.mcts.search import _puct_scores_n
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.resnet import init_params
from alphafive_tpu_torch.utils import trace

torch.set_num_threads(1)

ENV = EnvConfig(board_size=7, n_in_row=4)
NET = NetConfig(blocks=1, channels=16, value_hidden=16,
                compute_dtype="float32")
PACKED = MCTSConfig(num_simulations=48, leaf_batch=8, branch_cap=8,
                    max_depth=12, value_dtype="int16",
                    prior_dtype="bfloat16")
UNPACKED = dataclasses.replace(PACKED, value_dtype="float32",
                               prior_dtype="float32")
SEARCHES = {
    "packed": PACKED,
    "unpacked": UNPACKED,
    "packed_pending": dataclasses.replace(PACKED, backup_interval=2),
    "gumbel_packed": dataclasses.replace(PACKED, root_selection="gumbel",
                                         gumbel_m=8),
    "gumbel_unpacked": dataclasses.replace(UNPACKED, root_selection="gumbel",
                                           gumbel_m=8),
}


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.disable()
    trace.reset()
    yield
    trace.reset()


def evaluator(seed: int = 0):
    params, stats = init_params(ENV, NET, seed)
    return net_evaluator(ENV, NET, params, stats, "cpu")


def opened(envs: int, moves: int, shift: int = 0) -> vector.EnvState:
    """`envs` boards `moves` moves in, each on its own cells."""
    st = vector.init(ENV, envs, "cpu")
    for k in range(moves):
        st = vector.step(ENV, st, (torch.arange(envs, dtype=torch.int32) * 7
                                   + 3 * k + 1 + shift) % 49)
    return st


def run_search(name: str, evaluate, st, seed: int = 5):
    cfg = SEARCHES[name]
    gen = torch.Generator().manual_seed(seed)
    if cfg.root_selection == "gumbel":
        return gumbel.run_gumbel_mcts(ENV, cfg, evaluate, st, gen)
    return search.run_mcts(ENV, cfg, evaluate, st, gen)


def select_lanes_before(stat_a, stat_b, tree_p, tree_child, tree_done,
                        c_puct, depth_limit, w_inv_scale, forced_k,
                        num_slots, packed, lb, forced_slots=None,
                        pending=None):
    """The descent as it was before the step became a function of device
    tensors: a Python int ``k`` and fresh state a pass (the reference)."""
    d = depth_limit
    e = tree_done.shape[0]
    dev = tree_done.device
    eidx = torch.arange(e, device=dev)[:, None]
    lanes = torch.arange(lb, device=dev)
    slot_ar = torch.arange(num_slots, device=dev)
    tri = lanes[:, None] < lanes[None, :]
    cur = torch.zeros((e, lb), dtype=torch.long, device=dev)
    depth = torch.zeros((e, lb), dtype=torch.long, device=dev)
    stopped = torch.zeros((e, lb), dtype=torch.bool, device=dev)
    sel = torch.full((e, lb), -1, dtype=torch.long, device=dev)
    ppas = torch.zeros((e, lb, d), dtype=torch.long, device=dev)
    k = 0
    while not bool(stopped.all()):
        active = (lanes[None, :] <= k) & ~stopped
        revisit = tree_done[eidx, cur] | (depth >= d)
        p_signed = tree_p[eidx, cur].float()
        legal = p_signed >= 0
        if packed:
            row = stat_a[eidx, cur]
            nf_real = (row & 0xFFFF).float()
            w_row = (row >> 16).float() * w_inv_scale
        else:
            nf_real = stat_a[eidx, cur].float()
            w_row = stat_b[eidx, cur].float() * w_inv_scale
        p_row = p_signed.clamp(min=0.0)
        dsel = (k - lanes).clamp(0, d - 1)
        ent = ppas[:, :, dsel]
        match = (tri[None]
                 & (depth[:, :, None] > depth[:, None, :])
                 & ((ent >> 8) == cur[:, None, :]))
        virt = (match[..., None]
                & ((ent & 255)[..., None] == slot_ar)).sum(dim=1).float()
        if pending is not None:
            pp, pw, pdep = pending
            entp = pp[:, :, dsel]
            validp = ((dsel[None, None, :] < pdep[:, :, None])
                      & ((entp >> 8) == cur[:, None, :]))
            hit = validp[..., None] & ((entp & 255)[..., None] == slot_ar)
            nf_real = nf_real + hit.sum(dim=1).float()
            w_row = w_row + torch.where(
                hit, pw[:, :, dsel].float()[..., None], 0.0).sum(dim=1) \
                * w_inv_scale
        nf = nf_real + virt
        score = _puct_scores_n(nf, w_row, p_row, legal, c_puct)
        forced = (legal & (depth == 0)[..., None] & (nf_real > 0)
                  & (nf_real * nf_real
                     < forced_k * p_row * nf_real.sum(dim=-1, keepdim=True)))
        score = torch.where(forced, float("inf"), score)
        s = score.argmax(dim=-1)
        if forced_slots is not None:
            s = torch.where(depth == 0, forced_slots, s)
        ch = tree_child[eidx, cur, s].long()
        stop_now = revisit | (ch < 0)
        rec = active & ~revisit
        ppas[:, lanes, dsel] += torch.where(rec, (cur << 8) | s, 0)
        depth = depth + rec.long()
        sel = torch.where(active & stop_now,
                          torch.where(revisit, -1, s), sel)
        stopped = stopped | (active & stop_now)
        cur = torch.where(active & ~stop_now, ch, cur)
        k += 1
    return cur, sel, depth, ppas, k


def passes_of(name: str, monkeypatch, check):
    """Run two plies of search `name`, calling check(args, out) on every
    pass's descent; returns the passes by (forced slots, pending)."""
    seen = collections.Counter()
    select = search_capped._select_lanes

    def wrapped(*args):
        out = select(*args)
        check(args, out)
        seen[(args[-2] is not None, args[-1] is not None)] += 1
        return out

    monkeypatch.setattr(search_capped, "_select_lanes", wrapped)
    evaluate = evaluator()
    for ply in range(2):
        run_search(name, evaluate, opened(3, 2 + 3 * ply), seed=ply)
    return seen


def expected_kinds(name: str) -> set:
    if name.startswith("gumbel"):
        return {(True, False)}
    if name == "packed_pending":
        return {(False, False), (False, True)}
    return {(False, False)}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_step_loop_matches_the_loop_before(name, monkeypatch):
    """Every pass's descent, through _descent_step, bit-equal to the loop
    it replaced, on the same tree: lanes, slots, depths, paths and the
    step count."""
    steps = []

    def check(args, out):
        *want, k = select_lanes_before(*args)
        for field, a, b in zip(("lps", "slots", "deps", "ppas"), out, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        steps.append(k)

    seen = passes_of(name, monkeypatch, check)
    assert set(seen) == expected_kinds(name)
    assert sum(steps) == trace.counter("wavefront_steps")
    # the trees were deep enough for lanes to meet: more steps than lanes
    assert max(steps) > SEARCHES[name].leaf_batch


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_steps_after_every_lane_stopped_change_nothing(name, monkeypatch):
    """Once every lane has stopped, further steps leave the state as it
    is but for the step index: the property several steps a replay would
    rely on."""
    def check(args, out):
        (stat_a, stat_b, tree_p, tree_child, tree_done, c_puct, d,
         w_inv_scale, forced_k, c, packed, lb, forced, pending) = args
        tree = (stat_a, stat_b, tree_p, tree_child, tree_done)
        scalars = (c_puct, d, w_inv_scale, forced_k, packed)
        s = search_capped._Descent.new(tree_done.shape[0], lb, d, c,
                                       tree_done.device)
        steps = 0
        while not bool(search_capped._descent_step(s, *tree, *scalars,
                                                   forced, pending)):
            steps += 1
        before = {f.name: getattr(s, f.name).clone()
                  for f in dataclasses.fields(s)}
        for extra in range(1, 4):
            assert bool(search_capped._descent_step(s, *tree, *scalars,
                                                    forced, pending))
            for field, value in before.items():
                now = getattr(s, field)
                if field == "k":
                    assert int(now) == steps + 1 + extra
                else:
                    assert torch.equal(now, value), (name, field)
        assert all(torch.equal(a, b) for a, b in zip(
            out, (s.cur, s.sel, s.depth, s.ppas)))

    seen = passes_of(name, monkeypatch, check)
    assert set(seen) == expected_kinds(name)


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_kept_tree_matches_a_fresh_tree(name, monkeypatch):
    """Back-to-back searches of different positions in one shape, with a
    search of another shape between them, through the kept tree: every
    result bit-equal to the same search on a fresh tree, and the kept
    tree's storage the same across the shape's searches."""
    init = search_capped._capped_tree_init
    storage = collections.defaultdict(set)

    def recorded(state, *args):
        tree = init(state, *args)
        storage[state.board.shape[0]].add(tree.n.data_ptr())
        return tree

    monkeypatch.setattr(search_capped, "_capped_tree_init", recorded)
    evaluate = evaluator(1)
    positions = [opened(3, moves, shift) for moves, shift in
                 ((1, 0), (4, 2), (2, 5))]
    search_capped._TREES.clear()
    kept = []
    for i, st in enumerate(positions):
        kept.append(run_search(name, evaluate, st, seed=i))
        run_search(name, evaluate, opened(2, 3), seed=9)   # another shape
    assert len(storage[3]) == 1 and len(storage[2]) == 1
    for i, st in enumerate(positions):
        search_capped._TREES.clear()
        fresh = run_search(name, evaluate, st, seed=i)
        for field, a, b in zip(fresh._fields, kept[i], fresh):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, i, field)


def test_kept_trees_are_bounded():
    """One tree a shape, the least recently used dropped past the bound."""
    search_capped._TREES.clear()
    evaluate = evaluator()
    for envs in range(1, search_capped._MAX_TREES + 3):
        run_search("packed", evaluate, opened(envs, 2))
    assert len(search_capped._TREES) == search_capped._MAX_TREES
    assert sorted(k[1] for k in search_capped._TREES) == list(
        range(3, search_capped._MAX_TREES + 3))


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_cpu_steps_run_eagerly(name):
    """Off CUDA no graph is captured or replayed: every step counted in
    wavefront_steps is an eager one, one host read a step and a drain a
    pass as before."""
    run_search(name, evaluator(), opened(3, 2))
    c = trace.snapshot()["counters"]
    assert c["wavefront_steps"] > 0
    assert c["descent_eager_steps"] == c["wavefront_steps"]
    assert c["syncs.descent_step"] == c["wavefront_steps"]
    assert c["syncs.descent_drain"] == c["passes"]
    for name in ("descent_graph_captures", "descent_graph_replays"):
        assert name not in c
    assert not search_capped._GRAPHS
