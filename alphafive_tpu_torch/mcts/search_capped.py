"""Branch-capped batched MCTS over slot-indexed trees (port of
``alphafive_tpu/mcts/search_capped.py``).

Every node stores only its top-``branch_cap`` children by prior, so edge
arrays are [E, NN, C]. A search runs in passes of ``leaf_batch`` lanes:
a wavefront PUCT descent of all lanes with full-path virtual visits, one
batched env.step and one batched net forward over the E·lb leaves,
deduplicated expansion, and one backup scatter. Semantics are the JAX
package's, step for step; the port differs only in mechanics:

* The tree is updated in place (JAX rebuilds immutable arrays), and one
  tree a shape is kept and emptied for the next search
  (``_capped_tree_init``), so its storage stays put.
* The wavefront ``while_loop`` is a Python loop with one host sync per
  step (``stopped.all()``). The step (``_descent_step``) is a function of
  device tensors only, its index ``k`` a device scalar. On CUDA it is
  captured once as a CUDA graph (``_StepGraph``) and replayed each step,
  so a step costs one graph launch where it cost ~90 PyTorch ops; the
  deferred fold's passes (``pending``) and every other device run it
  eagerly. A graph is cached by key: the device, pointer, shape, strides
  and dtype of every tree tensor the step reads, ``c_puct``,
  ``forced_k``, the value scale, the depth cap, packed stats, the lanes,
  the slots and the forced slots' shape; the descent state and the forced
  slots live in its static buffers. The kept tree keeps the pointers, so
  a shape's graphs are captured in its first search.
* Top-C takes a stable descending sort, so ties keep the lower action
  first, as ``lax.top_k`` does; the TPU's ``approx_max_k`` is not used
  (on the CPU, where the parity tests run, it is exact and orders ties the
  same way).
* Visit counts (u16 in JAX) and child links (i16) are int32: torch's
  uint16 supports too few ops, and scatter-adds into int32 are supported
  on every device.
* In packed mode (int16 value sums) a stat is one int32 ``(w << 16) + n``;
  the value field is added as ``w * 65536``, the same two's-complement
  bits as JAX's shift.

The Gumbel search over this tree (``mcts/gumbel.py``) forces each lane's
first step onto its root slot through ``forced_slots``.

Deferred backup (``backup_interval >= 2``, packed mode only; ignored
otherwise, as in JAX): passes run in pairs inside a depth stage. The first
pass of a pair skips its stats scatter and hands its path entries and
value units to the second as ``pending``; the second pass's descent folds
them into the real visits and value sums it reads, through the same
depth index its virtual visits read, and its backup scatters both passes
in one ``index_put_``. Every fold adds integers (visits) or multiples of
1/64 (value sums) in f32, all below 2^24, so each add is exact and the
search is bit-identical to scattering every pass. The counter
``backup_scatters`` (``utils/trace.py``) counts the stats scatters (50 a
400-sim, ``leaf_batch`` 8 search; 25 with deferral).

Spans (``utils/trace.py``): ``search`` / ``root_forward``, and per pass
``descent``, ``leaf_env_step``, ``leaf_forward``, ``expand``, ``backup``.
The descent's host reads are the sync sites ``descent_drain`` (a pass's
first, which waits for the previous pass's queued work) and
``descent_step`` (every later one). Counters: ``passes``,
``wavefront_steps``, ``leaves`` (E·lb a pass), ``descent_graph_captures``
(step graphs captured), ``descent_graph_replays`` and
``descent_eager_steps`` (the steps each way, summing to
``wavefront_steps``) and, on the device while spans are on, ``expanded``
(the leaves that expanded a node).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts.search import (Evaluator, SearchResult,
                                             _gather_env, _puct_scores_n,
                                             _select_where, _write_nodes,
                                             dirichlet_noise, masked_softmax)
from alphafive_tpu_torch.utils import trace


def __getattr__(name: str):
    """``backup_scatters`` as a module attribute: a view of the counter,
    as ``perfbench/run.py`` reads it."""
    if name == "backup_scatters":
        return trace.counter(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class CappedTree:
    # edge stats [E, NN, C] (slot-indexed)
    n: torch.Tensor          # int32 visits, or packed (w << 16) + n
    w: Optional[torch.Tensor]  # f32 value sums; None when packed
    p: torch.Tensor          # priors (prior_dtype); pads/illegal = -1
    child: torch.Tensor      # int32 child node index, -1 if unexpanded
    cand_act: torch.Tensor   # int16 action id per slot
    # node stats [E, NN] / [E, NN, A]
    node_done: torch.Tensor
    node_winner: torch.Tensor
    node_to_play: torch.Tensor
    node_last: torch.Tensor
    node_count: torch.Tensor
    node_board: torch.Tensor


def _top_c(p_signed: torch.Tensor, c: int, prior_dtype: torch.dtype):
    """(slot priors [..., C], slot actions i16[..., C]) from [..., A] signed
    priors (legal >= 0, illegal = -1). Legal moves sort above illegal ones
    even at prior 0.0; ties keep the lower action first."""
    vals, idx = torch.sort(p_signed, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :c], idx[..., :c]
    vals = torch.where(vals >= 0, vals, -1.0).to(prior_dtype)
    return vals, idx.to(torch.int16)


@dataclasses.dataclass
class _Descent:
    """A pass's wavefront state, which ``_descent_step`` updates in place:
    each lane's node, path length, stop flag and chosen slot [E, LB], its
    packed path entries [E, LB, D] and the step index ``k`` (a device
    int64 scalar), beside the step's index constants."""
    eidx: torch.Tensor       # [E, 1]
    lanes: torch.Tensor      # [LB]
    slot_ar: torch.Tensor    # [C]
    tri: torch.Tensor        # [LBi, LBj]: lane i starts before lane j
    cur: torch.Tensor
    depth: torch.Tensor
    stopped: torch.Tensor
    sel: torch.Tensor
    ppas: torch.Tensor
    k: torch.Tensor

    @classmethod
    def new(cls, e: int, lb: int, d: int, num_slots: int, dev) -> "_Descent":
        lanes = torch.arange(lb, device=dev)
        z = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
        return cls(eidx=torch.arange(e, device=dev)[:, None], lanes=lanes,
                   slot_ar=torch.arange(num_slots, device=dev),
                   tri=lanes[:, None] < lanes[None, :],
                   cur=z(e, lb), depth=z(e, lb),
                   stopped=torch.zeros((e, lb), dtype=torch.bool, device=dev),
                   sel=torch.full((e, lb), -1, dtype=torch.long, device=dev),
                   ppas=z(e, lb, d), k=z())

    def reset(self) -> None:
        for t in (self.cur, self.depth, self.stopped, self.ppas, self.k):
            t.zero_()
        self.sel.fill_(-1)


def _descent_step(s: _Descent, stat_a, stat_b, tree_p, tree_child, tree_done,
                  c_puct, d, w_inv_scale, forced_k, packed, forced_slots=None,
                  pending=None):
    """One wavefront step of every lane, in place on `s`, ``k`` included;
    returns whether every lane has stopped, as a device bool. It reads
    nothing on the host, so a CUDA graph can replay it (``_StepGraph``).

    Lane j starts at step j and every active lane takes one step per
    iteration, so while lane j is active its depth is exactly k - j. Virtual
    visits are computed from the lanes' recorded paths: every node has a
    unique depth, so lane j standing at ``cur`` can only meet another
    lane's path entry at index k - j (see the JAX docstring for the
    argument). The tree is read-only here. Once every lane has stopped a
    step changes nothing but ``k``."""
    eidx, lanes, cur, depth, k = s.eidx, s.lanes, s.cur, s.depth, s.k
    active = (lanes[None, :] <= k) & ~s.stopped                 # [E,LB]
    revisit = tree_done[eidx, cur] | (depth >= d)
    p_signed = tree_p[eidx, cur].float()                        # [E,LB,C]
    legal = p_signed >= 0
    if packed:
        row = stat_a[eidx, cur]                                 # [E,LB,C]
        nf_real = (row & 0xFFFF).float()
        w_row = (row >> 16).float() * w_inv_scale
    else:
        nf_real = stat_a[eidx, cur].float()
        w_row = stat_b[eidx, cur].float() * w_inv_scale
    p_row = p_signed.clamp(min=0.0)

    # path entry of lane i at lane j's depth k - j: ent[e,i,j]
    dsel = (k - lanes).clamp(0, d - 1)                          # [LBj]
    ent = s.ppas[:, :, dsel]                                    # [E,LBi,LBj]
    match = (s.tri[None]
             & (depth[:, :, None] > depth[:, None, :])
             & ((ent >> 8) == cur[:, None, :]))                 # [E,LBi,LBj]
    virt = (match[..., None]
            & ((ent & 255)[..., None] == s.slot_ar)).sum(dim=1).float()

    if pending is not None:
        pp, pw, pdep = pending
        entp = pp[:, :, dsel]                                   # [E,LP,LBj]
        validp = ((dsel[None, None, :] < pdep[:, :, None])
                  & ((entp >> 8) == cur[:, None, :]))
        hit = validp[..., None] & ((entp & 255)[..., None] == s.slot_ar)
        nf_real = nf_real + hit.sum(dim=1).float()              # [E,LBj,C]
        w_row = w_row + torch.where(
            hit, pw[:, :, dsel].float()[..., None], 0.0).sum(dim=1) \
            * w_inv_scale

    nf = nf_real + virt
    score = _puct_scores_n(nf, w_row, p_row, legal, c_puct)
    # forced-playout gate on REAL visits only
    forced = (legal & (depth == 0)[..., None] & (nf_real > 0)
              & (nf_real * nf_real
                 < forced_k * p_row * nf_real.sum(dim=-1, keepdim=True)))
    score = torch.where(forced, float("inf"), score)
    sl = score.argmax(dim=-1)                                   # [E,LB]
    if forced_slots is not None:  # Gumbel lane: pin the root slot
        sl = torch.where(depth == 0, forced_slots, sl)
    ch = tree_child[eidx, cur, sl].long()
    stop_now = revisit | (ch < 0)
    rec = active & ~revisit
    stop = active & stop_now
    # each (lane, depth) entry is written at most once
    s.ppas[:, lanes, dsel] += torch.where(rec, (cur << 8) | sl, 0)
    s.sel.copy_(torch.where(stop, torch.where(revisit, -1, sl), s.sel))
    s.cur.copy_(torch.where(active & ~stop_now, ch, cur))
    depth.add_(rec.long())
    s.stopped.logical_or_(stop)
    k.add_(1)
    return s.stopped.all()


class _StepGraph:
    """One ``_descent_step`` captured as a CUDA graph. Its static buffers
    are the descent state and the forced slots; the tree is read where it
    lies, so the cache key holds the tree's pointers (``_step_graph``)."""

    def __init__(self, tree, scalars, num_slots: int, lb: int,
                 forced_slots):
        dev = tree[-1].device
        self.state = _Descent.new(tree[-1].shape[0], lb, scalars[1],
                                  num_slots, dev)
        self.forced = None if forced_slots is None else forced_slots.clone()
        step = lambda: _descent_step(self.state, *tree, *scalars,
                                     self.forced)
        with torch.cuda.device(dev):
            # a warm-up step on a side stream first, as capture requires
            main, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                step()
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.done = step()

    def start(self, forced_slots) -> _Descent:
        """The static state, reset for a new pass."""
        self.state.reset()
        if forced_slots is not None:
            self.forced.copy_(forced_slots)
        return self.state

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.done


_GRAPHS: "collections.OrderedDict[tuple, _StepGraph]" = \
    collections.OrderedDict()
_MAX_GRAPHS = 32   # least recently used out first: evals at other shapes


def _step_graph(tree, scalars, num_slots: int, lb: int, forced_slots,
                pending) -> Optional[_StepGraph]:
    """The step graph of this descent, captured the first time its key is
    seen; None where the step runs eagerly (off CUDA, or with `pending`).
    The key is every tree tensor's device, pointer, shape, strides and
    dtype, the step's scalars, the lanes, the slots and the forced slots'
    shape: a tree at a new address gets a new capture, whatever the
    allocator does."""
    if not tree[-1].is_cuda or pending is not None:
        return None
    key = (scalars, num_slots, lb,
           None if forced_slots is None else (forced_slots.shape,
                                              forced_slots.dtype),
           tuple((t.device, t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for t in tree))
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = _StepGraph(tree, scalars, num_slots, lb, forced_slots)
        trace.count("descent_graph_captures")
        _GRAPHS[key] = graph
        if len(_GRAPHS) > _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
    return graph


def _select_lanes(stat_a, stat_b, tree_p, tree_child, tree_done, c_puct,
                  depth_limit, w_inv_scale, forced_k, num_slots, packed, lb,
                  forced_slots=None, pending=None):
    """Wavefront PUCT descent of all ``lb`` lanes of a pass: one
    ``_descent_step`` after another until every lane has stopped, read
    on the host after each step. On CUDA each step is a replay of its
    ``_StepGraph`` (the deferred fold's passes excepted); elsewhere it
    runs eagerly. `forced_slots` [E, LB] pins lane j's first step to root
    slot forced_slots[:, j] (the Gumbel search's halving lanes).
    `pending` (deferred backup) is the previous pass's unscattered
    results (ppas_prev [E,LP,D], pw_prev int32 [E,LP,D] value units,
    deps_prev [E,LP]): its visits and value units are folded into the
    real stats read at the same depth index.

    Returns (lps [E,LB] leaf-parent nodes, slots [E,LB] chosen slot or -1
    for revisits, deps [E,LB] path lengths, ppas [E,LB,D] packed
    (node << 8 | slot) path entries)."""
    tree = (stat_a, stat_b, tree_p, tree_child, tree_done)
    scalars = (c_puct, depth_limit, w_inv_scale, forced_k, packed)
    graph = _step_graph(tree, scalars, num_slots, lb, forced_slots, pending)
    if graph is None:
        s = _Descent.new(tree_done.shape[0], lb, depth_limit, num_slots,
                         tree_done.device)
        step = lambda: _descent_step(s, *tree, *scalars, forced_slots,
                                     pending)
    else:
        s = graph.start(forced_slots)
        step = graph.replay
    done, steps = s.stopped.all(), 0
    site = "descent_drain"   # the first read waits for the last pass's work
    while not trace.read_bool(site, done):
        site = "descent_step"
        done = step()
        steps += 1
    trace.count("wavefront_steps", steps)
    trace.count("descent_eager_steps" if graph is None
                else "descent_graph_replays", steps)
    out = s.cur, s.sel, s.depth, s.ppas
    # the graph's buffers are the next pass's: the caller gets copies
    return out if graph is None else tuple(t.clone() for t in out)


def _run_pass(env_cfg, evaluate, tree: CappedTree, *, base, d, lb, c,
              packed, w_scale, prior_dtype, c_puct, forced_k,
              forced_slots=None, pending=None, defer=False):
    """One leaf-parallel pass: wavefront select of `lb` lanes, batched
    env.step + net forward, dedup expansion at node ids [base, base + lb),
    backup scatter. Shared by ``run_mcts_capped`` and the Gumbel search,
    which pins each lane's root slot with `forced_slots` [E, lb]. Updates
    `tree` in place.

    Deferred backup (packed mode only): with `defer` the stats scatter is
    skipped and the pass returns its results as the next pass's
    `pending`, which that pass folds into its descent and scatters with
    its own in one ``index_put_``. Returns the pending tuple with `defer`,
    else None."""
    e = tree.node_done.shape[0]
    dev = tree.node_done.device
    trace.count("passes")
    trace.count("leaves", e * lb)
    with trace.span("descent"):
        lps, slots, deps, ppas = _select_lanes(
            tree.n, tree.n if packed else tree.w, tree.p, tree.child,
            tree.node_done, c_puct, d, 1.0 / w_scale, forced_k, c, packed,
            lb, forced_slots, pending)

    flat = lambda x: x.reshape((e * lb,) + x.shape[2:])
    unflat = lambda x: x.reshape((e, lb) + x.shape[1:])
    with trace.span("leaf_env_step"):
        is_revisit = slots < 0
        safe_slot = slots.clamp(min=0)
        eidx2 = torch.arange(e, device=dev)[:, None]
        safe_act = tree.cand_act[eidx2, lps, safe_slot].long()
        parent = _gather_env(tree, lps)
        stepped = vector.step(env_cfg, parent.map(flat),
                              flat(safe_act)).map(unflat)
        leaf = _select_where(is_revisit, parent, stepped)

    # ONE batched evaluation per pass
    with trace.span("leaf_forward"):
        logits_f, v_f = evaluate(flat(leaf.board), flat(leaf.to_play),
                                 flat(leaf.last_move))
    with trace.span("expand"):
        logits, v = unflat(logits_f), unflat(v_f)
        leaf_value = torch.where(leaf.done, (leaf.winner
                                             * leaf.to_play).float(),
                                 v.float())
        # duplicate expansions (two lanes stopping at the same unexpanded
        # edge) all link to the first lane's node id
        edge_key = lps * c + safe_slot
        expanding = ~is_revisit
        same = ((edge_key[:, :, None] == edge_key[:, None, :])
                & expanding[:, :, None] & expanding[:, None, :])
        jj = torch.arange(lb, device=dev)
        first_lane = torch.where(same, jj[None, None, :],
                                 lb).min(dim=-1).values
        is_first = expanding & (first_lane == jj[None, :])
        trace.count_device("expanded", is_first)
        link_add = torch.where(is_first, base + first_lane + 1, 0).int()
        child_legal = stepped.board == 0
        child_p = masked_softmax(logits, child_legal)
        slot_p, slot_act = _top_c(torch.where(child_legal, child_p, -1.0),
                                  c, prior_dtype)

        new = slice(base, base + lb)
        _write_nodes(tree, new, stepped)
        tree.p[:, new] = slot_p
        tree.cand_act[:, new] = slot_act
        # child starts at -1 and no selected edge has a child yet, so
        # adding link + 1 writes the link; revisit and duplicate lanes
        # add 0
        tree.child.index_put_((eidx2.expand_as(lps), lps, safe_slot),
                              link_add, accumulate=True)

    with trace.span("backup"):
        return _backup(tree, ppas, deps, leaf_value, packed=packed,
                       w_scale=w_scale, pending=pending, defer=defer)


def _backup(tree: CappedTree, ppas, deps, leaf_value, *, packed, w_scale,
            pending=None, defer=False):
    """The stats backup of a pass: edge j of a path of length L gets
    leaf_value * (-1)^(L - j) and one visit; pad entries add 0 at (0, 0).
    With `defer` nothing is scattered and (ppas, value units, deps) is
    returned for the next pass; with `pending` both passes' deltas go
    into one ``index_put_``. Counts ``backup_scatters``."""
    e, _, d = ppas.shape
    dev = ppas.device
    dn = torch.arange(d, device=dev)[None, None, :]
    on_path = dn < deps[:, :, None]
    sign = torch.where((deps[:, :, None] - dn) % 2 == 0, 1.0, -1.0)
    vals = torch.where(on_path, sign * leaf_value[:, :, None], 0.0)
    if packed:
        pw = torch.round(vals * w_scale).int()
        if defer:
            # entries past a lane's depth read as 0 in the next descent
            return torch.where(on_path, ppas, 0), pw, deps
        delta = pw * 65536 + on_path.int()
        if pending is not None:
            p_ppas, p_pw, p_deps = pending
            ppas = torch.cat([ppas, p_ppas], dim=1)
            delta = torch.cat([delta, p_pw * 65536
                               + (dn < p_deps[:, :, None]).int()], dim=1)
    idx = (torch.arange(e, device=dev)[:, None, None].expand_as(ppas),
           ppas >> 8, ppas & 255)
    if packed:
        tree.n.index_put_(idx, delta, accumulate=True)
    else:
        if defer or pending is not None:
            raise ValueError("deferred backup needs packed stats")
        tree.n.index_put_(idx, on_path.int(), accumulate=True)
        tree.w.index_put_(idx, vals, accumulate=True)
    trace.count("backup_scatters")
    return None


# each tree field's empty value; w is absent (None) in packed mode
_TREE_FILL = dict(n=0, w=0, p=-1, child=-1, cand_act=0, node_done=0,
                  node_winner=0, node_to_play=1, node_last=-1, node_count=0,
                  node_board=0)
_TREES: "collections.OrderedDict[tuple, CappedTree]" = \
    collections.OrderedDict()
_MAX_TREES = 4   # least recently used out first: evals at other shapes


def _capped_tree_init(state: EnvState, nn: int, c: int, packed: bool,
                      prior_dtype) -> CappedTree:
    """An empty [E, nn, C] slot tree on the device of `state`, whose root
    (node 0) is `state`; the root's slots are the caller's to fill.

    One tree a shape is kept and emptied in place, so its storage, and
    with it the descent's step graphs (keyed by the tree's pointers),
    lasts across searches: a search's tree is valid until the next search
    of its shape starts."""
    e, a = state.board.shape
    dev = state.board.device
    key = (dev, e, a, nn, c, packed, prior_dtype)
    tree = _TREES.pop(key, None)
    if tree is None:
        z = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
        tree = CappedTree(
            n=z((e, nn, c), torch.int32),
            w=None if packed else z((e, nn, c), torch.float32),
            p=z((e, nn, c), prior_dtype),
            child=z((e, nn, c), torch.int32),
            cand_act=z((e, nn, c), torch.int16),
            node_done=z((e, nn), torch.bool),
            node_winner=z((e, nn), torch.int8),
            node_to_play=z((e, nn), torch.int8),
            node_last=z((e, nn), torch.int32),
            node_count=z((e, nn), torch.int32),
            node_board=z((e, nn, a), torch.int8),
        )
        if len(_TREES) >= _MAX_TREES:
            _TREES.popitem(last=False)
    _TREES[key] = tree
    for name, fill in _TREE_FILL.items():
        t = getattr(tree, name)
        if t is not None:
            t.fill_(fill)
    _write_nodes(tree, 0, state)
    return tree


def _stages(passes: int, d: int):
    """(first pass, end pass, path-depth cap) of the depth-staged loop: a
    descent in pass p records at most p + 1 edges, so early passes run with
    a smaller cap (8, doubling up to min(max_depth, passes))."""
    out, lo, dc = [], 0, 8
    while lo < passes:
        if dc >= min(d, passes):
            out.append((lo, passes, min(d, passes)))
            break
        out.append((lo, min(passes, dc), dc))
        lo = min(passes, dc)
        dc *= 2
    return out


@torch.no_grad()
def run_mcts_capped(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                    evaluate: Evaluator, state: EnvState,
                    generator: Optional[torch.Generator] = None, *,
                    num_simulations: Optional[int] = None,
                    add_noise: bool = True,
                    noise: Optional[torch.Tensor] = None) -> SearchResult:
    """Branch-capped search; same contract as ``search.run_mcts``.
    `noise` [E, A] replaces the Dirichlet draw from `generator`."""
    sims = int(num_simulations or mcts_cfg.num_simulations)
    e, a = state.board.shape
    dev = state.board.device
    c = min(int(mcts_cfg.branch_cap), a)
    nn = sims + 1
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    prior_dtype = (torch.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else torch.float32)
    # fixed-point value sums in 1/64 steps, packed beside the visit count
    packed = mcts_cfg.value_dtype == "int16" and nn <= 511
    w_scale = 64.0 if packed else 1.0
    c_puct = float(mcts_cfg.c_puct)
    forced_k = float(mcts_cfg.forced_playouts_k if add_noise else 0.0)
    if nn > 32767 or c > 256:
        raise ValueError("tree too large: nodes <= 32767 and branch_cap "
                         "<= 256 (paths pack node << 8 | slot)")

    with trace.span("search"):
        tree = _capped_tree_init(state, nn, c, packed, prior_dtype)

        with trace.span("root_forward"):
            root_logits, _ = evaluate(state.board, state.to_play,
                                      state.last_move)
        root_legal = state.board == 0
        root_p = masked_softmax(root_logits, root_legal)
        if add_noise:
            if noise is None:
                noise = dirichlet_noise(generator, mcts_cfg.dirichlet_alpha,
                                        root_legal)
            eps = float(mcts_cfg.dirichlet_eps)
            root_p = (1.0 - eps) * root_p + eps * noise
        root_slot_p, root_slot_act = _top_c(
            torch.where(root_legal, root_p, -1.0), c, prior_dtype)
        tree.p[:, 0] = root_slot_p
        tree.cand_act[:, 0] = root_slot_act

        lb = max(1, int(mcts_cfg.leaf_batch))
        while sims % lb:
            lb -= 1
        passes = sims // lb

        def pass_(p_, d, pending=None, defer=False):
            return _run_pass(env_cfg, evaluate, tree, base=1 + p_ * lb,
                             d=d, lb=lb, c=c, packed=packed,
                             w_scale=w_scale, prior_dtype=prior_dtype,
                             c_puct=c_puct, forced_k=forced_k,
                             pending=pending, defer=defer)

        defer_ok = packed and int(mcts_cfg.backup_interval) >= 2
        for lo, hi, d in _stages(passes, depth_limit):
            if not defer_ok:
                for p_ in range(lo, hi):
                    pass_(p_, d)
                continue
            # pairs (2q, 2q + 1) inside the stage, as JAX pairs them: a
            # pair never crosses a stage, whose depth cap sizes the pending
            # buffers. Every stage starts at an even pass (_stages), so the
            # pairs tile it and an odd end runs its last pass alone
            for q in range(lo // 2, hi // 2):
                pass_(2 * q + 1, d, pending=pass_(2 * q, d, defer=True))
            if hi % 2:
                pass_(hi - 1, d)

        # slot visit counts back onto the action space
        if packed:
            n0 = (tree.n[:, 0, :] & 0xFFFF).float()             # [E, C]
            w_root = (tree.n[:, 0, :] >> 16).float().sum(-1) / w_scale
        else:
            n0 = tree.n[:, 0, :].float()
            w_root = tree.w[:, 0, :].sum(-1) / w_scale
        act0 = tree.cand_act[:, 0, :].long()
        visits = torch.zeros((e, a), dtype=torch.float32, device=dev)
        visits.scatter_add_(1, act0, n0)
        n_sum = n0.sum(-1)
        root_value = torch.where(n_sum > 0, w_root / n_sum.clamp(min=1.0),
                                 0.0)
        return SearchResult(visits=visits, root_value=root_value,
                            priors=root_p)
