"""Batched MCTS: the full-width search and the ``run_mcts`` dispatch (port
of ``alphafive_tpu/mcts/search.py``).

``run_mcts`` dispatches as the JAX function does: with ``branch_cap`` set
to the branch-capped search (``mcts/search_capped.py``, the self-play
path); with ``select_impl="pallas"`` to the packed-tree search whose
descent is the select kernel (``mcts/search_packed.py``); otherwise to the
full-width search below, over action-indexed edge arrays ``[E, NN, A]``.
The Gumbel root search (``mcts/gumbel.py``) reuses its descent
(``_select_one``'s ``root_action`` lanes) and the rest of its pass
(``_expand_and_backup``). Semantics are the JAX package's, step for step;
the port differs only in mechanics:

* The tree is updated in place (JAX rebuilds immutable arrays); in "path"
  virtual mode the virtual visits go straight into the visit array, which
  JAX swaps in after the select phase.
* The per-env descent (a vmapped ``while_loop`` in JAX) is one loop over
  all envs with one host sync per step (``stopped.all()``).
* Visit counts (u16 in JAX), child links (i16) and the int16 fixed-point
  value sums are int32 tensors holding the same values: torch's small
  integer types support too few ops, and scatter-adds into int32 work on
  every device. The fixed-point budget check (``nn <= 511``) is JAX's, so
  the sums stay within int16's range as there.

Randomness comes from ``torch.Generator``s; a caller that needs the JAX
package's exact noise passes it in as a tensor (``noise=``).

Spans and counters (``utils/trace.py``), named as in the capped search:
``search`` / ``root_forward``, and per pass ``descent``,
``leaf_env_step``, ``leaf_forward``, ``expand``, ``backup``; sync sites
``descent_drain`` and ``descent_step`` in ``_select_one``; counters
``passes``, ``wavefront_steps``, ``leaves`` and ``expanded``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.utils import trace

# evaluator: (board int8[E,A], to_play int8[E], last int32[E])
#            -> (logits f32[E,A], value f32[E])
Evaluator = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


class SearchResult(NamedTuple):
    visits: torch.Tensor      # f32[E, A] root visit counts
    root_value: torch.Tensor  # f32[E] W(root)/N(root)
    priors: torch.Tensor      # f32[E, A] root priors (after noise)


@dataclasses.dataclass
class Tree:
    # edge stats [E, NN, A]
    n: torch.Tensor       # int32 visit counts
    w: torch.Tensor       # f32 value sums, or int32 fixed-point (1/64)
    p: torch.Tensor       # priors (prior_dtype), illegal = -1
    child: torch.Tensor   # int32 child node index, -1 if unexpanded
    # node stats [E, NN] / [E, NN, A]
    node_done: torch.Tensor
    node_winner: torch.Tensor
    node_to_play: torch.Tensor
    node_last: torch.Tensor
    node_count: torch.Tensor
    node_board: torch.Tensor


def masked_softmax(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Softmax over legal entries only (same op order as the JAX version);
    rows with no legal action return zeros."""
    x = torch.where(legal, logits.float(), float("-inf"))
    m = x.max(dim=-1, keepdim=True).values
    ex = torch.where(legal, torch.exp(x - torch.where(torch.isfinite(m), m,
                                                      0.0)), 0.0)
    return ex / ex.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def dirichlet_noise(generator: torch.Generator, alpha: float,
                    legal: torch.Tensor) -> torch.Tensor:
    """Dirichlet(α) over each env's legal moves (zero on illegal)."""
    conc = torch.full(legal.shape, float(alpha), dtype=torch.float32,
                      device=legal.device)
    g = torch._standard_gamma(conc, generator=generator)
    g = torch.where(legal, g, 0.0)
    return g / g.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def _tree_init(env_cfg: EnvConfig, num_envs: int, num_nodes: int,
               prior_dtype: torch.dtype, fixed_w: bool, device) -> Tree:
    e, nn, a = num_envs, num_nodes, env_cfg.num_actions
    if nn > 32767:  # JAX's int16 child pointers
        raise ValueError("the tree is capped at 32767 nodes")
    z = lambda shape, dt, fill=0: torch.full(shape, fill, dtype=dt,
                                             device=device)
    return Tree(
        n=z((e, nn, a), torch.int32),
        w=z((e, nn, a), torch.int32 if fixed_w else torch.float32),
        p=z((e, nn, a), prior_dtype),
        child=z((e, nn, a), torch.int32, -1),
        node_done=z((e, nn), torch.bool),
        node_winner=z((e, nn), torch.int8),
        node_to_play=z((e, nn), torch.int8, 1),
        node_last=z((e, nn), torch.int32, -1),
        node_count=z((e, nn), torch.int32),
        node_board=z((e, nn, a), torch.int8),
    )


def _puct_scores_n(nf, w_row, p_row, legal, c_puct: float):
    """PUCT with float visit counts (virtual visits already folded in)."""
    q = torch.where(nf > 0, w_row / nf.clamp(min=1.0), 0.0)
    ns = 1.0 + nf.sum(dim=-1, keepdim=True)
    u = c_puct * p_row.float() * torch.sqrt(ns) / (1.0 + nf)
    return torch.where(legal, q + u, float("-inf"))


def _select_one(tree_n, tree_w, tree_p, tree_child, tree_done, vroot,
                c_puct: float, depth_limit: int, w_inv_scale: float = 1.0,
                forced_k: float = 0.0, root_action=None):
    """PUCT descent of every env from its root (JAX's ``_select_one``,
    there vmapped over envs). `vroot` [E, A] holds the pass's virtual
    root visits (None: none). A descent stops at the first missing child
    (to expand), at a terminal node or at the depth cap (the latter two:
    action -1, a leaf revisit). The path records every traversed edge,
    including the stopping edge when expanding; unused slots stay (0, 0).

    `root_action` [E, L] runs L lanes per env over the same tree (no
    virtual visits: `vroot` must be None), lane j's first edge pinned to
    root_action[:, j]: the Gumbel search's halving lanes (JAX's hook,
    vmapped over lanes there). The lanes are E·L rows of one loop.

    Returns (leaf_parent, action, depth, path_nodes, path_actions), all
    int64, leading dims [E] (or [E, L] with `root_action`); paths add
    [D]."""
    d = depth_limit
    e = tree_done.shape[0]
    dev = tree_done.device
    lanes = 1 if root_action is None else root_action.shape[1]
    rows = torch.arange(e, device=dev).repeat_interleave(lanes)  # env of row
    r = e * lanes
    rarange = torch.arange(r, device=dev)
    pinned = None if root_action is None else root_action.reshape(r).long()
    cur = torch.zeros(r, dtype=torch.long, device=dev)
    act = torch.full((r,), -1, dtype=torch.long, device=dev)
    depth = torch.zeros(r, dtype=torch.long, device=dev)
    stopped = torch.zeros(r, dtype=torch.bool, device=dev)
    pn = torch.zeros((r, d), dtype=torch.long, device=dev)
    pa = torch.zeros((r, d), dtype=torch.long, device=dev)
    steps = 0
    site = "descent_drain"   # the first read waits for the last pass's work
    while not trace.read_bool(site, stopped.all()):
        site = "descent_step"
        steps += 1
        live = ~stopped
        revisit = tree_done[rows, cur] | (depth >= d)
        p_signed = tree_p[rows, cur].float()
        legal = p_signed >= 0
        w_row = tree_w[rows, cur].float() * w_inv_scale
        p_row = p_signed.clamp(min=0.0)
        nf_real = tree_n[rows, cur].float()
        nf = (nf_real if vroot is None
              else torch.where((cur == 0)[:, None], nf_real + vroot, nf_real))
        score = _puct_scores_n(nf, w_row, p_row, legal, c_puct)
        # forced-playout gate on REAL visits (see the JAX docstring)
        forced = (legal & (depth == 0)[:, None] & (nf_real > 0)
                  & (nf_real * nf_real
                     < forced_k * p_row * nf_real.sum(dim=-1, keepdim=True)))
        score = torch.where(forced, float("inf"), score)
        a = score.argmax(dim=-1)
        if pinned is not None:  # Gumbel lane: pin the root edge
            a = torch.where(depth == 0, pinned, a)
        ch = tree_child[rows, cur, a].long()
        stop = revisit | (ch < 0)
        rec = live & ~revisit
        slot = depth.clamp(max=d - 1)
        pn[rarange, slot] = torch.where(rec, cur, pn[rarange, slot])
        pa[rarange, slot] = torch.where(rec, a, pa[rarange, slot])
        depth = depth + rec.long()
        act = torch.where(live, torch.where(revisit, -1, a), act)
        cur = torch.where(live & ~stop, ch, cur)
        stopped = stopped | stop
    trace.count("wavefront_steps", steps)
    out = (cur, act, depth, pn, pa)
    if root_action is None:
        return out
    return tuple(x.reshape((e, lanes) + x.shape[1:]) for x in out)


def _gather_env(tree, idx: torch.Tensor) -> EnvState:
    """EnvState of node idx[E] (or nodes idx[E, L], leading [E, L]) in
    each env's tree (any tree with the ``node_*`` fields)."""
    idx = idx.long()
    e = torch.arange(idx.shape[0], device=idx.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return EnvState(
        board=tree.node_board[e, idx],
        to_play=tree.node_to_play[e, idx],
        last_move=tree.node_last[e, idx],
        move_count=tree.node_count[e, idx],
        done=tree.node_done[e, idx],
        winner=tree.node_winner[e, idx],
    )


def _write_nodes(tree, ids, st: EnvState) -> None:
    """Store `st` as node(s) `ids` (an int, or a slice over [E, L] lanes)
    of every env's tree, in place."""
    tree.node_board[:, ids] = st.board
    tree.node_to_play[:, ids] = st.to_play
    tree.node_last[:, ids] = st.last_move
    tree.node_count[:, ids] = st.move_count
    tree.node_done[:, ids] = st.done
    tree.node_winner[:, ids] = st.winner


def _select_where(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Field-wise ``where(mask, a, b)``; `mask` covers the leading dims."""
    def pick(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)
    return EnvState(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                       for f in dataclasses.fields(EnvState)})


def _run_pass(env_cfg, evaluate, tree: Tree, *, base: int, lb: int, d: int,
              path_virtual: bool, fixed_w: bool, w_scale: float,
              prior_dtype, c_puct: float, forced_k: float) -> None:
    """One leaf-parallel pass: `lb` descents per env with virtual visits
    between them, then ``_expand_and_backup`` of the E·lb leaves at node
    ids [base, base + lb). Updates `tree` in place."""
    e, _, a = tree.n.shape
    dev = tree.n.device
    earange = torch.arange(e, device=dev)
    dn = torch.arange(d, device=dev)
    vroot = torch.zeros((e, a), dtype=torch.float32, device=dev)
    lanes = []
    with trace.span("descent"):
        for _ in range(lb):
            lp, act, depth, pn, pa = _select_one(
                tree.n, tree.w, tree.p, tree.child, tree.node_done, vroot,
                c_puct, d, 1.0 / w_scale, forced_k)
            if path_virtual:  # +1 on every traversed edge, for good
                tree.n.index_put_((earange[:, None].expand_as(pn), pn, pa),
                                  (dn[None, :] < depth[:, None]).int(),
                                  accumulate=True)
            else:             # +1 on the first edge, for this pass only
                vroot[earange, pa[:, 0]] += (depth > 0).float()
            lanes.append((lp, act, depth, pn, pa))
    # in path mode the visits landed at select time
    _expand_and_backup(env_cfg, evaluate, tree,
                       *(torch.stack(x, dim=1) for x in zip(*lanes)),
                       base=base, fixed_w=fixed_w, w_scale=w_scale,
                       prior_dtype=prior_dtype, add_visits=not path_virtual)


def _expand_and_backup(env_cfg, evaluate, tree: Tree, lps, acts, deps, pns,
                       pas, *, base: int, fixed_w: bool, w_scale: float,
                       prior_dtype, add_visits: bool) -> None:
    """The rest of a pass, after the descents of its `lb` lanes ([E, lb]
    leaf parents, actions, depths and [E, lb, D] paths): one batched
    env.step and net forward over the E·lb leaves, dedup expansion at
    node ids [base, base + lb), one backup scatter (visits too with
    `add_visits`). Shared by ``_run_pass`` and the Gumbel search's
    passes. Updates `tree` in place."""
    e, lb = lps.shape
    a = tree.n.shape[2]
    dev = tree.n.device
    earange = torch.arange(e, device=dev)
    dn = torch.arange(pns.shape[2], device=dev)
    trace.count("passes")
    trace.count("leaves", e * lb)

    # revisit lanes (action -1): terminal node or live node at the depth
    # cap — no expansion, back up the leaf's own value
    flat = lambda x: x.reshape((e * lb,) + x.shape[2:])
    unflat = lambda x: x.reshape((e, lb) + x.shape[1:])
    with trace.span("leaf_env_step"):
        is_revisit = acts < 0                                  # [E, lb]
        safe_act = acts.clamp(min=0)
        parent = _gather_env(tree, lps)
        stepped = vector.step(env_cfg, parent.map(flat),
                              flat(safe_act)).map(unflat)
        leaf = _select_where(is_revisit, parent, stepped)

    # ONE batched evaluation per pass
    with trace.span("leaf_forward"):
        logits_f, v_f = evaluate(flat(leaf.board), flat(leaf.to_play),
                                 flat(leaf.last_move))
    with trace.span("expand"):
        # duplicate expansions (two lanes stopping at the same unexpanded
        # edge) all link to the first lane's node id; child starts at -1
        # and no selected edge has a child yet, so adding link + 1 writes
        # the link
        edge_key = lps * a + safe_act
        expanding = ~is_revisit
        same = ((edge_key[:, :, None] == edge_key[:, None, :])
                & expanding[:, :, None] & expanding[:, None, :])
        jj = torch.arange(lb, device=dev)
        first_lane = torch.where(same, jj[None, None, :],
                                 lb).min(dim=-1).values
        is_first = expanding & (first_lane == jj[None, :])
        trace.count_device("expanded", is_first)
        link_add = torch.where(is_first, base + first_lane + 1, 0).int()
        new = slice(base, base + lb)
        _write_nodes(tree, new, stepped)
        tree.child.index_put_((earange[:, None].expand_as(lps), lps,
                               safe_act), link_add, accumulate=True)

        logits, v = unflat(logits_f), unflat(v_f)
        leaf_value = torch.where(leaf.done, (leaf.winner
                                             * leaf.to_play).float(),
                                 v.float())
        child_legal = stepped.board == 0
        child_p = masked_softmax(logits, child_legal)
        tree.p[:, new] = torch.where(child_legal, child_p,
                                     -1.0).to(prior_dtype)

    # backup: edge j of a path of length L gets leaf_value * (-1)^(L - j)
    # and one visit; pad slots add 0 at (0, 0)
    with trace.span("backup"):
        on_path = dn[None, None, :] < deps[:, :, None]         # [E, lb, D]
        sign = torch.where((deps[:, :, None] - dn) % 2 == 0, 1.0, -1.0)
        vals = torch.where(on_path, sign * leaf_value[:, :, None], 0.0)
        if fixed_w:
            vals = torch.round(vals * w_scale).int()
        idx = (earange[:, None, None].expand_as(pns), pns, pas)
        tree.w.index_put_(idx, vals, accumulate=True)
        if add_visits:
            tree.n.index_put_(idx, on_path.int(), accumulate=True)


@torch.no_grad()
def run_mcts(env_cfg: EnvConfig, mcts_cfg: MCTSConfig, evaluate: Evaluator,
             state: EnvState, generator: Optional[torch.Generator] = None,
             *, num_simulations: Optional[int] = None,
             add_noise: bool = True,
             noise: Optional[torch.Tensor] = None) -> SearchResult:
    """Search every env's current position. Roots should not be terminal
    (done envs are searched harmlessly but their visits are meaningless).
    `noise` [E, A] replaces the Dirichlet draw from `generator`."""
    if mcts_cfg.branch_cap is not None:
        if mcts_cfg.select_impl == "pallas":
            raise ValueError("branch_cap and select_impl='pallas' are "
                             "mutually exclusive")
        from alphafive_tpu_torch.mcts.search_capped import run_mcts_capped
        return run_mcts_capped(env_cfg, mcts_cfg, evaluate, state, generator,
                               num_simulations=num_simulations,
                               add_noise=add_noise, noise=noise)
    if mcts_cfg.select_impl == "pallas":
        if mcts_cfg.leaf_batch > 1:
            raise ValueError("select_impl='pallas' implements sequential "
                             "descent only; leaf_batch > 1 needs 'xla'")
        from alphafive_tpu_torch.mcts.search_packed import run_mcts_packed
        return run_mcts_packed(env_cfg, mcts_cfg, evaluate, state, generator,
                               num_simulations=num_simulations,
                               add_noise=add_noise, noise=noise)
    sims = int(num_simulations or mcts_cfg.num_simulations)
    e, a = state.board.shape
    nn = sims + 1
    # worst case is a single chain of sims edges; perf presets cap it
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    prior_dtype = (torch.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else torch.float32)
    # fixed-point value sums in 1/64 steps; budgets whose |W| could leave
    # int16's range fall back to exact f32 sums
    fixed_w = mcts_cfg.value_dtype == "int16" and nn <= 511
    w_scale = 64.0 if fixed_w else 1.0
    c_puct = float(mcts_cfg.c_puct)
    # forced playouts only perturb noisy self-play searches
    forced_k = float(mcts_cfg.forced_playouts_k if add_noise else 0.0)

    with trace.span("search"):
        tree = _tree_init(env_cfg, e, nn, prior_dtype, fixed_w,
                          state.board.device)
        _write_nodes(tree, 0, state)
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
        # sign-masked priors: selection reads legality from the prior row
        tree.p[:, 0] = torch.where(root_legal, root_p, -1.0).to(prior_dtype)

        lb = max(1, int(mcts_cfg.leaf_batch))
        while sims % lb:
            lb -= 1  # runtime budgets round down to the largest divisor
        path_virtual = mcts_cfg.virtual_mode == "path" and lb > 1
        for p_ in range(sims // lb):
            _run_pass(env_cfg, evaluate, tree, base=1 + p_ * lb, lb=lb,
                      d=depth_limit, path_virtual=path_virtual,
                      fixed_w=fixed_w, w_scale=w_scale,
                      prior_dtype=prior_dtype, c_puct=c_puct,
                      forced_k=forced_k)

        visits = tree.n[:, 0].float()
        n_sum = visits.sum(-1)
        w_root = tree.w[:, 0].float().sum(-1) / w_scale
        root_value = torch.where(n_sum > 0, w_root / n_sum.clamp(min=1.0),
                                 0.0)
        return SearchResult(visits=visits, root_value=root_value,
                            priors=root_p)


def pi_from_visits(visits: torch.Tensor, temperature: torch.Tensor,
                   greedy: torch.Tensor) -> torch.Tensor:
    """π ∝ N^(1/τ), in log space; greedy[E] lanes get one-hot argmax."""
    logn = torch.where(visits > 0, torch.log(visits), float("-inf"))
    scaled = logn / temperature[:, None].clamp(min=1e-6)
    scaled = scaled - scaled.max(dim=-1, keepdim=True).values
    pi = torch.where(torch.isfinite(scaled), torch.exp(scaled), 0.0)
    pi = pi / pi.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    onehot = torch.nn.functional.one_hot(
        visits.argmax(dim=-1), visits.shape[-1]).float()
    return torch.where(greedy[:, None], onehot, pi)


def sample_actions(generator: torch.Generator,
                   pi: torch.Tensor) -> torch.Tensor:
    """Sample one action per env from π (all-zero rows sample uniformly)."""
    w = torch.where(pi > 0, pi, 0.0)
    w = torch.where((w > 0).any(dim=-1, keepdim=True), w, 1.0)
    return torch.multinomial(w, 1, generator=generator)[:, 0].to(torch.int32)
