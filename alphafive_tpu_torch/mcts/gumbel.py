"""Gumbel root search with sequential halving (port of
``alphafive_tpu/mcts/gumbel.py``; Danihelka et al. 2022, "Policy
Improvement by Planning with Gumbel").

The root samples Gumbel noise g on its logits and keeps the top-m
candidates by g + logits. The budget is spent by sequential halving: each
pass visits every surviving candidate once, one lane per candidate, and
each halving keeps the half with the best g + logits + σ(q̂). The played
action is the last halving's winner and the policy target is the improved
policy π' = softmax(logits + σ(completed Q)), where σ(q) = (c_visit +
max_b N(b)) · c_scale · q and unvisited actions complete with the mixed
value v_mix.

The halving survivors are a pass's lanes: lane j's first edge is pinned to
candidate j and it descends PUCT below it. All lanes of a pass read the
same pre-pass tree (distinct root edges lead to disjoint subtrees, so no
virtual visits are needed), then one batched env.step and net forward
serve all E·lanes leaves. Two searches, as in the JAX package:

* full width (``branch_cap`` None, the ``lowsim_15x15`` path): the lanes
  descend together through ``search._select_one``'s ``root_action`` hook,
  then ``search._expand_and_backup`` finishes the pass;
* the branch-capped slot tree (``_run_gumbel_capped``): the root's slots
  are the candidates, and ``search_capped._run_pass`` runs each pass with
  its ``forced_slots`` hook.

Envs with fewer than m legal moves repeat their best candidate; duplicate
lanes expand one node and each backs up its own value. Top-k here is a
stable descending sort, so ties keep the lower index first, as
``lax.top_k`` does. Randomness: g is drawn from `generator`, or injected
as a table (``gumbel=``), as the JAX package's tests inject theirs.

Spans (``utils/trace.py``): ``search`` / ``root_forward``, then the
passes' spans (``descent`` and the rest, from ``search`` or
``search_capped``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts import search, search_capped
from alphafive_tpu_torch.mcts.search import (Evaluator, _tree_init,
                                             _write_nodes, masked_softmax)
from alphafive_tpu_torch.utils import trace


class GumbelResult(NamedTuple):
    visits: torch.Tensor      # f32[E, A] root visit counts
    root_value: torch.Tensor  # f32[E] W(root)/N(root)
    priors: torch.Tensor      # f32[E, A] softmax(logits) (no noise)
    action: torch.Tensor      # int32[E] halving winner (the move to play)
    pi_target: torch.Tensor   # f32[E, A] improved policy π'


def build_schedule(budget: int, m: int) -> List[Tuple[int, int]]:
    """Static sequential-halving schedule: [(lanes, passes), ...]. The
    budget splits evenly over ceil(log2 m) phases; leftovers go to the
    final 2-candidate phase, with a trailing 1-lane group for an odd
    remainder, so Σ lanes·passes == budget exactly."""
    if budget < 1 or m < 1:
        raise ValueError(f"budget and m must be >= 1, got {budget}, {m}")
    m = min(m, budget)
    if m < 2:
        return [(1, budget)]
    phases = max(1, (m - 1).bit_length())  # ceil(log2(m))
    groups: List[Tuple[int, int]] = []
    left, mk = budget, m
    while mk >= 2 and left >= mk:
        if mk <= 2:            # final phase: spend everything left
            per = left // mk
        else:
            per = max(1, (budget // phases) // mk)
        per = min(per, left // mk)
        if per == 0:
            break
        groups.append((mk, per))
        left -= mk * per
        mk = max(2, mk // 2)
    if left > 0:
        groups.append((1, left))
    return groups


def _sigma_q(n0: torch.Tensor, q: torch.Tensor, c_visit: float,
             c_scale: float) -> torch.Tensor:
    """σ(q) = (c_visit + max_b N(b)) · c_scale · q  (paper eq. 8)."""
    max_n = n0.max(dim=-1, keepdim=True).values
    return (c_visit + max_n) * c_scale * q


def _pi_target(root_logits, root_legal, root_p, root_v, n0, q,
               c_visit: float, c_scale: float) -> torch.Tensor:
    """Improved policy π' = softmax(logits + σ(completed Q)): unvisited
    actions complete with v_mix = (v_net + ΣN · Σ_visited π q /
    Σ_visited π) / (1 + ΣN). Inputs are action-space [E, A] (q is W/N
    where visited, else 0)."""
    n_sum = n0.sum(-1)
    visited = n0 > 0
    pi_vis = torch.where(visited, root_p, 0.0)
    sum_pi_vis = pi_vis.sum(-1)
    wq = (pi_vis * q).sum(-1) / sum_pi_vis.clamp(min=1e-30)
    v = root_v.float()
    v_mix = torch.where(sum_pi_vis > 0, (v + n_sum * wq) / (1.0 + n_sum), v)
    completed = torch.where(visited, q, v_mix[:, None])
    return masked_softmax(
        root_logits + _sigma_q(n0, completed, c_visit, c_scale), root_legal)


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k best per row, best first, ties to the lower index
    (``lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _gumbel_noise(shape, generator, add_noise: bool,
                  gumbel: Optional[torch.Tensor], device) -> torch.Tensor:
    """g [E, A]: the injected table, a Gumbel draw, or zeros."""
    if gumbel is not None:
        return gumbel.to(device=device, dtype=torch.float32)
    if not add_noise:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _root(evaluate: Evaluator, state: EnvState, generator, add_noise: bool,
          gumbel: Optional[torch.Tensor]):
    """Root forward and Gumbel scores: (logits, value, legal, priors,
    g + logits with illegal = -inf)."""
    with trace.span("root_forward"):
        root_logits, root_v = evaluate(state.board, state.to_play,
                                       state.last_move)
    root_logits = root_logits.float()
    root_legal = state.board == 0
    root_p = masked_softmax(root_logits, root_legal)
    g = _gumbel_noise(root_legal.shape, generator, add_noise, gumbel,
                      state.board.device)
    glogits = torch.where(root_legal, g + root_logits, float("-inf"))
    return root_logits, root_v, root_legal, root_p, glogits


def _budget(mcts_cfg: MCTSConfig, num_simulations: Optional[int]):
    """(sims, node count, depth cap, fixed-point W, W scale, prior dtype).
    ``backup_interval`` is not read: as in JAX, the Gumbel driver scatters
    every pass."""
    sims = int(num_simulations or mcts_cfg.num_simulations)
    nn = sims + 1
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    fixed_w = mcts_cfg.value_dtype == "int16" and nn <= 511
    prior_dtype = (torch.bfloat16 if mcts_cfg.prior_dtype == "bfloat16"
                   else torch.float32)
    return sims, nn, depth_limit, fixed_w, 64.0 if fixed_w else 1.0, \
        prior_dtype


@torch.no_grad()
def run_gumbel_mcts(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                    evaluate: Evaluator, state: EnvState,
                    generator: Optional[torch.Generator] = None, *,
                    num_simulations: Optional[int] = None,
                    add_noise: bool = True,
                    gumbel: Optional[torch.Tensor] = None) -> GumbelResult:
    """Gumbel sequential-halving search of every env's current position.
    `add_noise` True draws g from `generator` (self-play); False sets
    g = 0 (deterministic: match play). `gumbel` [E, A] injects g."""
    sims, nn, depth_limit, fixed_w, w_scale, prior_dtype = _budget(
        mcts_cfg, num_simulations)
    with trace.span("search"):
        if mcts_cfg.branch_cap is not None:
            return _run_gumbel_capped(env_cfg, mcts_cfg, evaluate, state,
                                      generator, sims=sims,
                                      add_noise=add_noise, gumbel=gumbel)
        e, a = state.board.shape
        schedule = build_schedule(sims, min(int(mcts_cfg.gumbel_m), a))
        m = schedule[0][0]
        c_puct = float(mcts_cfg.c_puct)
        c_visit = float(mcts_cfg.gumbel_c_visit)
        c_scale = float(mcts_cfg.gumbel_c_scale)

        tree = _tree_init(env_cfg, e, nn, prior_dtype, fixed_w,
                          state.board.device)
        _write_nodes(tree, 0, state)
        root_logits, root_v, root_legal, root_p, glogits = _root(
            evaluate, state, generator, add_noise, gumbel)
        tree.p[:, 0] = torch.where(root_legal, root_p, -1.0).to(prior_dtype)

        # top-m candidates by g + logits; envs with fewer than m legal
        # moves repeat their best candidate
        cand = _top_k(glogits, m)                              # [E, m]
        cand = torch.where(root_legal.gather(1, cand), cand, cand[:, :1])

        def root_stats():
            n0 = tree.n[:, 0].float()
            w0 = tree.w[:, 0].float() / w_scale
            return n0, torch.where(n0 > 0, w0 / n0.clamp(min=1.0), 0.0)

        def cand_scores(cand):
            """g + logits + σ(q̂) at the current candidates ([E, lanes])."""
            n0, q = root_stats()
            return (glogits + _sigma_q(n0, q, c_visit,
                                       c_scale)).gather(1, cand)

        base = 1
        for lb, passes in schedule:
            if cand.shape[1] != lb:  # halve: keep the top-lb survivors
                cand = cand.gather(1, _top_k(cand_scores(cand), lb))
            for _ in range(passes):
                with trace.span("descent"):
                    paths = search._select_one(
                        tree.n, tree.w, tree.p, tree.child, tree.node_done,
                        None, c_puct, depth_limit, 1.0 / w_scale,
                        root_action=cand)
                search._expand_and_backup(
                    env_cfg, evaluate, tree, *paths, base=base,
                    fixed_w=fixed_w, w_scale=w_scale, prior_dtype=prior_dtype,
                    add_visits=True)
                base += lb

        # final action: the best survivor by g + logits + σ(q̂)
        action = cand.gather(1, cand_scores(cand).argmax(dim=1)[:, None])[:, 0]
        n0, q = root_stats()
        n_sum = n0.sum(-1)
        w_root = tree.w[:, 0].float().sum(-1) / w_scale
        root_value = torch.where(n_sum > 0, w_root / n_sum.clamp(min=1.0), 0.0)
        pi_target = _pi_target(root_logits, root_legal, root_p, root_v, n0, q,
                               c_visit, c_scale)
        return GumbelResult(visits=n0, root_value=root_value, priors=root_p,
                            action=action.int(), pi_target=pi_target)


def _run_gumbel_capped(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                       evaluate: Evaluator, state: EnvState, generator, *,
                       sims: int, add_noise: bool,
                       gumbel: Optional[torch.Tensor]) -> GumbelResult:
    """Gumbel sequential halving over the branch-capped slot tree. The
    root's slots 0..m-1 are the top-m candidates by g + logits (below the
    root, slots stay prior-ordered), so halving lane j is root slot j and
    ``search_capped._run_pass`` pins it there. Candidates past an env's
    legal moves map onto slot 0 and share its subtree. Each halving group
    caps its paths at the depth its passes can reach."""
    _, nn, depth_limit, packed, w_scale, prior_dtype = _budget(mcts_cfg,
                                                               sims)
    e, a = state.board.shape
    dev = state.board.device
    c = min(int(mcts_cfg.branch_cap), a)
    schedule = build_schedule(sims, min(int(mcts_cfg.gumbel_m), a, c))
    m = schedule[0][0]
    c_puct = float(mcts_cfg.c_puct)
    c_visit = float(mcts_cfg.gumbel_c_visit)
    c_scale = float(mcts_cfg.gumbel_c_scale)
    if nn > 32767 or c > 256:
        raise ValueError("tree too large: nodes <= 32767 and branch_cap "
                         "<= 256 (paths pack node << 8 | slot)")

    tree = search_capped._capped_tree_init(state, nn, c, packed, prior_dtype)
    root_logits, root_v, root_legal, root_p, glogits = _root(
        evaluate, state, generator, add_noise, gumbel)

    # top-m candidates by g + logits become root slots 0..m-1 (exact: a
    # dropped candidate would get no π' mass); illegal ones map onto slot 0
    cand = _top_k(glogits, m)                                  # [E, m]
    cand_legal = root_legal.gather(1, cand)
    cand_act = torch.where(cand_legal, cand, cand[:, :1])
    cand_slots = torch.where(cand_legal,
                             torch.arange(m, device=dev)[None, :], 0)
    tree.p[:, 0, :m] = torch.where(cand_legal, root_p.gather(1, cand_act),
                                   -1.0).to(prior_dtype)
    tree.cand_act[:, 0, :m] = cand_act.to(torch.int16)
    # g + logits per root slot; pad and illegal slots -inf
    glogits_slot = torch.full((e, c), float("-inf"), device=dev)
    glogits_slot[:, :m] = torch.where(cand_legal, glogits.gather(1, cand_act),
                                      float("-inf"))

    def root_stats():
        row = tree.n[:, 0]
        if packed:
            n0 = (row & 0xFFFF).float()                         # [E, C]
            w0 = (row >> 16).float() / w_scale
        else:
            n0 = row.float()
            w0 = tree.w[:, 0].float() / w_scale
        return n0, w0, torch.where(n0 > 0, w0 / n0.clamp(min=1.0), 0.0)

    def cand_scores(slots):
        """g + logits + σ(q̂) at the current survivor slots ([E, lanes])."""
        n0, _, q = root_stats()
        return (glogits_slot + _sigma_q(n0, q, c_visit, c_scale)).gather(
            1, slots)

    base, done_passes = 1, 0
    for lb, passes in schedule:
        if cand_slots.shape[1] != lb:  # halve: keep the top-lb survivors
            cand_slots = cand_slots.gather(1, _top_k(cand_scores(cand_slots),
                                                     lb))
        # a descent in global pass p records at most p + 1 edges
        d_group = max(1, min(depth_limit, done_passes + passes))
        for _ in range(passes):
            search_capped._run_pass(
                env_cfg, evaluate, tree, base=base, d=d_group, lb=lb, c=c,
                packed=packed, w_scale=w_scale, prior_dtype=prior_dtype,
                c_puct=c_puct, forced_k=0.0, forced_slots=cand_slots)
            base += lb
        done_passes += passes

    # final action: the best surviving slot's action
    act0 = tree.cand_act[:, 0].long()                           # [E, C]
    best = cand_slots.gather(1, cand_scores(cand_slots).argmax(dim=1)[:, None])
    action = act0.gather(1, best)[:, 0]

    # slot stats back onto actions; duplicated slots sum N and W
    n0, w0, _ = root_stats()
    visits = torch.zeros((e, a), dtype=torch.float32, device=dev)
    visits.scatter_add_(1, act0, n0)
    w_a = torch.zeros((e, a), dtype=torch.float32, device=dev)
    w_a.scatter_add_(1, act0, w0)
    q_a = torch.where(visits > 0, w_a / visits.clamp(min=1.0), 0.0)
    n_sum = n0.sum(-1)
    root_value = torch.where(n_sum > 0, w0.sum(-1) / n_sum.clamp(min=1.0),
                             0.0)
    pi_target = _pi_target(root_logits, root_legal, root_p, root_v, visits,
                           q_a, c_visit, c_scale)
    return GumbelResult(visits=visits, root_value=root_value, priors=root_p,
                        action=action.int(), pi_target=pi_target)
