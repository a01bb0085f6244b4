"""Branch-capped batched MCTS over slot-indexed trees (port of
``alphafive_tpu/mcts/search_capped.py``).

Every node stores only its top-``branch_cap`` children by prior, so edge
arrays are [E, NN, C]. A search runs in passes of ``leaf_batch`` lanes:
a wavefront PUCT descent of all lanes with full-path virtual visits, one
batched env.step and one batched net forward over the E·lb leaves,
deduplicated expansion, and one backup scatter. Semantics are the JAX
package's, step for step; the port differs only in mechanics:

* The tree is updated in place (JAX rebuilds immutable arrays).
* The wavefront ``while_loop`` is a Python loop with one host sync per
  step (``stopped.all()``).
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

Not ported: deferred backup (``backup_interval=2`` raises) and the Gumbel
search's ``forced_slots`` hook.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts.search import (Evaluator, SearchResult,
                                             _puct_scores_n, dirichlet_noise,
                                             masked_softmax)


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


def _select_lanes(stat_a, stat_b, tree_p, tree_child, tree_done, c_puct,
                  depth_limit, w_inv_scale, forced_k, num_slots, packed, lb):
    """Wavefront PUCT descent of all ``lb`` lanes of a pass.

    Lane j starts at step j and every active lane takes one step per
    iteration, so while lane j is active its depth is exactly k - j. Virtual
    visits are computed from the lanes' recorded paths: every node has a
    unique depth, so lane j standing at ``cur`` can only meet another
    lane's path entry at index k - j (see the JAX docstring for the
    argument). The tree is read-only here.

    Returns (lps [E,LB] leaf-parent nodes, slots [E,LB] chosen slot or -1
    for revisits, deps [E,LB] path lengths, ppas [E,LB,D] packed
    (node << 8 | slot) path entries)."""
    d = depth_limit
    e = tree_done.shape[0]
    dev = tree_done.device
    eidx = torch.arange(e, device=dev)[:, None]                 # [E,1]
    lanes = torch.arange(lb, device=dev)
    slot_ar = torch.arange(num_slots, device=dev)
    tri = lanes[:, None] < lanes[None, :]                       # [LBi,LBj]

    cur = torch.zeros((e, lb), dtype=torch.long, device=dev)
    depth = torch.zeros((e, lb), dtype=torch.long, device=dev)
    stopped = torch.zeros((e, lb), dtype=torch.bool, device=dev)
    sel = torch.full((e, lb), -1, dtype=torch.long, device=dev)
    ppas = torch.zeros((e, lb, d), dtype=torch.long, device=dev)
    k = 0
    while not bool(stopped.all()):
        active = (lanes[None, :] <= k) & ~stopped               # [E,LB]
        revisit = tree_done[eidx, cur] | (depth >= d)
        p_signed = tree_p[eidx, cur].float()                    # [E,LB,C]
        legal = p_signed >= 0
        if packed:
            row = stat_a[eidx, cur]                             # [E,LB,C]
            nf_real = (row & 0xFFFF).float()
            w_row = (row >> 16).float() * w_inv_scale
        else:
            nf_real = stat_a[eidx, cur].float()
            w_row = stat_b[eidx, cur].float() * w_inv_scale
        p_row = p_signed.clamp(min=0.0)

        # path entry of lane i at lane j's depth k - j: ent[e,i,j]
        dsel = (k - lanes).clamp(0, d - 1)                      # [LBj]
        ent = ppas[:, :, dsel]                                  # [E,LBi,LBj]
        match = (tri[None]
                 & (depth[:, :, None] > depth[:, None, :])
                 & ((ent >> 8) == cur[:, None, :]))             # [E,LBi,LBj]
        virt = (match[..., None]
                & ((ent & 255)[..., None] == slot_ar)).sum(dim=1).float()

        nf = nf_real + virt
        score = _puct_scores_n(nf, w_row, p_row, legal, c_puct)
        # forced-playout gate on REAL visits only
        forced = (legal & (depth == 0)[..., None] & (nf_real > 0)
                  & (nf_real * nf_real
                     < forced_k * p_row * nf_real.sum(dim=-1, keepdim=True)))
        score = torch.where(forced, float("inf"), score)
        s = score.argmax(dim=-1)                                # [E,LB]
        ch = tree_child[eidx, cur, s].long()
        stop_now = revisit | (ch < 0)
        rec = active & ~revisit
        # each (lane, depth) entry is written at most once
        ppas[:, lanes, dsel] += torch.where(rec, (cur << 8) | s, 0)
        depth = depth + rec.long()
        sel = torch.where(active & stop_now,
                          torch.where(revisit, -1, s), sel)
        stopped = stopped | (active & stop_now)
        cur = torch.where(active & ~stop_now, ch, cur)
        k += 1
    return cur, sel, depth, ppas


def _run_pass(env_cfg, evaluate, tree: CappedTree, *, base, d, lb, c,
              packed, w_scale, prior_dtype, c_puct, forced_k) -> None:
    """One leaf-parallel pass: wavefront select of `lb` lanes, batched
    env.step + net forward, dedup expansion at node ids [base, base + lb),
    backup scatter. Updates `tree` in place."""
    e = tree.node_done.shape[0]
    dev = tree.node_done.device
    lps, slots, deps, ppas = _select_lanes(
        tree.n, tree.n if packed else tree.w, tree.p, tree.child,
        tree.node_done, c_puct, d, 1.0 / w_scale, forced_k, c, packed, lb)
    pns, pas = ppas >> 8, ppas & 255                            # [E,lb,D]

    is_revisit = slots < 0
    safe_slot = slots.clamp(min=0)
    eidx2 = torch.arange(e, device=dev)[:, None]
    safe_act = tree.cand_act[eidx2, lps, safe_slot].long()

    parent = EnvState(
        board=tree.node_board[eidx2, lps],
        to_play=tree.node_to_play[eidx2, lps],
        last_move=tree.node_last[eidx2, lps],
        move_count=tree.node_count[eidx2, lps],
        done=tree.node_done[eidx2, lps],
        winner=tree.node_winner[eidx2, lps],
    )
    flat = lambda x: x.reshape((e * lb,) + x.shape[2:])
    unflat = lambda x: x.reshape((e, lb) + x.shape[1:])
    stepped = vector.step(env_cfg, parent.map(flat),
                          flat(safe_act)).map(unflat)

    def sel_(a_, b_):
        m = is_revisit.reshape(is_revisit.shape + (1,) * (a_.dim() - 2))
        return torch.where(m, a_, b_)

    leaf = EnvState(**{f.name: sel_(getattr(parent, f.name),
                                    getattr(stepped, f.name))
                       for f in dataclasses.fields(EnvState)})

    # duplicate expansions (two lanes stopping at the same unexpanded
    # edge) all link to the first lane's node id
    edge_key = lps * c + safe_slot
    expanding = ~is_revisit
    same = ((edge_key[:, :, None] == edge_key[:, None, :])
            & expanding[:, :, None] & expanding[:, None, :])
    jj = torch.arange(lb, device=dev)
    first_lane = torch.where(same, jj[None, None, :], lb).min(dim=-1).values
    is_first = expanding & (first_lane == jj[None, :])
    link_add = torch.where(is_first, base + first_lane + 1, 0).int()

    # ONE batched evaluation per pass
    logits_f, v_f = evaluate(flat(leaf.board), flat(leaf.to_play),
                             flat(leaf.last_move))
    logits, v = unflat(logits_f), unflat(v_f)
    leaf_value = torch.where(leaf.done,
                             (leaf.winner * leaf.to_play).float(), v.float())
    child_legal = stepped.board == 0
    child_p = masked_softmax(logits, child_legal)
    slot_p, slot_act = _top_c(torch.where(child_legal, child_p, -1.0), c,
                              prior_dtype)

    new = slice(base, base + lb)
    tree.node_board[:, new] = stepped.board
    tree.node_to_play[:, new] = stepped.to_play
    tree.node_last[:, new] = stepped.last_move
    tree.node_count[:, new] = stepped.move_count
    tree.node_done[:, new] = stepped.done
    tree.node_winner[:, new] = stepped.winner
    tree.p[:, new] = slot_p
    tree.cand_act[:, new] = slot_act
    # child starts at -1 and no selected edge has a child yet, so adding
    # link + 1 writes the link; revisit and duplicate lanes add 0
    tree.child.index_put_((eidx2.expand_as(lps), lps, safe_slot), link_add,
                          accumulate=True)

    # backup: edge j of a path of length L gets leaf_value * (-1)^(L - j)
    # and one visit; pad entries add 0 at (0, 0)
    dn = torch.arange(d, device=dev)[None, None, :]
    on_path = dn < deps[:, :, None]
    sign = torch.where((deps[:, :, None] - dn) % 2 == 0, 1.0, -1.0)
    vals = torch.where(on_path, sign * leaf_value[:, :, None], 0.0)
    idx = (torch.arange(e, device=dev)[:, None, None].expand_as(pns), pns,
           pas)
    if packed:
        pw = torch.round(vals * w_scale).int()
        tree.n.index_put_(idx, pw * 65536 + on_path.int(), accumulate=True)
    else:
        tree.n.index_put_(idx, on_path.int(), accumulate=True)
        tree.w.index_put_(idx, vals, accumulate=True)


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
    if int(mcts_cfg.backup_interval) != 1:
        raise ValueError("backup_interval != 1 (deferred backup) is not "
                         "ported: ROADMAP Queue 1 item 18")
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

    z = lambda shape, dt, fill=0: torch.full(shape, fill, dtype=dt,
                                             device=dev)
    tree = CappedTree(
        n=z((e, nn, c), torch.int32),
        w=None if packed else z((e, nn, c), torch.float32),
        p=z((e, nn, c), prior_dtype, -1.0),
        child=z((e, nn, c), torch.int32, -1),
        cand_act=z((e, nn, c), torch.int16),
        node_done=z((e, nn), torch.bool),
        node_winner=z((e, nn), torch.int8),
        node_to_play=z((e, nn), torch.int8, 1),
        node_last=z((e, nn), torch.int32, -1),
        node_count=z((e, nn), torch.int32),
        node_board=z((e, nn, a), torch.int8),
    )
    tree.node_board[:, 0] = state.board
    tree.node_to_play[:, 0] = state.to_play
    tree.node_last[:, 0] = state.last_move
    tree.node_count[:, 0] = state.move_count
    tree.node_done[:, 0] = state.done
    tree.node_winner[:, 0] = state.winner

    root_logits, _ = evaluate(state.board, state.to_play, state.last_move)
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
    for lo, hi, d in _stages(passes, depth_limit):
        for p_ in range(lo, hi):
            _run_pass(env_cfg, evaluate, tree, base=1 + p_ * lb, d=d, lb=lb,
                      c=c, packed=packed, w_scale=w_scale,
                      prior_dtype=prior_dtype, c_puct=c_puct,
                      forced_k=forced_k)

    # slot visit counts back onto the action space
    if packed:
        n0 = (tree.n[:, 0, :] & 0xFFFF).float()                 # [E, C]
        w_root = (tree.n[:, 0, :] >> 16).float().sum(-1) / w_scale
    else:
        n0 = tree.n[:, 0, :].float()
        w_root = tree.w[:, 0, :].sum(-1) / w_scale
    act0 = tree.cand_act[:, 0, :].long()
    visits = torch.zeros((e, a), dtype=torch.float32, device=dev)
    visits.scatter_add_(1, act0, n0)
    n_sum = n0.sum(-1)
    root_value = torch.where(n_sum > 0, w_root / n_sum.clamp(min=1.0), 0.0)
    return SearchResult(visits=visits, root_value=root_value, priors=root_p)
