"""The searches whose answers the check judges, from their equations
(NumPy, one root at a time, moves by ``rules.step``).

``follow_capped`` checks the program's branch-capped PUCT search on a
root step by step, fed what the program recorded: the root's and every
leaf's net outputs, the lanes' paths of each pass, and the root's visit
counts. Net outputs are the program's, judged apart against the
reference net; the search's decisions, its tree and its counts are
worked out again here from the equations:

* A node's prior is the policy softmax of its net logits over the empty
  cells; the root's is mixed with the search's Dirichlet draw as
  ``(1 − ε) p + ε · noise``. A node searches only its ``branch_cap``
  children of highest prior (f32, ties to the lower action); priors are
  stored in bfloat16 where the configuration says so.
* A search of ``sims`` simulations runs ``sims / leaf_batch`` passes of
  ``leaf_batch`` lanes. Lane j descends after lanes 0 … j−1 of its pass
  and counts one virtual visit (no value) on every edge their paths took;
  the tree changes only after the pass. At a node a lane takes a child of
  highest ``Q + c_puct · P · sqrt(1 + ΣN) / (1 + N)`` (``Q = W / N``, 0
  unvisited, over real plus virtual visits); at the root, with forced
  playouts on, first a visited child whose real visits ``n`` have
  ``n² < k · P · Σn``. It stops at a child not yet made (expanding it),
  or at a finished game or the depth cap (evaluating the node again). The
  cap is staged: 8 edges for passes 0–7, then 16, 32, … up to
  ``min(max_depth, passes)``.
* After the pass, two lanes on one new edge make one node (the first
  lane's, numbered ``1 + pass · leaf_batch + lane``); each lane's leaf
  value (a finished game's: its winner from the view of the player to
  move) is backed up: every edge of a path of length L gets one visit and
  the value times (−1)^(L − t) at depth t, in steps of 1/64 where the
  configuration says so.

A choice counts as the program's if its score could be the highest with
each prior anywhere its f32 value, to a relative 1e-5, rounds in
bfloat16: the program's softmax and the reference's differ in the last
bits. Every other departure is a fault: a node, child, stop or leaf
position other than the equations', a choice that is not the highest, a
root visit count other than the replayed tree's.

``gumbel_root``: the one-pass Gumbel root of Danihelka et al. (2022),
where the budget equals the candidates, run on the reference net: the
top-m legal actions by ``g + logits`` are each visited once (an env with
fewer than m legal actions repeats its best), each child's value backed
up as above, and the target is ``softmax(logits + σ(completed Q))`` over
the empty cells, with ``σ(q) = (c_visit + max N) · c_scale · q`` and
unvisited actions completed by ``v_mix = (v + ΣN · Σ_visited π q /
Σ_visited π) / (1 + ΣN)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import rules

f32 = np.float32


def masked_softmax(logits: np.ndarray, legal: np.ndarray) -> np.ndarray:
    """Softmax over the legal entries (f32); zero elsewhere."""
    x = np.where(legal, logits.astype(f32), -np.inf)
    m = x.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, f32(0))
    ex = np.where(legal, np.exp(x - m), f32(0)).astype(f32)
    return (ex / np.maximum(ex.sum(-1, keepdims=True), f32(1e-30))).astype(f32)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """`x` rounded to bfloat16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, f32)).to(
        torch.bfloat16).float().numpy()


def stages(passes: int, d: int):
    """(first pass, end pass, depth cap) of the staged depth cap."""
    out, lo, dc = [], 0, 8
    while lo < passes:
        if dc >= min(d, passes):
            out.append((lo, passes, min(d, passes)))
            break
        out.append((lo, min(passes, dc), dc))
        lo = min(passes, dc)
        dc *= 2
    return out


def _leaf_value(game: rules.Game, v: float) -> f32:
    return f32(game.winner * game.to_play) if game.done else f32(v)


class _Node:
    """A node of the replayed tree: its game, its priors (f32, and the
    bfloat16 values the program's could round to), its capped candidates
    and its edges' visits, value sums and children, by action."""

    __slots__ = ("game", "p", "lo", "hi", "cand", "cut", "n", "w",
                 "children")

    def __init__(self, game, logits, noise, cfg):
        legal = game.board == 0
        p = masked_softmax(logits, legal)
        if noise is not None:
            eps = f32(cfg["eps"])
            p = ((f32(1) - eps) * p + eps * noise.astype(f32)).astype(f32)
        order = np.argsort(-np.where(legal, p, f32(-1)), kind="stable")
        self.cand = order[:cfg["c"]][legal[order[:cfg["c"]]]]
        self.cut = p[self.cand[-1]] if len(self.cand) else f32(0)
        self.game, self.p = game, p
        if cfg["bf16"]:
            self.lo = to_bf16(p * f32(1 - 1e-5))
            self.hi = to_bf16(p * f32(1 + 1e-5))
        else:
            self.lo = self.hi = p
        a = len(p)
        self.n = np.zeros(a, np.int64)
        self.w = np.zeros(a, np.float64)
        self.children: Dict[int, int] = {}

    def action_to(self, node_id: int) -> Optional[int]:
        for a, c in self.children.items():
            if c == node_id:
                return a
        return None

    def could_choose(self, a: int, virt, root: bool, cfg) -> bool:
        """Whether `a` could be the program's choice here."""
        if not (self.game.board[a] == 0
                and self.p[a] >= self.cut * f32(1 - 1e-5)):
            return False
        cand = self.cand if a in self.cand else np.append(self.cand, a)
        n_real = self.n[cand].astype(f32)
        nf = n_real + (virt[cand] if virt is not None else f32(0))
        scale = f32(cfg["value_scale"] or 1.0)
        w = (self.w[cand] / scale).astype(f32)
        q = np.where(nf > 0, w / np.maximum(nf, f32(1)), f32(0))
        root_n = np.sqrt(f32(1) + nf.sum(dtype=f32))
        c = f32(cfg["c_puct"])
        hi = q + c * self.hi[cand] * root_n / (f32(1) + nf)
        lo = q + c * self.lo[cand] * root_n / (f32(1) + nf)
        i = int(np.nonzero(cand == a)[0][0])
        fk = f32(cfg["forced_k"])
        if root and fk > 0:
            total = n_real.sum(dtype=f32)
            forced_hi = (n_real > 0) & (n_real * n_real
                                        < fk * self.hi[cand] * total)
            forced_lo = (n_real > 0) & (n_real * n_real
                                        < fk * self.lo[cand] * total)
            if forced_lo.any():
                return bool(forced_hi[i])
            if forced_hi[i]:
                return True
        return bool(hi[i] >= lo.max() - f32(1e-6) * (f32(1) + abs(lo.max())))


def _same(game: rules.Game, board, to_play, last) -> bool:
    return (np.array_equal(game.board, board) and game.to_play == int(to_play)
            and game.last == int(last))


def _placed(game: rules.Game, board) -> Optional[int]:
    """The one cell where `board` holds a stone of the player to move and
    the game's board is empty, or None."""
    diff = np.nonzero(board != game.board)[0]
    if len(diff) != 1 or game.board[diff[0]] != 0 \
            or board[diff[0]] != game.to_play:
        return None
    return int(diff[0])


def follow_capped(game: rules.Game, noise: Optional[np.ndarray],
                  root_logits: np.ndarray, passes: List[Dict],
                  visits: np.ndarray, cfg: Dict) -> int:
    """The faults of the program's capped search of `game`: `passes`
    holds, per pass, its lanes' packed paths ``ppas`` [lb, D] (node << 8
    | slot), path lengths ``deps``, chosen slots ``sel`` (−1: a revisit),
    last nodes ``lps``, and the leaves it evaluated (``board``,
    ``to_play``, ``last``) with the net's ``logits`` and ``value``."""
    nodes = {0: _Node(game, root_logits, noise, cfg)}
    faults, lb, a_n = 0, cfg["lb"], cfg["size"] ** 2
    n_pass = cfg["sims"] // lb
    caps = [d for lo, hi, d in stages(n_pass, cfg["depth"])
            for _ in range(lo, hi)]
    if len(passes) != n_pass:
        return 1 + abs(len(passes) - n_pass)
    scale = f32(cfg["value_scale"] or 1.0)
    for k, rec in enumerate(passes):
        d, base = caps[k], 1 + k * lb
        virt: Dict[int, np.ndarray] = {}
        lanes = []
        for j in range(lb):
            dep, sel = int(rec["deps"][j]), int(rec["sel"][j])
            path = [(int(x) >> 8, int(x) & 255) for x in rec["ppas"][j][:dep]]
            steps, leaf, cur = [], None, 0
            for t, (pn, _) in enumerate(path):
                node = nodes.get(pn)
                if pn != cur or node is None or node.game.done or t >= d:
                    faults += 1
                    break
                if t + 1 < dep:
                    a = node.action_to(path[t + 1][0])
                elif sel >= 0:
                    a = _placed(node.game, rec["board"][j])
                    if a is not None and a in node.children:
                        a = None     # it should have gone on down
                else:
                    a = node.action_to(int(rec["lps"][j]))
                if a is None:
                    faults += 1
                    break
                if not node.could_choose(a, virt.get(pn), t == 0, cfg):
                    faults += 1
                steps.append((pn, a))
                cur = node.children.get(a, -1)
            else:
                if sel >= 0 and dep > 0:
                    pn, a = steps[-1]
                    leaf = rules.step(nodes[pn].game, a, cfg["size"],
                                      cfg["n_in_row"], cfg["rules"])
                elif sel < 0:
                    node = nodes.get(cur)
                    if (node is not None and cur == int(rec["lps"][j])
                            and (node.game.done or dep >= d)):
                        leaf = node.game
                if leaf is None or not _same(leaf, rec["board"][j],
                                             rec["to_play"][j],
                                             rec["last"][j]):
                    faults += 1
                    leaf = None
            for pn, a in steps:
                virt.setdefault(pn, np.zeros(a_n, f32))[a] += 1
            lanes.append((steps, leaf, sel >= 0))
        made = {}
        for j, (steps, leaf, expands) in enumerate(lanes):
            if leaf is None:
                continue
            if expands and steps[-1] not in made:
                made[steps[-1]] = base + j
                nodes[steps[-1][0]].children[steps[-1][1]] = base + j
                nodes[base + j] = _Node(leaf, rec["logits"][j], None, cfg)
            value = _leaf_value(leaf, rec["value"][j])
            for t, (pn, a) in enumerate(steps):
                val = value if (len(steps) - t) % 2 == 0 else -value
                nodes[pn].n[a] += 1
                nodes[pn].w[a] += (np.round(f32(val) * scale)
                                   if cfg["value_scale"] else f32(val))
    return faults + int((nodes[0].n != np.asarray(visits).round()).sum())


def search_config(env, mcts, add_noise: bool) -> Dict:
    """The capped search's settings from the configuration's env and
    search settings (with the program's field names)."""
    sims = int(mcts.num_simulations)
    a = int(env.board_size) ** 2
    lb = max(1, int(mcts.leaf_batch))
    while sims % lb:
        lb -= 1
    nn = sims + 1
    packed = mcts.value_dtype == "int16" and nn <= 511
    return {"sims": sims, "lb": lb, "c": min(int(mcts.branch_cap), a),
            "depth": min(nn, mcts.max_depth or nn),
            "c_puct": float(mcts.c_puct), "eps": float(mcts.dirichlet_eps),
            "forced_k": float(mcts.forced_playouts_k if add_noise else 0.0),
            "bf16": mcts.prior_dtype == "bfloat16",
            "value_scale": 64.0 if packed else None,
            "size": int(env.board_size), "n_in_row": int(env.n_in_row),
            "rules": env.rules}


def _evaluate_games(evaluate, games: List[rules.Game]):
    board = np.stack([g.board for g in games]).astype(np.int8)
    to_play = np.array([g.to_play for g in games], np.int8)
    last = np.array([g.last for g in games], np.int32)
    logits, value = evaluate(board, to_play, last)
    return np.asarray(logits, f32), np.asarray(value, f32)


def gumbel_config(env, mcts) -> Dict:
    """The Gumbel root's settings (the program's field names)."""
    sims = int(mcts.num_simulations)
    m = min(int(mcts.gumbel_m), int(env.board_size) ** 2, sims)
    if mcts.branch_cap is not None or m != sims:
        raise NotImplementedError(
            "the reference Gumbel root covers the one-pass full-width root "
            "(budget = candidates, no branch cap)")
    packed = mcts.value_dtype == "int16" and sims + 1 <= 511
    return {"m": m, "c_visit": float(mcts.gumbel_c_visit),
            "c_scale": float(mcts.gumbel_c_scale),
            "value_scale": 64.0 if packed else None,
            "size": int(env.board_size), "n_in_row": int(env.n_in_row),
            "rules": env.rules}


def gumbel_root(games: List[rules.Game], gumbel: np.ndarray,
                evaluate: Callable, cfg: Dict):
    """(improved policy f32[K, A], action int64[K]) of each root, given
    its Gumbel draw `gumbel` f32[K, A]."""
    k, a, m = len(games), cfg["size"] ** 2, cfg["m"]
    scale = f32(cfg["value_scale"] or 1.0)
    logits, v_root = _evaluate_games(evaluate, games)
    legal = np.stack([g.board == 0 for g in games])
    root_p = masked_softmax(logits, legal)
    glog = np.where(legal, gumbel.astype(f32) + logits, -np.inf).astype(f32)
    cand = np.argsort(-glog, axis=1, kind="stable")[:, :m]
    cand = np.where(np.take_along_axis(legal, cand, 1), cand, cand[:, :1])
    children = [rules.step(g, int(x), cfg["size"], cfg["n_in_row"],
                           cfg["rules"]) for g, row in zip(games, cand)
                for x in row]
    _, v = _evaluate_games(evaluate, children)
    n0 = np.zeros((k, a), f32)
    w = np.zeros((k, a), f32)
    for i in range(k):
        for j in range(m):
            val = -_leaf_value(children[i * m + j], v[i * m + j])
            n0[i, cand[i, j]] += 1
            w[i, cand[i, j]] += (np.round(val * scale) / scale
                                 if cfg["value_scale"] else val)
    q = np.where(n0 > 0, w / np.maximum(n0, f32(1)), f32(0)).astype(f32)
    sigma = lambda x: ((f32(cfg["c_visit"]) + n0.max(-1, keepdims=True))
                       * f32(cfg["c_scale"]) * x).astype(f32)
    visited = n0 > 0
    pi_vis = np.where(visited, root_p, f32(0))
    s_pi = pi_vis.sum(-1)
    wq = (pi_vis * q).sum(-1) / np.maximum(s_pi, f32(1e-30))
    n_sum = n0.sum(-1)
    v_mix = np.where(s_pi > 0, (v_root + n_sum * wq) / (f32(1) + n_sum),
                     v_root).astype(f32)
    completed = np.where(visited, q, v_mix[:, None])
    pi = masked_softmax(logits + sigma(completed), legal)
    score = np.take_along_axis(glog + sigma(q), cand, 1)
    action = np.take_along_axis(cand, score.argmax(1)[:, None], 1)[:, 0]
    return pi, action
