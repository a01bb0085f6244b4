"""MCTS over the packed tree layout, descended by the select kernel (port
of ``alphafive_tpu/mcts/search_packed.py``).

Same search as the full-width ``search.run_mcts`` at ``leaf_batch=1`` (one
expansion per simulation, PUCT over sign-masked priors, sign-alternating
backup), but the edge statistics of every env live in ONE f32 array
``[E, NN, 8, A_pad]`` (``ops/select.py``) and each simulation's descent is
one ``select_batch`` call: the CUDA kernel on the card. Node metadata
(boards, players, terminal info) stays in side arrays. Priors and values
are stored in f32 whatever ``prior_dtype``/``value_dtype`` say, as in the
JAX package, so the visits equal the full-width search's only at f32.

The tree is updated in place. Nothing in the simulation loop waits on the
device: the kernel's outputs feed the next ops as tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.env.vector import EnvState
from alphafive_tpu_torch.mcts.search import (Evaluator, SearchResult,
                                             _gather_env, _select_where,
                                             _write_nodes, dirichlet_noise,
                                             masked_softmax)
from alphafive_tpu_torch.ops import select as ps


@dataclasses.dataclass
class PackedTree:
    packed: torch.Tensor        # f32 [E, NN, 8, A_pad] (ops/select.py)
    node_board: torch.Tensor    # int8 [E, NN, A]
    node_done: torch.Tensor     # bool [E, NN]
    node_winner: torch.Tensor   # int8 [E, NN]
    node_to_play: torch.Tensor  # int8 [E, NN]
    node_last: torch.Tensor     # int32 [E, NN]
    node_count: torch.Tensor    # int32 [E, NN]


def _tree_init(env_cfg: EnvConfig, e: int, nn: int,
               device) -> PackedTree:
    a = env_cfg.num_actions
    packed = torch.zeros((e, nn, ps.NUM_SEC, ps.pad_actions(a)),
                         dtype=torch.float32, device=device)
    packed[:, :, ps.SEC_CHILD, :] = -1.0   # unexpanded child pointers
    z = lambda shape, dt, fill=0: torch.full(shape, fill, dtype=dt,
                                             device=device)
    return PackedTree(
        packed=packed,
        node_board=z((e, nn, a), torch.int8),
        node_done=z((e, nn), torch.bool),
        node_winner=z((e, nn), torch.int8),
        node_to_play=z((e, nn), torch.int8, 1),
        node_last=z((e, nn), torch.int32, -1),
        node_count=z((e, nn), torch.int32),
    )


def _signed_priors(p: torch.Tensor, legal: torch.Tensor,
                   a_pad: int) -> torch.Tensor:
    """[E, A] priors → [E, A_pad] sign-masked (illegal/pad = -1)."""
    e, a = p.shape
    out = torch.full((e, a_pad), -1.0, dtype=torch.float32, device=p.device)
    out[:, :a] = torch.where(legal, p, -1.0)
    return out


@torch.no_grad()
def run_mcts_packed(env_cfg: EnvConfig, mcts_cfg: MCTSConfig,
                    evaluate: Evaluator, state: EnvState,
                    generator: Optional[torch.Generator] = None, *,
                    num_simulations: Optional[int] = None,
                    add_noise: bool = True,
                    noise: Optional[torch.Tensor] = None,
                    select: Callable = ps.select_batch,
                    return_tree: bool = False):
    """Packed-tree search; same contract as ``search.run_mcts``.

    `noise` [E, A] replaces the Dirichlet draw from `generator`. `select`
    is the descent (``ops.select.select_batch``; the plain
    ``select_batch_reference`` to compare on the card). With
    `return_tree`, returns ``(SearchResult, PackedTree)``."""
    sims = int(num_simulations or mcts_cfg.num_simulations)
    e, a = state.board.shape
    dev = state.board.device
    nn = sims + 1
    depth_limit = min(nn, mcts_cfg.max_depth or nn)
    a_pad = ps.pad_actions(a)
    c_puct = float(mcts_cfg.c_puct)
    forced_k = float(mcts_cfg.forced_playouts_k) if add_noise else 0.0

    tree = _tree_init(env_cfg, e, nn, dev)
    _write_nodes(tree, 0, state)
    root_logits, _ = evaluate(state.board, state.to_play, state.last_move)
    root_legal = state.board == 0
    root_p = masked_softmax(root_logits, root_legal)
    if add_noise:
        if noise is None:
            noise = dirichlet_noise(generator, mcts_cfg.dirichlet_alpha,
                                    root_legal)
        eps = float(mcts_cfg.dirichlet_eps)
        root_p = (1.0 - eps) * root_p + eps * noise
    packed = tree.packed
    packed[:, 0, ps.SEC_P, :] = _signed_priors(root_p, root_legal, a_pad)
    packed[:, 0, ps.SEC_META, 0] = state.done.float()

    earange = torch.arange(e, device=dev)
    dn = torch.arange(depth_limit, device=dev)[None, :]
    for s in range(sims):
        leaf_parent, sel_act, depth, pn, pa = select(
            packed, a, depth_limit, c_puct, forced_k)
        leaf_parent, depth = leaf_parent.long(), depth.long()
        is_revisit = sel_act < 0
        safe_act = sel_act.clamp(min=0).long()

        parent = _gather_env(tree, leaf_parent)
        stepped = vector.step(env_cfg, parent, safe_act)
        # leaf: the stepped child when expanding, the node itself when
        # revisiting (a step would put a stone on a live depth-capped node)
        leaf = _select_where(is_revisit, parent, stepped)

        new = s + 1
        logits, v = evaluate(leaf.board, leaf.to_play, leaf.last_move)
        leaf_value = torch.where(leaf.done,
                                 (leaf.winner * leaf.to_play).float(),
                                 v.float())
        child_legal = stepped.board == 0
        child_p = masked_softmax(logits, child_legal)
        packed[:, new, ps.SEC_P, :] = _signed_priors(child_p, child_legal,
                                                     a_pad)
        packed[:, new, ps.SEC_META, 0] = stepped.done.float()
        # link parent -> child only for expanding lanes
        old = packed[earange, leaf_parent, ps.SEC_CHILD, safe_act]
        packed[earange, leaf_parent, ps.SEC_CHILD, safe_act] = torch.where(
            is_revisit, old, float(new))

        # backup: edge j of a path of length L gets leaf_value * (-1)^(L-j)
        # and one visit; pad entries add 0 at (node 0, action 0)
        on_path = dn < depth[:, None]
        sign = torch.where((depth[:, None] - dn) % 2 == 0, 1.0, -1.0)
        vals = torch.where(on_path, sign * leaf_value[:, None], 0.0)
        idx = (earange[:, None].expand_as(pn), pn.long(), pa.long())
        packed[:, :, ps.SEC_N].index_put_(idx, on_path.float(),
                                          accumulate=True)
        packed[:, :, ps.SEC_W].index_put_(idx, vals, accumulate=True)
        _write_nodes(tree, new, stepped)

    visits = packed[:, 0, ps.SEC_N, :a].clone()
    w_root = packed[:, 0, ps.SEC_W, :a]
    n_sum = visits.sum(-1)
    root_value = torch.where(n_sum > 0,
                             w_root.sum(-1) / n_sum.clamp(min=1.0), 0.0)
    res = SearchResult(visits=visits, root_value=root_value, priors=root_p)
    return (res, tree) if return_tree else res
