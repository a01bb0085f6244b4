"""Batched MCTS: shared pieces and the ``run_mcts`` dispatch (port of
``alphafive_tpu/mcts/search.py``).

The self-play path runs the branch-capped search
(``mcts/search_capped.py``). The full-width search (``branch_cap=None``)
and the packed-tree search behind ``select_impl="pallas"`` are not ported
yet (ROADMAP Queue 1 item 4, Queue 1 item 17 with Queue 2 item 2);
``run_mcts`` raises for them. Randomness comes from ``torch.Generator``s;
a caller that needs the JAX package's exact noise passes it in as a
tensor (``run_mcts_capped(noise=...)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env.vector import EnvState

# evaluator: (board int8[E,A], to_play int8[E], last int32[E])
#            -> (logits f32[E,A], value f32[E])
Evaluator = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


class SearchResult(NamedTuple):
    visits: torch.Tensor      # f32[E, A] root visit counts
    root_value: torch.Tensor  # f32[E] W(root)/N(root)
    priors: torch.Tensor      # f32[E, A] root priors (after noise)


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


def _puct_scores_n(nf, w_row, p_row, legal, c_puct: float):
    """PUCT with float visit counts (virtual visits already folded in)."""
    q = torch.where(nf > 0, w_row / nf.clamp(min=1.0), 0.0)
    ns = 1.0 + nf.sum(dim=-1, keepdim=True)
    u = c_puct * p_row.float() * torch.sqrt(ns) / (1.0 + nf)
    return torch.where(legal, q + u, float("-inf"))


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


def run_mcts(env_cfg: EnvConfig, mcts_cfg: MCTSConfig, evaluate: Evaluator,
             state: EnvState, generator: Optional[torch.Generator] = None,
             *, num_simulations: Optional[int] = None,
             add_noise: bool = True,
             noise: Optional[torch.Tensor] = None) -> SearchResult:
    """Search every env's current position (roots must not be terminal)."""
    if mcts_cfg.branch_cap is None:
        raise NotImplementedError(
            "full-width search (branch_cap=None) is not ported yet: "
            "ROADMAP Queue 1 item 4")
    if mcts_cfg.select_impl == "pallas":
        raise NotImplementedError(
            "select_impl='pallas' (packed-tree search and its descent "
            "kernel) is not ported yet: ROADMAP Queue 1 item 17, Queue 2 "
            "item 2")
    from alphafive_tpu_torch.mcts.search_capped import run_mcts_capped
    return run_mcts_capped(env_cfg, mcts_cfg, evaluate, state, generator,
                           num_simulations=num_simulations,
                           add_noise=add_noise, noise=noise)
