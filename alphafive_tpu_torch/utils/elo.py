"""Elo tracking against a pure-MCTS anchor ladder (port of
``alphafive_tpu/utils/elo.py``, same behaviour).

Anchors are pure-MCTS players at doubling rollout budgets, each with a
fixed rating (anchor 0 = 0 Elo). The per-doubling step was measured by the
JAX package's ``benchmarks/calibrate_elo.py`` round-robin on 9×9 (least
squares over all pairs, mean ≈ 215; see that module's docstring).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

ANCHOR_STEP_ELO = 215.0


@dataclasses.dataclass
class LadderState:
    level: int = 0                 # current anchor index
    base_rollouts: int = 200       # anchor 0 budget
    promote_score: float = 0.85    # move up when score >= this
    max_rollouts: int = 12_800     # stop doubling here (eval cost ∝ budget)
    history: List[dict] = dataclasses.field(default_factory=list)

    @property
    def anchor_rollouts(self) -> int:
        return self.base_rollouts * (2 ** self.level)

    @property
    def anchor_elo(self) -> float:
        return ANCHOR_STEP_ELO * self.level


def performance_elo(score: float, anchor_elo: float,
                    games: Optional[int] = None) -> float:
    """Rating implied by `score` against an `anchor_elo` opponent. With
    `games`, the score is clamped at the sample resolution
    [1/(2n), 1 − 1/(2n)], so a sweep stays finite and the estimate is
    monotone in the win count; without it, at [1e-3, 1 − 1e-3]."""
    lo = 1.0 / (2.0 * games) if games else 1e-3
    s = min(max(score, lo), 1 - lo)
    return anchor_elo - 400.0 * math.log10(1.0 / s - 1.0)


def update_ladder(ladder: LadderState, result: dict,
                  step: int) -> Optional[float]:
    """Record an eval result; maybe climb the ladder. Returns Elo estimate."""
    elo = performance_elo(result["score"], ladder.anchor_elo,
                          games=result.get("games"))
    ladder.history.append({
        "step": step, "level": ladder.level,
        "anchor_rollouts": ladder.anchor_rollouts, **result, "elo": elo,
    })
    if (result["score"] >= ladder.promote_score
            and ladder.anchor_rollouts * 2 <= ladder.max_rollouts):
        ladder.level += 1
    return elo
