"""Typed configuration with named presets.

A copy of ``alphafive_tpu/config.py`` (copied, not imported: that package
imports jax). ``to_json()`` is byte-equal to the JAX package's for every
preset, so checkpoints and bundles load in both. ``apply_overrides`` adds
the ``--set section.field=value`` parsing of the CLIs.

The reference keeps hyperparameters in a module of constants (SURVEY.md §1 L0,
§2 "Config": board_size, n_in_row=5, c_puct, n_playout≈400, temperature decay,
Dirichlet α≈0.3/ε=0.25, lr schedule, L2≈1e-4, buffer/batch size, res-blocks).
Here they are frozen dataclasses with presets matching the five benchmark
configs in BASELINE.json:6-12, CLI-overridable, and serialized into every
checkpoint (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

FREESTYLE = "freestyle"  # >=5 in a row wins (reference rules, SURVEY.md §2)
RENJU_LITE = "renju_lite"  # black needs exactly 5; black overline is a loss
# Renju forbidden-move rules for black: overline, double-four and
# double-three all lose (exact five wins and takes precedence); white plays
# unrestricted and wins with >=5. Open threes are detected non-recursively
# (RIF's "the straight-four point must itself not be forbidden" recursion
# is out of scope — it changes outcomes only in rare nested positions);
# see env/scalar.py for the operational definitions.
RENJU = "renju"


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Board-engine parameters (SURVEY.md §1 L1)."""

    board_size: int = 15
    n_in_row: int = 5
    rules: str = FREESTYLE

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Residual policy-value net (SURVEY.md §1 L3, §2 "Policy-value net")."""

    blocks: int = 4
    channels: int = 64
    value_hidden: int = 64
    compute_dtype: str = "bfloat16"  # params stay float32
    use_pallas: bool = False  # fused Pallas residual blocks (inference path)


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """Batched array-MCTS parameters (SURVEY.md §1 L2, §2 "MCTS player")."""

    num_simulations: int = 400
    c_puct: float = 5.0
    dirichlet_alpha: float = 0.3
    dirichlet_eps: float = 0.25
    # τ=1 sampling for the first `temperature_moves` plies of each game, then
    # greedy (the reference family's temperature decay, SURVEY.md §2 Config).
    temperature_moves: int = 8
    # Selection-depth cap: descents longer than this are treated as leaf
    # revisits (mctx-style truncation). None = exact (sims+1) — required by
    # the oracle-parity tests; perf presets cap it so path buffers and the
    # backup scatter stay O(cap) instead of O(sims).
    max_depth: Optional[int] = None
    # Tree prior storage dtype: "float32" (exact, parity tests) or
    # "bfloat16" (halves the largest tree array on big perf configs).
    prior_dtype: str = "float32"
    # Tree value-sum storage: "float32" (exact) or "int16" (fixed-point,
    # 1/64 steps — needs num_simulations < 512; max quantization error on
    # Q is ~0.01, negligible vs c_puct exploration noise). Halves the
    # largest remaining array the select loop relays out per simulation.
    value_dtype: str = "float32"
    # Playout cap randomization (KataGo, PAPERS.md "Accelerating Self-Play
    # Learning in Go"): when small_simulations > 0, each lockstep ply runs
    # the full budget with probability full_sim_fraction (π becomes a
    # training target) and a cheap small_simulations search otherwise
    # (value-only position). Off by default.
    small_simulations: int = 0
    full_sim_fraction: float = 0.25
    # Forced playouts + policy target pruning (KataGo §3.4): during noisy
    # self-play search, a root child with n > 0 is force-selected while
    # n < sqrt(k · p · Σn); at π extraction the forced share is subtracted
    # from non-best children (train/actor.py). 0 disables (exact PUCT).
    # Approximation vs KataGo: the FULL theoretical quota is subtracted,
    # not just playouts actually identified as forced, so strong non-best
    # children are pruned slightly harder than KataGo would (biasing π a
    # little toward the argmax move). Accepted: tracking per-playout
    # forcedness would need an extra [E,A] carry through the sim loop.
    forced_playouts_k: float = 0.0
    # Selection implementation: "xla" (vmapped while_loop) or "pallas"
    # (packed-tree descent kernel, ops/pallas_select.py). Identical search
    # results; different perf/memory trade (see search_packed.py).
    select_impl: str = "xla"
    # Leaf-parallel search (virtual-visit MCTS): each pass selects
    # `leaf_batch` leaves per env (+1 virtual visits on the ROOT edges
    # between descents so lanes diverge — see search._select_one for why
    # root-only), expands them, and evaluates all E·leaf_batch leaves in
    # ONE net forward. Amortizes both the per-simulation forward launch
    # and the tree-array relayout traffic (docs/PERFORMANCE.md).
    # leaf_batch=1 is bit-identical to sequential MCTS (the oracle-parity
    # tests run there); >1 trades a slightly stale-statistics search for
    # large throughput (equal-budget strength A/B in docs/PERFORMANCE.md).
    leaf_batch: int = 1
    # How lanes within a pass diverge (leaf_batch > 1 only):
    #   "path" — +1 virtual visit on EVERY traversed edge between descents
    #            (classic virtual-visit MCTS; costs one visit-array scatter
    #            + relayout per descent, measured ~20% slower than "root"
    #            at the headline config, but keeps deep descents diverging
    #            — markedly stronger at equal budget, docs/PERFORMANCE.md).
    #   "root" — virtual visits on the root edges only (cheapest; lanes
    #            can collapse onto the same deep leaf).
    virtual_mode: str = "path"
    # Branch cap: when set, each node tracks only its top-`branch_cap`
    # children by prior (slot-indexed edge arrays [E, NN, C] instead of
    # action-indexed [E, NN, A]). Cuts the tree's scatter/relayout traffic
    # — the measured throughput bottleneck — by A/C. Approximation: a
    # node's children outside its top-C priors are never searched
    # (KataGo-style policy pruning). How tight the cap can go depends on
    # POLICY QUALITY: when the net confidently misranks a defense below
    # slot C, the capped search can never find it. Measured at 15×15/400
    # sims with the bundled net: C=64 costs ~150 Elo at equal budget,
    # C=128 is Elo-neutral (docs/PERFORMANCE.md) — perf presets use 128.
    # None = exact full-width (parity tests).
    branch_cap: Optional[int] = None
    # Root action selection / policy-target scheme:
    #   "puct"   — classic AlphaZero root (Dirichlet noise + temperature
    #              sampling over visit counts) — the reference family's
    #              behavior (SURVEY.md §2 "MCTS player").
    #   "gumbel" — Gumbel root search with sequential halving (Danihelka
    #              et al. 2022, "Policy Improvement by Planning with
    #              Gumbel"; mcts/gumbel.py). Exploration comes from Gumbel
    #              noise on the root logits instead of Dirichlet+temperature,
    #              the played action is the halving winner, and the policy
    #              target is the improved policy softmax(logits + σ(completed
    #              Q)) — the known technique that keeps very low simulation
    #              budgets (≤32, the only physically 1M-aggregate-capable
    #              regime — docs/NORTH_STAR.md §3) producing sound policy
    #              improvement. TPU-native fit: the halving survivors ARE
    #              the leaf-parallel lanes (each pass visits every survivor
    #              once, distinct root children ⇒ no virtual-visit machinery).
    root_selection: str = "puct"
    # Backup-scatter cadence in passes (packed int16 mode only). 2 =
    # DEFERRED backup: odd passes skip their [E,NN,C] stats scatter and
    # the next pass folds their results into PUCT through the select
    # loop's depth-unique lookup, materializing both in one scatter —
    # bit-identical search (tests/test_mcts.py::
    # test_deferred_backup_bit_identical), half the scatter traffic
    # (the largest non-matmul op of the pass profile,
    # docs/PERFORMANCE.md "Known headroom"). 1 = scatter every pass.
    backup_interval: int = 1
    # Max root candidates considered by the Gumbel search (m in the paper;
    # power of two). The effective m is min(gumbel_m, budget).
    gumbel_m: int = 16
    # σ(q) = (c_visit + max_b N(b)) · c_scale · q — the paper's monotone
    # Q transform used in scores and the improved-policy target.
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """On-device ring replay buffer (SURVEY.md §1 L4)."""

    capacity: int = 200_000
    batch_size: int = 512
    min_fill: int = 2_048


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Actor-learner loop parameters (SURVEY.md §1 L5/L6)."""

    num_envs: int = 256
    selfplay_plies_per_iter: int = 32  # lockstep plies collected per iteration
    learner_steps_per_iter: int = 4
    learning_rate: float = 2e-3
    lr_warmup_steps: int = 100
    l2_coef: float = 1e-4
    momentum: float = 0.9  # unused by adam; kept for sgd option
    optimizer: str = "adam"
    value_loss_weight: float = 1.0
    # KL-adaptive lr multiplier target (SURVEY.md §3.1 reference-family
    # `policy_update`): KL(π_old‖π_new) per update phase steers lr_scale.
    kl_target: float = 0.02
    # Cap on the KL-adaptive lr multiplier. 10 matches the reference-family
    # clamp; hard configs use a lower cap because a degenerate (bias-only)
    # policy also yields tiny update-KL, which the controller misreads as
    # "lr too small" and amplifies (the round-3 19×19 collapse cycle —
    # train/learner.py docstring).
    lr_scale_max: float = 10.0
    # KL early-stop INSIDE the update phase (SURVEY.md §3.1: the reference
    # breaks out of its ~5 update epochs when KL(π_old‖π_new) exceeds a
    # multiple of the target — the guard-rail that aborts a too-big
    # update). When > 0, each learner step probes KL against the
    # phase-start policy and the remaining steps of the phase are masked
    # once KL > kl_stop_factor * kl_target. 0 disables (no probe forwards).
    kl_stop_factor: float = 0.0
    seed: int = 0
    eval_every_iters: int = 50
    eval_games: int = 32
    eval_simulations: int = 0  # 0 → use mcts.num_simulations
    # Ladder promotion stops doubling the anchor budget here. Besides eval
    # cost, single-call duration matters on watchdogged remote-TPU
    # runtimes: one 12800-rollout anchor search per device call exceeded
    # the ~60s kill threshold and crash-looped a training run (round 2).
    max_anchor_rollouts: int = 12_800
    # Once the anchor ladder is maxed AND the net sweeps it, the ladder
    # carries no further strength signal (the round-4 19×19 run "flew
    # blind" past iter 249). The gate then switches to NET-VS-NET: the
    # current net plays the stored best model (workdir/best_model) under
    # the same search config, and is promoted to best on score >= this
    # threshold (the reference family's new-vs-best gate, SURVEY.md §3.5).
    best_gate_score: float = 0.55
    checkpoint_every_iters: int = 50
    total_iters: int = 1_000


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (SURVEY.md §2 parallelism table, §5.8)."""

    data: int = 1  # data-parallel axis size (envs + learner batch sharded)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str = "default"
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    net: NetConfig = dataclasses.field(default_factory=NetConfig)
    mcts: MCTSConfig = dataclasses.field(default_factory=MCTSConfig)
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        return _from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def _known(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Drop keys the dataclass no longer has: configs are serialized into
    every checkpoint/export, so fields REMOVED from a config class (e.g.
    the dead `train.eval_rollouts` knob, round 5) must not break loading
    artifacts written while they existed. Unknown keys are ignored, not
    errors — the restored value of a removed field is its removal, and
    new fields absent from old artifacts already default via **kwargs."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _from_dict(d: Dict[str, Any]) -> RunConfig:
    return RunConfig(
        name=d.get("name", "default"),
        env=EnvConfig(**_known(EnvConfig, d.get("env", {}))),
        net=NetConfig(**_known(NetConfig, d.get("net", {}))),
        mcts=MCTSConfig(**_known(MCTSConfig, d.get("mcts", {}))),
        replay=ReplayConfig(**_known(ReplayConfig, d.get("replay", {}))),
        train=TrainConfig(**_known(TrainConfig, d.get("train", {}))),
        mesh=MeshConfig(**_known(MeshConfig, d.get("mesh", {}))),
    )


# ---------------------------------------------------------------------------
# Presets — one per BASELINE.json config (lines 6-12).
# ---------------------------------------------------------------------------

def smoke_9x9() -> RunConfig:
    """BASELINE.json:7 — 9×9, 1 env, 100-sim MCTS, 4-block 64-ch net, CPU.

    leaf_batch=4 (100 sims = 25 exact passes) matches the production
    presets' leaf-parallel search; the sequential lb=1 path is pinned by
    the unit parity tests (test_mcts), and batch-4 forwards keep the CPU
    smoke run ~3× faster than batch-1 (round-2 verdict weak #8)."""
    return RunConfig(
        name="smoke_9x9",
        env=EnvConfig(board_size=9),
        net=NetConfig(blocks=4, channels=64, compute_dtype="float32"),
        mcts=MCTSConfig(num_simulations=100, leaf_batch=4),
        replay=ReplayConfig(capacity=20_000, batch_size=128, min_fill=256),
        train=TrainConfig(num_envs=1, selfplay_plies_per_iter=81,
                          learner_steps_per_iter=2),
    )


def chip_15x15() -> RunConfig:
    """BASELINE.json:8 — 15×15, 256 lockstep envs, 400-sim MCTS, 1 chip."""
    return RunConfig(
        name="chip_15x15",
        env=EnvConfig(board_size=15),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=400, max_depth=64,
                        prior_dtype="bfloat16", value_dtype="int16",
                        leaf_batch=8, branch_cap=128),
        train=TrainConfig(num_envs=256, selfplay_plies_per_iter=32),
    )


def host_15x15() -> RunConfig:
    """BASELINE.json:9 — 15×15 full actor-learner: 2048 envs + replay +
    data-parallel learner on one host."""
    return RunConfig(
        name="host_15x15",
        env=EnvConfig(board_size=15),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=400, max_depth=64,
                        prior_dtype="bfloat16", value_dtype="int16",
                        leaf_batch=8, branch_cap=128),
        replay=ReplayConfig(capacity=500_000, batch_size=2_048,
                            min_fill=16_384),
        train=TrainConfig(num_envs=2_048, selfplay_plies_per_iter=16,
                          learner_steps_per_iter=8),
        mesh=MeshConfig(data=4),
    )


def pod_v5p16() -> RunConfig:
    """BASELINE.json:10 — multi-host v5p-16: envs sharded over hosts feeding a
    sharded learner synced via psum over ICI (SURVEY.md §5.8)."""
    return RunConfig(
        name="pod_v5p16",
        env=EnvConfig(board_size=15),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=400, max_depth=64,
                        prior_dtype="bfloat16", value_dtype="int16",
                        leaf_batch=8, branch_cap=128),
        replay=ReplayConfig(capacity=1_000_000, batch_size=4_096,
                            min_fill=32_768),
        train=TrainConfig(num_envs=8_192, selfplay_plies_per_iter=16,
                          learner_steps_per_iter=16),
        mesh=MeshConfig(data=8),
    )


def renju_19x19() -> RunConfig:
    """BASELINE.json:11 — 19×19 Renju-rules variant with a 10-block net,
    stressing MCTS tree memory (SURVEY.md §5.7)."""
    return RunConfig(
        name="renju_19x19",
        env=EnvConfig(board_size=19, rules=RENJU),
        net=NetConfig(blocks=10, channels=128),
        mcts=MCTSConfig(num_simulations=400, max_depth=64,
                        prior_dtype="bfloat16", value_dtype="int16",
                        leaf_batch=8, branch_cap=128),
        replay=ReplayConfig(capacity=300_000, batch_size=1_024,
                            min_fill=8_192),
        train=TrainConfig(num_envs=512, selfplay_plies_per_iter=16),
    )


def train_9x9() -> RunConfig:
    """Practical 9×9 training config (not a BASELINE preset): produces the
    bundled pretrained checkpoint the reference also ships (SURVEY.md §2
    "Pretrained model"). Tuned for wall-clock on one v5e chip."""
    return RunConfig(
        name="train_9x9",
        env=EnvConfig(board_size=9),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=150, max_depth=32,
                        temperature_moves=6, prior_dtype="bfloat16",
                        small_simulations=50),
        replay=ReplayConfig(capacity=200_000, batch_size=512,
                            min_fill=4_096),
        train=TrainConfig(num_envs=256, selfplay_plies_per_iter=32,
                          learner_steps_per_iter=4,
                          eval_every_iters=25, eval_games=32,
                          eval_simulations=100,
                          checkpoint_every_iters=25),
    )


def train_15x15() -> RunConfig:
    """Practical 15×15 training config (not a BASELINE preset): produces the
    bundled pretrained model at the reference's headline board size, using
    the SAME search approximations as the chip_15x15 perf preset (depth cap
    64, bf16 priors, int16 value sums, leaf_batch 8) so training validates
    them for strength (round-1 VERDICT item 2). PCR keeps ~75% of plies on
    a cheap 64-sim search; the KL guard-rail aborts oversized updates."""
    return RunConfig(
        name="train_15x15",
        env=EnvConfig(board_size=15),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=240, max_depth=64,
                        temperature_moves=12, prior_dtype="bfloat16",
                        value_dtype="int16", leaf_batch=8, branch_cap=128,
                        small_simulations=64),
        replay=ReplayConfig(capacity=400_000, batch_size=512,
                            min_fill=8_192),
        train=TrainConfig(num_envs=256, selfplay_plies_per_iter=32,
                          learner_steps_per_iter=4,
                          kl_stop_factor=4.0,
                          # big-anchor evals cost ~15 min each on this
                          # chip; a sparse cadence keeps wall-clock on
                          # self-play once the ladder tops out
                          eval_every_iters=100, eval_games=32,
                          eval_simulations=240,
                          max_anchor_rollouts=6_400,
                          checkpoint_every_iters=25,
                          total_iters=4_000),
    )


def train_19x19() -> RunConfig:
    """Practical 19×19 FULL-RENJU training config (not a BASELINE preset):
    exercises the forbidden-move rules (double-three/four/overline) in
    real self-play training and produces the bundled preview model. Same
    recipe as train_15x15 scaled to the bigger board; the renju_19x19
    10-block net is the memory-stress preset's — training it to full
    strength takes far longer than one round's budget, so the bundle is
    explicitly a preview.

    Round-3 recipe changes after the head-collapse forensics
    (train/learner.py docstring): 32-ply chunks over 256 envs (same 8192
    env-steps/iter as before, but chunk length now covers the ~26-ply
    average Renju game, lifting the z_valid fraction from the measured
    0.33 to ~0.6 — unfinished-game positions carry no value target);
    lr_scale_max=3 (the 10× controller cap amplified the collapse);
    8 learner steps/iter for gradient throughput."""
    return RunConfig(
        name="train_19x19",
        env=EnvConfig(board_size=19, rules=RENJU),
        net=NetConfig(blocks=6, channels=96),
        mcts=MCTSConfig(num_simulations=240, max_depth=64,
                        temperature_moves=16, prior_dtype="bfloat16",
                        value_dtype="int16", leaf_batch=8, branch_cap=128,
                        small_simulations=64),
        replay=ReplayConfig(capacity=400_000, batch_size=512,
                            min_fill=8_192),
        train=TrainConfig(num_envs=256, selfplay_plies_per_iter=32,
                          learner_steps_per_iter=8,
                          kl_stop_factor=4.0,
                          lr_scale_max=3.0,
                          eval_every_iters=50, eval_games=64,
                          eval_simulations=240,
                          max_anchor_rollouts=3_200,
                          checkpoint_every_iters=25,
                          total_iters=4_000),
    )


def tiny_test() -> RunConfig:
    """Not a BASELINE preset: miniature config for fast unit tests."""
    return RunConfig(
        name="tiny_test",
        env=EnvConfig(board_size=5, n_in_row=4),
        net=NetConfig(blocks=1, channels=16, value_hidden=16,
                      compute_dtype="float32"),
        mcts=MCTSConfig(num_simulations=16, temperature_moves=4),
        replay=ReplayConfig(capacity=1_024, batch_size=32, min_fill=32),
        train=TrainConfig(num_envs=4, selfplay_plies_per_iter=25,
                          learner_steps_per_iter=1, eval_games=4),
    )


def lowsim_15x15() -> RunConfig:
    """The aggregate-throughput config (docs/NORTH_STAR.md §3): ≥1M
    aggregate env-steps/s on v5p-16 is physically reachable only at
    ≤16-average-sim budgets, and at budget 16 the Gumbel root search
    (mcts/gumbel.py) delivers classic-root@32-sims strength
    (PERFORMANCE.md "Gumbel root search", pooled 256-game finals:
    0.512 ± 0.031 at half budget, +77 Elo at equal budget).
    gumbel_m=16 makes the whole search ONE
    16-lane batched forward per move — 2048 envs × 16 lanes = 32k-wide
    leaf batches on the MXU with no sequential pass loop."""
    return RunConfig(
        name="lowsim_15x15",
        env=EnvConfig(board_size=15),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=16, max_depth=16,
                        root_selection="gumbel", gumbel_m=16,
                        prior_dtype="bfloat16", value_dtype="int16"),
        replay=ReplayConfig(capacity=400_000, batch_size=512,
                            min_fill=8_192),
        train=TrainConfig(num_envs=2048, selfplay_plies_per_iter=32),
    )


def train_lowsim_15x15() -> RunConfig:
    """Practical training recipe for the lowsim_15x15 data-engine config
    (not a BASELINE preset): the SAME search as lowsim_15x15 (16-sim
    gumbel one-pass root — the only physically 1M-aggregate-capable
    regime, docs/NORTH_STAR.md §3) with the train/eval scaffolding of
    train_15x15 so the two recipes compare at matched device time.
    In-run ladder evals use a 240-sim gumbel search on the same anchor
    scale as train_15x15 (canonical exact anchors, cap 6400)."""
    return RunConfig(
        name="train_lowsim_15x15",
        env=EnvConfig(board_size=15),
        net=NetConfig(blocks=4, channels=64),
        mcts=MCTSConfig(num_simulations=16, max_depth=16,
                        root_selection="gumbel", gumbel_m=16,
                        prior_dtype="bfloat16", value_dtype="int16"),
        replay=ReplayConfig(capacity=400_000, batch_size=512,
                            min_fill=8_192),
        train=TrainConfig(num_envs=2048, selfplay_plies_per_iter=32,
                          learner_steps_per_iter=4,
                          kl_stop_factor=4.0,
                          # 16-sim π' targets keep per-update KL small, so
                          # the controller drifts to its cap far more
                          # readily than under 240-sim visit counts: the
                          # round-5 matched-budget run sat at the 10×
                          # default cap from ~iter 2540, flattened the
                          # policy and destroyed the net in its last ~100
                          # iters (ckpt 2500 beat the final export
                          # 111–17; docs/TRAINING.md "lr-ceiling
                          # runaway"). Same cap the 19×19 forensics
                          # landed on.
                          lr_scale_max=3.0,
                          eval_every_iters=400, eval_games=32,
                          eval_simulations=240,
                          max_anchor_rollouts=6_400,
                          checkpoint_every_iters=100,
                          total_iters=2_400),
    )


PRESETS = {
    "smoke_9x9": smoke_9x9,
    "chip_15x15": chip_15x15,
    "lowsim_15x15": lowsim_15x15,
    "train_lowsim_15x15": train_lowsim_15x15,
    "host_15x15": host_15x15,
    "pod_v5p16": pod_v5p16,
    "renju_19x19": renju_19x19,
    "train_9x9": train_9x9,
    "train_15x15": train_15x15,
    "train_19x19": train_19x19,
    "tiny_test": tiny_test,
}


def get_preset(name: str) -> RunConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


def _parse_override_value(raw: str, old, optional: bool):
    if raw.lower() in ("none", "null"):
        if optional:
            return None
        raise ValueError(f"override value {raw!r} only applies to "
                         f"Optional fields; this one is {type(old).__name__}")
    if isinstance(old, bool):
        if raw.lower() not in ("1", "0", "true", "false", "yes", "no"):
            raise ValueError(f"override value {raw!r} is not a boolean")
        return raw.lower() in ("1", "true", "yes")
    if old is None:  # Optional numeric field (mcts.branch_cap, max_depth)
        for typ in (int, float):
            try:
                return typ(raw)
            except ValueError:
                pass
        raise ValueError(f"override value {raw!r} is not numeric")
    return type(old)(raw)


def apply_overrides(cfg: RunConfig, overrides) -> RunConfig:
    """`cfg` with each ``"section.field=value"`` of `overrides` applied
    (the ``--set`` flag of the bench and smoke CLIs)."""
    import typing
    for ov in overrides:
        path, _, raw = ov.partition("=")
        section, _, field = path.partition(".")
        if not raw or not field:
            raise ValueError(f"bad override {ov!r} (want section.field=value)")
        sub = getattr(cfg, section)
        if field not in {f.name for f in dataclasses.fields(sub)}:
            raise ValueError(f"unknown field {path!r}")
        hint = typing.get_type_hints(type(sub))[field]
        val = _parse_override_value(raw, getattr(sub, field),
                                    type(None) in typing.get_args(hint))
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: val})})
    return cfg
