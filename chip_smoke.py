"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card and times it beside
its bound (and, for the resblock, cuDNN's two convolutions as the
yardstick), checks a bundled net, and drives the port's two paths through
the entry points a user calls:

* self-play at ``chip_15x15`` with ``net.use_pallas=true`` (256 envs, 400
  sims per move, the bundled 15×15 weights) through
  ``alphafive_tpu_torch.benchmarks.selfplay_bench.run`` — the resblock
  kernel's path, every launch in its resident variant — then again with
  deferred backup (``mcts.backup_interval=2``), held bit-equal, and a
  per-ply breakdown at both intervals;
* self-play at ``renju_19x19`` with ``net.use_pallas=true`` at full width
  (512 envs, 400 sims, Renju rules, the bundled 10-block × 128
  ``19x19_10b`` weights) at backup intervals 2 and 1, held bit-equal,
  every resblock launch streaming; the peak memory against the guard's
  estimate, a per-ply breakdown at both intervals and the device-busy
  share of a ply;
* self-play at ``lowsim_15x15`` with ``net.use_pallas=true`` (2,048 envs,
  the Gumbel root at 16 sims: one pass of 16 lanes, so 32,768-leaf
  forwards; the bundled ``15x15_lowsim`` weights) through the same entry
  point, with a per-ply breakdown by synchronised timers; the capped and
  full-width Gumbel searches held equal on 256 positions; and the replay
  ring at the preset's capacity filled from that self-play and sampled;
* ``python -m alphafive_tpu_torch.cli eval --preset chip_15x15`` with the
  packed-tree search (``mcts.select_impl=pallas``, full width,
  ``leaf_batch`` 1: 400 sims per net move through the select kernel)
  against the rollout anchor — the select kernel's path;
* the actor-learner iteration at ``train_lowsim_15x15`` with
  ``net.use_pallas=true`` from the bundled ``15x15_lowsim`` weights
  through ``selfplay_bench.run_iteration`` (``cli bench --mode
  iteration``): each iteration's self-play runs the resblock kernel in an
  evaluator refolded from the learner's live weights, then the ring write
  and 4 learner steps of 512; a per-part breakdown by synchronised timers
  follows. Before it, one learner step at batch 512: f32 on the card
  against the port's own CPU step, and the bf16 step timed beside its
  FLOP bound;
* ``python -m alphafive_tpu_torch.cli train --preset train_lowsim_15x15``
  with ``net.use_pallas=true`` and ``--init-from pretrained/15x15_lowsim``
  at full width: 4 iterations with checkpoints at 2 and 4, one ladder eval
  (cut to 2 games at 64 sims a move) and the best export (phase
  ``train_loop``); step 4
  restored onto the card bit-equal to the carry ``train`` returned, then
  ``--resume`` to 6 (``train_resume``); ``cli export`` of the result and
  ``--workdir`` loading (``export``); the memory guard's estimate against
  the peak the device allocated over ``train_loop`` (``memory_guard``).
  Every resblock launch of the loop is resident, and each leaf batch its
  eval launches has a kernel_vs_plain row;
* ``python -m alphafive_tpu_torch.cli train --multihost`` at
  ``train_lowsim_15x15`` with ``net.use_pallas=true`` and ``--init-from
  pretrained/15x15_lowsim`` as two ranks sharing the card over gloo
  (NCCL refuses two ranks on one device; ``mesh.data=2``: 1,024 envs and
  16,384-leaf resblock forwards a rank): 3 iterations with checkpoints
  of per-rank shards, then a ``--resume`` (``train_two_ranks``), checked
  for one record per event, env steps summed over the ranks, the ranks'
  weights bit-identical and the shards on disk; and a world of one under
  NCCL against the loop with no process group from the same seed
  (``train_nccl_one_rank``: self-play and the ring bit-equal, the
  learner within the iteration parity test's bars).

* ``cli play``'s search (``run_mcts`` on one env, 400 sims) for 4 AI
  moves from ``pretrained/15x15`` (``chip_15x15``) and
  ``pretrained/19x19_10b`` (``renju_19x19``) with the bundle's net fused
  (``small_batch_play``): the small batches (1 and 8) that the resblock
  kernel's split variant serves, each held by a kernel_vs_plain row.

Before the eval, the packed search itself is run with the kernel and with
the plain descent and against the full-width search. Each phase prints one
JSON line; any failure raises. The last lines are the kernel table, the
card's name and power limit from nvidia-smi, and ``{"ok": true, "device":
{...}}``. There is no CPU path: without CUDA the script exits non-zero
before printing any result. Imports nothing of JAX.

A kernel row's ``ms`` is device time per launch: 20 calls of the wrapper
captured into one CUDA graph, median of 5 timed replays
(``benchmarks/timing.py``); a call that cannot be captured fails the run.
``host_us_per_call`` beside it is the wall time per call of 400
unsynchronised calls, what a loop that launches the kernel once per step
pays. The plain versions wait on the host inside (the plain descent syncs
once per step), so ``plain_ms`` stays eager CUDA-event time. Each select
row also gives ``latency_bound_ms``: the launch floor plus its longest
descent's steps times one L2 round trip, both measured here by
``benchmarks/select_profile.py``. The streaming resblock rows also give
``before_ms``, the variant's time before its redesign, and the streaming
variant's tap pack is held bit-equal to its plain twin at 64, 96 and 128
channels (``pack_taps_vs_plain``). The small-batch rows also give the
split variant (one sample over a thread-block cluster) launched by name
against the plain twin, its ``split_ms`` and the ``replaced_ms`` of the
variant the shape takes otherwise; a row that dispatches split fails
unless split is the faster in that run.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from alphafive_tpu_torch.benchmarks import select_profile  # noqa: E402
from alphafive_tpu_torch.benchmarks import timing  # noqa: E402
from alphafive_tpu_torch.ops import _build, resblock as rb  # noqa: E402
from alphafive_tpu_torch.ops import select as sel  # noqa: E402

# kernel vs plain: (batch, board, channels, dtype, the variant that must
# run it); the first two are chip_15x15 self-play's pass and root forwards,
# the third lowsim_15x15's leaf forward (2,048 envs × 16 lanes; its root
# forward is the first shape), the next four the other bundles, the next
# five every other kernel instantiation of csrc/resblock.cu (bf16
# streaming at 64 channels, tiled at 9x9, and f32 general at 19x19 with
# 64, 96 and 128 channels, the shapes the f32 plain kernel ran before the
# general one replaced it), and the last five the train loop's eval: one
# game a colour, the root (1) and the Gumbel passes of 16, 8, 4 and 2
# lanes of a 64-sim search (EVAL_BATCHES; phase train_loop checks it saw
# no other), then
# train_two_ranks' root and leaf forwards, 1,024 envs a rank × 16 lanes
# (TWO_RANK_BATCHES; that phase checks it saw no other), and last
# renju_19x19 self-play's leaf and root forwards (512 envs × 8 lanes, and
# the 512 roots), streaming
SHAPES = [(2048, 15, 64, torch.bfloat16, "resident"),
          (256, 15, 64, torch.bfloat16, "resident"),
          (32768, 15, 64, torch.bfloat16, "resident"),
          (2048, 9, 64, torch.bfloat16, "resident"),
          (2048, 19, 96, torch.bfloat16, "streaming"),
          (2048, 19, 128, torch.bfloat16, "streaming"),
          (2048, 15, 64, torch.float32, "tiled"),
          (256, 19, 64, torch.bfloat16, "streaming"),
          (256, 9, 64, torch.float32, "tiled"),
          (256, 19, 64, torch.float32, "general"),
          (256, 19, 96, torch.float32, "general"),
          (256, 19, 128, torch.float32, "general")]
EVAL_BATCHES = (1, 2, 4, 8, 16)
SHAPES += [(b, 15, 64, torch.bfloat16, "split") for b in EVAL_BATCHES]
TWO_RANK_BATCHES = (1024, 16384)
SHAPES += [(b, 15, 64, torch.bfloat16, "resident")
           for b in TWO_RANK_BATCHES]
SHAPES += [(4096, 19, 128, torch.bfloat16, "streaming"),
           (512, 19, 128, torch.bfloat16, "streaming")]
# the 19x19_10b bundle's cli play and cli eval forwards: the root (1) and
# the leaf batches or Gumbel lanes (2 to 16)
SHAPES += [(1, 19, 128, torch.bfloat16, "split"),
           (2, 19, 128, torch.bfloat16, "split"),
           (4, 19, 128, torch.bfloat16, "split"),
           (8, 19, 128, torch.bfloat16, "streaming"),
           (16, 19, 128, torch.bfloat16, "streaming")]
# the streaming rows' device ms before the variant's redesign (the first
# form: a cp.async ring, a block barrier a tap, x reloaded for the
# residual), by this script on an H100 80GB HBM3 at 700 W: each row gives
# it as before_ms beside its ms
STREAMING_BEFORE_MS = {(2048, 19, 96): 0.7926, (2048, 19, 128): 1.1396,
                       (256, 19, 64): 0.05447, (4096, 19, 128): 2.2171,
                       (512, 19, 128): 0.3113}
# the streaming variant's tap pack against its plain twin, bit for bit, at
# every width the variant takes
PACK_CHANNELS = (64, 96, 128)
# the general variant (every shape the four fast ones refuse): JAX's own
# test shapes (f32 5x5 x 16 and 7x7 x 32), tiny_test's board and width in
# bf16 at a batch of 256, C not a multiple of 8 (48 and 20), then phase
# general_shapes' leaf forwards: chip_15x15 at 256 channels and on a 21x21
# board (2,048 leaves), the 33x33 search's board, f32 whose y exceeds
# shared memory (it goes to the workspace), and the kernel's edges: batch
# 1 at 256 channels (a 256-channel net's eval), one sample more than the
# 132-CTA grid at C = 40 (K padded to 48), C = 8 (below one k16 step),
# and a 240x240 board at C = 72, too wide for two slabs of all three tap
# rows (span 1). Their two bf16 rows at batch 1 go to the split variant.
# GENERAL_ROW is the row the kernels line shows
GENERAL_SHAPES = [(4, 5, 16, torch.float32, "general"),
                  (4, 7, 32, torch.float32, "general"),
                  (256, 5, 16, torch.bfloat16, "general"),
                  (2048, 15, 48, torch.bfloat16, "general"),
                  (64, 9, 20, torch.bfloat16, "general"),
                  (2048, 15, 256, torch.bfloat16, "general"),
                  (2048, 21, 64, torch.bfloat16, "general"),
                  (256, 33, 64, torch.bfloat16, "general"),
                  (256, 19, 192, torch.float32, "general"),
                  (1, 15, 256, torch.bfloat16, "split"),
                  (133, 9, 40, torch.bfloat16, "general"),
                  (64, 6, 8, torch.bfloat16, "general"),
                  (1, 240, 72, torch.bfloat16, "split")]
SHAPES += GENERAL_SHAPES
# the 33x33 search's forwards (phase general_shapes: one env, batch 1)
SHAPES += [(1, 33, 64, torch.bfloat16, "split")]
# the split variant (one sample over a thread-block cluster) is held
# against the plain twin, and timed beside the variant its shape takes
# otherwise, at every bf16 row whose batch it takes (split_ms, replaced,
# replaced_ms; a row that dispatches split must be the faster) and at
# these rows of other variants, where it is timed beside them
SPLIT_ALSO = {(64, 6, 8)} | {(b, 19, 128) for b in EVAL_BATCHES}
GENERAL_ROW = (2048, 15, 256)
SPLIT_ROW = (1, 19, 128)   # the split row the kernels line shows
# bf16: one ulp of a rounded y (2^-8 relative) moves the output by about one
# ulp of the output again, so allow two ulps of outputs of magnitude ~4-8
# (2^-5 = 0.03125) plus 2% relative; f32 differs only in summation order
TOL = {torch.bfloat16: (5e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# bundle forward, bf16 trunk: policy logits (atol, rtol) and value atol
NET_TOL = {"logits": (1e-1, 2e-2), "value": 2e-2}
SELFPLAY_PLIES, SELFPLAY_REPEATS = 4, 2
FORWARDS_PER_PLY = 400 // 8 + 1   # 50 passes of 8 lanes + the root
# stats scatters a 400-sim, leaf_batch-8 search: one a pass, or one a pair
# of passes with deferred backup (mcts.backup_interval=2)
SCATTERS_PER_PLY = {1: 50, 2: 25}
# renju_19x19 self-play: plies a chunk and timed chunks after the first;
# the breakdown's timed plies at each backup interval
RENJU_PLIES, RENJU_REPEATS, RENJU_BREAKDOWN_PLIES = 1, 2, 1
CAPPED_BREAKDOWN_PLIES = 2     # chip_15x15 plies a turn of the breakdown
# lowsim_15x15: plies per chunk, timed chunks (after the first), and the
# forwards per ply (the root, then one pass of 16 lanes)
LOWSIM_PLIES, LOWSIM_REPEATS, LOWSIM_FORWARDS = 8, 2, 2
BREAKDOWN_PLIES = 3            # plies timed part by part
CAPPED_ENVS = 256              # positions of the capped/full-width check
# packed-tree search: 400 sims per move, descents capped at 64 edges
SIMS, DEPTH = 400, 64
# select kernel vs plain: (bundle, envs) of the searches whose trees are
# compared; the first two are the 15×15 shapes, the third a 19×19 tree. The
# first tree's env 0 alone is compared too: E = 1, the shape cli eval
# launches
SELECT_TREES = [("15x15", 16), ("15x15", 256), ("19x19", 16)]
# and a 33×33 tree (A_pad 1152: the kernel's chunk-streaming path), from a
# search with chip_15x15's net on that board, random weights
RANDOM_33 = "random_33x33"
SELECT_TREES += [(RANDOM_33, 16)]
FORCED_K = 2.0   # the forced-playout gate's k in the second comparison
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16
# tensor cores, f32 outside the tensor cores, device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# the actor-learner iteration: iterations run (the first, one warm-up and
# the timed ones), and steps compared f32 card against CPU
ITERATION_WARMUP, ITERATION_REPEATS, LEARNER_CHECK_STEPS = 1, 2, 3
# f32 learner steps, card against CPU, TF32 off: summation order only.
# Aux metrics and batch statistics to 1e-4 relative; the Adam moments to
# 1e-3 relative plus 1e-4 of their largest entry; params to 4e-6 absolute
# (the three steps move a weight by at most ~6e-5: lr 0, 2e-5, 4e-5)
LEARNER_TOL = {"aux_rtol": 1e-4, "stats_rtol": 1e-4, "stats_atol": 1e-5,
               "moment_rtol": 1e-3, "moment_atol_of_max": 1e-4,
               "param_atol": 4e-6}
# cli train at train_lowsim_15x15 (full width: 2,048 envs, 16-lane
# Gumbel, ring 400,000, 4 blocks × 64) from the lowsim bundle: 4
# iterations, checkpoints every 2, one ladder eval at the end; then a
# resume to 6. Cut: eval_games 32 → 2 (one game a colour) and the eval's
# search budget 240 → 64 sims a move (the net's Gumbel passes keep their
# 16, 8, 4 and 2 lanes; the rollout anchor's searches dominate the script)
TRAIN_EVAL_GAMES, TRAIN_EVAL_SIMS = 2, 64
TRAIN_ARGV = ["train", "--preset", "train_lowsim_15x15",
              "--set", "net.use_pallas=true",
              "--set", "train.checkpoint_every_iters=2",
              "--set", "train.eval_every_iters=4",
              "--set", f"train.eval_games={TRAIN_EVAL_GAMES}",
              "--set", f"train.eval_simulations={TRAIN_EVAL_SIMS}"]
TRAIN_REDUCED = [f"train.eval_games 32 -> {TRAIN_EVAL_GAMES}",
                 f"train.eval_simulations 240 -> {TRAIN_EVAL_SIMS} (the "
                 "anchor's searches took 175-345 s of the script at 240)",
                 "iterations 2,400 -> 4 (then a resume to 6)"]
# cli train --multihost at train_lowsim_15x15 as two ranks sharing the one
# card over gloo between CUDA tensors (NCCL refuses two ranks on one
# device): each rank 1,024 envs x 16 lanes (16,384-leaf resblock forwards),
# a ring of 200,000 rows and learner batches of 256. 3 iterations with a
# checkpoint at 2 and the final one at 3, then a resume to 4. Cut: no
# ladder eval
TWO_RANKS, TWO_RANK_TIMEOUT_S = 2, 420
TWO_RANK_ARGV = ["train", "--preset", "train_lowsim_15x15",
                 "--set", "net.use_pallas=true",
                 "--set", f"mesh.data={TWO_RANKS}",
                 "--set", "train.checkpoint_every_iters=2",
                 "--set", "train.eval_every_iters=0"]
TWO_RANK_REDUCED = ["train.eval_every_iters 400 -> 0 (no ladder eval)",
                    "iterations 2,400 -> 3 (then a resume to 4)",
                    "2 ranks on one card, over gloo (NCCL needs a card a "
                    "rank)"]
SHARD_FILES = sorted(["meta.json", "model.pt"]
                     + [f"carry.rank{r}.pt" for r in range(TWO_RANKS)])
# a world of one under NCCL against no group: 2 iterations (the first
# stages, the second writes the ring and runs the learner), so both runs'
# self-play reads the same weights and must match bit for bit; the
# learner's metrics and weights to the iteration parity test's bars
# (tests/test_torch_iteration.py: cuDNN's convolution backward is not
# bit-deterministic from run to run)
NCCL_ITERS = 2
NCCL_METRIC_TOL, NCCL_PARAM_TOL = (1e-7, 1e-4), (1e-5, 1e-4)
SELFPLAY_KEYS = ("games_finished", "env_steps", "black_wins", "white_wins",
                 "draws", "mean_root_value", "buffer_size", "z_valid_frac",
                 "updated", "step")
# the JAX loop's iter record (alphafive_tpu/train/loop.py): the
# iteration's metrics, the rates and the two lr canaries
ITER_KEYS = {"t", "kind", "iter", "black_wins", "buffer_size", "draws",
             "entropy_pi", "env_steps", "executed_steps", "games_finished",
             "grad_norm", "kl_pi_p", "kl_update", "l2_loss", "loss",
             "lr_scale", "mean_root_value", "policy_loss", "step", "updated",
             "value_loss", "value_mae", "white_wins", "z_valid_frac",
             "iter_seconds", "env_steps_per_s", "env_steps_per_s_per_chip",
             "sims_per_s", "lr_at_floor", "lr_at_ceiling"}
# phase general_shapes: tiny_test's cli train with the kernel (5×5 × 16,
# f32: 2 iterations, before any eval or checkpoint falls due but the
# final checkpoint); one ply of chip_15x15 self-play at 256 channels and
# on a 21×21 board (the preset's 400 sims: 50 passes of 2,048 leaves and
# the root), random weights; a 64-sim packed search of one env on a 33×33
# board
GENERAL_TRAIN_ARGV = ["train", "--preset", "tiny_test",
                      "--set", "net.use_pallas=true", "--iters", "2"]
GENERAL_PLIES = 1
GENERAL_WIDE = ["net.channels=256"]
GENERAL_BOARD = ["env.board_size=21"]
GENERAL_SEARCH_SIMS = 64
# phase small_batch_play: cli play's AI search (run_mcts on one env, no
# noise, the preset's search: 400 sims, leaf_batch 8, branch cap 128) for
# PLAY_MOVES moves with no human, the AI playing both colours, from each
# bundle under its preset: forwards of 1 (the root) and 8 (the leaves)
PLAY_MOVES, PLAY_SIMS = 4, 400
PLAY_BUNDLES = [("15x15", "chip_15x15"), ("19x19_10b", "renju_19x19")]
# cli eval: two games against the rollout anchor at a small budget
EVAL_ARGV = ["eval", "--preset", "chip_15x15",
             "--set", "mcts.select_impl=pallas",
             "--set", "mcts.branch_cap=none", "--set", "mcts.leaf_batch=1",
             "--games", "2", "--anchor-rollouts", "16"]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over the type's peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def library_pair(x, w1, w2):
    """The two convolutions of a block as cuDNN computes them (channels-
    last, no bias, ReLU or rounding): the yardstick, never the port."""
    c = x.shape[-1]
    oihw = [w.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for w in (w1, w2)]
    xc = x.permute(0, 3, 1, 2)   # NHWC storage: channels-last NCHW view
    conv = torch.nn.functional.conv2d
    return lambda: conv(conv(xc, oihw[0], padding=1), oihw[1], padding=1)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return name


def phase_build():
    """Both libraries at once: the kernels' and the instrumented copy of
    csrc/select.cu that measures the select kernel's latency bound."""
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        main = pool.submit(_build.load)
        profile = pool.submit(select_profile.build)
        main.result()
        plib = profile.result()
    regs = [line.strip() for line in _build.build_log.splitlines()
            if any(k in line for k in ("entry function", "registers",
                                       "spill"))]
    emit("build", seconds=time.time() - t0, ptxas=regs)
    return plib


def phase_select_latency(plib):
    """The two measured inputs of the select kernel's latency bound."""
    inputs = select_profile.latency_inputs(plib)
    emit("select_latency", **inputs, nvidia_smi=nvidia_smi())
    return inputs


def timed(row: dict, kernel, plain) -> None:
    """Device ms of the kernel's wrapper (graph replay), its host µs per
    call over timing.HOST_CALLS calls, and the plain version's eager ms,
    into `row`."""
    row["ms"], row["ms_spread"] = timing.graph_ms(kernel)
    row["host_us_per_call"] = timing.host_us_per_call(kernel)
    row["plain_ms"], row["plain_ms_spread"] = timing.eager_ms(plain)


def phase_kernel_vs_plain():
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, c, dt, kind in SHAPES:
        scale = 1.0 / (3.0 * c ** 0.5)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
        x = rnd(b, s, s, c).relu().to(dt)
        w1, w2 = ((rnd(9, c, c) * scale).to(dt) for _ in range(2))
        b1, b2 = (0.1 * rnd(c) for _ in range(2))
        rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
        got = rb.fused_resblock(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        if rb.variant_launches[kind] != 1:
            raise AssertionError(f"{b}x{s}x{s}x{c} {dt}: want {kind}, ran "
                                 f"{rb.variant_launches}")
        ref = rb.fused_resblock_reference(x, w1, b1, w2, b2)
        err = (got.float() - ref.float()).abs()
        atol, rtol = TOL[dt]
        worst = (err - rtol * ref.float().abs()).max().item()
        row = dict(batch=b, board=s, channels=c, dtype=str(dt)[6:],
                   variant=kind, max_abs_err=err.max().item(),
                   max_rel_err=(err / ref.float().abs().clamp(min=1e-3))
                   .max().item(), atol=atol, rtol=rtol)
        if not worst <= atol:
            emit("kernel_vs_plain", **row, ok=False)
            raise AssertionError(f"resblock kernel disagrees: {row}")
        timed(row, lambda: rb.fused_resblock(x, w1, b1, w2, b2),
              lambda: rb.fused_resblock_reference(x, w1, b1, w2, b2))
        # cuDNN's best algorithm, picked in the warm-up before the capture
        torch.backends.cudnn.benchmark = True
        row["library_ms"], row["library_ms_spread"] = timing.graph_ms(
            library_pair(x, w1, w2))
        torch.backends.cudnn.benchmark = False
        item = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            2 * 2 * b * s * s * c * c * 9,
            2 * x.numel() * item + 2 * w1.numel() * item + 2 * 4 * c, dt)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if (b, s, c) in STREAMING_BEFORE_MS:  # ms includes the tap pack
            row["before_ms"] = STREAMING_BEFORE_MS[(b, s, c)]
        if kind == "split" or (b, s, c) in SPLIT_ALSO:
            split_vs_replaced(row, kind, x, w1, b1, w2, b2)
        emit("kernel_vs_plain", **row, ok=True)
        rows.append(row)
    return rows


def split_vs_replaced(row: dict, kind: str, x, w1, b1, w2, b2) -> None:
    """The split variant at this row, launched by name, against the plain
    twin within TOL, and both it and the variant the shape takes otherwise
    timed by graph replay (`split_ms`, `replaced`, `replaced_ms`). Where
    the dispatch picks split it must be the faster in this run."""
    dt, (b, h, w, c) = x.dtype, x.shape
    base = rb.variant(dt, h, w, c)
    got = rb.fused_resblock_as("split", x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    ref = rb.fused_resblock_reference(x, w1, b1, w2, b2).float()
    err = (got.float() - ref).abs()
    atol, rtol = TOL[dt]
    row["split_max_abs_err"] = err.max().item()
    row["cluster_size"] = rb.cluster_size(b, h, w, c)
    # clusters of that size the card runs at once at split's shared memory
    row["active_clusters"] = _build.load().alphafive_resblock_active_clusters(
        row["cluster_size"], h, w, c)
    if not (err - rtol * ref.abs()).max().item() <= atol:
        emit("kernel_vs_plain", **row, ok=False)
        raise AssertionError(f"split disagrees with the plain twin: {row}")
    row["split_ms"], row["split_ms_spread"] = timing.graph_ms(
        lambda: rb.fused_resblock_as("split", x, w1, b1, w2, b2))
    row["replaced"] = base
    row["replaced_ms"], row["replaced_ms_spread"] = timing.graph_ms(
        lambda: rb.fused_resblock_as(base, x, w1, b1, w2, b2))
    if kind == "split" and not row["split_ms"] < row["replaced_ms"]:
        emit("kernel_vs_plain", **row, ok=False)
        raise AssertionError(f"split dispatched but not faster: {row}")


def phase_pack_taps_vs_plain():
    """The streaming variant's tap pack (``rb.pack_streaming_taps``)
    against its plain twin, bit for bit, at each width the variant takes:
    random bf16 [9, C, C] weights, timed beside the bytes it must move (two
    inputs read, the packed taps written). No one PyTorch call computes
    it: library_ms is null."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for c in PACK_CHANNELS:
        w1, w2 = (torch.randn(9, c, c, generator=g, device="cuda")
                  .bfloat16() for _ in range(2))
        got = rb.pack_streaming_taps(w1, w2)
        ref = rb.pack_streaming_taps_reference(w1, w2)
        torch.cuda.synchronize()
        row = dict(channels=c, shape=list(got.shape),
                   bit_equal=torch.equal(got, ref),
                   max_abs_err=(got.float() - ref.float()).abs().max()
                   .item())
        if not row["bit_equal"]:
            emit("pack_taps_vs_plain", **row, ok=False)
            raise AssertionError(f"tap pack disagrees: {row}")
        timed(row, lambda: rb.pack_streaming_taps(w1, w2),
              lambda: rb.pack_streaming_taps_reference(w1, w2))
        row["bound_ms"], row["bound_by"] = bound(
            0, 2 * got.numel() * got.element_size(), torch.bfloat16)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_ms"] = None
        emit("pack_taps_vs_plain", **row, ok=True)
        rows.append(row)
    return rows


def random_states(env_cfg, n: int, max_plies: int, seed: int = 1):
    """`n` positions from uniformly random legal play (0..max_plies moves,
    games that end are reset)."""
    from alphafive_tpu_torch.env import vector
    g = torch.Generator(device="cuda").manual_seed(seed)
    st = vector.init(env_cfg, n, "cuda")
    stop = torch.randint(0, max_plies + 1, (n,), generator=g, device="cuda")
    for ply in range(max_plies):
        u = torch.rand(st.board.shape, generator=g, device="cuda")
        act = (u * vector.legal_mask(st)).argmax(-1).int()
        nxt = vector.step(env_cfg, st, act)
        nxt = vector.reset_where(env_cfg, nxt, nxt.done)
        keep = stop <= ply
        st = vector.EnvState(**{
            f: torch.where(keep.reshape((n,) + (1,) * (getattr(st, f).dim()
                                                        - 1)),
                           getattr(st, f), getattr(nxt, f))
            for f in ("board", "to_play", "last_move", "move_count", "done",
                      "winner")})
    return st


def phase_bundle(bundle: str):
    """A bundle's forward through the kernel against its plain version on
    2,048 random positions, within NET_TOL."""
    from alphafive_tpu_torch.models.resnet import FusedPolicyValueNet
    from alphafive_tpu_torch.train.checkpoint import load_model
    params, stats, cfg = load_model(os.path.join(ROOT, "pretrained", bundle))
    from alphafive_tpu_torch.env import vector
    feats = vector.state_features(cfg.env, random_states(cfg.env, 2048, 60))
    kernel_net = FusedPolicyValueNet(cfg.env, cfg.net, params, stats, "cuda")
    plain_net = FusedPolicyValueNet(cfg.env, cfg.net, params, stats, "cuda",
                                    plain=True)
    logits, value = kernel_net(feats)
    ref_logits, ref_value = plain_net(feats)
    torch.cuda.synchronize()
    lerr = (logits - ref_logits).abs()
    verr = (value - ref_value).abs().max().item()
    atol, rtol = NET_TOL["logits"]
    ok = bool(torch.isfinite(logits).all() and torch.isfinite(value).all()
              and (lerr <= atol + rtol * ref_logits.abs()).all()
              and verr <= NET_TOL["value"])
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean()
    emit("bundle", bundle=f"pretrained/{bundle}", positions=2048,
         logits_max_abs_err=lerr.max().item(), value_max_abs_err=verr,
         tol=NET_TOL, argmax_agreement=agree.item(), ok=ok)
    if not ok:
        raise AssertionError(f"{bundle} forward: kernel disagrees with "
                             "plain")
    return params, stats, cfg


def check_fit(bundle: str, saved_cfg, cfg) -> None:
    net = lambda c: (c.net.blocks, c.net.channels, c.net.value_hidden,
                     c.env.board_size)
    if net(saved_cfg) != net(cfg):
        raise ValueError(f"pretrained/{bundle} does not fit {cfg.name}'s net")


def selfplay_run(cfg, params, stats, plies: int, repeats: int) -> dict:
    """``selfplay_bench.run`` from seed 0 (a first chunk and `repeats`
    timed ones of `plies` plies) with every ply recorded (position,
    action, visits, root value) and checked: every root live, its visits
    summing to the budget, every move legal. The kernel's launch counts
    and the stats scatters are set to 0 just before and read just after."""
    from alphafive_tpu_torch.benchmarks import selfplay_bench
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.mcts import search_capped
    sims = cfg.mcts.num_simulations
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    rec, last = [], []

    def observe(state, res, action):
        legal = state.board.gather(1, action.long()[:, None])[:, 0] == 0
        bad.add_((res.visits.sum(-1) != sims).sum() + (~legal).sum()
                 + state.done.sum())
        rec.append((state.board.clone(), action.clone(), res.visits.clone(),
                    res.root_value.clone()))
        last[:] = [state, action]

    rb.resblock_launches = rb.pack_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    search_capped.backup_scatters = 0
    out, traj = selfplay_bench.run(
        cfg, plies=plies, warmup=0, repeats=repeats, device="cuda",
        params=params, batch_stats=stats, observe=observe,
        return_trajectory=True)
    launches, scatters = rb.resblock_launches, search_capped.backup_scatters
    packs = rb.pack_launches
    pi_sum = traj.pi.sum(-1)
    return dict(out=out, traj=traj, rec=rec, plies=len(rec),
                final=vector.step(cfg.env, *last), launches=launches,
                variants=dict(rb.variant_launches), packs=packs,
                scatters=scatters,
                failed_checks=bad.item(),
                pi_ok=bool(torch.isfinite(traj.pi).all()
                           and ((pi_sum - 1).abs() < 1e-5).all()))


def runs_bit_equal(a: dict, b: dict) -> bool:
    """Two self-play runs' every ply (position, action, visits, root
    value), final state and last chunk's trajectory equal bit for bit."""
    fields = lambda obj: [getattr(obj, f.name)
                          for f in dataclasses.fields(obj)]
    pairs = [pair for ra, rb_ in zip(a["rec"], b["rec"])
             for pair in zip(ra, rb_)]
    pairs += list(zip(fields(a["final"]), fields(b["final"])))
    pairs += list(zip(fields(a["traj"]), fields(b["traj"])))
    return (a["plies"] == b["plies"]
            and all(torch.equal(x, y) for x, y in pairs))


def interval_runs(cfg, params, stats, plies: int, repeats: int,
                  intervals) -> dict:
    """selfplay_run at each backup interval, in the order given."""
    from alphafive_tpu_torch.config import apply_overrides
    return {i: selfplay_run(apply_overrides(
        cfg, [f"mcts.backup_interval={i}"]), params, stats, plies, repeats)
        for i in intervals}


def run_summary(run: dict, blocks: int, variant: str) -> tuple[dict, list]:
    """A run's numbers for its phase line, and the checks it failed: the
    kernel launched in `variant` `blocks` times a forward, 51 forwards a
    ply, the tap pack once before each streaming launch, the stats
    scatters a ply as the interval gives them, π finite and summing to
    1."""
    interval = run["out"]["backup_interval"]
    plies = run["plies"]
    want = blocks * FORWARDS_PER_PLY * plies
    fails = [name for name, ok in (
        ("failed_checks", run["failed_checks"] == 0),
        ("launches", run["launches"] == want),
        ("variant", run["variants"][variant] == run["launches"]),
        ("pack", run["packs"] == run["variants"]["streaming"]),
        ("scatters", run["scatters"] == SCATTERS_PER_PLY[interval] * plies),
        ("pi", run["pi_ok"])) if not ok]
    return dict(env_steps_per_s=run["out"]["env_steps_per_s"],
                seconds=run["out"]["seconds"], total_plies=plies,
                resblock_launches=run["launches"], expected_launches=want,
                variant_launches=run["variants"],
                pack_launches=run["packs"],
                backup_scatters_per_ply=run["scatters"] / plies,
                failed_checks=run["failed_checks"]), fails


def phase_selfplay(params, stats, saved_cfg, card: str):
    """chip_15x15 self-play (the preset's backup interval 1: the main
    path), then the same seed, plies and bundle at backup interval 2:
    every ply, the final state and the trajectory bit-equal; and where
    the ply goes at both intervals (capped_breakdown)."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    cfg = apply_overrides(get_preset("chip_15x15"), ["net.use_pallas=true"])
    check_fit("15x15", saved_cfg, cfg)
    runs = interval_runs(cfg, params, stats, SELFPLAY_PLIES,
                         SELFPLAY_REPEATS, (1, 2))
    (main, fails), (deferred, fails2) = (
        run_summary(runs[i], cfg.net.blocks, "resident") for i in (1, 2))
    equal = runs_bit_equal(runs[1], runs[2])
    fails += [f"interval_2 {f}" for f in fails2]
    fails += [] if equal else ["interval_2 not bit-equal"]
    emit("selfplay", **{**runs[1]["out"], **main}, interval_2=deferred,
         bit_equal_across_intervals=equal, nvidia_smi=nvidia_smi(),
         card=card, failed=fails, ok=not fails)
    if fails:
        raise AssertionError(f"self-play phase failed its checks: {fails}")
    emit("capped_breakdown", **capped_breakdown(cfg, params, stats,
                                                CAPPED_BREAKDOWN_PLIES),
         nvidia_smi=nvidia_smi(), card=card, ok=True)
    return runs[1]["launches"]


def phase_selfplay_renju(card: str):
    """renju_19x19 self-play at full width (512 envs, 400 sims, lb 8, cap
    128, int16 value sums; 10 blocks × 128 from pretrained/19x19_10b,
    Renju rules) at backup interval 2 and again at 1 from the same seed:
    each run checked as selfplay_run and run_summary check it, every
    launch streaming, the two bit-equal; the peak device memory against
    utils/memory.py's estimate; where a ply goes at both intervals and
    the device-busy share of one ply."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.utils import memory
    params, stats, saved_cfg = phase_bundle("19x19_10b")
    cfg = apply_overrides(get_preset("renju_19x19"), ["net.use_pallas=true"])
    check_fit("19x19_10b", saved_cfg, cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = interval_runs(cfg, params, stats, RENJU_PLIES, RENJU_REPEATS,
                         (2, 1))
    peak = torch.cuda.max_memory_allocated() - base
    (deferred, fails), (main, fails1) = (
        run_summary(runs[i], cfg.net.blocks, "streaming") for i in (2, 1))
    equal = runs_bit_equal(runs[2], runs[1])
    fails += [f"interval_1 {f}" for f in fails1]
    fails += [] if equal else ["intervals not bit-equal"]
    terms = memory.estimate_terms(cfg)
    est = sum(terms.values())
    fails += [] if est >= peak else ["memory estimate below the peak"]
    emit("selfplay_renju", **{**runs[2]["out"], **deferred},
         interval_1=main,
         bit_equal_across_intervals=equal, bundle="pretrained/19x19_10b",
         rules=cfg.env.rules, blocks=cfg.net.blocks,
         channels=cfg.net.channels, measured_peak_bytes=peak,
         allocated_before_bytes=base, estimate_bytes=est,
         estimate_terms=terms,
         selfplay_terms_over_peak=(terms["tree"] + terms["act"]
                                   + terms["params"]) / peak,
         nvidia_smi=nvidia_smi(), card=card, failed=fails, ok=not fails)
    if fails:
        raise AssertionError(f"renju self-play phase failed its checks: "
                             f"{fails}")
    emit("capped_breakdown", **capped_breakdown(
        cfg, params, stats, RENJU_BREAKDOWN_PLIES, profile=True),
        nvidia_smi=nvidia_smi(), card=card, ok=True)
    return runs[2]["launches"], runs[2]["packs"]


def capped_breakdown(cfg, params, stats, plies: int,
                     profile: bool = False) -> dict:
    """Where a ply of the capped search goes at backup intervals 1 and 2,
    by synchronised timers: a sync before and after each part (the
    evaluator's calls split by batch into the root and leaf forwards;
    the descent, `_select_lanes`, with the pending fold at interval 2;
    the leaf env.step; the stats backup, `_backup`; the rest of the pass
    is the expansion; the rest of the search its set-up and the root
    visits; then the ply's own env step and reset). The intervals take
    turns 1, 2, 2, 1, each turn `plies` plies from the same positions and
    seed (the searches are bit-equal, so the work is the same), first
    without the timers (the ply's wall time) and then with them. With
    `profile`, the device's kernel time of one interval-2 ply."""
    from alphafive_tpu_torch.config import apply_overrides
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.mcts import search, search_capped
    from alphafive_tpu_torch.models.evaluator import net_evaluator
    e = cfg.train.num_envs
    net_eval = net_evaluator(cfg.env, cfg.net, params, stats, "cuda")
    names = ("root_forward", "leaf_forward", "descent", "leaf_env_step",
             "backup", "pass", "search", "ply_env_step", "untimed", "timed")
    acc = {i: dict.fromkeys(names, 0.0) for i in (1, 2)}
    into = [acc[1]]

    def timer(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into[0][name] += time.perf_counter() - t0
            return out
        return run

    forward = [net_eval]

    def evaluate(board, to_play, last):
        return forward[0](board, to_play, last)

    def timed_forward(board, to_play, last):
        name = "root_forward" if board.shape[0] == e else "leaf_forward"
        return timer(name, net_eval)(board, to_play, last)

    saved = (search_capped._select_lanes, search_capped._backup,
             search_capped._run_pass, vector.step)

    def advance(st, action):
        st = saved[3](cfg.env, st, action)
        return vector.reset_where(cfg.env, st, st.done)

    def plies_from(start, mcts, play, run):
        gen = torch.Generator(device="cuda").manual_seed(5)
        st = start
        for _ in range(plies):
            res = run(cfg.env, mcts, evaluate, st, gen)
            st = play(st, res.visits.argmax(-1).int())
        return st

    start = random_states(cfg.env, e, 20, seed=3)
    mcts = {i: apply_overrides(cfg, [f"mcts.backup_interval={i}"]).mcts
            for i in (1, 2)}
    for interval in (1, 2, 2, 1):
        into[0] = acc[interval]
        timer("untimed", plies_from)(start, mcts[interval], advance,
                                     search.run_mcts)
        search_capped._select_lanes = timer("descent", saved[0])
        search_capped._backup = timer("backup", saved[1])
        search_capped._run_pass = timer("pass", saved[2])
        vector.step = timer("leaf_env_step", saved[3])
        forward[0] = timed_forward
        try:
            timer("timed", plies_from)(
                start, mcts[interval], timer("ply_env_step", advance),
                timer("search", search.run_mcts))
        finally:
            (search_capped._select_lanes, search_capped._backup,
             search_capped._run_pass, vector.step) = saved
            forward[0] = net_eval
    out = {"preset": cfg.name, "method": "synchronised timers", "envs": e,
           "plies_per_turn": plies, "turns": [1, 2, 2, 1]}
    for interval in (1, 2):
        ms = {k: v / (2 * plies) * 1e3 for k, v in acc[interval].items()}
        # nested parts: the descent, the leaf step and forward and the
        # backup run inside the pass, the passes and the root forward
        # inside the search; "timed" holds the nested timers twice
        parts = {
            "root_forward": ms["root_forward"], "descent": ms["descent"],
            "leaf_env_step": ms["leaf_env_step"],
            "leaf_forward": ms["leaf_forward"], "backup": ms["backup"],
            "expansion": ms["pass"] - ms["descent"] - ms["leaf_env_step"]
            - ms["leaf_forward"] - ms["backup"],
            "search_setup_and_visits": ms["search"] - ms["root_forward"]
            - ms["pass"],
            "ply_env_step": ms["ply_env_step"]}
        out[f"interval_{interval}"] = {
            "ms_per_ply": parts, "timed_ply_ms": ms["timed"],
            "untimed_ply_ms": ms["untimed"],
            "untimed_env_steps_per_s": e / ms["untimed"] * 1e3}
    if profile:
        device = device_profile(
            lambda: plies_from(start, mcts[2], advance, search.run_mcts), 1)
        kernel_ms = device["kernel_ms"] and device["kernel_ms"] / plies
        untimed = out["interval_2"]["untimed_ply_ms"]
        out["interval_2"].update(
            device_kernel_ms_per_ply=kernel_ms,
            device_busy_share=kernel_ms and kernel_ms / untimed,
            top_kernels_ms_per_ply=device["top"])
    return out


def phase_selfplay_lowsim(params, stats, saved_cfg, card: str):
    """lowsim_15x15 self-play through selfplay_bench.run: every root live,
    its visits summing to 16, every move legal and visited, π' finite,
    summing to 1 and zero on stones; two forwards a ply through the
    kernel's resident variant."""
    from alphafive_tpu_torch.benchmarks import selfplay_bench
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    cfg = apply_overrides(get_preset("lowsim_15x15"), ["net.use_pallas=true"])
    check_fit("15x15_lowsim", saved_cfg, cfg)
    sims = cfg.mcts.num_simulations
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    plies = [0]

    def observe(state, res, action):
        a = action.long()[:, None]
        pi = res.pi_target
        bad.add_((res.visits.sum(-1) != sims).sum()
                 + (state.board.gather(1, a)[:, 0] != 0).sum()
                 + (res.visits.gather(1, a)[:, 0] < 1).sum()
                 + state.done.sum() + (~torch.isfinite(pi)).sum()
                 + ((pi.sum(-1) - 1).abs() >= 1e-5).sum()
                 + ((pi != 0) & (state.board != 0)).sum())
        plies[0] += 1

    rb.resblock_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    out, traj = selfplay_bench.run(
        cfg, plies=LOWSIM_PLIES, warmup=0, repeats=LOWSIM_REPEATS,
        device="cuda", params=params, batch_stats=stats, observe=observe,
        return_trajectory=True)
    launches = rb.resblock_launches
    variants = dict(rb.variant_launches)
    expected = cfg.net.blocks * LOWSIM_FORWARDS * plies[0]
    ok = bool(bad.item() == 0 and launches == expected
              and variants["resident"] == launches)
    emit("selfplay_lowsim", **out, total_plies=plies[0],
         resblock_launches=launches, variant_launches=variants,
         expected_launches=expected, failed_checks=bad.item(),
         nvidia_smi=nvidia_smi(), card=card, ok=ok)
    if not ok:
        raise AssertionError("lowsim self-play phase failed its checks")
    return launches, traj, cfg


def phase_lowsim_breakdown(params, stats, cfg, card: str):
    """Where a lowsim_15x15 ply goes, by synchronised timers: a sync
    before and after each part (the evaluator's calls split by batch into
    the root and leaf forwards; the descent; the leaf env.step; the rest
    of the pass is the backup; the rest of the search is the Gumbel
    set-up, the halving and π'; then the ply's own env step and reset).
    Also the ply's wall time without the timers' syncs."""
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.mcts import gumbel, search
    from alphafive_tpu_torch.models.evaluator import net_evaluator
    e = cfg.train.num_envs
    net_eval = net_evaluator(cfg.env, cfg.net, params, stats, "cuda")
    acc = dict.fromkeys(("root_forward", "leaf_forward", "descent",
                         "leaf_env_step", "pass_rest", "search",
                         "ply_env_step"), 0.0)

    def timer(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return run

    def evaluate(board, to_play, last):
        name = "root_forward" if board.shape[0] == e else "leaf_forward"
        return timer(name, net_eval)(board, to_play, last)

    gen = torch.Generator(device="cuda").manual_seed(5)

    def advance(st, action):
        st = saved[2](cfg.env, st, action)
        return vector.reset_where(cfg.env, st, st.done)

    def ply(st):
        res = gumbel.run_gumbel_mcts(cfg.env, cfg.mcts, evaluate, st, gen)
        return play(st, res.action)

    saved = (search._select_one, search._expand_and_backup, vector.step,
             gumbel.run_gumbel_mcts)
    st = random_states(cfg.env, e, 30, seed=3)
    play = advance
    ply(st)                                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BREAKDOWN_PLIES):
        st = ply(st)
    torch.cuda.synchronize()
    untimed = (time.perf_counter() - t0) / BREAKDOWN_PLIES
    acc.update(dict.fromkeys(acc, 0.0))   # the forwards ran untimed too
    search._select_one = timer("descent", saved[0])
    search._expand_and_backup = timer("pass_rest", saved[1])
    vector.step = timer("leaf_env_step", saved[2])
    gumbel.run_gumbel_mcts = timer("search", saved[3])
    play = timer("ply_env_step", advance)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BREAKDOWN_PLIES):
            st = ply(st)
        torch.cuda.synchronize()
        timed = (time.perf_counter() - t0) / BREAKDOWN_PLIES
    finally:
        (search._select_one, search._expand_and_backup, vector.step,
         gumbel.run_gumbel_mcts) = saved
    ms = {k: v / BREAKDOWN_PLIES * 1e3 for k, v in acc.items()}
    device = device_profile(lambda: ply(st), BREAKDOWN_PLIES)
    # nested parts: the leaf step and forward run inside the pass's rest,
    # and the pass and root forward inside the search
    parts = {
        "root_forward": ms["root_forward"], "descent": ms["descent"],
        "leaf_env_step": ms["leaf_env_step"],
        "leaf_forward": ms["leaf_forward"],
        "backup": ms["pass_rest"] - ms["leaf_env_step"] - ms["leaf_forward"],
        "setup_halving_and_pi": ms["search"] - ms["root_forward"]
        - ms["descent"] - ms["pass_rest"],
        "ply_env_step": ms["ply_env_step"]}
    total = timed * 1e3
    kernel_ms = device["kernel_ms"]
    emit("lowsim_breakdown", method="synchronised timers", envs=e,
         plies=BREAKDOWN_PLIES, ms_per_ply=parts,
         share={k: v / total for k, v in parts.items()},
         timed_ply_ms=total, untimed_ply_ms=untimed * 1e3,
         untimed_env_steps_per_s=e / untimed,
         device_kernel_ms_per_ply=kernel_ms,
         device_busy_share=(None if kernel_ms is None
                            else kernel_ms / (untimed * 1e3)),
         top_kernels_ms_per_ply=device["top"], nvidia_smi=nvidia_smi(),
         card=card, ok=True)


def device_profile(step, calls: int, top: int = 8) -> dict:
    """Device kernel ms per call of `step` from a torch.profiler trace of
    `calls` calls (CUDA activity only; the kernels of one stream do not
    overlap), and the `top` kernels by time. None where the trace holds
    no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3 / calls)
    if not by_name:
        return {"kernel_ms": None, "top": None}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    shown = {}
    for name, ms in ranked:   # names cut to 80 characters may coincide
        shown[name[:80]] = shown.get(name[:80], 0.0) + ms
    return {"kernel_ms": sum(by_name.values()), "top": shown}


def phase_gumbel_capped_vs_uncapped(params, stats, cfg):
    """CAPPED_ENVS random positions, the lowsim net through the kernel,
    one g table: run_gumbel_mcts full width and with branch_cap 225 at
    lowsim_15x15's budget and types. Equal visits and moves, π' within
    1e-5."""
    from alphafive_tpu_torch.mcts.gumbel import run_gumbel_mcts
    from alphafive_tpu_torch.models.evaluator import net_evaluator
    evaluate = net_evaluator(cfg.env, cfg.net, params, stats, "cuda")
    st = random_states(cfg.env, CAPPED_ENVS, 30, seed=7)
    u = torch.rand(st.board.shape, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(8))
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    un = run_gumbel_mcts(cfg.env, cfg.mcts, evaluate, st, gumbel=g)
    cap = run_gumbel_mcts(cfg.env, dataclasses.replace(
        cfg.mcts, branch_cap=cfg.env.num_actions), evaluate, st, gumbel=g)
    torch.cuda.synchronize()
    pi_err = (un.pi_target - cap.pi_target).abs().max().item()
    out = dict(envs=CAPPED_ENVS, branch_cap=cfg.env.num_actions,
               visits_equal=bool(torch.equal(un.visits, cap.visits)),
               actions_equal=bool(torch.equal(un.action, cap.action)),
               pi_max_abs_diff=pi_err,
               visits_sum_to_sims=bool((un.visits.sum(-1)
                                        == cfg.mcts.num_simulations).all()))
    ok = (out["visits_equal"] and out["actions_equal"] and pi_err <= 1e-5
          and out["visits_sum_to_sims"])
    emit("gumbel_capped_vs_uncapped", **out, ok=ok)
    if not ok:
        raise AssertionError("capped and full-width Gumbel disagree")


def phase_replay(traj, cfg, card: str):
    """The lowsim trajectory (z-resolved) written into a ring of the
    preset's capacity on the card, and one batch sampled: shapes and
    types, size and pointer, π rows summing to 1 (bf16) and zero on the
    transformed board's stones, every last move on a stone."""
    from alphafive_tpu_torch.replay import buffer
    ring = buffer.init(cfg.env, cfg.replay, device="cuda")
    m, bs, s = traj.board.shape[0], cfg.replay.batch_size, cfg.env.board_size
    t = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t[0].record()
    buffer.write(ring, traj.board, traj.to_play, traj.last_move, traj.pi,
                 traj.z, traj.z_valid, traj.pi_valid)
    t[1].record()
    feats, pi, z, zv, pv = buffer.sample(
        cfg.env, ring, bs, torch.Generator(device="cuda").manual_seed(9))
    t[2].record()
    torch.cuda.synchronize()
    stones = (feats[..., 0] + feats[..., 1]).reshape(bs, -1) > 0
    last = feats[..., 2].reshape(bs, -1) > 0
    out = dict(
        capacity=cfg.replay.capacity, written=m, size=ring.size,
        ptr=ring.ptr, batch=bs, write_ms=t[0].elapsed_time(t[1]),
        sample_ms=t[1].elapsed_time(t[2]),
        shapes_ok=(tuple(feats.shape) == (bs, s, s, 4)
                   and tuple(pi.shape) == (bs, s * s)
                   and all(x.shape == (bs,) for x in (z, zv, pv))),
        dtypes_ok=(all(x.dtype == torch.float32
                       for x in (feats, pi, z, zv, pv))
                   and ring.pi.dtype == torch.bfloat16
                   and ring.board.dtype == torch.int8),
        pi_sum_max_err=(pi.sum(-1) - 1).abs().max().item(),
        pi_on_stones=int((pi[stones] != 0).sum()),
        last_moves=int(last.sum()), last_off_stones=int((last
                                                         & ~stones).sum()),
        z_ok=bool(((z == -1) | (z == 0) | (z == 1)).all()),
        nvidia_smi=nvidia_smi(), card=card)
    ok = (out["size"] == out["ptr"] == m and out["shapes_ok"]
          and out["dtypes_ok"] and out["pi_sum_max_err"] <= 4e-3
          and out["pi_on_stones"] == 0 and out["last_off_stones"] == 0
          and out["last_moves"] > 0 and out["z_ok"])
    emit("replay", **out, ok=ok)
    if not ok:
        raise AssertionError("replay phase failed its checks")


def random_net(board: int):
    """chip_15x15's net (4 blocks × 64, bf16, the resblock kernel) on a
    `board`×`board` board, random weights from seed 0: (params, stats,
    cfg)."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.models.resnet import init_params
    cfg = apply_overrides(get_preset("chip_15x15"), [
        "net.use_pallas=true", f"env.board_size={board}"])
    return (*init_params(cfg.env, cfg.net, seed=0), cfg)


def packed_search(bundle: str, envs: int, seed: int, select=None,
                  sims: int = SIMS):
    """Search `envs` random positions with a bundle net (or, for
    RANDOM_33, random_net(33)) on the packed tree: (SearchResult,
    PackedTree, seconds), f32 priors and values."""
    from alphafive_tpu_torch.config import MCTSConfig
    from alphafive_tpu_torch.mcts.search_packed import run_mcts_packed
    from alphafive_tpu_torch.models.evaluator import net_evaluator
    from alphafive_tpu_torch.train.checkpoint import load_model
    params, stats, cfg = (random_net(33) if bundle == RANDOM_33 else
                          load_model(os.path.join(ROOT, "pretrained", bundle)))
    evaluate = net_evaluator(cfg.env, cfg.net, params, stats, "cuda")
    st = random_states(cfg.env, envs, 30, seed)
    mcts = MCTSConfig(num_simulations=sims, max_depth=DEPTH,
                      select_impl="pallas")
    kw = {} if select is None else {"select": select}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, tree = run_mcts_packed(cfg.env, mcts, evaluate, st, add_noise=False,
                                return_tree=True, **kw)
    torch.cuda.synchronize()
    return res, tree, time.perf_counter() - t0, (cfg, evaluate, st, mcts)


def phase_select_kernel_vs_plain(latency: dict):
    """The select kernel against its plain version on the trees 400-sim
    searches left (and on env 0 of the first alone, E = 1), with forced_k
    0 and > 0 and terminal roots: all five outputs exactly equal."""
    rows = []
    for i, (bundle, envs) in enumerate(SELECT_TREES):
        res, tree, _, (cfg, *_) = packed_search(bundle, envs, seed=10 + i)
        trees = [(envs, tree.packed)]
        if i == 0:
            trees.append((1, tree.packed[:1].contiguous()))
        for e, packed in trees:
            rows += select_cases(bundle, e, packed, cfg.env.num_actions,
                                 latency, terminal=i == 0)
        if (res.visits.sum(-1) != SIMS).any():
            raise AssertionError(f"{bundle}: a root's visits do not sum to "
                                 f"{SIMS}")
    return rows


def select_cases(bundle, envs, tree, a, latency, terminal):
    """One tree's rows: forced_k 0 and FORCED_K (and, with `terminal`,
    every third root made terminal), each checked, timed and bounded."""
    cases = [("tree", tree, 0.0), ("tree", tree, FORCED_K)]
    if terminal:
        done_root = tree.clone()
        done_root[::3, 0, sel.SEC_META, 0] = 1.0
        cases.append(("terminal_roots", done_root, 0.0))
    rows, base_act = [], None
    for kind, packed, fk in cases:
        got = sel.select_batch(packed, a, DEPTH, 5.0, fk)
        torch.cuda.synchronize()
        ref = sel.select_batch_reference(packed, a, DEPTH, 5.0, fk)
        equal = all(torch.equal(g, r) for g, r in zip(got, ref))
        if base_act is None:
            base_act = ref[1]
        steps = (ref[2].long() + 1).clamp(max=DEPTH)   # loop trips per env
        row = dict(bundle=bundle, envs=envs, a_pad=packed.shape[-1],
                   nodes=packed.shape[1], depth_limit=DEPTH,
                   forced_k=fk, case=kind, equal=equal,
                   max_abs_err=max((g - r).abs().max().item()
                                   for g, r in zip(got, ref)),
                   mean_depth=ref[2].float().mean().item(),
                   max_steps=int(steps.max()),
                   revisits=int((ref[1] < 0).sum()),
                   acts_changed_vs_k0=int((ref[1] != base_act).sum()))
        if not equal:
            emit("select_kernel_vs_plain", **row, ok=False)
            raise AssertionError(f"select kernel disagrees: {row}")
        timed(row, lambda: sel.select_batch(packed, a, DEPTH, 5.0, fk),
              lambda: sel.select_batch_reference(packed, a, DEPTH, 5.0, fk))
        # this data's reads: sections N, W, P of each row on the path
        # plus its child id and terminal flag; writes: the outputs
        a_pad = packed.shape[-1]
        n_steps = int(steps.sum())
        row["bound_ms"], row["bound_by"] = bound(
            n_steps * 3 * a_pad * 10, n_steps * (3 * a_pad + 2) * 4
            + sum(t.numel() * 4 for t in ref), torch.float32)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["latency_bound_ms"] = select_profile.latency_bound_ms(
            latency, row["max_steps"])
        row["share_of_latency_bound"] = row["latency_bound_ms"] / row["ms"]
        row["library_ms"] = None   # no PyTorch call computes it
        emit("select_kernel_vs_plain", **row, ok=True)
        rows.append(row)
    return rows


def phase_search_packed(card: str):
    """run_mcts_packed with the 15×15 bundle, 16 envs, 400 sims, depth cap
    64: through the kernel, through the plain descent, and against the
    full-width search at leaf_batch 1 (all f32: equal visits)."""
    from alphafive_tpu_torch.mcts import search
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    packed_search("15x15", 16, seed=20)           # warm-up
    sel.select_launches = 0
    res_k, _, t_k, (cfg, evaluate, st, mcts) = packed_search("15x15", 16,
                                                             seed=20)
    launches = sel.select_launches
    res_p, _, t_p, _ = packed_search("15x15", 16, seed=20,
                                     select=sel.select_batch_reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f = search.run_mcts(cfg.env, dataclasses.replace(
        mcts, select_impl="xla", leaf_batch=1), evaluate, st,
        add_noise=False)
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    sims = 16 * SIMS
    out = dict(
        bundle="pretrained/15x15", envs=16, sims=SIMS, max_depth=DEPTH,
        select_launches=launches, expected_launches=SIMS,
        kernel_equals_plain=bool(torch.equal(res_k.visits, res_p.visits)),
        packed_equals_full_width=bool(torch.equal(res_k.visits,
                                                  res_f.visits)),
        roots_sum_to_sims=bool((res_k.visits.sum(-1) == SIMS).all()),
        root_value_max_diff_full_width=(res_k.root_value
                                        - res_f.root_value).abs().max()
        .item(),
        kernel_seconds=t_k, plain_seconds=t_p, full_width_seconds=t_f,
        sims_per_s_kernel=sims / t_k, sims_per_s_plain=sims / t_p,
        sims_per_s_full_width=sims / t_f, nvidia_smi=nvidia_smi(), card=card)
    ok = (launches == SIMS and out["kernel_equals_plain"]
          and out["packed_equals_full_width"] and out["roots_sum_to_sims"]
          and out["root_value_max_diff_full_width"] <= 1e-5
          and bool(torch.equal(res_k.root_value, res_p.root_value)))
    emit("search_packed", **out, ok=ok)
    if not ok:
        raise AssertionError("packed search phase failed its checks")
    return out


def phase_eval(card: str):
    """`cli eval` at chip_15x15 through the packed search, 2 games against
    a 16-rollout anchor. Every move legal (stones on the board = moves
    made, colours alternate), results add up, and 400 select launches per
    net search."""
    from alphafive_tpu_torch import cli
    from alphafive_tpu_torch.train import evaluate as ev_mod
    finals = []
    play_games = ev_mod.play_games

    def recording(*args, **kw):
        st = play_games(*args, **kw)
        finals.append(st)
        return st

    ev_mod.play_games = recording
    buf = io.StringIO()
    sel.select_launches = 0
    rb.resblock_launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(EVAL_ARGV)
        torch.cuda.synchronize()
    finally:
        ev_mod.play_games = play_games
    seconds = time.perf_counter() - t0
    launches = sel.select_launches
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    plies, net_searches, legal = [], 0, True
    for st in finals:   # one game each: the net black, then white
        m = int(st.move_count[0])
        stones = st.board[0]
        black, white = int((stones == 1).sum()), int((stones == -1).sum())
        legal &= (black + white == m and 0 <= black - white <= 1
                  and bool(st.done[0]))
        plies.append(m)
        # two plies per call: the call that ends the game runs both plies,
        # so each side searched ceil(m / 2) times
        net_searches += math.ceil(m / 2)
    out = dict(argv=EVAL_ARGV, result=result, rc=rc, wall_seconds=seconds,
               plies=plies, net_searches=net_searches,
               select_launches=launches,
               expected_launches=SIMS * net_searches,
               resblock_launches=rb.resblock_launches, all_moves_legal=legal,
               nvidia_smi=nvidia_smi(), card=card)
    ok = (rc == 0 and len(finals) == 2 and legal
          and result["games"] == 2
          and result["wins"] + result["losses"] + result["draws"] == 2
          and launches == SIMS * net_searches > 0)
    emit("eval", **out, ok=ok)
    if not ok:
        raise AssertionError("cli eval phase failed its checks")
    return launches


def net_flops(cfg) -> float:
    """Multiply-adds × 2 of one position's forward: the 3×3 stem and the
    blocks' convs, the 1×1 head convs and the three dense layers."""
    s2, c, a = cfg.env.board_size ** 2, cfg.net.channels, cfg.env.num_actions
    convs = 2 * s2 * 9 * (4 * c + 2 * cfg.net.blocks * c * c)
    heads = 2 * s2 * c * 3 + 2 * (2 * a * a + a * cfg.net.value_hidden
                                  + cfg.net.value_hidden)
    return convs + heads


def learner_batches(traj, cfg, n: int, seed: int):
    """`n` batches of the preset's size sampled on the card from a ring
    filled with a self-play trajectory."""
    from alphafive_tpu_torch.replay import buffer
    ring = buffer.init(cfg.env, cfg.replay, device="cuda")
    buffer.write(ring, traj.board, traj.to_play, traj.last_move, traj.pi,
                 traj.z, traj.z_valid, traj.pi_valid)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [buffer.sample(cfg.env, ring, cfg.replay.batch_size, gen)
            for _ in range(n)]


def phase_learner_step(params, stats, traj, saved_cfg, card: str):
    """One learner step of train_lowsim_15x15 at batch 512 (the
    `15x15_lowsim` weights, batches sampled from the lowsim self-play
    ring): three f32 steps on the card against the port's own CPU steps
    on the same batches (TF32 off) within LEARNER_TOL, then the bf16 step
    and the probe's eval forward timed with CUDA events beside their FLOP
    bounds, and the step's device-busy share from a torch.profiler
    trace."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.train import learner
    cfg = apply_overrides(get_preset("train_lowsim_15x15"),
                          ["net.use_pallas=true"])
    check_fit("15x15_lowsim", saved_cfg, cfg)
    batches = learner_batches(traj, cfg, LEARNER_CHECK_STEPS, seed=11)
    f32 = dataclasses.replace(cfg.net, compute_dtype="float32")
    card_ts, cpu_ts = (learner.init_train_state(cfg.env, f32, cfg.train,
                                                params, stats, dev)
                       for dev in ("cuda", "cpu"))
    worst = dict.fromkeys(("aux_rel", "stats_abs", "moment_abs",
                           "param_abs"), 0.0)
    ok = True
    for b in batches:
        _, aux = learner.train_step(cfg.env, f32, cfg.train, card_ts, b)
        _, ref = learner.train_step(cfg.env, f32, cfg.train, cpu_ts,
                                    tuple(x.cpu() for x in b))
        for k in aux:
            g, w = float(aux[k]), float(ref[k])
            rel = abs(g - w) / max(abs(w), 1e-12)
            worst["aux_rel"] = max(worst["aux_rel"], rel)
            ok &= math.isfinite(g) and abs(g - w) <= LEARNER_TOL[
                "aux_rtol"] * abs(w) + 1e-7
    torch.cuda.synchronize()
    (gp, gs), (wp, ws) = card_ts.net.to_flax(), cpu_ts.net.to_flax()

    def leaves(tree):
        return [x for v in tree.values() for x in (
            leaves(v) if isinstance(v, dict) else [v])]
    for g, w in zip(leaves(gs), leaves(ws)):
        err = abs(g - w)
        worst["stats_abs"] = max(worst["stats_abs"], float(err.max()))
        ok &= bool((err <= LEARNER_TOL["stats_atol"]
                    + LEARNER_TOL["stats_rtol"] * abs(w)).all())
    for g, w in zip(leaves(gp), leaves(wp)):
        worst["param_abs"] = max(worst["param_abs"], float(abs(g - w).max()))
    ok &= worst["param_abs"] <= LEARNER_TOL["param_atol"]
    for mg, mw in ((card_ts.opt_state.mu, cpu_ts.opt_state.mu),
                   (card_ts.opt_state.nu, cpu_ts.opt_state.nu)):
        for g, w in zip(mg, mw):
            g = g.cpu()
            err = (g - w).abs()
            worst["moment_abs"] = max(worst["moment_abs"], float(err.max()))
            ok &= bool((err <= LEARNER_TOL["moment_rtol"] * w.abs()
                        + LEARNER_TOL["moment_atol_of_max"]
                        * float(w.abs().max())).all())

    # the bf16 step, timed: eager CUDA events (median of 5 windows of 20)
    ts = learner.init_train_state(cfg.env, cfg.net, cfg.train, params,
                                  stats, "cuda")
    b = batches[0]

    def step():
        learner.train_step(cfg.env, cfg.net, cfg.train, ts, b)

    def probe():
        ts.net(b[0])
    step_ms, step_spread = timing.eager_ms(step)
    probe_ms, probe_spread = timing.eager_ms(probe)
    device = device_profile(step, 5, top=12)
    bs = cfg.replay.batch_size
    n_params = sum(p.numel() for p in ts.net.parameters())
    # the step reads the batch once, and reads and writes each weight and
    # its two Adam moments
    in_bytes = sum(x.numel() * x.element_size() for x in b)
    bound_ms, bound_by = bound(3 * net_flops(cfg) * bs,
                               in_bytes + 6 * 4 * n_params, torch.bfloat16)
    probe_bound, _ = bound(net_flops(cfg) * bs, b[0].numel() * 4
                           + 4 * n_params, torch.bfloat16)
    kernel_ms = device["kernel_ms"]
    out = dict(batch=bs, f32_steps=LEARNER_CHECK_STEPS, tol=LEARNER_TOL,
               worst=worst, bf16_step_ms=step_ms,
               bf16_step_ms_spread=step_spread,
               step_flops=3 * net_flops(cfg) * bs, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / step_ms,
               device_kernel_ms_per_step=kernel_ms,
               device_busy_share=(None if kernel_ms is None
                                  else kernel_ms / step_ms),
               top_kernels_ms_per_step=device["top"],
               probe_forward_ms=probe_ms, probe_forward_spread=probe_spread,
               probe_bound_ms=probe_bound,
               probe_share_of_bound=probe_bound / probe_ms,
               library_ms=None, nvidia_smi=nvidia_smi(), card=card, ok=ok)
    emit("learner_step", **out)
    if not ok:
        raise AssertionError("learner step: the card disagrees with the CPU")
    return out


def phase_iteration_lowsim(params, stats, saved_cfg, card: str):
    """The actor-learner iteration at train_lowsim_15x15 + use_pallas from
    the `15x15_lowsim` weights, through selfplay_bench.run_iteration:
    iteration 0 stages only (no update, empty ring); every later one
    writes 65,536 rows, runs at least one learner step with finite
    losses, moves the weights and batch statistics and keeps lr_scale in
    [0.1, lr_scale_max]; every resblock launch (8 a ply) resident. Then
    the rebuilt fused evaluator against its plain twin on 2,048
    positions."""
    from alphafive_tpu_torch.benchmarks import selfplay_bench
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.models.resnet import FusedPolicyValueNet
    cfg = apply_overrides(get_preset("train_lowsim_15x15"),
                          ["net.use_pallas=true"])
    check_fit("15x15_lowsim", saved_cfg, cfg)
    tc = cfg.train
    chunk = tc.num_envs * tc.selfplay_plies_per_iter
    snap = lambda tensors: [t.detach().clone() for t in tensors]
    change = lambda now, before: max(float((a - b).abs().max())
                                     for a, b in zip(now, before))
    seen = []

    def observe(carry, metrics, seconds):
        net = carry.train_state.net
        now = (snap(net.parameters()), snap(net.buffers()))
        moved = ((None, None) if not seen else
                 tuple(change(a, b) for a, b in zip(now, seen[-1]["weights"])))
        seen.append(dict(metrics=metrics, seconds=seconds, weights=now,
                         moved=moved, carry=carry,
                         launches=rb.resblock_launches))

    rb.resblock_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    out = selfplay_bench.run_iteration(
        cfg, warmup=ITERATION_WARMUP, repeats=ITERATION_REPEATS,
        device="cuda", params=params, batch_stats=stats, observe=observe)
    launches = rb.resblock_launches
    variants = dict(rb.variant_launches)
    iters = len(seen)
    per_ply = cfg.net.blocks * LOWSIM_FORWARDS
    expected = per_ply * tc.selfplay_plies_per_iter * iters
    fails = []
    for i, it in enumerate(seen):
        m = it["metrics"]
        if i == 0:
            if m["updated"] != 0.0 or m["buffer_size"] != 0.0:
                fails.append((i, "iteration 0 updated or wrote"))
            continue
        losses = [m[k] for k in ("loss", "policy_loss", "value_loss")]
        checks = {
            "updated": m["updated"] == 1.0,
            "ring": m["buffer_size"] == min(chunk * i, cfg.replay.capacity),
            "executed_steps": m["executed_steps"] >= 1.0,
            "finite_losses": all(math.isfinite(x) for x in losses),
            "params_moved": it["moved"][0] > 0.0,
            "batch_stats_moved": it["moved"][1] > 0.0,
            "lr_scale": 0.1 <= m["lr_scale"] <= tc.lr_scale_max,
            "z_valid_frac": 0.0 <= m["z_valid_frac"] <= 1.0}
        fails += [(i, k) for k, v in checks.items() if not v]
    carry = seen[-1]["carry"]
    ts = carry.train_state
    if not 0.1 <= float(ts.lr_scale) <= tc.lr_scale_max:
        fails.append(("end", "lr_scale"))
    if launches != expected or variants["resident"] != launches:
        fails.append(("all", "launches"))
    # the evaluator the next iteration would build, kernel against plain
    feats = vector.state_features(cfg.env, random_states(cfg.env, 2048, 60))
    kernel_net = FusedPolicyValueNet.from_module(cfg.env, cfg.net, ts.net)
    plain_net = FusedPolicyValueNet.from_module(cfg.env, cfg.net, ts.net,
                                                plain=True)
    logits, value = kernel_net(feats)
    ref_logits, ref_value = plain_net(feats)
    torch.cuda.synchronize()
    lerr = (logits - ref_logits).abs()
    verr = (value - ref_value).abs().max().item()
    atol, rtol = NET_TOL["logits"]
    if not (torch.isfinite(logits).all() and torch.isfinite(value).all()
            and (lerr <= atol + rtol * ref_logits.abs()).all()
            and verr <= NET_TOL["value"]):
        fails.append(("end", "rebuilt evaluator kernel vs plain"))
    per_iter = [dict(it["metrics"], seconds=it["seconds"],
                     params_max_change=it["moved"][0],
                     batch_stats_max_change=it["moved"][1],
                     resblock_launches_so_far=it["launches"])
                for it in seen]
    emit("iteration_lowsim", **out, iterations=iters,
         seconds_per_iteration=[it["seconds"] for it in seen],
         resblock_launches=launches, expected_launches=expected,
         variant_launches=variants, per_iteration=per_iter,
         rebuilt_evaluator=dict(positions=2048,
                                logits_max_abs_err=lerr.max().item(),
                                value_max_abs_err=verr, tol=NET_TOL),
         failed_checks=fails, nvidia_smi=nvidia_smi(), card=card,
         ok=not fails)
    if fails:
        raise AssertionError(f"iteration phase failed its checks: {fails}")
    return launches, carry, cfg


def phase_iteration_breakdown(carry, cfg, card: str):
    """Where an iteration goes: one iteration untimed, then one with a
    sync before and after each part (the evaluator rebuild, self-play,
    the resolve, the ring write, and inside the learner phase its batch
    samples, train steps, probe forwards and adapt_lr_scale), then the
    device kernel time of one more from a torch.profiler trace."""
    from alphafive_tpu_torch import parallel
    from alphafive_tpu_torch.parallel import mesh
    from alphafive_tpu_torch.replay import buffer
    from alphafive_tpu_torch.train import actor, learner
    iteration = parallel.make_train_iteration(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iteration(carry)
    torch.cuda.synchronize()
    untimed = time.perf_counter() - t0
    acc = {}

    def timer(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
            return res
        return run

    patches = [(mesh, "net_evaluator", "evaluator_rebuild"),
               (actor, "selfplay_record", "selfplay"),
               (actor, "resolve_chunk", "resolve"),
               (buffer, "write", "ring_write"),
               (mesh, "learner_phase", "learner_phase"),
               (buffer, "sample", "learner_sample"),
               (learner, "train_step", "learner_steps"),
               (mesh, "policy_logp", "probe_forwards"),
               (learner, "adapt_lr_scale", "adapt_lr_scale")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, label in patches:
        setattr(mod, name, timer(label, getattr(mod, name)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = iteration(carry)
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    device = device_profile(lambda: iteration(carry), 1)
    ms = {k: v * 1e3 for k, v in acc.items()}
    kernel_ms = device["kernel_ms"]
    env_steps = cfg.train.num_envs * cfg.train.selfplay_plies_per_iter
    emit("iteration_breakdown", method="synchronised timers",
         ms=ms, share={k: v / (timed * 1e3) for k, v in ms.items()},
         learner_share=ms.get("learner_phase", 0.0) / (timed * 1e3),
         timed_ms=timed * 1e3, untimed_ms=untimed * 1e3,
         untimed_env_steps_per_s=env_steps / untimed,
         executed_steps=m["executed_steps"],
         device_kernel_ms=kernel_ms,
         device_busy_share=(None if kernel_ms is None
                            else kernel_ms / (untimed * 1e3)),
         top_kernels_ms=device["top"], nvidia_smi=nvidia_smi(), card=card,
         ok=True)


def records(workdir: str) -> list:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


def flax_trees_equal(a, b) -> bool:
    if isinstance(b, dict):
        return (isinstance(a, dict) and set(a) == set(b)
                and all(flax_trees_equal(a[k], b[k]) for k in b))
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


@contextlib.contextmanager
def patched(*patches):
    """Set (module, name, value) attributes for the block's duration."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def timer(fn, acc: list):
    """`fn` with a sync before and after each call, its seconds into
    `acc`."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        return out
    return run


def carry_diffs(a, b) -> list:
    """Names of the carry parts where `a` and `b` differ (bit for bit)."""
    bad = []
    for part in ("env_state", "buffer", "pending"):
        x, y = getattr(a, part), getattr(b, part)
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            same = (u.dtype == v.dtype and torch.equal(u, v)
                    if isinstance(u, torch.Tensor) else u == v)
            if not same:
                bad.append(f"{part}.{f.name}")
    ta, tb = a.train_state, b.train_state
    for (k, u), v in zip(ta.net.state_dict().items(),
                         tb.net.state_dict().values()):
        if not torch.equal(u, v):
            bad.append(f"net.{k}")
    moments = ta.opt_state.mu + ta.opt_state.nu
    if (len(moments) != len(tb.opt_state.mu + tb.opt_state.nu)
            or not all(torch.equal(u, v) for u, v in zip(
                moments, tb.opt_state.mu + tb.opt_state.nu))):
        bad.append("opt_state.moments")
    if (ta.opt_state.count, ta.step) != (tb.opt_state.count, tb.step):
        bad.append("opt_state.count/step")
    if not torch.equal(ta.lr_scale, tb.lr_scale):
        bad.append("lr_scale")
    if a.has_pending != b.has_pending:
        bad.append("has_pending")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        bad.append("generator")
    return bad


def phase_train_loop(workdir: str, card: str):
    """`cli train` at train_lowsim_15x15 + use_pallas from the lowsim
    bundle (--init-from): 4 iterations, checkpoints at 2 and 4, one ladder
    eval at 4 and the best export. Checks the records (transfer_init,
    four iter records with the JAX keys and the canaries, iterations 1-3
    updating with finite losses, checkpoints 2 and 4, one eval with a
    finite Elo, best), the checkpoint steps, best_model loading with the
    live weights and an equal f32 forward, every resblock launch resident
    or (the eval's batches of 1 to 16) split as the dispatch picks, and
    every batch the eval launched a row of kernel_vs_plain at that
    variant. The save
    and eval seconds by synchronised timers; the device memory peak over
    the phase."""
    from alphafive_tpu_torch import cli
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.models.resnet import PolicyValueNet
    from alphafive_tpu_torch.train import checkpoint as ckpt, loop
    from alphafive_tpu_torch.train import evaluate as ev_mod
    argv = [*TRAIN_ARGV, "--init-from",
            os.path.join(ROOT, "pretrained", "15x15_lowsim"),
            "--workdir", workdir, "--iters", "4"]
    returned, saves, evals, batches = [], [], [], []
    train, fused = loop.train, rb.fused_resblock
    search = ev_mod._search_action
    sides = {"net": [], "anchor": []}

    def timed_search(env_cfg, mcts_cfg, *args):
        side = "net" if mcts_cfg.root_selection == "gumbel" else "anchor"
        return timer(search, sides[side])(env_cfg, mcts_cfg, *args)

    def recording_train(*args, **kw):
        returned.append(train(*args, **kw))
        return returned[-1]

    def recording_fused(x, *args):
        batches.append((*x.shape, x.dtype))
        return fused(x, *args)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rb.resblock_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    t0 = time.perf_counter()
    with patched((loop, "train", recording_train),
                 (ckpt, "save", timer(ckpt.save, saves)),
                 (loop, "run_eval", timer(loop.run_eval, evals)),
                 (rb, "fused_resblock", recording_fused),
                 (ev_mod, "_search_action", timed_search)):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, variants = rb.resblock_launches, dict(rb.variant_launches)
    peak = torch.cuda.max_memory_allocated() - base
    carry = returned[-1][0]
    recs = records(workdir)
    seq = [(r["kind"], r.get("iter")) for r in recs]
    want = [("transfer_init", None), ("iter", 0), ("iter", 1),
            ("checkpoint", 2), ("iter", 2), ("iter", 3), ("checkpoint", 4),
            ("eval", 3), ("best", 4)]
    fails = [] if rc == 0 and seq == want else [("records", seq)]
    iters = [r for r in recs if r["kind"] == "iter"]
    for r in iters:
        losses = [r[k] for k in ("loss", "policy_loss", "value_loss")]
        if set(r) != ITER_KEYS:
            fails.append((r["iter"], "keys", sorted(set(r) ^ ITER_KEYS)))
        if r["iter"] >= 1 and not (r["updated"] == 1.0 and all(
                math.isfinite(x) for x in losses)):
            fails.append((r["iter"], "update"))
        if {r["lr_at_floor"], r["lr_at_ceiling"]} - {0.0, 1.0}:
            fails.append((r["iter"], "canaries"))
    ev = [r for r in recs if r["kind"] == "eval"]
    if not (len(ev) == 1 and math.isfinite(ev[0]["elo"])
            and ev[0]["games"] == TRAIN_EVAL_GAMES):
        fails.append(("eval", ev))
    mgr = ckpt.make_manager(os.path.join(workdir, "ckpt"))
    if mgr.all_steps() != [2, 4]:
        fails.append(("ckpt steps", mgr.all_steps()))
    _, cfg, _ = ckpt.read_meta(mgr)
    # best_model: the live weights, and an equal f32 forward
    bp, bbs, bcfg = ckpt.load_model(os.path.join(workdir, "best_model"))
    live_p, live_s = carry.train_state.net.to_flax()
    weights_equal = flax_trees_equal(bp, live_p) and flax_trees_equal(
        bbs, live_s)
    f32 = dataclasses.replace(cfg.net, compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(12)
    st = vector.init(cfg.env, 256, "cuda")
    for _ in range(20):
        u = torch.rand(st.board.shape, generator=gen, device="cuda")
        st = vector.step(cfg.env, st, torch.where(st.board == 0, u, -1.0)
                         .argmax(-1).int())
    feats = vector.state_features(cfg.env, st)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        best_out = PolicyValueNet.from_flax(bcfg.env, f32, bp, bbs,
                                            "cuda")(feats)
        live_out = PolicyValueNet.from_flax(cfg.env, f32, live_p, live_s,
                                            "cuda")(feats)
    forward_equal = all(torch.equal(x, y) for x, y in zip(best_out,
                                                          live_out))
    if not (weights_equal and forward_equal):
        fails.append(("best_model", weights_equal, forward_equal))
    if not (launches > 0 and variants == dispatched(batches)
            and variants["resident"] + variants["split"] == launches):
        fails.append(("launches", launches, variants))
    seen = sorted({b[0] for b in batches})
    missing = uncovered(batches)
    if missing:
        fails.append(("batches without a kernel_vs_plain row", missing))
    out = dict(
        argv=argv, reduced=TRAIN_REDUCED, rc=rc, seconds=seconds,
        records=seq, iter_seconds=[r["iter_seconds"] for r in iters],
        env_steps_per_s=[r["env_steps_per_s"] for r in iters],
        losses=[r["loss"] for r in iters],
        eval=ev[0] if ev else None, eval_seconds=evals,
        eval_search_seconds={k: sum(v) for k, v in sides.items()},
        eval_moves={k: len(v) for k, v in sides.items()},
        save_seconds=saves,
        checkpoint_step_bytes=dir_bytes(mgr.step_dir(4)),
        best_model_weights_equal=weights_equal,
        best_model_f32_forward_equal=forward_equal,
        resblock_launches=launches, variant_launches=variants,
        resblock_batches=seen, peak_bytes=peak, nvidia_smi=nvidia_smi(),
        card=card, failed_checks=fails, ok=not fails)
    emit("train_loop", **out)
    if fails:
        raise AssertionError(f"train loop phase failed its checks: {fails}")
    return dict(workdir=workdir, carry=carry, cfg=cfg, launches=launches,
                peak_bytes=peak, base_bytes=base)


def phase_train_resume(run: dict, card: str):
    """Step 4 restored onto the device into a fresh carry: every tensor,
    the ring's ptr/size, has_pending and the generator state bit-equal to
    the carry `train` returned. Then `cli train --resume --iters 6`:
    records resume at 4, iterations 4 and 5 updating with finite losses,
    a checkpoint at 6; every resblock launch resident."""
    from alphafive_tpu_torch import cli, parallel
    from alphafive_tpu_torch.train import checkpoint as ckpt
    workdir, cfg = run["workdir"], run["cfg"]
    mgr = ckpt.make_manager(os.path.join(workdir, "ckpt"))
    fresh = parallel.init_carry(cfg, "cuda", seed=cfg.train.seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, back, _, _ = ckpt.restore(mgr, fresh)
    torch.cuda.synchronize()
    restore_seconds = time.perf_counter() - t0
    diffs = carry_diffs(back, run.pop("carry"))
    del fresh, back
    fails = [("restore", step, diffs)] if diffs or step != 4 else []
    before = len(records(workdir))
    argv = [*TRAIN_ARGV, "--workdir", workdir, "--iters", "6", "--resume"]
    rb.resblock_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, variants = rb.resblock_launches, dict(rb.variant_launches)
    recs = records(workdir)[before:]
    seq = [(r["kind"], r.get("iter")) for r in recs]
    if rc != 0 or seq != [("resume", 4), ("iter", 4), ("iter", 5),
                          ("checkpoint", 6)]:
        fails.append(("records", seq))
    iters = [r for r in recs if r["kind"] == "iter"]
    for r in iters:
        if not (r["updated"] == 1.0 and all(math.isfinite(r[k]) for k in (
                "loss", "policy_loss", "value_loss"))):
            fails.append((r["iter"], "update"))
    if not (launches > 0 and variants["resident"] == launches):
        fails.append(("launches", launches, variants))
    emit("train_resume", restored_step=step, restore_seconds=restore_seconds,
         carry_bit_equal=not diffs, differing=diffs, argv=argv, rc=rc,
         seconds=seconds, records=seq,
         iter_seconds=[r["iter_seconds"] for r in iters],
         losses=[r["loss"] for r in iters], resblock_launches=launches,
         variant_launches=variants, steps=mgr.all_steps(),
         nvidia_smi=nvidia_smi(), card=card, failed_checks=fails,
         ok=not fails)
    if fails:
        raise AssertionError(f"train resume phase failed its checks: {fails}")


def phase_export(run: dict, card: str):
    """`cli export` of the latest checkpoint (6): the bundle loads with
    the checkpoint's weights, config.json carries the iteration and the
    learner step; `cli._load_model` on the workdir takes the checkpoint
    path with the same weights."""
    from alphafive_tpu_torch import cli
    from alphafive_tpu_torch.train import checkpoint as ckpt
    workdir = run["workdir"]
    out_dir = os.path.join(workdir, "export")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["export", "--workdir", workdir, "--out", out_dir])
    seconds = time.perf_counter() - t0
    mgr = ckpt.make_manager(os.path.join(workdir, "ckpt"))
    ts, saved = ckpt.restore_train_state(mgr)
    want = ts.net.to_flax()
    params, stats, _ = ckpt.load_model(out_dir)
    with open(os.path.join(out_dir, "config.json")) as f:
        meta = json.load(f)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        lp, ls, net_cfg = cli._load_model(saved, workdir)
    checks = {
        "rc": rc == 0,
        "bundle_weights": flax_trees_equal(params, want[0])
        and flax_trees_equal(stats, want[1]),
        "meta": (meta["iteration"], meta["train_step"]) == (6, ts.step),
        "load_model_took_the_checkpoint":
            "restored checkpoint step 6" in err.getvalue()
            and net_cfg == saved.net and flax_trees_equal(lp, want[0])
            and flax_trees_equal(ls, want[1])}
    fails = [k for k, v in checks.items() if not v]
    emit("export", seconds=seconds, bundle_bytes=dir_bytes(out_dir),
         iteration=meta["iteration"], train_step=meta["train_step"],
         lr_scale=meta["lr_scale"], checks=checks, card=card,
         nvidia_smi=nvidia_smi(), ok=not fails)
    if fails:
        raise AssertionError(f"export phase failed its checks: {fails}")


def phase_memory_guard(run: dict, card: str):
    """utils/memory.py's estimate for the train run's config beside the
    device memory it allocated at its peak over train_loop (above what
    was allocated before): the estimate must not be below the peak. The
    run had no process group: the estimate for its world of one."""
    from alphafive_tpu_torch.parallel import distributed
    from alphafive_tpu_torch.utils import memory
    cfg = run["cfg"]
    terms = memory.estimate_terms(cfg, distributed.world())
    est = sum(terms.values())
    peak = run["peak_bytes"]
    emit("memory_guard", preset=cfg.name, estimate_bytes=est,
         estimate_terms=terms, measured_peak_bytes=peak,
         allocated_before_bytes=run["base_bytes"],
         estimate_over_peak=est / peak,
         budget_bytes=memory.device_budget("cuda"),
         total_memory_bytes=torch.cuda.get_device_properties(0).total_memory,
         nvidia_smi=nvidia_smi(), card=card, ok=est >= peak)
    if est < peak:
        raise AssertionError(f"memory estimate {est} below the measured "
                             f"peak {peak}")



def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(fn, args, nprocs: int, timeout_s: float) -> None:
    """fn(rank, *args) in `nprocs` spawned processes; raise what a rank
    raised, or past `timeout_s`; every process is ended on the way out."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def weights_digest(state_dict) -> str:
    """sha256 of a net's parameters and buffers, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for k, t in state_dict.items():
        h.update(k.encode())
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def two_rank_worker(rank: int, port: int, argv: list, out: str) -> None:
    """One rank of train_two_ranks: joins a gloo group on the card, runs
    `cli.main(argv)` with the multi-host flags (the CLI keeps the group
    it finds) and writes its counts, its self-play env steps, its
    iteration and learner seconds (synchronised timers), the batch
    sizes it launched the resblock kernel at and a digest of its final
    weights to `out`.rank<r>.json."""
    from alphafive_tpu_torch import cli, parallel
    from alphafive_tpu_torch.parallel import distributed, mesh
    from alphafive_tpu_torch.train import actor, loop
    distributed.initialize(f"127.0.0.1:{port}", TWO_RANKS, rank,
                           backend="gloo", device="cuda")
    returned, steps, iter_s, learner_s = [], [], [], []
    train, record = loop.train, actor.selfplay_record
    make, fused = parallel.make_train_iteration, rb.fused_resblock
    batches = set()

    def recording_train(*args, **kw):
        returned.append(train(*args, **kw))
        return returned[-1]

    def recording_selfplay(*args, **kw):
        result = record(*args, **kw)
        steps.append(result[2].env_steps)
        return result

    def timed_make(*args, **kw):
        return timer(make(*args, **kw), iter_s)

    def recording_fused(x, *args):
        batches.add((x.shape[0], x.shape[1], x.shape[3], str(x.dtype)))
        return fused(x, *args)

    rb.resblock_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    with patched((loop, "train", recording_train),
                 (actor, "selfplay_record", recording_selfplay),
                 (parallel, "make_train_iteration", timed_make),
                 (mesh, "learner_phase", timer(mesh.learner_phase,
                                               learner_s)),
                 (rb, "fused_resblock", recording_fused)):
        rc = cli.main([*argv, "--multihost",
                       "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", str(TWO_RANKS),
                       "--process-id", str(rank)])
    carry = returned[-1][0]
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(dict(rank=rank, rc=rc, launches=rb.resblock_launches,
                       variants=dict(rb.variant_launches),
                       local_env_steps=steps, iter_seconds=iter_s,
                       learner_seconds=learner_s,
                       batches=sorted(batches),
                       digest=weights_digest(
                           carry.train_state.net.state_dict()),
                       peak_bytes=torch.cuda.max_memory_allocated()), f)


def phase_train_two_ranks(workdir: str, card: str):
    """`cli train --multihost` at train_lowsim_15x15 + use_pallas from the
    lowsim bundle as two ranks on the one card (gloo): 3 iterations with
    checkpoints at 2 and 3, then a `--resume` to 4 (its checkpoint at 4).
    Checks: one record per event in metrics.jsonl (rank 0 writes it
    alone), iterations 1-3 updating with finite losses, each iteration's
    env_steps the sum of the ranks' own, both ranks' weights bit-identical
    after each run and equal to step 4's model.pt, steps 2-4 each with
    model.pt and both shards (meta world 2), every resblock launch of
    both ranks resident, each rank's device memory peak within the memory
    guard's estimate for a world of two. Prints each rank's and the
    aggregate env-steps/s and the learner's share of each rank's
    iterations. Every batch the ranks launched the resblock kernel at has
    a kernel_vs_plain row."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.train import checkpoint as ckpt
    from alphafive_tpu_torch.utils import memory
    estimate = memory.estimate_device_bytes(apply_overrides(
        get_preset("train_lowsim_15x15"), ["net.use_pallas=true"]),
        TWO_RANKS)
    wd = os.path.join(workdir, "run")
    runs = {"train": [*TWO_RANK_ARGV, "--init-from",
                      os.path.join(ROOT, "pretrained", "15x15_lowsim"),
                      "--workdir", wd, "--iters", "3"],
            "resume": [*TWO_RANK_ARGV, "--workdir", wd, "--iters", "4",
                       "--resume"]}
    want = {"train": [("transfer_init", None), ("iter", 0), ("iter", 1),
                      ("checkpoint", 2), ("iter", 2)],
            "resume": [("resume", 3), ("iter", 3), ("checkpoint", 4)]}
    torch.cuda.empty_cache()
    fails, report, seen = [], {}, 0
    for tag, argv in runs.items():
        out = os.path.join(workdir, tag)
        t0 = time.perf_counter()
        spawn_ranks(two_rank_worker, (free_port(), argv, out), TWO_RANKS,
                    TWO_RANK_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(TWO_RANKS):
            with open(f"{out}.rank{r}.json") as f:
                ranks.append(json.load(f))
        recs = records(wd)[seen:]
        seen += len(recs)
        seq = [(r["kind"], r.get("iter")) for r in recs]
        if seq != want[tag] or any(r["rc"] != 0 for r in ranks):
            fails.append((tag, "records", seq))
        iters = [r for r in recs if r["kind"] == "iter"]
        for i, r in enumerate(iters):
            local = [rk["local_env_steps"][i] for rk in ranks]
            if r["env_steps"] != sum(local):
                fails.append((tag, r["iter"], "env_steps", r["env_steps"],
                              local))
            if r["iter"] >= 1 and not (r["updated"] == 1.0 and all(
                    math.isfinite(r[k]) for k in ("loss", "policy_loss",
                                                  "value_loss"))):
                fails.append((tag, r["iter"], "update"))
        if len({rk["digest"] for rk in ranks}) != 1:
            fails.append((tag, "ranks' weights differ"))
        covered = {(b, s, c, str(dt)) for b, s, c, dt, _ in SHAPES}
        for rk in ranks:
            if not (rk["launches"] > 0
                    and rk["variants"]["resident"] == rk["launches"]):
                fails.append((tag, rk["rank"], "launches", rk["launches"]))
            if rk["peak_bytes"] > estimate:
                fails.append((tag, rk["rank"], "peak over the estimate",
                              rk["peak_bytes"], estimate))
            missing = [b for b in map(tuple, rk["batches"])
                       if b not in covered]
            if missing:
                fails.append((tag, rk["rank"], "batches without a "
                              "kernel_vs_plain row", missing))
        report[tag] = dict(
            argv=argv, seconds=seconds, records=seq,
            iter_seconds=[r["iter_seconds"] for r in iters],
            env_steps_per_s=[r["env_steps_per_s"] for r in iters],
            env_steps_per_s_per_chip=[r["env_steps_per_s_per_chip"]
                                      for r in iters],
            losses=[r["loss"] for r in iters],
            ranks=[dict(rank=rk["rank"], resblock_launches=rk["launches"],
                        variant_launches=rk["variants"],
                        env_steps_per_s=[n / s for n, s in zip(
                            rk["local_env_steps"], rk["iter_seconds"])],
                        iteration_seconds=rk["iter_seconds"],
                        learner_seconds=rk["learner_seconds"],
                        learner_share=sum(rk["learner_seconds"])
                        / sum(rk["iter_seconds"]),
                        resblock_batches=rk["batches"],
                        peak_bytes=rk["peak_bytes"])
                   for rk in ranks],
            weights_digest=ranks[0]["digest"])
    mgr = ckpt.make_manager(os.path.join(wd, "ckpt"))
    if mgr.all_steps() != [2, 3, 4]:
        fails.append(("ckpt steps", mgr.all_steps()))
    layout = {s: sorted(os.listdir(mgr.step_dir(s)))
              for s in mgr.all_steps()}
    if any(files != SHARD_FILES for files in layout.values()):
        fails.append(("ckpt layout", layout))
    with open(os.path.join(mgr.step_dir(4), "meta.json")) as f:
        meta_world = json.load(f)["world"]
    saved = torch.load(os.path.join(mgr.step_dir(4), "model.pt"),
                       map_location="cpu", weights_only=True)
    if (meta_world != TWO_RANKS or weights_digest(saved["net"])
            != report["resume"]["weights_digest"]):
        fails.append(("step 4", meta_world, "model.pt weights"))
    launches = sum(rk["resblock_launches"] for run in report.values()
                   for rk in run["ranks"])
    emit("train_two_ranks", reduced=TWO_RANK_REDUCED, ranks=TWO_RANKS,
         backend="gloo", envs_per_rank=1024, runs=report,
         checkpoint_steps=mgr.all_steps(), checkpoint_layout=layout,
         checkpoint_step_bytes=dir_bytes(mgr.step_dir(4)),
         memory_estimate_per_rank_bytes=estimate,
         resblock_launches=launches, nvidia_smi=nvidia_smi(), card=card,
         failed_checks=fails, ok=not fails)
    if fails:
        raise AssertionError(f"two-rank train phase failed its checks: "
                             f"{fails}")
    return launches


class Records:
    """A logger that keeps the loop's records."""

    def __init__(self):
        self.records = []

    def log(self, record) -> None:
        self.records.append(record)


def phase_train_nccl_one_rank(card: str):
    """`loop.train` at train_lowsim_15x15 + use_pallas from the lowsim
    bundle in a world of one under NCCL, so the learner's all-reduces run
    on the card, against the loop with no process group from the same
    seed: NCCL_ITERS iterations each. Self-play metrics and the ring
    equal bit for bit; the learner's metrics and the weights and
    statistics within the iteration test's bars; the NCCL run made its
    all-reduces (counted), the other none; every resblock launch
    resident."""
    import torch.distributed as dist
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.parallel import distributed, mesh
    from alphafive_tpu_torch.train import loop
    cfg = apply_overrides(get_preset("train_lowsim_15x15"),
                          ["net.use_pallas=true", "train.eval_every_iters=0"])
    bundle = os.path.join(ROOT, "pretrained", "15x15_lowsim")
    runs = {}
    for name in ("nccl", "no_group"):
        reduces = []
        all_reduce = dist.all_reduce

        def counting(tensor, *args, **kw):
            reduces.append(tensor.numel())
            return all_reduce(tensor, *args, **kw)

        backend = None
        if name == "nccl":
            distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                   backend="nccl", device="cuda")
            backend = dist.get_backend()
        log = Records()
        rb.resblock_launches = 0
        rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
        t0 = time.perf_counter()
        try:
            with patched((dist, "all_reduce", counting)):
                carry, _ = loop.train(cfg, None, NCCL_ITERS, logger=log,
                                      init_from=bundle, device="cuda")
            torch.cuda.synchronize()
        finally:
            distributed.shutdown()
        runs[name] = dict(
            carry=carry, backend=backend, seconds=time.perf_counter() - t0,
            iters=[r for r in log.records if r["kind"] == "iter"],
            all_reduces=len(reduces), all_reduce_elements=sum(reduces),
            launches=rb.resblock_launches,
            variants=dict(rb.variant_launches))
    a, b = runs["nccl"], runs["no_group"]
    fails = []
    if not (a["backend"] == "nccl" and a["all_reduces"] > 0
            and b["all_reduces"] == 0):
        fails.append(("collectives", a["backend"], a["all_reduces"],
                      b["all_reduces"]))
    worst = {}
    for i, (ma, mb) in enumerate(zip(a["iters"], b["iters"])):
        for k in SELFPLAY_KEYS:
            if ma[k] != mb[k]:
                fails.append((i, k, ma[k], mb[k]))
        for k in mesh.AUX_KEYS:
            err = abs(ma[k] - mb[k])
            worst[k] = max(worst.get(k, 0.0), err)
            if err > NCCL_METRIC_TOL[0] + NCCL_METRIC_TOL[1] * abs(mb[k]):
                fails.append((i, k, ma[k], mb[k]))
    if not (len(a["iters"]) == len(b["iters"]) == NCCL_ITERS
            and a["iters"][-1]["updated"] == 1.0):
        fails.append(("iterations", len(a["iters"]), len(b["iters"])))
    ca, cb = a["carry"], b["carry"]
    ring = [f.name for f in dataclasses.fields(ca.buffer)
            if not torch.equal(torch.as_tensor(getattr(ca.buffer, f.name)),
                               torch.as_tensor(getattr(cb.buffer, f.name)))]
    if ring:
        fails.append(("ring", ring))
    param_err = 0.0
    for (k, u), v in zip(ca.train_state.net.state_dict().items(),
                         cb.train_state.net.state_dict().values()):
        if not u.is_floating_point():
            continue
        err = (u - v).abs()
        param_err = max(param_err, float(err.max()))
        if not bool((err <= NCCL_PARAM_TOL[0]
                     + NCCL_PARAM_TOL[1] * v.abs()).all()):
            fails.append(("weights", k, float(err.max())))
    bit_equal = all(torch.equal(u, v) for u, v in zip(
        ca.train_state.net.state_dict().values(),
        cb.train_state.net.state_dict().values()))
    for name, run in runs.items():
        if not (run["launches"] > 0
                and run["variants"]["resident"] == run["launches"]):
            fails.append((name, "launches", run["launches"]))
    emit("train_nccl_one_rank", iterations=NCCL_ITERS,
         backend=a["backend"], all_reduces=a["all_reduces"],
         all_reduce_elements=a["all_reduce_elements"],
         seconds={k: r["seconds"] for k, r in runs.items()},
         iter_seconds={k: [m["iter_seconds"] for m in r["iters"]]
                       for k, r in runs.items()},
         learner_metric_max_abs_err=worst, weights_max_abs_err=param_err,
         weights_bit_equal=bit_equal, ring_equal=not ring,
         tol=dict(metrics=NCCL_METRIC_TOL, weights=NCCL_PARAM_TOL),
         resblock_launches=a["launches"], nvidia_smi=nvidia_smi(),
         card=card, failed_checks=fails, ok=not fails)
    if fails:
        raise AssertionError(f"NCCL one-rank phase failed its checks: "
                             f"{fails}")
    return a["launches"]


def phase_small_batch_play(card: str) -> dict:
    """`cli play`'s search, the call `_cmd_play` makes for an AI move, for
    PLAY_MOVES moves from each of PLAY_BUNDLES with net.use_pallas=true.
    cli play builds its evaluator from the bundle's own net config, whose
    use_pallas is false (the JAX CLI does the same); here the bundle's net
    runs the fused forward, as `--set net.use_pallas=true` asks. Each move
    legal; per move the seconds (synchronised), the resblock launches by
    variant (the counts set to 0 just before the search and read just
    after) and the batches seen; every launch in the variant the dispatch
    picks, every shape with a kernel_vs_plain row. Returns the launches
    by bundle."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.mcts.search import run_mcts
    from alphafive_tpu_torch.models.evaluator import net_evaluator
    from alphafive_tpu_torch.train.checkpoint import load_model
    launches, failed = {}, {}
    for bundle, preset in PLAY_BUNDLES:
        cfg = apply_overrides(get_preset(preset), ["net.use_pallas=true"])
        params, stats, saved = load_model(os.path.join(ROOT, "pretrained",
                                                       bundle))
        check_fit(bundle, saved, cfg)
        net_cfg = dataclasses.replace(saved.net, use_pallas=True)
        evaluate = net_evaluator(cfg.env, net_cfg, params, stats, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        st = vector.init(cfg.env, 1, "cuda")
        moves, fails, total = [], [], dict.fromkeys(rb.variant_launches, 0)
        for m in range(PLAY_MOVES):
            res, seconds, counts = general_counts(lambda: run_mcts(
                cfg.env, cfg.mcts, evaluate, st, gen,
                num_simulations=PLAY_SIMS, add_noise=False))
            a = int(res.visits[0].argmax())
            legal = bool(st.board[0, a] == 0) and not bool(st.done[0])
            st = vector.step(cfg.env, st, torch.tensor(
                [a], dtype=torch.int32, device="cuda"))
            for k, v in counts["variant_launches"].items():
                total[k] += v
            moves.append(dict(
                move=m, action=divmod(a, cfg.env.board_size),
                root_value=float(res.root_value[0]), seconds=seconds,
                legal=legal, visits=int(res.visits[0].sum()),
                **{k: counts[k] for k in (
                    "resblock_launches", "variant_launches", "dispatched",
                    "resblock_batches", "uncovered")}))
            fails += [(m, k) for k, ok in (
                ("legal", legal), ("visits", int(res.visits[0].sum())
                                   == PLAY_SIMS),
                ("as_dispatched", as_dispatched(counts))) if not ok]
        stones = int((st.board[0] != 0).sum())
        if stones != PLAY_MOVES:
            fails.append(("stones", stones))
        if bundle == "19x19_10b" and not total["split"] > 0:
            fails.append(("no split launch", total))
        emit("small_batch_play", bundle=f"pretrained/{bundle}",
             preset=cfg.name, sims=PLAY_SIMS, envs=1,
             leaf_batch=cfg.mcts.leaf_batch, blocks=net_cfg.blocks,
             channels=net_cfg.channels, moves=moves,
             seconds_per_move=[mv["seconds"] for mv in moves],
             variant_launches=total,
             cluster_narrowed=rb.cluster_narrowed(),
             nvidia_smi=nvidia_smi(), card=card, failed=fails,
             ok=not fails)
        launches[bundle] = sum(total.values())
        if fails:
            failed[bundle] = fails
    if failed:
        raise AssertionError(f"small_batch_play failed its checks: {failed}")
    return launches


def dispatched(launched: list) -> dict:
    """The launches by variant that `rb.variant` picks for each recorded
    (batch, h, w, c, dtype) launch."""
    want = dict.fromkeys(rb.variant_launches, 0)
    for b, h, w, c, dt in launched:
        want[rb.variant(dt, h, w, c, b)] += 1
    return want


def uncovered(launched: list) -> list:
    """The (batch, h, w, c, dtype) shapes among `launched` that no
    kernel_vs_plain row holds at the variant they ran."""
    rows = {(b, s, s, c, dt): kind for b, s, c, dt, kind in SHAPES}
    return sorted({(b, h, w, c, str(dt)[6:]) for b, h, w, c, dt in launched
                   if rows.get((b, h, w, c, dt)) != rb.variant(dt, h, w, c,
                                                               b)})


def general_counts(fn):
    """Run `fn()` with the resblock counts (by variant, with the shapes it
    launched at, and the counts the dispatch should give them) and the
    select launches set to 0 just before and read just after: (result,
    seconds, counts)."""
    shapes, launched, fused = set(), [], rb.fused_resblock

    def recording(x, *args):
        shapes.add((x.shape[1], x.shape[2], x.shape[3], str(x.dtype)[6:]))
        launched.append((*x.shape, x.dtype))
        return fused(x, *args)

    rb.resblock_launches = 0
    rb.variant_launches.update(dict.fromkeys(rb.variant_launches, 0))
    sel.select_launches = 0
    t0 = time.perf_counter()
    with patched((rb, "fused_resblock", recording)):
        out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, dict(
        resblock_launches=rb.resblock_launches,
        variant_launches=dict(rb.variant_launches),
        dispatched=dispatched(launched),
        resblock_batches=sorted({b for b, *_ in launched}),
        resblock_shapes=sorted(shapes), select_launches=sel.select_launches,
        uncovered=uncovered(launched))


def all_general(counts: dict) -> bool:
    return 0 < counts["resblock_launches"] == counts["variant_launches"][
        "general"]


def as_dispatched(counts: dict) -> bool:
    """Launches counted by the variants the dispatch picks at the batches
    seen (the 33x33 search's batch 1: split), each shape with a row."""
    return (0 < counts["resblock_launches"]
            and counts["variant_launches"] == counts["dispatched"]
            and not counts["uncovered"])


def general_train(card: str) -> dict:
    """`cli train --preset tiny_test --set net.use_pallas=true`, 2
    iterations (no eval falls due): finite losses in metrics.jsonl, the
    second iteration updating, every resblock launch general."""
    from alphafive_tpu_torch import cli
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tiny_")
    argv = [*GENERAL_TRAIN_ARGV, "--workdir", workdir]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc, seconds, counts = general_counts(lambda: cli.main(argv))
        iters = [r for r in records(workdir) if r["kind"] == "iter"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    losses = [[r[k] for k in ("loss", "policy_loss", "value_loss")]
              for r in iters]
    fails = [k for k, ok in (
        ("rc", rc == 0), ("iterations", len(iters) == 2),
        ("updated", len(iters) == 2 and iters[1]["updated"] == 1.0),
        ("finite_losses", all(math.isfinite(x) for ls in losses
                              for x in ls)),
        ("all_general", all_general(counts))) if not ok]
    emit("general_shapes", run="tiny_test_cli_train", argv=argv,
         seconds=seconds, losses=losses, **counts, nvidia_smi=nvidia_smi(),
         card=card, failed=fails, ok=not fails)
    return dict(counts, fails=fails)


def general_selfplay(name: str, overrides: list, card: str) -> dict:
    """One ply of chip_15x15 self-play (random weights from seed 0)
    through selfplay_bench.run with `overrides`: the checks of
    selfplay_run, every resblock launch general, and the first pass's
    leaf forward against the plain twin within NET_TOL."""
    from alphafive_tpu_torch.benchmarks import selfplay_bench
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.models.resnet import (FusedPolicyValueNet,
                                                   init_params)
    cfg = apply_overrides(get_preset("chip_15x15"),
                          ["net.use_pallas=true", *overrides])
    params, stats = init_params(cfg.env, cfg.net, seed=0)
    make, leaf = selfplay_bench.net_evaluator, []

    def capturing(*args, **kw):
        evaluate = make(*args, **kw)

        def first_leaf(board, to_play, last):
            if not leaf and board.shape[0] != cfg.train.num_envs:
                leaf.append((board.clone(), to_play.clone(), last.clone()))
            return evaluate(board, to_play, last)
        return first_leaf

    with patched((selfplay_bench, "net_evaluator", capturing)):
        run, seconds, counts = general_counts(lambda: selfplay_run(
            cfg, params, stats, GENERAL_PLIES, 0))
    sims, lb = cfg.mcts.num_simulations, cfg.mcts.leaf_batch
    want = cfg.net.blocks * (sims // lb + 1) * run["plies"]
    feats = vector.features(cfg.env, *leaf[0])
    logits, value = FusedPolicyValueNet(cfg.env, cfg.net, params, stats,
                                        "cuda")(feats)
    ref_logits, ref_value = FusedPolicyValueNet(
        cfg.env, cfg.net, params, stats, "cuda", plain=True)(feats)
    torch.cuda.synchronize()
    lerr = (logits - ref_logits).abs()
    verr = (value - ref_value).abs().max().item()
    atol, rtol = NET_TOL["logits"]
    fails = [k for k, ok in (
        ("failed_checks", run["failed_checks"] == 0),
        ("plies", run["plies"] == GENERAL_PLIES), ("pi", run["pi_ok"]),
        ("launches", counts["resblock_launches"] == want),
        ("all_general", all_general(counts)),
        ("leaf_forward", bool(
            torch.isfinite(logits).all() and torch.isfinite(value).all()
            and (lerr <= atol + rtol * ref_logits.abs()).all()
            and verr <= NET_TOL["value"]))) if not ok]
    emit("general_shapes", run=name, preset=cfg.name, overrides=overrides,
         board=cfg.env.board_size, channels=cfg.net.channels,
         blocks=cfg.net.blocks, envs=cfg.train.num_envs, sims=sims,
         plies=run["plies"], seconds=seconds,
         ply_seconds=run["out"]["compile_seconds"], expected_launches=want,
         **counts, leaf_batch=int(feats.shape[0]),
         leaf_logits_max_abs_err=lerr.max().item(),
         leaf_value_max_abs_err=verr, tol=NET_TOL,
         failed_checks=run["failed_checks"], nvidia_smi=nvidia_smi(),
         card=card, failed=fails, ok=not fails)
    return dict(counts, fails=fails)


def general_search(card: str) -> dict:
    """run_mcts_packed on a 33×33 board (A_pad 1152), one env, 64 sims,
    random_net(33): every select launch at A_pad 1152 (the kernel's
    chunk-streaming path), every resblock launch at 33×33 × 64 in the
    variant the dispatch picks for its batch (1: split), visits bit-equal
    to the plain descent's on the same net."""
    pads = []

    def select(packed, *args):
        pads.append(packed.shape[-1])
        return sel.select_batch(packed, *args)

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    (res_k, _, t_k, _), seconds, counts = general_counts(
        lambda: packed_search(RANDOM_33, 1, seed=40, select=select,
                              sims=GENERAL_SEARCH_SIMS))
    res_p, _, t_p, _ = packed_search(RANDOM_33, 1, seed=40,
                                     select=sel.select_batch_reference,
                                     sims=GENERAL_SEARCH_SIMS)
    torch.cuda.synchronize()
    equal = bool(torch.equal(res_k.visits, res_p.visits)
                 and torch.equal(res_k.root_value, res_p.root_value))
    fails = [k for k, ok in (
        ("select_launches", counts["select_launches"]
         == GENERAL_SEARCH_SIMS == len(pads)),
        ("a_pad", set(pads) == {1152}),
        ("as_dispatched", as_dispatched(counts)),
        ("shapes", counts["resblock_shapes"] == [(33, 33, 64, "bfloat16")]),
        ("visits_sum", bool((res_k.visits.sum(-1)
                             == GENERAL_SEARCH_SIMS).all())),
        ("kernel_equals_plain", equal)) if not ok]
    emit("general_shapes", run="search_packed_33x33", envs=1,
         sims=GENERAL_SEARCH_SIMS, a_pad=sorted(set(pads)), seconds=seconds,
         kernel_seconds=t_k, plain_seconds=t_p, **counts,
         kernel_equals_plain=equal, nvidia_smi=nvidia_smi(), card=card,
         failed=fails, ok=not fails)
    return dict(counts, fails=fails)


def phase_general_shapes(card: str) -> dict:
    """The shapes only the general resblock variant and the select
    kernel's streaming path take, through the entry points: tiny_test's
    cli train, chip_15x15 self-play at 256 channels and on a 21×21 board,
    and a packed search on 33×33. One line per run; raises after all ran
    if any failed."""
    runs = {"tiny_test_cli_train": general_train(card),
            "selfplay_256_channels": general_selfplay(
                "selfplay_256_channels", GENERAL_WIDE, card),
            "selfplay_21x21": general_selfplay("selfplay_21x21",
                                               GENERAL_BOARD, card),
            "search_packed_33x33": general_search(card)}
    failed = {k: r["fails"] for k, r in runs.items() if r["fails"]}
    if failed:
        raise AssertionError(f"general_shapes failed its checks: {failed}")
    return {k: sum(r[k] for r in runs.values())
            for k in ("resblock_launches", "select_launches")}


def main() -> int:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    card = phase_device()
    plib = phase_build()
    latency = phase_select_latency(plib)
    rows = phase_kernel_vs_plain()
    pack_rows = phase_pack_taps_vs_plain()
    play_launches = phase_small_batch_play(card)
    params, stats, saved_cfg = phase_bundle("15x15")
    rb_launches = phase_selfplay(params, stats, saved_cfg, card)
    renju_launches, pack_launches = phase_selfplay_renju(card)
    params, stats, saved_cfg = phase_bundle("15x15_lowsim")
    lowsim_launches, traj, lowsim = phase_selfplay_lowsim(params, stats,
                                                          saved_cfg, card)
    phase_lowsim_breakdown(params, stats, lowsim, card)
    phase_gumbel_capped_vs_uncapped(params, stats, lowsim)
    phase_replay(traj, lowsim, card)
    phase_learner_step(params, stats, traj, saved_cfg, card)
    train_launches, carry, train_cfg = phase_iteration_lowsim(
        params, stats, saved_cfg, card)
    phase_iteration_breakdown(carry, train_cfg, card)
    del carry
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        run = phase_train_loop(workdir, card)
        phase_train_resume(run, card)
        phase_export(run, card)
        phase_memory_guard(run, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        two_rank_launches = phase_train_two_ranks(workdir, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    nccl_launches = phase_train_nccl_one_rank(card)
    sel_rows = phase_select_kernel_vs_plain(latency)
    phase_search_packed(card)
    sel_launches = phase_eval(card)
    general = phase_general_shapes(card)
    emit("total", seconds=time.time() - t0)
    # the resblock's self-play shape; the select kernel's cli eval shape
    main_row = rows[0]
    leaf_row = next(r for r in rows if r["batch"] == 32768)
    rank_leaf_row = next(r for r in rows if r["batch"] == 16384)
    renju_leaf_row = next(r for r in rows if r["batch"] == 4096)
    split_row = next(r for r in rows if (r["batch"], r["board"],
                                         r["channels"]) == SPLIT_ROW)
    general_row = next(r for r in rows if (r["batch"], r["board"],
                                           r["channels"]) == GENERAL_ROW)
    sel_row = next(r for r in sel_rows if r["envs"] == 1
                   and r["case"] == "tree" and r["forced_k"] == 0.0)
    pack_row = next(r for r in pack_rows if r["channels"] == 128)
    print(json.dumps({"kernels": [{
        "name": "fused_resblock", "route": "cuda",
        "source": "alphafive_tpu_torch/csrc/resblock.cu",
        "replaces": "alphafive_tpu/ops/pallas_resblock.py:97",
        "launches": (rb_launches + renju_launches + lowsim_launches
                     + train_launches + run["launches"] + two_rank_launches
                     + nccl_launches + general["resblock_launches"]
                     + sum(play_launches.values())),
        "launches_chip_15x15": rb_launches,
        "launches_renju_19x19": renju_launches,
        "launches_lowsim_15x15": lowsim_launches,
        "launches_train_lowsim_15x15": train_launches,
        "launches_train_loop": run["launches"],
        "launches_train_two_ranks": two_rank_launches,
        "launches_train_nccl_one_rank": nccl_launches,
        "launches_general_shapes": general["resblock_launches"],
        "launches_small_batch_play": play_launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "host_us_per_call": main_row["host_us_per_call"],
        "lowsim_leaf_shape": {k: leaf_row[k] for k in (
            "batch", "max_abs_err", "ms", "host_us_per_call", "plain_ms",
            "bound_ms", "bound_by", "share_of_bound", "library_ms")},
        "two_rank_leaf_shape": {k: rank_leaf_row[k] for k in (
            "batch", "max_abs_err", "ms", "host_us_per_call", "plain_ms",
            "bound_ms", "bound_by", "share_of_bound", "library_ms")},
        "renju_leaf_shape": {k: renju_leaf_row[k] for k in (
            "batch", "board", "channels", "variant", "max_abs_err", "ms",
            "host_us_per_call", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "library_ms")},
        "split_shape": {k: split_row[k] for k in (
            "batch", "board", "channels", "variant", "cluster_size",
            "max_abs_err", "ms", "replaced", "replaced_ms",
            "host_us_per_call", "plain_ms", "bound_ms",
            "bound_by", "share_of_bound", "library_ms")},
        "general_shape": {k: general_row[k] for k in (
            "batch", "board", "channels", "variant", "max_abs_err", "ms",
            "host_us_per_call", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "library_ms")}}, {
        "name": "pack_streaming_taps", "route": "cuda",
        "source": "alphafive_tpu_torch/csrc/resblock.cu",
        "replaces": "alphafive_tpu/ops/pallas_resblock.py:97",
        "launches": pack_launches, "launches_renju_19x19": pack_launches,
        "max_abs_err": pack_row["max_abs_err"],
        "ms": pack_row["ms"], "plain_ms": pack_row["plain_ms"],
        "bound_ms": pack_row["bound_ms"], "bound_by": pack_row["bound_by"],
        "library_ms": None, "host_us_per_call": pack_row["host_us_per_call"],
        "channels": pack_row["channels"]}, {
        "name": "select_batch", "route": "cuda",
        "source": "alphafive_tpu_torch/csrc/select.cu",
        "replaces": "alphafive_tpu/ops/pallas_select.py:189",
        "launches": sel_launches + general["select_launches"],
        "launches_cli_eval": sel_launches,
        "launches_general_shapes": general["select_launches"],
        "max_abs_err": sel_row["max_abs_err"],
        "ms": sel_row["ms"], "plain_ms": sel_row["plain_ms"],
        "bound_ms": sel_row["bound_ms"], "bound_by": sel_row["bound_by"],
        "library_ms": None, "host_us_per_call": sel_row["host_us_per_call"],
        "latency_bound_ms": sel_row["latency_bound_ms"],
        "share_of_latency_bound": sel_row["share_of_latency_bound"]}]}),
        flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
