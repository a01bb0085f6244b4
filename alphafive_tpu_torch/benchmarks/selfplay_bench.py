"""Self-play throughput benchmark (port of
``alphafive_tpu/benchmarks/selfplay_bench.py::run`` and ``main``).

Times whole self-play chunks — MCTS with batched net leaf evaluation,
move sampling, env stepping, auto-reset — on one device, behind
``torch.cuda.synchronize()``. The first chunk (kernel build and warm-up)
is reported separately as ``compile_seconds``. Result keys are the JAX
benchmark's plus ``impl`` and ``device``.

    python -m alphafive_tpu_torch.benchmarks.selfplay_bench \\
        --preset chip_15x15 --set net.use_pallas=true
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from alphafive_tpu_torch.config import RunConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.resnet import init_params
from alphafive_tpu_torch.train import actor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: RunConfig, plies: int = 8, warmup: int = 1, repeats: int = 3,
        device: str = "cuda", params=None, batch_stats=None, seed: int = 0,
        observe=None, return_trajectory: bool = False):
    """Benchmark `repeats` chunks of `plies` lockstep plies after one
    first chunk and `warmup` more. `params`/`batch_stats` are flax-layout
    numpy trees (a bundle's); by default a random net from `seed`.
    `observe` is handed to ``actor.selfplay_chunk``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if params is None:
        params, batch_stats = init_params(cfg.env, cfg.net, seed)
    evaluate = net_evaluator(cfg.env, cfg.net, params, batch_stats, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = vector.init(cfg.env, cfg.train.num_envs, dev)

    def chunk(st):
        st, traj, _ = actor.selfplay_chunk(cfg.env, cfg.mcts, evaluate, st,
                                           gen, plies, observe=observe)
        _sync(dev)
        return st, traj

    t0 = time.perf_counter()
    st, traj = chunk(st)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        st, traj = chunk(st)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        st, traj = chunk(st)
        best = min(best, time.perf_counter() - t0)

    env_steps = cfg.train.num_envs * plies
    sims = env_steps * cfg.mcts.num_simulations
    out: Dict = {
        "preset": cfg.name,
        "impl": "torch",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "board": cfg.env.board_size,
        "num_envs": cfg.train.num_envs,
        "num_simulations": cfg.mcts.num_simulations,
        "plies": plies,
        "chips": 1,
        "seconds": best,
        "compile_seconds": compile_s,
        "env_steps_per_s": env_steps / best,
        "env_steps_per_s_per_chip": env_steps / best,
        "sims_per_s": sims / best,
        # one leaf evaluated per sim; forwards are batched leaf_batch-wide
        "leaf_evals_per_s": sims / best,
        "net_forwards_per_s": sims / best / max(cfg.mcts.leaf_batch, 1),
    }
    return (out, traj) if return_trajectory else out


def main(argv: Optional[list] = None) -> int:
    """CLI: one JSON line of self-play throughput for any preset."""
    import argparse
    import json

    from alphafive_tpu_torch.config import apply_overrides, get_preset
    from alphafive_tpu_torch.train.checkpoint import load_model

    ap = argparse.ArgumentParser(prog="selfplay_bench")
    ap.add_argument("--preset", default="chip_15x15")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="SEC.FIELD=VAL")
    ap.add_argument("--bundle", default=None,
                    help="pretrained/<dir> weights (default: random net)")
    ap.add_argument("--plies", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    params = batch_stats = None
    if args.bundle:
        params, batch_stats, saved = load_model(args.bundle)
        if (saved.net.blocks, saved.net.channels, saved.net.value_hidden,
                saved.env.board_size) != (cfg.net.blocks, cfg.net.channels,
                                          cfg.net.value_hidden,
                                          cfg.env.board_size):
            raise SystemExit(f"{args.bundle} does not fit {cfg.name}'s net")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(cfg, plies=args.plies, warmup=args.warmup,
              repeats=args.repeats, device=args.device, params=params,
              batch_stats=batch_stats)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
