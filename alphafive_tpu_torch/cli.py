"""Command-line entry points: train / eval / play / bench / export (port
of ``alphafive_tpu/cli.py``). Usage:

    python -m alphafive_tpu_torch.cli train --preset train_lowsim_15x15 \\
        --set net.use_pallas=true --init-from pretrained/15x15_lowsim \\
        --workdir runs/lowsim
    python -m alphafive_tpu_torch.cli train ... --resume
    torchrun --nproc-per-node 4 -m alphafive_tpu_torch.cli train \\
        --multihost --preset host_15x15 --workdir runs/host
    python -m alphafive_tpu_torch.cli export --workdir runs/lowsim \\
        --out runs/lowsim_model
    python -m alphafive_tpu_torch.cli eval  --preset chip_15x15 \\
        --set mcts.select_impl=pallas --set mcts.branch_cap=none \\
        --set mcts.leaf_batch=1
    python -m alphafive_tpu_torch.cli play  --preset smoke_9x9
    python -m alphafive_tpu_torch.cli bench --preset chip_15x15
    python -m alphafive_tpu_torch.cli bench --mode iteration \\
        --preset train_lowsim_15x15 --set net.use_pallas=true
    torchrun --nproc-per-node 4 -m alphafive_tpu_torch.cli bench \\
        --mode iteration --multihost --preset host_15x15

The flags are the JAX CLI's, except that ``--platform`` is ``--device``
(default ``cuda``; it refuses to run when CUDA is absent, ``--device cpu``
runs on the host). ``--set a.b=c`` overrides any config field. ``train``
and ``bench`` on the card first run the memory guard (``utils/memory.py``)
unless ``--allow-oversubscribe``. ``--workdir`` loads the latest training
checkpoint under ``<workdir>/ckpt`` (the port's own format,
``train/checkpoint.py``) or an exported bundle.

``--multihost`` on ``train`` and ``bench --mode iteration`` joins the
process group (``parallel/distributed.py``): one process a GPU, from
torchrun's environment or from ``--coordinator host:port --num-processes
N --process-id r`` given to every process. The world takes the place of
``mesh.data`` (``bench`` clamps ``mesh.data`` to it, as JAX's bench clamps
it to the device count), the memory guard sizes each rank's share, and
rank 0 alone logs and prints. ``--debug-nans`` turns on
``torch.autograd``'s anomaly mode, under which the learner and the
iteration raise ``FloatingPointError`` on a non-finite loss, averaged
gradient or metric (the counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from alphafive_tpu_torch.parallel import distributed


def main(argv=None):
    p = argparse.ArgumentParser(prog="alphafive_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", default="chip_15x15")
        sp.add_argument("--workdir", default=None)
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; refused without CUDA) or cpu")
        sp.add_argument("--num-cpu-devices", type=int, default=8,
                        help="accepted for the JAX CLI's command lines; "
                             "torch runs one device a process")
        sp.add_argument("--set", action="append", default=[],
                        metavar="SEC.FIELD=VAL", dest="overrides")
        sp.add_argument("--debug-nans", action="store_true",
                        help="autograd anomaly mode, and raise on a "
                             "non-finite loss, gradient or metric")

    def multihost(sp):
        sp.add_argument("--multihost", action="store_true",
                        help="join the process group: one process a GPU")
        sp.add_argument("--coordinator", default=None,
                        help="rank 0's host:port (default: torchrun's)")
        sp.add_argument("--num-processes", type=int, default=None)
        sp.add_argument("--process-id", type=int, default=None)

    sp = sub.add_parser("train", help="run the actor-learner pipeline")
    common(sp)
    sp.add_argument("--allow-oversubscribe", action="store_true")
    sp.add_argument("--iters", type=int, default=None)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--profile-iters", type=int, default=0)
    sp.add_argument("--init-from", default=None, metavar="MODEL_DIR")
    multihost(sp)

    sp = sub.add_parser("eval", help="evaluate a model vs pure MCTS")
    common(sp)
    sp.add_argument("--games", type=int, default=None)
    sp.add_argument("--anchor-rollouts", type=int, default=1000)

    sp = sub.add_parser("play", help="human vs AI on the console")
    common(sp)
    sp.add_argument("--sims", type=int, default=None)
    sp.add_argument("--human-color", choices=["black", "white"],
                    default="black")
    sp.add_argument("--opponent", choices=["net", "pure"], default="net",
                    help="'pure' = net-free rollout MCTS (no checkpoint)")

    sp = sub.add_parser("bench", help="self-play throughput benchmark")
    common(sp)
    sp.add_argument("--allow-oversubscribe", action="store_true")
    sp.add_argument("--plies", type=int, default=8)
    sp.add_argument("--mode", choices=["selfplay", "iteration"],
                    default="selfplay")
    multihost(sp)

    sp = sub.add_parser("export", help="export a workdir checkpoint")
    common(sp)
    sp.add_argument("--out", required=True)

    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available "
                         "(use --device cpu to run on the host)")
    multi = getattr(args, "multihost", False)
    if multi and args.cmd == "bench" and args.mode != "iteration":
        raise SystemExit("bench --multihost times --mode iteration")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    from alphafive_tpu_torch.config import apply_overrides, get_preset
    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if multi:
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id, device=str(device))
    try:
        _run(cfg, args, device)
    finally:
        if multi:
            distributed.shutdown()
    return 0


def _run(cfg, args, device) -> None:
    if args.cmd in ("train", "bench"):
        _check_device_budget(cfg, args, device)
    if args.cmd == "train":
        from alphafive_tpu_torch.train.loop import train
        train(cfg, workdir=args.workdir, total_iters=args.iters,
              resume=args.resume, profile_iters=args.profile_iters,
              init_from=args.init_from, device=str(device))
    elif args.cmd == "export":
        _cmd_export(args, device)
    elif args.cmd == "eval":
        print(json.dumps(_cmd_eval(cfg, args, device)))
    elif args.cmd == "play":
        _cmd_play(cfg, args, device)
    elif args.cmd == "bench":
        from alphafive_tpu_torch.benchmarks import selfplay_bench
        if args.mode == "iteration":
            out = selfplay_bench.run_iteration(cfg, device=str(device))
        else:
            out = selfplay_bench.run(cfg, plies=args.plies,
                                     device=str(device))
        if distributed.is_primary():
            print(json.dumps(out))


def _check_device_budget(cfg, args, device) -> None:
    """Refuse a run on the card whose estimated footprint per rank exceeds
    the budget (``utils/memory.py``), unless ``--allow-oversubscribe``.
    The CPU (host memory) is not guarded."""
    if args.allow_oversubscribe or device.type == "cpu":
        return
    from alphafive_tpu_torch.utils.memory import budget_error
    err = budget_error(cfg, distributed.world(), device=device)
    if err is not None:
        raise SystemExit(err)


def _cmd_export(args, device) -> None:
    """Export the latest checkpoint under ``<workdir>/ckpt`` as a bundle,
    with its iteration, lr_scale and learner step in config.json."""
    from alphafive_tpu_torch.train import checkpoint as ckpt

    if not args.workdir:
        raise SystemExit("export: --workdir with a checkpoint is required")
    mgr = ckpt.make_manager(f"{args.workdir}/ckpt")
    step = mgr.latest_step()
    if step is None:
        raise SystemExit(f"export: no checkpoint under {args.workdir}/ckpt")
    ts, saved_cfg = ckpt.restore_train_state(mgr, step, device)
    params, batch_stats = ts.net.to_flax()
    ckpt.export_model(args.out, params, batch_stats, saved_cfg,
                      extra={"iteration": step,
                             "lr_scale": float(ts.lr_scale),
                             "train_step": int(ts.step)})
    print(f"exported step {step} -> {args.out}")


def _pretrained_dir(cfg):
    """Bundled pretrained model for this board size, if shipped: the
    strength-ranked variant where one exists (15×15 → ``15x15_lowsim``,
    19×19 → ``19x19_10b``; see their READMEs), else the plain dir; none
    for a net other than the resnet (no bundle holds one)."""
    if cfg.net.arch != "resnet":   # the bundles hold resnets only
        return None
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = cfg.env.board_size
    ranked = {15: ["15x15_lowsim"], 19: ["19x19_10b"]}
    for name in ranked.get(s, []) + [f"{s}x{s}"]:
        path = os.path.join(here, "pretrained", name)
        if os.path.isdir(path):
            return path
    return None


def _load_model(cfg, workdir):
    """(params, batch_stats, net_cfg) for inference: the workdir's latest
    training checkpoint (restored against its own saved config, so any
    preset loads it) or a params-only export dir / bundle
    (``model.msgpack``) → the bundled model for this board size → a fresh
    net from ``cfg.train.seed``. The returned net_cfg is the one the
    weights were trained with: build the evaluator from it, not from the
    preset."""
    from alphafive_tpu_torch.models.nets import init_params
    from alphafive_tpu_torch.train import checkpoint as ckpt

    def fresh():
        params, batch_stats = init_params(cfg.env, cfg.net, cfg.train.seed)
        return params, batch_stats, cfg.net

    def bundle(path, what):
        params, batch_stats, saved = ckpt.load_model(path)
        if saved.env.board_size != cfg.env.board_size:
            raise ValueError(f"{path}: board {saved.env.board_size} differs "
                             f"from the preset's {cfg.env.board_size}")
        print(f"loaded {what} from {path}", file=sys.stderr)
        return params, batch_stats, saved.net

    if workdir:
        # an explicit workdir never falls through to the bundled model
        mgr = ckpt.make_manager(os.path.join(workdir, "ckpt"))
        step = mgr.latest_step()
        if step is not None:
            # the train state alone, on the host: the caller builds its
            # evaluator on its device from these trees
            ts, saved = ckpt.restore_train_state(mgr, step, "cpu")
            if saved.env.board_size != cfg.env.board_size:
                raise ValueError(f"{mgr.directory}: board "
                                 f"{saved.env.board_size} differs from the "
                                 f"preset's {cfg.env.board_size}")
            print(f"restored checkpoint step {step} from {mgr.directory}",
                  file=sys.stderr)
            params, batch_stats = ts.net.to_flax()
            return params, batch_stats, saved.net
        if os.path.exists(os.path.join(workdir, "model.msgpack")):
            return bundle(workdir, "exported model")
        print(f"WARNING: no model under {workdir} — using a fresh "
              f"(untrained) net", file=sys.stderr)
        return fresh()
    pre = _pretrained_dir(cfg)
    if pre is not None:
        return bundle(pre, "bundled pretrained model")
    print("no model found; using a fresh (untrained) net", file=sys.stderr)
    return fresh()


def _cmd_eval(cfg, args, device) -> dict:
    from alphafive_tpu_torch.config import MCTSConfig
    from alphafive_tpu_torch.models.evaluator import (net_evaluator,
                                                      rollout_evaluator)
    from alphafive_tpu_torch.train.evaluate import evaluate_vs
    from alphafive_tpu_torch.utils.elo import performance_elo

    params, batch_stats, net_cfg = _load_model(cfg, args.workdir)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)
    result = evaluate_vs(
        cfg.env, cfg.mcts,
        net_evaluator(cfg.env, net_cfg, params, batch_stats, device),
        rollout_evaluator(cfg.env, generator=gen),
        cfg.train.eval_simulations or cfg.mcts.num_simulations,
        args.anchor_rollouts,
        args.games or cfg.train.eval_games, gen,
        # canonical exact anchor (preset-independent Elo scale)
        mcts_a=cfg.mcts, mcts_b=MCTSConfig(),
        plies_per_call=1 if args.anchor_rollouts >= 3_200 else 2,
        device=device)
    result["anchor_rollouts"] = args.anchor_rollouts
    result["elo_vs_anchor"] = performance_elo(result["score"], 0.0,
                                              games=result.get("games"))
    return result


def _render(board, size: int) -> str:
    sym = {0: ".", 1: "X", -1: "O"}
    cells = board.reshape(size, size).tolist()
    rows = ["    " + " ".join(f"{c:2d}" for c in range(size))]
    for r in range(size):
        rows.append(f"{r:2d}  " + "  ".join(sym[v] for v in cells[r]))
    return "\n".join(rows)


def _cmd_play(cfg, args, device) -> None:
    """Console human-vs-AI on one env of the vector engine."""
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.mcts.gumbel import run_gumbel_mcts
    from alphafive_tpu_torch.mcts.search import run_mcts
    from alphafive_tpu_torch.models.evaluator import (net_evaluator,
                                                      rollout_evaluator)

    gen = torch.Generator(device=device).manual_seed(0)
    if args.opponent == "pure":
        evaluate = rollout_evaluator(cfg.env, generator=gen)
    else:
        params, batch_stats, net_cfg = _load_model(cfg, args.workdir)
        evaluate = net_evaluator(cfg.env, net_cfg, params, batch_stats,
                                 device)
    sims = args.sims or cfg.mcts.num_simulations
    size = cfg.env.board_size
    st = vector.init(cfg.env, 1, device)
    human = 1 if args.human_color == "black" else -1
    print(f"You are {'X (black)' if human == 1 else 'O (white)'}; "
          f"enter moves as 'row col'. AI: {sims} simulations.")
    while not bool(st.done[0]):
        board = st.board[0].cpu()
        print(_render(board, size))
        if int(st.to_play[0]) == human:
            try:
                line = input("your move> ").strip()
            except EOFError:
                print("bye")
                return
            try:
                r, c = map(int, line.replace(",", " ").split())
                a = r * size + c
                if not (0 <= r < size and 0 <= c < size) or board[a] != 0:
                    raise ValueError(line)
            except ValueError:
                print("invalid move, try again (e.g. '7 7')")
                continue
        else:
            if cfg.mcts.root_selection == "gumbel":
                # the halving winner at g = 0 (deterministic)
                res = run_gumbel_mcts(cfg.env, cfg.mcts, evaluate, st, gen,
                                      num_simulations=sims, add_noise=False)
                a = int(res.action[0])
            else:
                res = run_mcts(cfg.env, cfg.mcts, evaluate, st, gen,
                               num_simulations=sims, add_noise=False)
                a = int(res.visits[0].argmax())
            print(f"AI plays {divmod(a, size)} "
                  f"(value {float(res.root_value[0]):+.2f})")
        st = vector.step(cfg.env, st,
                         torch.tensor([a], dtype=torch.int32, device=device))
    print(_render(st.board[0].cpu(), size))
    out = {1: "black (X) wins", -1: "white (O) wins", 0: "draw"}
    print(out[int(st.winner[0])])


if __name__ == "__main__":
    sys.exit(main())
