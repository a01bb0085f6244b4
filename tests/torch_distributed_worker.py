"""Rank processes of the two-rank tests (not collected by pytest), and
the helpers that start them.

``run`` is a rank of ``tests/test_torch_distributed.py``'s parity test:
it joins a gloo group on the CPU, runs the port's data-parallel iteration
with the draws the test took from JAX's two-device program (each ply's
Gumbel table, each sampled batch's indices and symmetries) and writes,
after every iteration, the metrics, the rank's ring shard and its
weights and batch-norm statistics. ``run_loop`` is a rank of
``tests/test_torch_distributed_cli.py``'s loop test: the training loop
with a scripted ladder eval. Imports nothing of JAX: the test processes
do.
"""

import dataclasses
import json
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp

RING = ("board", "to_play", "last_move", "pi", "z", "z_valid", "pi_valid")
# the ranks' processes: start-up, a few tiny_test iterations, collectives
RANKS_TIMEOUT_S = 240
# run_loop's scripted ladder eval: the score at each eval's iteration
SCRIPT = {1: 0.5, 3: 0.75}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, args, nprocs):
    """Run fn(rank, *args) in `nprocs` spawned processes; kill them and
    raise past RANKS_TIMEOUT_S; raise what a rank raised."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish in "
                               f"{RANKS_TIMEOUT_S} s")


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def nested_tree(flat, prefix):
    """The inverse of ``flat_tree`` for the keys under `prefix`."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def run(rank, world, port, cfg_json, io_dir, iters):
    """Rank `rank`'s part: `iters` iterations from the weights in
    ``init.npz``, the draws of ``draws_{i}_rank{rank}.npz`` injected,
    results into ``out_rank{rank}.npz``."""
    torch.set_num_threads(1)
    from alphafive_tpu_torch import parallel
    from alphafive_tpu_torch.config import RunConfig
    from alphafive_tpu_torch.mcts import gumbel
    from alphafive_tpu_torch.parallel import distributed
    from alphafive_tpu_torch.replay import buffer

    cfg = RunConfig.from_json(cfg_json)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        init = dict(np.load(f"{io_dir}/init.npz"))
        group = distributed.group()
        carry = parallel.init_carry(
            cfg, "cpu", params=nested_tree(init, "params/"),
            batch_stats=nested_tree(init, "batch_stats/"), group=group)
        iteration = parallel.make_train_iteration(cfg, group)
        run_gumbel, sample = gumbel.run_gumbel_mcts, buffer.sample
        out = {}
        for i in range(iters):
            d = np.load(f"{io_dir}/draws_{i}_rank{rank}.npz")
            tables = [torch.from_numpy(d[f"table{p}"])
                      for p in range(cfg.train.selfplay_plies_per_iter)]
            picks = [(torch.from_numpy(d[f"idx{j}"]),
                      torch.from_numpy(d[f"sym{j}"]))
                     for j in range(int(d["n_picks"]))]

            def run_injected(*args, **kw):
                assert kw.pop("add_noise") is True
                return run_gumbel(*args, **kw, gumbel=tables.pop(0))

            def sample_injected(env, buf, batch_size, generator=None):
                idx, sym = picks.pop(0)
                assert batch_size == idx.numel()
                return sample(env, buf, batch_size, idx=idx, sym=sym)

            gumbel.run_gumbel_mcts, buffer.sample = (run_injected,
                                                     sample_injected)
            try:
                carry, m = iteration(carry)
            finally:
                gumbel.run_gumbel_mcts, buffer.sample = run_gumbel, sample
            out[f"{i}/tables_left"] = np.int64(len(tables))
            out[f"{i}/picks_left"] = np.int64(len(picks))
            out.update({f"{i}/m/{k}": np.float64(v) for k, v in m.items()})
            buf = carry.buffer
            out[f"{i}/ptr"], out[f"{i}/size"] = np.int64(buf.ptr), \
                np.int64(buf.size)
            for name in RING:
                out[f"{i}/ring/{name}"] = getattr(buf, name).float().numpy()
            params, stats = carry.train_state.net.to_flax()
            out.update(flat_tree(params, f"{i}/params/"))
            out.update(flat_tree(stats, f"{i}/batch_stats/"))
            ts = carry.train_state
            out[f"{i}/step"] = np.int64(ts.step)
            out[f"{i}/lr_scale"] = ts.lr_scale.numpy()
        np.savez(f"{io_dir}/out_rank{rank}.npz", **out)
    finally:
        distributed.shutdown()


def run_loop(rank, world, port, cfg_json, workdir, total, io_dir):
    """Rank `rank`'s part of ``loop.train(cfg, workdir, total)`` with the
    ladder eval scripted by SCRIPT; writes which evals this rank ran, its
    ladder and its weights into ``out_rank{rank}.npz`` in `io_dir`."""
    torch.set_num_threads(1)
    from alphafive_tpu_torch.config import RunConfig
    from alphafive_tpu_torch.parallel import distributed
    from alphafive_tpu_torch.train import loop
    from alphafive_tpu_torch.utils.elo import update_ladder
    from alphafive_tpu_torch.utils.logging import MetricsLogger

    evals = []

    def scripted(cfg, carry, ladder, it, log, device):
        evals.append(it)
        wins = int(SCRIPT[it] * 4)
        result = {"score": SCRIPT[it], "games": 4, "wins": wins,
                  "losses": 4 - wins, "draws": 0}
        elo = update_ladder(ladder, result, it)
        log.log({"kind": "eval", "iter": it, **result, "elo": elo})
        return elo

    loop.run_eval = scripted
    cfg = RunConfig.from_json(cfg_json)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        log = MetricsLogger(workdir if rank == 0 else None, quiet=True,
                            tensorboard=False)
        carry, ladder = loop.train(cfg, workdir, total, logger=log,
                                   device="cpu")
        log.close()
        params, stats = carry.train_state.net.to_flax()
        np.savez(f"{io_dir}/out_rank{rank}.npz", evals=np.array(evals),
                 ladder=np.array(json.dumps(dataclasses.asdict(ladder))),
                 **flat_tree(params, "params/"),
                 **flat_tree(stats, "batch_stats/"))
    finally:
        distributed.shutdown()
