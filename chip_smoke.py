"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, checks a bundled net,
and drives the port's self-play main path (``chip_15x15`` with
``net.use_pallas=true``: 256 envs, 400 sims per move, the bundled 15×15
weights) through ``alphafive_tpu_torch.benchmarks.selfplay_bench.run``.
Each phase prints one JSON line; any failure raises. The last lines are
the kernel table, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``. There is no CPU path: without CUDA the
script exits non-zero before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from alphafive_tpu_torch.ops import _build, resblock as rb  # noqa: E402

# kernel vs plain: (batch, board, channels, dtype); the first two are the
# self-play path's pass and root forwards, the rest the other bundles
SHAPES = [(2048, 15, 64, torch.bfloat16), (256, 15, 64, torch.bfloat16),
          (2048, 9, 64, torch.bfloat16), (2048, 19, 96, torch.bfloat16),
          (2048, 19, 128, torch.bfloat16), (2048, 15, 64, torch.float32)]
# bf16: one ulp of a rounded y (2^-8 relative) moves the output by about one
# ulp of the output again, so allow two ulps of outputs of magnitude ~4-8
# (2^-5 = 0.03125) plus 2% relative; f32 differs only in summation order
TOL = {torch.bfloat16: (5e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# bundle forward, bf16 trunk: policy logits (atol, rtol) and value atol
NET_TOL = {"logits": (1e-1, 2e-2), "value": 2e-2}
SELFPLAY_PLIES, SELFPLAY_REPEATS = 4, 2
FORWARDS_PER_PLY = 400 // 8 + 1   # 50 passes of 8 lanes + the root


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return name


def phase_build():
    _build.load()
    regs = [line.strip() for line in _build.build_log.splitlines()
            if "registers" in line or "spill" in line]
    emit("build", seconds=_build.build_seconds, ptxas=regs)


def phase_kernel_vs_plain():
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, c, dt in SHAPES:
        scale = 1.0 / (3.0 * c ** 0.5)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
        x = rnd(b, s, s, c).relu().to(dt)
        w1, w2 = ((rnd(9, c, c) * scale).to(dt) for _ in range(2))
        b1, b2 = (0.1 * rnd(c) for _ in range(2))
        got = rb.fused_resblock(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ref = rb.fused_resblock_reference(x, w1, b1, w2, b2)
        err = (got.float() - ref.float()).abs()
        atol, rtol = TOL[dt]
        worst = (err - rtol * ref.float().abs()).max().item()
        row = dict(batch=b, board=s, channels=c, dtype=str(dt)[6:],
                   max_abs_err=err.max().item(),
                   max_rel_err=(err / ref.float().abs().clamp(min=1e-3))
                   .max().item(), atol=atol, rtol=rtol)
        if not worst <= atol:
            emit("kernel_vs_plain", **row, ok=False)
            raise AssertionError(f"resblock kernel disagrees: {row}")
        row["ms"] = cuda_ms(lambda: rb.fused_resblock(x, w1, b1, w2, b2))
        row["plain_ms"] = cuda_ms(
            lambda: rb.fused_resblock_reference(x, w1, b1, w2, b2))
        emit("kernel_vs_plain", **row, ok=True)
        rows.append(row)
    return rows


def random_positions(env_cfg, n: int, max_plies: int):
    """`n` positions from uniformly random legal play (0..max_plies moves,
    games that end are reset)."""
    from alphafive_tpu_torch.env import vector
    g = torch.Generator(device="cuda").manual_seed(1)
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
    return vector.state_features(env_cfg, st)


def phase_bundle():
    from alphafive_tpu_torch.models.resnet import FusedPolicyValueNet
    from alphafive_tpu_torch.train.checkpoint import load_model
    params, stats, cfg = load_model(os.path.join(ROOT, "pretrained",
                                                 "15x15"))
    feats = random_positions(cfg.env, 2048, 60)
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
    emit("bundle", bundle="pretrained/15x15", positions=2048,
         logits_max_abs_err=lerr.max().item(), value_max_abs_err=verr,
         tol=NET_TOL, argmax_agreement=agree.item(), ok=ok)
    if not ok:
        raise AssertionError("bundle forward: kernel disagrees with plain")
    return params, stats, cfg


def phase_selfplay(params, stats, saved_cfg, card: str):
    from alphafive_tpu_torch.benchmarks import selfplay_bench
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    cfg = apply_overrides(get_preset("chip_15x15"), ["net.use_pallas=true"])
    if (saved_cfg.net.blocks, saved_cfg.net.channels,
            saved_cfg.net.value_hidden) != (cfg.net.blocks, cfg.net.channels,
                                            cfg.net.value_hidden):
        raise ValueError("pretrained/15x15 does not fit chip_15x15's net")
    sims = cfg.mcts.num_simulations
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    plies = [0]

    def observe(state, res, action):
        # every root is live (finished games are reset before the search)
        legal = state.board.gather(1, action.long()[:, None])[:, 0] == 0
        bad.add_((res.visits.sum(-1) != sims).sum() + (~legal).sum()
                 + state.done.sum())
        plies[0] += 1

    rb.resblock_launches = 0
    out, traj = selfplay_bench.run(
        cfg, plies=SELFPLAY_PLIES, warmup=0, repeats=SELFPLAY_REPEATS,
        device="cuda", params=params, batch_stats=stats, observe=observe,
        return_trajectory=True)
    launches = rb.resblock_launches
    pi_sum = traj.pi.sum(-1)
    ok = bool(bad.item() == 0
              and launches == 4 * FORWARDS_PER_PLY * plies[0]
              and torch.isfinite(traj.pi).all()
              and ((pi_sum - 1).abs() < 1e-5).all())
    emit("selfplay", **out, total_plies=plies[0], resblock_launches=launches,
         expected_launches=4 * FORWARDS_PER_PLY * plies[0],
         failed_checks=bad.item(), nvidia_smi=nvidia_smi(), card=card, ok=ok)
    if not ok:
        raise AssertionError("self-play phase failed its checks")
    return launches


def main() -> int:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    card = phase_device()
    phase_build()
    rows = phase_kernel_vs_plain()
    params, stats, saved_cfg = phase_bundle()
    launches = phase_selfplay(params, stats, saved_cfg, card)
    emit("total", seconds=time.time() - t0)
    main_row = rows[0]
    print(json.dumps({"kernels": [{
        "name": "fused_resblock", "route": "cuda",
        "source": "alphafive_tpu_torch/csrc/resblock.cu",
        "replaces": "alphafive_tpu/ops/pallas_resblock.py:97",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}]}),
        flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
