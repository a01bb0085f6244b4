"""What bounds the select kernel, and where a descent step's cycles go.

    python -m alphafive_tpu_torch.benchmarks.select_profile

Builds an instrumented copy of ``csrc/select.cu`` into
``build/kernels/profile/`` (never the library the package loads). In the
copy, every line ``// stamp: K DEP`` of the source becomes a ``clock64()``
stamp K of lane 0 of one env, taken once the value DEP is ready, for each
of its first 64 descent steps (the kernel names its env ``env`` and its
step ``it``). The generated source also holds an empty
kernel with the select kernel's parameters and a one-warp pointer chase.
Prints one JSON line each for:

* ``latency``: the two inputs of the kernel's latency bound. The launch
  floor is the device ms per launch of the empty kernel (one warp), taken
  by CUDA-graph replay through ctypes as ``chip_smoke.py`` times the
  kernels. The round trip is one dependent 16-byte-per-lane load of a row
  that sits in L2: a warp follows a random cycle through every row of a
  buffer the size of a 16-env, 400-sim 15×15 tree (16 × 401 × 8 × 256 f32,
  52.6 MB), once to bring the rows into L2 and then timed (CUDA events for
  ns, ``clock64()`` for SM cycles).
* ``stamps``, one per tree (400-sim searches with the bundled nets at
  E = 1, 16 and 256 on 15×15 and E = 16 on 19×19): the stamped env (the
  deepest descent), its SM cycles per step, and the mean cycles between
  consecutive stamps, the last of them the loop's return to the next
  step. ``csrc/select.cu``'s stamps split a step into the load round trip
  (0 → 1), ΣN's shuffles and the square root (1 → 2), every slot's exact
  or approximate score and the lane's best (2 → 3), the exact scores of
  the visited slots that could win (3 → 4), the argmax shuffles (4 → 5)
  and the child's shuffle with the path write (5 → 6).
* ``search_breakdown``: the host time of one simulation step of a 16-env
  packed search, split into the ``select_batch`` call, ``_gather_env`` +
  ``vector.step``, ``evaluate`` and the two backup ``index_put_`` calls
  (spans of ``utils/trace.py``, no synchronisation inside the search),
  and from a
  ``torch.profiler`` run of the same search the kernels' device time per
  step (in all, the select kernel's, the eight largest by name) and the
  device's busy share of the unprofiled search's wall time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import torch

from alphafive_tpu_torch.benchmarks import timing
from alphafive_tpu_torch.ops import _build
from alphafive_tpu_torch.ops import select as sel
from alphafive_tpu_torch.utils import trace

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "select.cu")
STEPS, STAMPS = 64, 8
# the chase buffer: one 16-env, 400-sim tree at 15×15 (A_pad 256)
CHASE_ROWS, CHASE_ROW_FLOATS = 16 * 401, sel.NUM_SEC * 256
SIMS, DEPTH, C_PUCT = 400, 64, 5.0
TREES = [("15x15", 1), ("15x15", 16), ("15x15", 256), ("19x19", 16)]
PRELUDE = f"""
__device__ long long select_stamps[{STEPS}][{STAMPS}];
__constant__ int select_stamp_env;
__device__ float select_stamp_sink;
// the predicated store never runs (DEP is never NaN) but makes the stamp
// wait until DEP is ready; volatile asm keeps the stamps in order
#define SELECT_STAMP(k, dep)                                              \\
  do {{                                                                   \\
    if (env == select_stamp_env && threadIdx.x == 0 && it < {STEPS}) {{   \\
      asm volatile("{{ .reg .pred p; setp.ne.f32 p, %0, %0; "            \\
                   "@p st.global.f32 [%1], %0; }}"                       \\
                   :: "f"((float)(dep)), "l"(&select_stamp_sink));       \\
      select_stamps[it][(k)] = clock64();                                \\
    }}                                                                   \\
  }} while (0)
"""
EXTRA = f"""
extern "C" int select_stamps_reset(int env) {{
  static long long zero[{STEPS}][{STAMPS}];
  cudaError_t err = cudaMemcpyToSymbol(select_stamps, zero, sizeof(zero));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(select_stamp_env, &env, sizeof(int));
}}

extern "C" int select_stamps_fetch(void* dst) {{
  return cudaMemcpyFromSymbol(dst, select_stamps, sizeof(select_stamps));
}}

__global__ void select_profile_empty_kernel(const float*, int, int, int, int,
                                            float, float, int*, int*, int*,
                                            int*, int*) {{}}

extern "C" int select_profile_empty(void* stream) {{
  select_profile_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(
      stream)>>>(nullptr, 0, 0, 0, 0, 0.0f, 0.0f, nullptr, nullptr, nullptr,
                 nullptr, nullptr);
  return cudaGetLastError();
}}

// one warp; lane l reads float4 l of the row, whose every element holds
// the next row's index
__global__ void select_profile_chase_kernel(const float* __restrict__ buf,
                                            int row_floats, int start,
                                            int steps, long long* cycles,
                                            int* last) {{
  int row = start;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {{
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        buf + static_cast<size_t>(row) * row_floats) + threadIdx.x);
    row = __float2int_rz(v.x);
  }}
  const long long t1 = clock64();
  if (threadIdx.x == 0) {{
    *cycles = t1 - t0;
    *last = row;
  }}
}}

extern "C" int select_profile_chase(const void* buf, int row_floats,
                                    int start, int steps, void* cycles,
                                    void* last, void* stream) {{
  select_profile_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const float*>(buf), row_floats, start, steps,
                 static_cast<long long*>(cycles), static_cast<int*>(last));
  return cudaGetLastError();
}}
"""


def instrument(src: str) -> str:
    out = []
    for line in src.splitlines():
        m = re.match(r"(\s*)// stamp: (\d+) (.+)$", line)
        out.append(f"{m.group(1)}SELECT_STAMP({m.group(2)}, {m.group(3)});"
                   if m else line)
    text = "\n".join(out) + "\n" + EXTRA
    return text.replace("#include <stdint.h>\n",
                        "#include <stdint.h>\n" + PRELUDE, 1)


def build() -> ctypes.CDLL:
    """Compile (or reuse) the instrumented library and bind it."""
    with open(SOURCE) as f:
        src = instrument(f.read())
    out_dir = os.path.join(_build.BUILD_ROOT, "profile", hashlib.sha256(
        (src + " ".join(_build.FLAGS)).encode()).hexdigest()[:16])
    so = os.path.join(out_dir, "libselect_profile.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        cu = os.path.join(out_dir, "select_profile.cu")
        with open(cu, "w") as f:
            f.write(src)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", "-o", tmp,
                        cu], check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in (
            ("alphafive_select", [ptr] + [i32] * 5 + [f32] * 2 + [ptr] * 6),
            ("select_stamps_reset", [i32]), ("select_stamps_fetch", [ptr]),
            ("select_profile_empty", [ptr]),
            ("select_profile_chase", [ptr] + [i32] * 3 + [ptr] * 3)):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = args
    return lib


def _ok(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def latency_inputs(lib, seed: int = 0) -> dict:
    """The launch floor (ms per launch of the empty kernel, graph replay)
    and the round trip (one dependent load of a row in L2)."""
    floor_ms, floor_spread = timing.graph_ms(
        lambda: _ok(lib.select_profile_empty(_stream()), "empty kernel"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(CHASE_ROWS, generator=g, device="cuda")
    nxt = torch.empty_like(order)
    nxt[order] = order.roll(-1)          # one cycle through every row
    buf = nxt.float()[:, None].expand(CHASE_ROWS,
                                      CHASE_ROW_FLOATS).contiguous()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    last = torch.zeros(1, dtype=torch.int32, device="cuda")
    start = int(order[0])

    def chase():
        _ok(lib.select_profile_chase(buf.data_ptr(), CHASE_ROW_FLOATS, start,
                                     CHASE_ROWS, cycles.data_ptr(),
                                     last.data_ptr(), _stream()), "chase")

    chase()                              # brings every row into L2
    torch.cuda.synchronize()
    if int(last) != start:
        raise AssertionError("the chase did not close its cycle")
    ns, cyc = [], []
    for _ in range(timing.WINDOWS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        chase()
        t1.record()
        torch.cuda.synchronize()
        ns.append(t0.elapsed_time(t1) * 1e6 / CHASE_ROWS)
        cyc.append(int(cycles) / CHASE_ROWS)
    ns.sort()
    cyc.sort()
    return dict(launch_floor_ms=floor_ms, launch_floor_spread=floor_spread,
                round_trip_ns=ns[len(ns) // 2], round_trip_ns_spread=ns[-1]
                - ns[0], round_trip_cycles=cyc[len(cyc) // 2],
                chase_rows=CHASE_ROWS,
                chase_bytes=CHASE_ROWS * CHASE_ROW_FLOATS * 4)


def latency_bound_ms(inputs: dict, max_steps: int) -> float:
    """launch floor + the longest descent's steps × one round trip."""
    return inputs["launch_floor_ms"] + max_steps * inputs[
        "round_trip_ns"] * 1e-6


def stamp_profile(lib, packed: torch.Tensor, num_actions: int,
                  depth_limit: int, repeats: int = 5) -> dict:
    """Mean cycles between consecutive stamps per step of the deepest
    env's descent, over `repeats` launches of the instrumented kernel."""
    ref = sel.select_batch_reference(packed, num_actions, depth_limit,
                                     C_PUCT)
    env = int(ref[2].argmax())
    e, nn, _, a_pad = packed.shape
    outs = [torch.empty(e, dtype=torch.int32, device="cuda")
            for _ in range(3)] + [
        torch.empty((e, depth_limit), dtype=torch.int32, device="cuda")
        for _ in range(2)]
    rows = []
    for _ in range(repeats):
        _ok(lib.select_stamps_reset(env), "stamp reset")
        _ok(lib.alphafive_select(
            packed.data_ptr(), e, nn, a_pad, num_actions, depth_limit,
            C_PUCT, 0.0, *(t.data_ptr() for t in outs), _stream()),
            "instrumented select")
        torch.cuda.synchronize()
        if not all(torch.equal(o, r) for o, r in zip(outs, ref)):
            raise AssertionError("the instrumented kernel disagrees with "
                                 "the plain version")
        stamps = torch.zeros(STEPS, STAMPS, dtype=torch.int64)
        _ok(lib.select_stamps_fetch(stamps.data_ptr()), "stamp fetch")
        rows.append(stamps)
    s = torch.stack(rows).double()                     # [R, STEPS, STAMPS]
    steps = int((s[0, :, 0] != 0).sum())
    used = int((s[0, 0] != 0).sum())
    s = s[:, :steps, :used]
    within = (s[:, :, 1:] - s[:, :, :-1]).mean((0, 1))
    back = (s[:, 1:, 0] - s[:, :-1, -1]).mean().item() if steps > 1 else None
    return dict(envs=e, nodes=nn, a_pad=a_pad, stamped_env=env,
                steps=steps, depth=int(ref[2][env]),
                max_steps=int((ref[2] + 1).clamp(max=depth_limit).max()),
                cycles_per_step=((s[:, 1:, 0] - s[:, :-1, 0]).mean().item()
                                 if steps > 1 else None),
                cycles_each_step=[round(v, 1) for v in
                                  (s[:, 1:, 0] - s[:, :-1, 0]).mean(0)
                                  .tolist()],
                cycles_between_stamps=[round(v, 1) for v in within.tolist()],
                cycles_to_next_step=back,
                cycles_descent=(s[:, -1, -1] - s[:, 0, 0]).mean().item())


def search_tree(bundle: str, envs: int, seed: int):
    """A 400-sim packed search (f32, depth cap 64) from random 6-ply
    openings with a bundled net: (tree, env config, evaluator, state,
    MCTS config)."""
    from alphafive_tpu_torch.config import MCTSConfig
    from alphafive_tpu_torch.mcts.search_packed import run_mcts_packed
    from alphafive_tpu_torch.models.evaluator import net_evaluator
    from alphafive_tpu_torch.train.checkpoint import load_model
    from alphafive_tpu_torch.train.evaluate import random_openings
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    params, stats, cfg = load_model(os.path.join(root, "pretrained", bundle))
    evaluate = net_evaluator(cfg.env, cfg.net, params, stats, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    st = random_openings(cfg.env, envs, 6, g, "cuda")
    mcts = MCTSConfig(num_simulations=SIMS, max_depth=DEPTH,
                      select_impl="pallas")
    _, tree = run_mcts_packed(cfg.env, mcts, evaluate, st, add_noise=False,
                              return_tree=True)
    return tree, cfg.env, evaluate, st, mcts


def search_breakdown(bundle: str = "15x15", envs: int = 16,
                     seed: int = 7) -> dict:
    """Host µs per simulation step of one packed search by part (a span
    around each call, nothing synchronised inside the search), and
    the kernels' device µs per step from a torch.profiler run of the same
    search."""
    from alphafive_tpu_torch.env import vector
    from alphafive_tpu_torch.mcts import search_packed as sp
    _, env_cfg, evaluate, st, mcts = search_tree(bundle, envs, seed)

    def timed(name, fn):
        def wrapped(*args, **kw):
            with trace.span(name):
                return fn(*args, **kw)
        return wrapped

    parts = ("select_batch", "gather_env+vector.step", "evaluate",
             "backup index_put_")

    def run():
        """The search with the parts spanned: (wall s, host s by part)."""
        trace.reset()
        trace.enable()
        with contextlib.ExitStack() as stack:
            for target, attr, name in (
                    (sp, "_gather_env", parts[1]), (vector, "step", parts[1]),
                    (torch.Tensor, "index_put_", parts[3])):
                stack.enter_context(mock.patch.object(
                    target, attr, timed(name, getattr(target, attr))))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp.run_mcts_packed(env_cfg, mcts, timed(parts[2], evaluate), st,
                               add_noise=False,
                               select=timed(parts[0], sel.select_batch))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace.disable()
        spans = trace.snapshot()["spans"]
        return wall, {k: spans[k]["total_s"] for k in parts}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp.run_mcts_packed(env_cfg, mcts, evaluate, st, add_noise=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    wall, host = run()
    host_us = {k: host[k] / SIMS * 1e6 for k in parts}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall, _ = run()
    # device time of the kernels themselves (an op's device time would
    # count its kernels again)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("af.")]   # not the spans' mirrors
    device_total = sum(e.time_range.elapsed_us() for e in kernels)
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        bundle=bundle, envs=envs, sims=SIMS,
        wall_us_per_sim=plain_s / SIMS * 1e6,
        timed_wall_us_per_sim=wall / SIMS * 1e6,
        host_us_per_sim=host_us,
        host_us_per_sim_rest=wall / SIMS * 1e6 - sum(host_us.values()),
        profiled_wall_us_per_sim=prof_wall / SIMS * 1e6,
        device_us_per_sim=device_total / SIMS,
        device_busy_share=device_total / SIMS / (plain_s / SIMS * 1e6),
        select_kernel_us_per_sim=sum(v for k, v in by_kernel.items()
                                     if "select_kernel" in k) / SIMS,
        top_kernels_us_per_sim={k[:80]: v / SIMS for k, v in top})


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("select_profile: CUDA is not available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lib = build()
    print(json.dumps({"latency": latency_inputs(lib), "card": card}),
          flush=True)
    for i, (bundle, envs) in enumerate(TREES):
        tree, env_cfg, *_ = search_tree(bundle, envs, seed=10 + i)
        row = stamp_profile(lib, tree.packed, env_cfg.num_actions, DEPTH)
        print(json.dumps({"stamps": dict(bundle=bundle, **row),
                          "card": card}), flush=True)
    print(json.dumps({"search_breakdown": search_breakdown(),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
