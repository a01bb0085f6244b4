"""Where a resblock kernel spends each sample, in SM clock cycles.

    python -m alphafive_tpu_torch.benchmarks.resblock_profile [--ablate NAME]

Builds an instrumented copy of ``csrc/resblock.cu`` into
``build/kernels/profile/`` and runs the persistent kernels at their
chip_smoke shapes on the card: resident (bf16, 2,048 × 15×15 and 9×9 ×
64) and streaming (bf16, 2,048 × 19×19 × 96 and 128). In the copy, every
line ``// stamp: K`` of the source becomes a ``clock64()`` stamp K of
thread 0 of block 0, kept for its first 16 samples. One JSON line per
shape gives the kernel's time (CUDA events), the cycles per sample and
the mean cycles between consecutive stamps over block 0's samples 1-7:
for the resident kernel stamps 0-4 (conv 1 with the previous output's
copy-out, conv 1's epilogue, conv 2 with the next x's loads, conv 2's
epilogue); for the streaming kernel stamps 0-17 (one per tap, after its
barrier) and 18-21 (conv 2 drained, x reloaded, output epilogue,
copy-out).

``--ablate NAME`` (repeatable) also deletes the line after each
``// ablate: NAME`` (the streaming kernel's per-tap ``barrier`` and tap
``loads``): the results are then wrong, and only the timing is read.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

from alphafive_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "resblock.cu")
SHAPES = [(2048, 15, 64), (2048, 9, 64), (2048, 19, 96), (2048, 19, 128)]
SAMPLES, STAMPS = 16, 32
PRELUDE = f"""
__device__ long long resblock_stamps[{SAMPLES}][{STAMPS}];
#define RESBLOCK_STAMP(k)                                                 \\
  do {{                                                                   \\
    const int it_ = (b - (int)blockIdx.x) / (int)gridDim.x;              \\
    if (blockIdx.x == 0 && threadIdx.x == 0 && it_ < {SAMPLES})           \\
      resblock_stamps[it_][(k)] = clock64();                             \\
  }} while (0)
"""
FETCH = """
extern "C" int resblock_stamps_fetch(void* dst) {
  return cudaMemcpyFromSymbol(dst, resblock_stamps, sizeof(resblock_stamps));
}
"""


def instrument(src: str, ablate) -> str:
    lines, out, drop = src.splitlines(), [], False
    for line in lines:
        m = re.match(r"(\s*)// stamp: (\w+)$", line)
        a = re.match(r"\s*// ablate: (\w+)$", line)
        if drop:
            drop = False
            continue
        if m:
            out.append(f"{m.group(1)}RESBLOCK_STAMP({m.group(2)});")
        elif a:
            drop = a.group(1) in ablate
        else:
            out.append(line)
    text = "\n".join(out) + "\n" + FETCH
    return text.replace("#include <stdint.h>\n",
                        "#include <stdint.h>\n" + PRELUDE, 1)


def build(ablate) -> ctypes.CDLL:
    src = instrument(open(SOURCE).read(), ablate)
    out_dir = os.path.join(_build.BUILD_ROOT, "profile", hashlib.sha256(
        src.encode()).hexdigest()[:16])
    so = os.path.join(out_dir, "libresblock_profile.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        cu = os.path.join(out_dir, "resblock_profile.cu")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", "-o", so,
                        cu], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.alphafive_resblock.restype = i32
    lib.alphafive_resblock.argtypes = [i32] + [ptr] * 7 + [i32] * 4 + [ptr]
    lib.resblock_stamps_fetch.restype = i32
    lib.resblock_stamps_fetch.argtypes = [ptr]
    return lib


def profile(lib, b: int, s: int, c: int, seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, s, c, generator=g, device="cuda").relu().bfloat16()
    w1, w2 = ((torch.randn(9, c, c, generator=g, device="cuda")
               / (3 * c ** 0.5)).bfloat16() for _ in range(2))
    b1, b2 = (0.1 * torch.randn(c, generator=g, device="cuda")
              for _ in range(2))
    out = torch.empty_like(x)

    def call():
        err = lib.alphafive_resblock(
            1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), None, b, s, s, c,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"resblock launch failed: CUDA error {err}")

    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        call()
    end.record()
    torch.cuda.synchronize()
    stamps = torch.zeros(SAMPLES, STAMPS, dtype=torch.int64)
    if lib.resblock_stamps_fetch(stamps.data_ptr()):
        raise RuntimeError("could not read the stamps")
    # block 0's samples 1..n-1 (sample 0 includes the weight load)
    n = min(8, int((stamps[:, 0] != 0).sum()))
    if n < 3:
        raise ValueError(f"batch {b}: block 0 runs {n} samples, need 3")
    used = int((stamps[1] != 0).sum())     # stamps this kernel writes
    t = stamps[1:n, :used].double()
    return dict(batch=b, board=s, channels=c, ms=start.elapsed_time(end) / 10,
                cycles_per_sample=(stamps[2:n, 0] - stamps[1:n - 1, 0])
                .double().mean().item(),
                cycles_between_stamps=[round(v, 1) for v in
                                       (t[:, 1:] - t[:, :-1]).mean(0)
                                       .tolist()])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ablate", action="append", default=[],
                   choices=("barrier", "loads"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resblock_profile: CUDA is not available")
    lib = build(set(args.ablate))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    for b, s, c in SHAPES:
        print(json.dumps({**profile(lib, b, s, c), "ablate": args.ablate,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
