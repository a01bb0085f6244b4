"""Where a resblock kernel spends each sample, in SM clock cycles.

    python -m alphafive_tpu_torch.benchmarks.resblock_profile [--ablate NAME]
        [--source PATH]

Builds an instrumented copy of ``csrc/resblock.cu`` into
``build/kernels/profile/`` and runs the persistent bf16 kernels at their
chip_smoke shapes on the card: resident (2,048 × 15×15 and 9×9 × 64),
streaming (2,048 × 19×19 × 96 and 128, and renju_19x19's 4,096 × 19×19 ×
128 leaf forward) and general (2,048 × 15×15 × 256 and 2,048 × 21×21 ×
64). In the copy, every line ``// stamp: K`` of the source becomes a
``clock64()`` stamp K of thread 0 of block 0, kept for its first 16
samples (K may be an expression). One JSON line per shape gives the
kernel's time (CUDA events; for streaming the tap pack's launch too), the
cycles per sample and the mean cycles between consecutive stamps over
block 0's samples 1-7: for the resident kernel stamps 0-4 (conv 1 with the
previous output's copy-out, conv 1's epilogue, conv 2 with the next x's
loads, conv 2's epilogue); for the streaming kernel stamps 0-8 (conv 1's
taps, each after its stage's `full` wait), 9-10 (conv 1 drained, its
epilogue: y over x, conv 2 started at b2 + x), 11-19 (conv 2's taps), 20-22
(conv 2 drained, the output epilogue, the copy-out fused with the next
x's loads); for the general kernel stamps 0-4 (conv 1's K loops with every
epilogue but the last tile's, that epilogue, the same two for conv 2).

``--ablate NAME`` (repeatable) also deletes the line after each
``// ablate: NAME``: the streaming kernel's tap ``bulk`` copy (and the
bytes its `full` barrier expects), the producer's ``empty`` wait (a
stage refilled before every warp released it), and the copy-out's output
``store`` and next-x load (``xload``); the general kernel's
``mma`` (the tensor-core products), ``copies`` (the ring's cp.async),
``epilogue`` and its K step's ``barrier``. The results are then wrong, and
only the timing is read.

``--source PATH`` profiles another copy of the source instead (an
earlier commit's ``csrc/resblock.cu``, say, so that one call to the card
compares the two).
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
SHAPES = [(2048, 15, 64), (2048, 9, 64), (2048, 19, 96), (2048, 19, 128),
          (4096, 19, 128), (2048, 15, 256), (2048, 21, 64)]
ABLATIONS = ("bulk", "empty", "store", "xload", "barrier", "mma", "copies",
             "epilogue")
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
extern "C" int resblock_stamps_clear() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, resblock_stamps);
  return err ? err : cudaMemset(p, 0, sizeof(resblock_stamps));
}
"""


def instrument(src: str, ablate) -> str:
    lines, out, drop = src.splitlines(), [], False
    for line in lines:
        m = re.match(r"(\s*)// stamp: (.+)$", line)
        a = re.match(r"\s*// ablate: (\w+)$", line)
        if drop:
            drop = False
            continue
        if m:
            out.append(f"{m.group(1)}RESBLOCK_STAMP(({m.group(2)}));")
        elif a:
            drop = a.group(1) in ablate
        else:
            out.append(line)
    text = "\n".join(out) + "\n" + FETCH
    return text.replace("#include <stdint.h>\n",
                        "#include <stdint.h>\n" + PRELUDE, 1)


def build(ablate, source: str = SOURCE) -> ctypes.CDLL:
    src = instrument(open(source).read(), ablate)
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
    lib.alphafive_resblock_workspace.restype = ctypes.c_longlong
    lib.alphafive_resblock_workspace.argtypes = [i32] * 5
    lib.resblock_stamps_fetch.restype = i32
    lib.resblock_stamps_fetch.argtypes = [ptr]
    lib.resblock_stamps_clear.restype = i32
    return lib


def profile(lib, b: int, s: int, c: int, seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, s, c, generator=g, device="cuda").relu().bfloat16()
    w1, w2 = ((torch.randn(9, c, c, generator=g, device="cuda")
               / (3 * c ** 0.5)).bfloat16() for _ in range(2))
    b1, b2 = (0.1 * torch.randn(c, generator=g, device="cuda")
              for _ in range(2))
    out = torch.empty_like(x)
    n = lib.alphafive_resblock_workspace(1, b, s, s, c)
    ws = torch.empty(n, dtype=torch.uint8, device="cuda") if n else None

    def call():
        err = lib.alphafive_resblock(
            1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), None if ws is None else
            ws.data_ptr(), b, s, s, c,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"resblock launch failed: CUDA error {err}")

    # the kernels write different stamps: none of the last shape's stay
    if lib.resblock_stamps_clear():
        raise RuntimeError("could not clear the stamps")
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
                   choices=ABLATIONS)
    p.add_argument("--source", default=SOURCE)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resblock_profile: CUDA is not available")
    lib = build(set(args.ablate), args.source)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    for b, s, c in SHAPES:
        print(json.dumps({**profile(lib, b, s, c), "ablate": args.ablate,
                          "source": os.path.relpath(args.source),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
