"""Where a resblock kernel spends each sample, in SM clock cycles.

    python -m alphafive_tpu_torch.benchmarks.resblock_profile [--ablate NAME]
        [--source PATH]

Builds an instrumented copy of ``csrc/resblock.cu`` into
``build/kernels/profile/`` and runs the bf16 kernels at their chip_smoke
shapes on the card, each variant named (``alphafive_resblock_as``):
resident (2,048 × 15×15 and 9×9 × 64), streaming (2,048 × 19×19 × 96 and
128, and renju_19x19's 4,096 × 19×19 × 128 leaf forward) and general
(2,048 × 15×15 × 256 and 2,048 × 21×21 × 64); then one sample of each
(1 × 15×15 × 64 resident, 1 × 19×19 × 128 streaming, 1 × 15×15 × 256
general) and the split variant at 1 × 15×15 × 64, 1 × 19×19 × 128, 1 ×
15×15 × 256, 8 × 19×19 × 128, 16 × 15×15 × 64, 1 × 33×33 × 64 and 1 ×
240×240 × 72 (y in the workspace). In the copy, every
line ``// stamp: K`` of the source becomes a ``clock64()`` stamp K of
thread 0 of block 0, kept for its first 16 samples (K may be an
expression), and ``// launch stamp: K`` one of block 0 into sample 0's
slot K (30 at a kernel's entry, 31 at its exit). One JSON line per
shape gives the kernel's time (CUDA events; for streaming the tap pack's
launch too). Where block 0 runs at least 3 samples: the cycles per
sample and the mean cycles between consecutive stamps over block 0's
samples 1-7; else (batch 1, and split, whose block 0 runs one sample):
the cycles from entry to exit and between consecutive stamps in the
order taken, as (from, to, cycles). The stamps: for the resident kernel
0-4 (conv 1 with the previous output's copy-out, conv 1's epilogue, conv
2 with the next x's loads, conv 2's epilogue); for the streaming kernel stamps 0-8 (conv 1's
taps, each after its stage's `full` wait), 9-10 (conv 1 drained, its
epilogue: y over x, conv 2 started at b2 + x), 11-19 (conv 2's taps), 20-22
(conv 2 drained, the output epilogue, the copy-out fused with the next
x's loads); for the general kernel stamps 0-4 (conv 1's K loops with every
epilogue but the last tile's, that epilogue, the same two for conv 2); for
split 0 (y zeroed), 1-2 (conv 1's K loops, its last epilogue), 5 (the
cluster barrier), 6 (the gather), 3-4 (conv 2's), 31 (the wait for the
peers).

``--ablate NAME`` (repeatable) also deletes the line after each
``// ablate: NAME``: the streaming kernel's tap ``bulk`` copy (and the
bytes its `full` barrier expects), the producer's ``empty`` wait (a
stage refilled before every warp released it), and the copy-out's output
``store`` and next-x load (``xload``); the general kernel's
``mma`` (the tensor-core products), ``copies`` (the ring's cp.async),
``epilogue`` and its K step's ``barrier`` (split runs the same K loop).
The results are then wrong, and only the timing is read.

``--source PATH`` profiles another copy of the source instead (a step's
``csrc/resblock.cu``, say, so that one call to the card compares the
two); it must have ``alphafive_resblock_as``.
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
# (batch, board, channels, variant): the persistent kernels at their
# chip_smoke shapes, then batch 1, where one CTA of each does the block
SHAPES = [(2048, 15, 64, "resident"), (2048, 9, 64, "resident"),
          (2048, 19, 96, "streaming"), (2048, 19, 128, "streaming"),
          (4096, 19, 128, "streaming"), (2048, 15, 256, "general"),
          (2048, 21, 64, "general"), (1, 15, 64, "resident"),
          (1, 19, 128, "streaming"), (1, 15, 256, "general"),
          (1, 15, 64, "split"), (1, 19, 128, "split"), (1, 15, 256, "split"),
          (8, 19, 128, "split"), (16, 15, 64, "split"), (1, 33, 64, "split"),
          (1, 240, 72, "split")]
CODES = {"streaming": 0, "resident": 1, "general": 4, "split": 5}
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
#define RESBLOCK_LAUNCH_STAMP(k)                                          \\
  do {{                                                                   \\
    if (blockIdx.x == 0 && threadIdx.x == 0)                              \\
      resblock_stamps[0][(k)] = clock64();                               \\
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
        e = re.match(r"(\s*)// launch stamp: (\d+)$", line)
        a = re.match(r"\s*// ablate: (\w+)$", line)
        if drop:
            drop = False
            continue
        if m:
            out.append(f"{m.group(1)}RESBLOCK_STAMP(({m.group(2)}));")
        elif e:
            out.append(f"{e.group(1)}RESBLOCK_LAUNCH_STAMP({e.group(2)});")
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
    lib.alphafive_resblock_as.restype = i32
    lib.alphafive_resblock_as.argtypes = [i32] * 2 + [ptr] * 7 + [i32] * 4 + [
        ptr]
    lib.alphafive_resblock_workspace_as.restype = ctypes.c_longlong
    lib.alphafive_resblock_workspace_as.argtypes = [i32] * 6
    lib.resblock_stamps_fetch.restype = i32
    lib.resblock_stamps_fetch.argtypes = [ptr]
    lib.resblock_stamps_clear.restype = i32
    return lib


def profile(lib, b: int, s: int, c: int, kind: str, seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, s, c, generator=g, device="cuda").relu().bfloat16()
    w1, w2 = ((torch.randn(9, c, c, generator=g, device="cuda")
               / (3 * c ** 0.5)).bfloat16() for _ in range(2))
    b1, b2 = (0.1 * torch.randn(c, generator=g, device="cuda")
              for _ in range(2))
    out = torch.empty_like(x)
    code = CODES[kind]
    n = lib.alphafive_resblock_workspace_as(code, 1, b, s, s, c)
    ws = torch.empty(n, dtype=torch.uint8, device="cuda") if n else None

    def call():
        err = lib.alphafive_resblock_as(
            code, 1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, s, s, c,
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
    row = dict(batch=b, board=s, channels=c, variant=kind,
               ms=start.elapsed_time(end) / 10)
    n = min(8, int((stamps[:, 0] != 0).sum()))
    if n < 3:
        # block 0 ran one sample: the cycles from the kernel's entry (30)
        # through each stamp of sample 0, in the order they were taken, to
        # its exit (31), as (from, to, cycles), the weights' and the first
        # x's staging included
        order = sorted((k for k in range(STAMPS) if stamps[0, k]),
                       key=lambda k: int(stamps[0, k]))
        t = stamps[0, order].tolist()
        return dict(row, cycles_launch=t[-1] - t[0], cycles_between_stamps=[
            (a, z, tz - ta) for a, z, ta, tz in zip(order, order[1:], t,
                                                    t[1:])])
    # block 0's samples 1..n-1 (sample 0 includes the weight load)
    used = int((stamps[1, :30] != 0).sum())   # stamps this kernel writes
    t = stamps[1:n, :used].double()
    return dict(row, cycles_per_sample=(stamps[2:n, 0] - stamps[1:n - 1, 0])
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
    for b, s, c, kind in SHAPES:
        print(json.dumps({**profile(lib, b, s, c, kind),
                          "ablate": args.ablate,
                          "source": os.path.relpath(args.source),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
