"""Fused inference residual block: CUDA kernel wrapper and plain version.

Port of ``alphafive_tpu/ops/pallas_resblock.py``. With batch norm folded
into the convolutions (``fold_batchnorm``), one block is

    y = round(relu(conv3x3(x; W1) + b1));  out = round(relu(conv3x3(y; W2) + b2 + x))

with f32 accumulation and rounding to the compute dtype at the two points
the Pallas kernel rounds. ``fused_resblock`` launches the hand-written
kernel ``csrc/resblock.cu`` on CUDA tensors and runs
``fused_resblock_reference`` on CPU tensors; on any other device it raises.
Layout is the JAX package's: x NHWC ``[B, H, W, C]``, packed weights
``[9, Cin, Cout]`` (tap = (dy + 1) * 3 + (dx + 1)), f32 biases ``[C]``.

Counters (``utils/trace.py``): ``resblock_launches``, the same launches
by the variant `variant` picked and the library launched as
``variant_launches.<variant>``, and ``pack_launches``, the streaming
variant's tap packs (one before each streaming block, and each
`pack_streaming_taps` on CUDA tensors).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from alphafive_tpu_torch.utils import trace

CHANNELS = (64, 96, 128)  # the widths the fast variants are built for
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
# csrc/resblock.cu's split variant (bf16): one sample over the CTAs of a
# thread-block cluster, each rank a tile of a band of the h x (w + 1)
# grid's positions x 64 output channels, counted in bands of SPLIT_BM. It
# runs the batches below SPLIT_BELOW[v] of each shape the variant v takes
# otherwise: where chip_smoke.py's kernel_vs_plain rows measured it faster
# than v at every batch below.
SPLIT_BM = 64
SPLIT_BELOW = {"resident": 17, "streaming": 17, "general": 2}


def split_tiles(h: int, w: int, c: int) -> int:
    """Output tiles of one sample in the split variant: bands of SPLIT_BM
    positions of the h x (w + 1) grid x 64-channel groups."""
    return -(-h * (w + 1) // SPLIT_BM) * -(-c // 64)


# csrc/resblock.cu's variant codes (enum Variant), as alphafive_resblock
# takes them
VARIANTS = {0: "streaming", 1: "resident", 2: "tiled", 4: "general",
            5: "split"}
_CODES = {v: k for k, v in VARIANTS.items()}
_TAPS = 18  # both convs' taps, as the streaming variant streams them


def __getattr__(name: str):
    """``resblock_launches``, ``pack_launches`` and ``variant_launches``
    (a dict by variant) as module attributes: views of the counters, as
    ``perfbench/run.py`` reads them."""
    if name in ("resblock_launches", "pack_launches"):
        return trace.counter(name)
    if name == "variant_launches":
        return {v: trace.counter("variant_launches." + v)
                for v in VARIANTS.values()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def pack_conv_kernel(k: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel [3, 3, Cin, Cout] → packed [9, Cin, Cout]."""
    return k.reshape(9, k.shape[2], k.shape[3])


def fold_batchnorm(kernel: torch.Tensor, bn_scale, bn_bias, bn_mean, bn_var,
                   eps: float = 1e-5):
    """Fold inference BatchNorm into the preceding conv (all f32).

    conv(x)·γ/√(σ²+ε) + (β − μγ/√(σ²+ε))  →  (W', b').
    kernel: [..., Cin, Cout]; BN params: [Cout].
    """
    inv = bn_scale * torch.rsqrt(bn_var + eps)
    return kernel * inv, bn_bias - bn_mean * inv


def conv3x3_packed(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """f32 3×3 'same' conv of NHWC `x` with packed `w9` [9, Cin, Cout] →
    NHWC f32. Inputs are widened to f32 first, so bf16 products are exact
    and only the summation order differs from the kernel's."""
    cin, cout = w9.shape[1], w9.shape[2]
    w = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)  # OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    return y.permute(0, 2, 3, 1)


def fused_resblock_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same rounding points.
    On the card, call it with ``torch.backends.cudnn.allow_tf32 = False``
    so its f32 convolutions are not rounded to TF32."""
    dt = x.dtype
    y = torch.relu(conv3x3_packed(x, w1) + b1.float()).to(dt)
    z = conv3x3_packed(y, w2) + b2.float() + x.float()
    return torch.relu(z).to(dt)


def pack_streaming_taps_reference(w1, w2) -> torch.Tensor:
    """Plain version of csrc/resblock.cu's ``streaming::pack_taps``: packed
    ``w1``/``w2`` [9, Cin, Cout] → [18, Cout / 8, Cin, 8], element (t, cin,
    cout) at [t, cout // 8, cin, cout % 8], so that each tap is one
    contiguous run in the MN-major layout the streaming kernel's wgmma
    reads."""
    c = w1.shape[-1]
    taps = torch.cat([w1, w2]).reshape(_TAPS, c, c // 8, 8)
    return taps.permute(0, 2, 1, 3).contiguous()


def pack_streaming_taps(w1, w2) -> torch.Tensor:
    """The streaming variant's tap pack on its own: the kernel on CUDA
    tensors (bf16, C a multiple of 8), the plain version on CPU ones."""
    if w1.device.type == "cpu":
        return pack_streaming_taps_reference(w1, w2)
    if w1.device.type != "cuda":
        raise RuntimeError(f"no tap pack kernel for device {w1.device}")
    c = w1.shape[-1]
    for name, t in (("w1", w1), ("w2", w2)):
        if (tuple(t.shape) != (9, c, c) or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != w1.device
                or t.data_ptr() % 16 or c % 8):
            raise ValueError(f"{name}: want contiguous 16-byte aligned bf16 "
                             f"[9, C, C] with C a multiple of 8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    taps = torch.empty(_TAPS, c // 8, c, 8, dtype=w1.dtype, device=w1.device)
    with torch.cuda.device(w1.device):
        err = lib.alphafive_resblock_pack_taps(
            w1.data_ptr(), w2.data_ptr(), taps.data_ptr(), c,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tap pack launch failed: CUDA error {err}")
    trace.count("pack_launches")
    return taps


# Shared-memory bytes of the fast kernel variants of csrc/resblock.cu,
# which `variant` picks only where they fit. The bf16 kernels keep
# activations as C / 8 channel-chunk planes over an h x (w + 1) grid of
# output positions, plus the rows the taps shift into and a junk row:
# "resident" holds both convs' 18 taps (147,456 B at C = 64) beside two
# such buffers of 2 x (48 or 120) positions; "streaming" one buffer of
# 3 x 128 positions beside a ring of 3 taps and its 6 mbarriers of 8 B
# (a full and an empty one a stage). "tiled" (f32) double-buffers
# one 16 KB tap beside two halo-padded buffers of 272 B rows.
def _smem_bytes(variant: str, h: int, w: int, c: int) -> int:
    def rows(positions):
        return (positions + 2 * (w + 1) + 9) // 8 * 8 + 1
    if variant == "resident":
        n = 48 if h * (w + 1) <= 96 else 120
        return 18 * c * c * 2 + 2 * (c // 8) * rows(2 * n) * 16
    if variant == "tiled":
        return (2 * c * c + 2 * (h + 2) * (w + 2) * (c + 4)) * 4
    if variant == "streaming":
        return 3 * c * c * 2 + (c // 8) * rows(384) * 16 + 2 * 3 * 8
    raise ValueError(f"no fast variant {variant!r}")


@functools.lru_cache(maxsize=None)   # a wrapper call asks it for its shape
def variant(dtype: torch.dtype, h: int, w: int, c: int,
            b: int | None = None) -> str:
    """The kernel variant that runs a [b, h, w, c] block of `dtype`, the
    one choice: csrc/resblock.cu launches the variant it is named.
    "resident" (bf16, C = 64, h·(w + 1) up to 240, e.g. 15×15: weights
    resident, wgmma), "tiled" (f32, C = 64, up to 256 pixels: register-
    blocked SIMT), "streaming" (bf16, C in CHANNELS, up to h·(w + 1) =
    384, e.g. 19×19: taps streamed, wgmma), or "general" (every other
    shape: any other C, e.g. 16 or 256; bf16 boards from 20×20 up; f32
    beyond 256 pixels or at other widths, e.g. 19×19 × 64 or 192: implicit
    GEMM, mma.sync for bf16 and register-blocked SIMT for f32, no width or
    board limit); and, for bf16 batches b below SPLIT_BELOW of the variant
    the shape takes otherwise, "split" (one sample over a cluster of
    CTAs), where a sample has at least two of its tiles and C is a
    multiple of 8. `b=None`: the choice at a batch that names none, as
    before the split variant (no split)."""
    if min(h, w, c) < 1:
        raise ValueError(f"{h}x{w}x{c}: every dimension must be at least 1")
    bf16 = dtype == torch.bfloat16
    cells, fast = h * (w + 1), c in CHANNELS
    if bf16:
        kinds = [("resident", c == 64 and cells <= 240),
                 ("streaming", fast and cells <= 384)]
    else:
        kinds = [("tiled", c == 64 and h * w <= 256)]
    base = next((v for v, shape_ok in kinds if shape_ok and
                 _smem_bytes(v, h, w, c) <= _SMEM_LIMIT), "general")
    if (bf16 and b is not None and 1 <= b < SPLIT_BELOW[base]
            and split_tiles(h, w, c) >= 2 and c % 8 == 0):
        return "split"
    return base


def _check(x, w1, b1, w2, b2) -> str:
    """Validate the operands; return the kernel variant that will run."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported dtype {x.dtype}")
    for name, t, shape, dt in (("w1", w1, (9, c, c), x.dtype),
                               ("w2", w2, (9, c, c), x.dtype),
                               ("b1", b1, (c,), torch.float32),
                               ("b2", b2, (c,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: want {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    # the kernels move 16 B at a time (cp.async, vector loads)
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return variant(x.dtype, h, w, c, b)


def cluster_narrowed() -> int:
    """Split launches so far (this process, the library's count) that ran
    clusters of 8 CTAs where cluster_size asked 16 and the card could not
    co-schedule 16 at their shared memory."""
    from alphafive_tpu_torch.ops import _build
    return _build.load().alphafive_resblock_narrowed()


@functools.lru_cache(maxsize=None)
def _workspace_bytes(code: int, bf16: int, b: int, h: int, w: int,
                     c: int) -> int:
    """The library's workspace for variant `code` at this batch and shape:
    the streaming variant's packed taps, or y where it does not fit in
    shared memory (split: each sample's; general: each CTA's)."""
    from alphafive_tpu_torch.ops import _build
    return _build.load().alphafive_resblock_workspace(code, bf16, b, h, w, c)


def _launch(kind: str, x, w1, b1, w2, b2) -> torch.Tensor:
    """The block by variant `kind` on checked CUDA operands; ValueError
    where that variant does not take the shape."""
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    code, bf16 = _CODES[kind], int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        n = _workspace_bytes(code, bf16, b, h, w, c)
        ws = torch.empty(n, dtype=torch.uint8, device=x.device) if n else None
        err = lib.alphafive_resblock(
            code, bf16, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), None if ws is None
            else ws.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    if err == 1:   # cudaErrorInvalidValue: only a shape the variant refuses
        raise ValueError(f"{kind} does not take {b}x{h}x{w}x{c} {x.dtype}")
    if err != 0:
        raise RuntimeError(f"resblock {kind} launch failed: CUDA error {err}")
    return out


def fused_resblock(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [B,H,W,C]; w1/w2 [9,C,C] packed (BN folded); b1/b2 f32 [C]."""
    if x.device.type == "cpu":
        return fused_resblock_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise RuntimeError(f"no resblock kernel for device {x.device}")
    kind = _check(x, w1, b1, w2, b2)
    out = _launch(kind, x, w1, b1, w2, b2)
    trace.count("resblock_launches")
    trace.count("variant_launches." + kind)
    if kind == "streaming":   # the library packed the taps first
        trace.count("pack_launches")
    return out


def fused_resblock_as(kind: str, x, w1, b1, w2, b2) -> torch.Tensor:
    """The block on CUDA tensors by the kernel variant named `kind`, where
    that variant takes the shape, else ValueError: to time one variant
    against another at one shape. Counts no launch; the main path calls
    `fused_resblock`."""
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_resblock_as launches kernels only: got "
                           f"{x.device}")
    _check(x, w1, b1, w2, b2)
    return _launch(kind, x, w1, b1, w2, b2)
