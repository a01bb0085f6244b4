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
by the variant the library ran as ``variant_launches.<variant>`` (see
`variant`), and ``pack_launches``, the streaming variant's tap packs (one
before each streaming block, and each `pack_streaming_taps` on CUDA
tensors).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from alphafive_tpu_torch.utils import trace

CHANNELS = (64, 96, 128)  # the widths the fast variants are built for
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
_SMS = 132             # the persistent kernels' grid: min(batch, SMs)
# csrc/resblock.cu's general variant: output tiles of BM pixels (256 bf16,
# 128 f32) x 64 channels; K steps of BK input channels of one tap (64
# bf16, 32 f32); a ring of 3 (bf16) or 2 (f32) weight tiles of BK x 64
# (_GENERAL_RING) and one or two A slabs of BK channels of the pixel rows
# an M tile's taps reach, rows padded by 16 B (`_general_stage`); beside
# them y of one sample where that fits


def _general_dims(bf16: bool) -> tuple:
    """(element bytes, elements in 16 B, BM, BK, ring stages)."""
    return (2, 8, 256, 64, 3) if bf16 else (4, 4, 128, 32, 2)


def _general_ring(bf16: bool) -> int:
    elem, pad, _, bk, stages = _general_dims(bf16)
    return stages * bk * (64 + pad) * elem


_GENERAL_RING = {bf16: _general_ring(bf16) for bf16 in (True, False)}


def _general_stage(h: int, w: int, c: int, bf16: bool) -> int:
    """The general variant's shared memory beside y: the ring and the
    slabs, each of the rows of all three tap rows of an M tile (BM + 2w +
    2, at most h·w) and 3 zero rows (one slab where C <= BK and a 64-channel
    residual row fits in a slab row, else two), or, where that does not
    fit, two of one tap row (BM + 2)."""
    elem, pad, bm, bk, _ = _general_dims(bf16)
    for reach, slabs in ((2 * w + 2, 1 if c <= bk and 64 <= bk else 2),
                         (2, 2)):
        rows = min(bm + reach, h * w) + 3
        stage = _GENERAL_RING[bf16] + slabs * rows * (bk + pad) * elem
        if stage <= _SMEM_LIMIT:
            return stage
    raise AssertionError("one tap row's slabs always fit")

# csrc/resblock.cu's split variant (bf16): one sample over the CTAs of a
# thread-block cluster, each rank a tile of one band of the h x (w + 1)
# grid's positions (SPLIT_BANDS) x 64 output channels on wgmma; clusters
# of 2 to SPLIT_CLUSTER_MAX CTAs (`cluster_size`, counting tiles of
# SPLIT_BM positions). It runs the batches below SPLIT_BELOW[v] of each
# shape the variant v takes otherwise (kSplitBelowResident, ... in the
# source): where chip_smoke.py measured it faster than v.
SPLIT_BM, SPLIT_CLUSTER_MAX = 64, 16
SPLIT_BANDS = (48, 64, 96, 192)   # band_at(0 .. kBands - 1); the last kBandMax
SPLIT_STAGES, SPLIT_STAGE_BYTES, SPLIT_BAR_BYTES = 3, 3 * 64 * 64 * 2, 128
SPLIT_BELOW_RESIDENT = 17
SPLIT_BELOW_STREAMING = 17
SPLIT_BELOW_GENERAL = 2
SPLIT_BELOW = {"resident": SPLIT_BELOW_RESIDENT,
               "streaming": SPLIT_BELOW_STREAMING,
               "general": SPLIT_BELOW_GENERAL}


def split_tiles(h: int, w: int, c: int, n: int = SPLIT_BM) -> int:
    """Output tiles of one sample in the split variant: bands of `n`
    positions of the h x (w + 1) grid x 64-channel groups."""
    return -(-h * (w + 1) // n) * -(-c // 64)


def split_planes(c: int) -> int:
    """16 B chunk planes of a split buffer: 8 a 64-channel group (zeros
    past C, so that every K step is 4 k16 products)."""
    return -(-c // 64) * 8


def _split_rows(used: int) -> int:
    """A split buffer's rows: `used`, one junk row, rounded to 1 mod 8."""
    return (used + 7) // 8 * 8 + 1


def split_window_rows(n: int, w: int) -> int:
    """Rows of a split window: every row a band of `n`'s 9 taps read
    (n + 2(w + 1) + 2), the junk row, rounded."""
    return _split_rows(n + 2 * (w + 1) + 2)


def split_band(k: int, h: int, w: int, c: int) -> int:
    """The band of a cluster of k: the shortest in SPLIT_BANDS whose tiles
    the ranks hold one each, else the longest."""
    return next((n for n in SPLIT_BANDS if split_tiles(h, w, c, n) <= k),
                SPLIT_BANDS[-1])


def _split_push_smem(n: int, w: int, c: int) -> int:
    return (SPLIT_BAR_BYTES + SPLIT_STAGES * SPLIT_STAGE_BYTES
            + 2 * split_planes(c) * split_window_rows(n, w) * 16)


_SPLIT_WS_SMEM = (SPLIT_BAR_BYTES + SPLIT_STAGES * SPLIT_STAGE_BYTES + 8 * (
    _split_rows(SPLIT_BANDS[-1] + 2) + _split_rows(SPLIT_BANDS[-1])) * 16)


def split_push(k: int, h: int, w: int, c: int) -> bool:
    """Whether a cluster of k keeps y in shared memory and pushes it to
    the peers: a tile a rank, and x's and y's windows fit; else y goes
    through the workspace in tiles of the longest band."""
    n = split_band(k, h, w, c)
    return (split_tiles(h, w, c, n) <= k
            and _split_push_smem(n, w, c) <= _SMEM_LIMIT)


def _split_smem(k: int, h: int, w: int, c: int) -> int:
    if split_push(k, h, w, c):
        return _split_push_smem(split_band(k, h, w, c), w, c)
    return _SPLIT_WS_SMEM


def split_push_rows(t: int, u: int, n: int, w: int, c: int) -> tuple:
    """The push map: the positions of tile t's band (its rank's y, in the
    8 planes of its group) that tile u's window reaches, (first, count);
    count 0 where none. Tile t holds band t // G (G = 64-channel groups),
    group t % G; u's window covers positions [u // G n - w - 2, u // G n +
    n + w + 2)."""
    ng = -(-c // 64)
    a, wa = t // ng * n, u // ng * n - w - 2
    lo, hi = max(a, wa), min(a + n, wa + n + 2 * (w + 2))
    return lo, max(hi - lo, 0)


def split_push_bytes(u: int, ntiles: int, n: int, w: int, c: int) -> int:
    """Bytes of y that tile u's window receives from the other tiles: the
    8 planes of each one's group at the rows the map gives."""
    return sum(split_push_rows(t, u, n, w, c)[1] * 8 * 16
               for t in range(ntiles) if t != u)


def cluster_size(b: int, h: int, w: int, c: int) -> int:
    """CTAs of the split variant's cluster (csrc/resblock.cu's
    cluster_size on a card of _SMS SMs): the power of two from 2 to
    SPLIT_CLUSTER_MAX that covers one sample's tiles of SPLIT_BM
    positions, halved while b clusters would hold more than half the SMs
    (down to 2: a cluster's CTAs share one GPC, so fewer than 8 clusters
    of 16 run at once). The library runs 8 where a cluster of 16 cannot
    be co-scheduled, and counts it (`cluster_narrowed`)."""
    k, t = 2, split_tiles(h, w, c)
    while k < SPLIT_CLUSTER_MAX and k < t:
        k *= 2
    while k > 2 and b * k > _SMS // 2:
        k //= 2
    return k


def split_in_smem(b: int, h: int, w: int, c: int) -> bool:
    """Whether split keeps y on chip at this batch, at its cluster and at
    the 8 a cluster of 16 narrows to (so the workspace is there whenever
    the workspace path runs)."""
    k = cluster_size(b, h, w, c)
    return split_push(k, h, w, c) and split_push(min(k, 8), h, w, c)


# csrc/resblock.cu's variant codes (alphafive_resblock_variant)
VARIANTS = {0: "streaming", 1: "resident", 2: "tiled", 4: "general",
            5: "split"}
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


# Shared-memory bytes of each kernel variant of csrc/resblock.cu, whose
# resblock_variant() makes the same choice: `fused_resblock` raises if the
# two disagree at a shape it launches. The bf16 kernels keep
# activations as C / 8 channel-chunk planes over an h x (w + 1) grid of
# output positions, plus the rows the taps shift into and a junk row:
# "resident" holds both convs' 18 taps (147,456 B at C = 64) beside two
# such buffers of 2 x (48 or 120) positions; "streaming" one buffer of
# 3 x 128 positions beside a ring of 3 taps and its 6 mbarriers of 8 B
# (a full and an empty one a stage). "tiled" (f32) double-buffers
# one 16 KB tap beside two halo-padded buffers of 272 B rows; "general"
# its ring and slabs, and y of one sample where that fits (else y goes to
# a device workspace, `_y_in_smem`): rows of C rounded up to 128 B plus
# 16 B, and 3 zero rows; "split" (at batch b's cluster) 7 mbarriers in
# 128 B and a ring of 3 tap rows of 64 x 64 weight slices beside x's and y's
# windows of every plane over the band's tap rows (`_split_push_smem`),
# or, where y goes through the workspace, one tap row's window of 8
# planes and the tile's staging rows (`_SPLIT_WS_SMEM`).
def _y_bytes(h: int, w: int, c: int, bf16: bool) -> int:
    pad = 8 if bf16 else 4                    # elements in 16 B
    stride = -(-c // (8 * pad)) * 8 * pad + pad
    return (h * w + 3) * stride * (2 if bf16 else 4)


def _y_in_smem(h: int, w: int, c: int, bf16: bool) -> bool:
    need = _general_stage(h, w, c, bf16) + _y_bytes(h, w, c, bf16)
    return need <= _SMEM_LIMIT


def _workspace_bytes(b: int, h: int, w: int, c: int, bf16: bool,
                     kind: str | None = None) -> int:
    """Bytes of device workspace a batch of this shape takes
    (csrc/resblock.cu's workspace_bytes on a card of _SMS SMs) in variant
    `kind` (default: the one `variant` picks for the batch): the streaming
    variant's packed taps; y where it does not fit on chip, of each sample
    (split) or of one sample per persistent CTA (general)."""
    kind = kind or variant(torch.bfloat16 if bf16 else torch.float32, h, w,
                           c, b)
    if b >= 1 and kind == "streaming":
        return _TAPS * c * c * 2
    if b >= 1 and kind == "split":
        return 0 if split_in_smem(b, h, w, c) else b * h * w * c * 2
    if b < 1 or kind != "general" or _y_in_smem(h, w, c, bf16):
        return 0
    return min(b, _SMS) * h * w * c * (2 if bf16 else 4)


def _smem_bytes(variant: str, h: int, w: int, c: int, bf16: bool,
                b: int = 1) -> int:
    def rows(positions):
        return (positions + 2 * (w + 1) + 9) // 8 * 8 + 1
    if variant == "resident":
        n = 48 if h * (w + 1) <= 96 else 120
        return 18 * c * c * 2 + 2 * (c // 8) * rows(2 * n) * 16
    if variant == "tiled":
        return (2 * c * c + 2 * (h + 2) * (w + 2) * (c + 4)) * 4
    if variant == "streaming":
        return 3 * c * c * 2 + (c // 8) * rows(384) * 16 + 2 * 3 * 8
    if variant == "general":
        return _general_stage(h, w, c, bf16) + (
            _y_bytes(h, w, c, bf16) if _y_in_smem(h, w, c, bf16) else 0)
    if variant == "split":   # at the batch's cluster
        return _split_smem(cluster_size(b, h, w, c), h, w, c)
    raise ValueError(f"no variant {variant!r}")


@functools.lru_cache(maxsize=None)   # a wrapper call asks it for its shape
def variant(dtype: torch.dtype, h: int, w: int, c: int,
            b: int | None = None) -> str:
    """The kernel variant that runs a [b, h, w, c] block of `dtype`:
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
                 _smem_bytes(v, h, w, c, bf16) <= _SMEM_LIMIT), "general")
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


# (dtype, b, h, w, c) -> (variant, workspace bytes) of shapes launched
# before: the library's choice is checked against `variant` once a shape
_launched: dict = {}


def _library_choice(lib, x, kind: str) -> tuple:
    b, h, w, c = x.shape
    key = (x.dtype, b, h, w, c)
    if key not in _launched:
        bf16 = int(x.dtype == torch.bfloat16)
        ran = VARIANTS.get(lib.alphafive_resblock_variant(bf16, b, h, w, c))
        if ran != kind:
            raise RuntimeError(f"{b}x{h}x{w}x{c} {x.dtype}: variant() picks "
                               f"{kind}, csrc/resblock.cu {ran or 'none'}")
        _launched[key] = (ran, lib.alphafive_resblock_workspace(
            bf16, b, h, w, c))
    return _launched[key]


def fused_resblock(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [B,H,W,C]; w1/w2 [9,C,C] packed (BN folded); b1/b2 f32 [C]."""
    if x.device.type == "cpu":
        return fused_resblock_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise RuntimeError(f"no resblock kernel for device {x.device}")
    kind = _check(x, w1, b1, w2, b2)
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    ran, n = _library_choice(lib, x, kind)
    with torch.cuda.device(x.device):
        # the streaming variant's packed taps, or y where it does not fit
        # in shared memory (split: each sample's; general: each CTA's)
        ws = torch.empty(n, dtype=torch.uint8, device=x.device) if n else None
        err = lib.alphafive_resblock(
            bf16, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), None if ws is None else
            ws.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: CUDA error {err}")
    trace.count("resblock_launches")
    trace.count("variant_launches." + ran)
    if ran == "streaming":   # the library packed the taps first
        trace.count("pack_launches")
    return out


def fused_resblock_as(kind: str, x, w1, b1, w2, b2) -> torch.Tensor:
    """The block on CUDA tensors by the kernel variant named `kind`, where
    that variant takes the shape (the library's ``alphafive_resblock_as``),
    else ValueError: to time one variant against another at one shape.
    Counts no launch; the main path calls `fused_resblock`."""
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_resblock_as launches kernels only: got "
                           f"{x.device}")
    _check(x, w1, b1, w2, b2)
    code = {v: k for k, v in VARIANTS.items()}[kind]
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        n = lib.alphafive_resblock_workspace_as(code, bf16, b, h, w, c)
        ws = torch.empty(n, dtype=torch.uint8, device=x.device) if n else None
        err = lib.alphafive_resblock_as(
            code, bf16, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), None if ws is None
            else ws.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    if err == 1:   # cudaErrorInvalidValue: only a shape the variant refuses
        raise ValueError(f"{kind} does not take {b}x{h}x{w}x{c} {x.dtype}")
    if err != 0:
        raise RuntimeError(f"resblock {kind} launch failed: CUDA error {err}")
    return out
