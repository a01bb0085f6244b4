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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHANNELS = (64, 96, 128)  # the widths the fast variants are built for
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
# csrc/resblock.cu's general variant: its double-buffered f32 staging of
# one 64-pixel x 16-channel A tile (rows padded to 68) and one 16 x 64 B
# tile, beside y of one sample where that fits
_GENERAL_STAGE = 2 * (16 * 68 + 16 * 64) * 4

# csrc/resblock.cu's variant codes (alphafive_resblock_variant)
VARIANTS = {0: "streaming", 1: "resident", 2: "tiled", 3: "f32_plain",
            4: "general"}
resblock_launches = 0  # kernel launches since the last reset
# the same launches by the variant the library ran (see `variant`)
variant_launches = dict.fromkeys(VARIANTS.values(), 0)


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


# Shared-memory bytes of each kernel variant of csrc/resblock.cu, whose
# resblock_variant() makes the same choice: `fused_resblock` raises if the
# two disagree at a shape it launches. The bf16 kernels keep
# activations as C / 8 channel-chunk planes over an h x (w + 1) grid of
# output positions, plus the rows the taps shift into and a junk row:
# "resident" holds both convs' 18 taps (147,456 B at C = 64) beside two
# such buffers of 2 x (48 or 120) positions; "streaming" one buffer of
# 3 x 128 positions beside a ring of 3 taps. "tiled" (f32) double-buffers
# one 16 KB tap beside two halo-padded buffers of 272 B rows; "f32_plain"
# holds y of one sample; "general" its staging tiles, and y of one sample
# where that fits (else y goes to a device workspace, `_y_in_smem`).
def _y_bytes(h: int, w: int, c: int, bf16: bool) -> int:
    return (h * w * c * (2 if bf16 else 4) + 15) // 16 * 16


def _y_in_smem(h: int, w: int, c: int, bf16: bool) -> bool:
    return _GENERAL_STAGE + _y_bytes(h, w, c, bf16) <= _SMEM_LIMIT


def _smem_bytes(variant: str, h: int, w: int, c: int, bf16: bool) -> int:
    def rows(positions):
        return (positions + 2 * (w + 1) + 9) // 8 * 8 + 1
    if variant == "resident":
        n = 48 if h * (w + 1) <= 96 else 120
        return 18 * c * c * 2 + 2 * (c // 8) * rows(2 * n) * 16
    if variant == "tiled":
        return (2 * c * c + 2 * (h + 2) * (w + 2) * (c + 4)) * 4
    if variant == "streaming":
        return 3 * c * c * 2 + (c // 8) * rows(384) * 16
    if variant == "general":
        return _GENERAL_STAGE + (_y_bytes(h, w, c, bf16)
                                 if _y_in_smem(h, w, c, bf16) else 0)
    return h * w * c * 4


def variant(dtype: torch.dtype, h: int, w: int, c: int) -> str:
    """The kernel variant that runs an [*, h, w, c] block of `dtype`:
    "resident" (bf16, C = 64, h·(w + 1) up to 240, e.g. 15×15: weights
    resident, wgmma), "tiled" (f32, C = 64, up to 256 pixels: register-
    blocked SIMT), "streaming" (bf16, C in CHANNELS, up to h·(w + 1) =
    384, e.g. 19×19: taps streamed, wgmma), "f32_plain" (f32, C in
    CHANNELS, y of one sample in shared memory: plain FMA), or "general"
    (every other shape: any other C, e.g. 16 or 256; bf16 boards from
    20×20 up; f32 samples whose y exceeds shared memory, e.g. 19×19×192:
    SIMT implicit GEMM, no width or board limit)."""
    if min(h, w, c) < 1:
        raise ValueError(f"{h}x{w}x{c}: every dimension must be at least 1")
    bf16 = dtype == torch.bfloat16
    cells, fast = h * (w + 1), c in CHANNELS
    if bf16:
        kinds = [("resident", c == 64 and cells <= 240),
                 ("streaming", fast and cells <= 384)]
    else:
        kinds = [("tiled", c == 64 and h * w <= 256), ("f32_plain", fast)]
    for v, shape_ok in kinds:
        if shape_ok and _smem_bytes(v, h, w, c, bf16) <= _SMEM_LIMIT:
            return v
    return "general"


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
    return variant(x.dtype, h, w, c)


def fused_resblock(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [B,H,W,C]; w1/w2 [9,C,C] packed (BN folded); b1/b2 f32 [C]."""
    global resblock_launches
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
    ran = VARIANTS.get(lib.alphafive_resblock_variant(bf16, h, w, c))
    if ran != kind:
        raise RuntimeError(f"{h}x{w}x{c} {x.dtype}: variant() picks {kind}, "
                           f"csrc/resblock.cu {ran or 'none'}")
    with torch.cuda.device(x.device):
        n = lib.alphafive_resblock_workspace(bf16, b, h, w, c)
        # y of each persistent CTA where it does not fit in shared memory
        ws = torch.empty(n, dtype=torch.uint8, device=x.device) if n else None
        err = lib.alphafive_resblock(
            bf16, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), None if ws is None else
            ws.data_ptr(), b, h, w, c,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: CUDA error {err}")
    resblock_launches += 1
    variant_launches[ran] += 1
    return out
