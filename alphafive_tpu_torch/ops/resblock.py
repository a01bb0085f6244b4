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

CHANNELS = (64, 96, 128)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)

resblock_launches = 0  # kernel launches since the last reset


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


def _check(x, w1, b1, w2, b2):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported dtype {x.dtype}")
    if c not in CHANNELS:
        raise ValueError(f"channels {c} not in {CHANNELS}")
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
    if x.dtype == torch.bfloat16:
        smem = (2 * h * w * (c + 8) + c * (c + 8)) * 2
    else:
        smem = h * w * c * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{h}x{w}x{c} {x.dtype} needs {smem} bytes of "
                         f"shared memory per block (> {_SMEM_LIMIT})")


def fused_resblock(x, w1, b1, w2, b2) -> torch.Tensor:
    """x [B,H,W,C]; w1/w2 [9,C,C] packed (BN folded); b1/b2 f32 [C]."""
    global resblock_launches
    if x.device.type == "cpu":
        return fused_resblock_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise RuntimeError(f"no resblock kernel for device {x.device}")
    _check(x, w1, b1, w2, b2)
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.alphafive_resblock(
        1 if x.dtype == torch.bfloat16 else 0, x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        b, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: CUDA error {err}")
    resblock_launches += 1
    return out
