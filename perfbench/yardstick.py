"""Operations, bytes and the card's peaks: what the rooflines and the
step's share of the peak divide by.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its full
700 W): 989 TFLOP/s in bf16, 67 TFLOP/s in f32 outside the tensor
cores, 3.35 TB/s of HBM. The card's power limit is printed beside every
reading (``nvidia-smi``), since a card set below 700 W runs slower.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def net_flops(board: int, blocks: int, channels: int,
              value_hidden: int) -> float:
    """Multiply-adds × 2 of one position's forward: the 3×3 stem and the
    blocks' convs, the 1×1 head convs and the three dense layers."""
    s2, c = board * board, channels
    a = s2
    convs = 2 * s2 * 9 * (4 * c + 2 * blocks * c * c)
    heads = 2 * s2 * c * 3 + 2 * (2 * a * a + a * value_hidden
                                  + value_hidden)
    return float(convs + heads)


def resblock_work(batch: int, board: int, channels: int,
                  dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one residual block on `batch` positions: two
    3×3 convs; x read once, y written once, both convs' weights (taps in
    the compute type) and biases (f32) read once."""
    s2, c = board * board, channels
    flops = 2 * 2 * batch * s2 * 9 * c * c
    eb = DTYPE_BYTES[dtype]
    nbytes = 2 * batch * s2 * c * eb + 2 * (9 * c * c * eb + 4 * c)
    return float(flops), float(nbytes)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the type's peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
