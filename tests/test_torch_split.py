"""The resblock's split variant (one sample over a thread-block cluster):
its dispatch, shared memory and workspace against csrc/resblock.cu, and
the plain twin and the fused net at the batches it takes against JAX.

On the CPU ``fused_resblock`` runs ``fused_resblock_reference`` whatever
the batch; the JAX side runs the Pallas kernel in interpret mode. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (its ``kernel_vs_plain`` rows, split launched through
``alphafive_resblock_as``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_resblock as prb
from alphafive_tpu_torch.ops import resblock as rb
from test_torch_net import assert_close, run_both
from test_torch_resblock import make_inputs

torch.set_num_threads(1)

SOURCE = os.path.join(os.path.dirname(rb.__file__), os.pardir, "csrc",
                      "resblock.cu")
BF16 = torch.bfloat16
# (board, channels, the variant at a batch that names none): the evals'
# and cli play's 15x15 x 64, the 19x19_10b bundle's 19x19 x 128, a
# 256-channel net's 15x15 and the widest general edge
SHAPES = [(15, 64, "resident"), (19, 128, "streaming"),
          (15, 256, "general"), (240, 72, "general")]
BATCHES = [1, 2, 3, 4, 8, 16, 17, 32, 64, 133, 256, 512, 2048]


def source_constants() -> dict:
    src = open(SOURCE).read()
    names = ("kSplitBelowResident", "kSplitBelowStreaming",
             "kSplitBelowGeneral", "BM", "kClusterMax")
    split = src[src.index("namespace split {"):]
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", split).group(1))
            for k in names}


def source_cluster_size(b, h, w, c, sms=rb._SMS) -> int:
    """csrc/resblock.cu's cluster_size, its loops parsed from the source
    and run with the source's constants."""
    src = open(SOURCE).read()
    body = src[src.index("int cluster_size(int b, int h, int w, int c)"):]
    body = body[:body.index("\n}\n")]
    assert "while (k < split::kClusterMax && k < t) k *= 2;" in body
    assert "while (k > 2 && (long long)b * k > sm_count() / 2) k /= 2;" in body
    k_max, bm = source_constants()["kClusterMax"], source_constants()["BM"]
    t = -(-h * w // bm) * -(-c // 64)
    k = 2
    while k < k_max and k < t:
        k *= 2
    while k > 2 and b * k > sms // 2:
        k //= 2
    return k


def test_split_constants_match_source():
    """The crossovers, the tile and the cluster bound are the source's."""
    got = source_constants()
    assert got == {"kSplitBelowResident": rb.SPLIT_BELOW_RESIDENT,
                   "kSplitBelowStreaming": rb.SPLIT_BELOW_STREAMING,
                   "kSplitBelowGeneral": rb.SPLIT_BELOW_GENERAL,
                   "BM": rb.SPLIT_BM, "kClusterMax": rb.SPLIT_CLUSTER_MAX}
    assert rb.SPLIT_BELOW == {"resident": rb.SPLIT_BELOW_RESIDENT,
                              "streaming": rb.SPLIT_BELOW_STREAMING,
                              "general": rb.SPLIT_BELOW_GENERAL}


@pytest.mark.parametrize("size,c,base", SHAPES)
def test_variant_by_batch(size, c, base):
    """Below its crossover a bf16 batch runs split, at and above it the
    variant its shape takes otherwise; a batch that names none keeps that
    variant; f32 never splits."""
    assert rb.variant(BF16, size, size, c) == base
    for b in BATCHES:
        want = "split" if b < rb.SPLIT_BELOW[base] else base
        assert rb.variant(BF16, size, size, c, b) == want, b
        t = torch.zeros(b, size, size, c, dtype=BF16) if size * size * b * c \
            <= 2_000_000 else None
        if t is not None:
            w = torch.zeros(9, c, c, dtype=BF16)
            bias = torch.zeros(c)
            assert rb._check(t, w, bias, w, bias) == want
    assert rb.variant(torch.float32, size, size, c, 1) != "split"


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 64, 133, 2048])
@pytest.mark.parametrize("size,c,_", SHAPES + [(6, 8, "general"),
                                               (33, 64, "general"),
                                               (9, 64, "resident")])
def test_cluster_size_matches_source(b, size, c, _):
    """cluster_size: a power of two from 2 to 16 that covers one sample's
    tiles, halved while the batch's clusters exceed half the 132 SMs."""
    k = rb.cluster_size(b, size, size, c)
    assert k == source_cluster_size(b, size, size, c)
    assert k in (2, 4, 8, 16)
    assert k == 2 or b * k <= rb._SMS // 2
    assert (k >= min(rb.split_tiles(size, size, c), 16)
            or b * 2 * k > rb._SMS // 2)


def test_cluster_sizes_at_the_rows():
    """The clusters chip_smoke.py's split rows launch: 4 CTAs a 15x15 x 64
    sample (4 tiles), 16 a 19x19 x 128 one (12 tiles) but 8 at 8 samples
    and 4 at 16 (64 CTAs), 16 at 15x15 x 256 (16 tiles) and 240x240 x 72,
    2 at 64 x 6x6 x 8 (one tile)."""
    assert [rb.cluster_size(b, 15, 15, 64) for b in (1, 16)] == [4, 4]
    assert [rb.cluster_size(b, 19, 19, 128) for b in (1, 4, 8, 16)] == [
        16, 16, 8, 4]
    assert rb.split_tiles(19, 19, 128) == 12
    assert rb.cluster_size(1, 15, 15, 256) == 16
    assert rb.split_tiles(15, 15, 256) == 16
    assert rb.cluster_size(1, 240, 240, 72) == 16
    assert rb.cluster_size(64, 6, 6, 8) == 2
    # one tile: nothing to split, whatever the batch
    assert rb.variant(BF16, 6, 6, 8, 1) == "general"


@pytest.mark.parametrize("size,c,on_chip,smem", [
    (15, 64, True, 74_736), (19, 128, True, 157_472),
    (15, 256, True, 176_544), (240, 72, False, 185_760), (6, 8, True, 38_880)])
def test_split_budget_and_workspace(size, c, on_chip, smem):
    """Shared memory: general's ring, slabs of 64-pixel tiles and, where it
    fits, y of the whole sample (each rank's copy, which conv 2 reads
    after the gather); the workspace holds y of every sample where it does
    not (240x240 x 72: 8.3 MB a sample)."""
    assert rb._smem_bytes("split", size, size, c, True) == smem
    assert smem <= rb._SMEM_LIMIT
    assert rb._y_in_smem(size, size, c, True, rb.SPLIT_BM) == on_chip
    stage = rb._general_stage(size, size, c, True, rb.SPLIT_BM)
    assert smem == stage + (rb._y_bytes(size, size, c, True) if on_chip
                            else 0)
    for b in (1, 16):
        want = 0 if on_chip else b * size * size * c * 2
        assert rb._workspace_bytes(b, size, size, c, True, "split") == want
    src = open(SOURCE).read()
    body = src[src.index("long long workspace_bytes("):]
    assert ("return split::y_in_smem(h, w, c) ? 0 : (long long)b * h * w * c"
            " * 2;") in body
    # the dispatch's own workspace at batch 1: split's
    assert rb._workspace_bytes(1, size, size, c, True) == (
        rb._workspace_bytes(1, size, size, c, True, "split")
        if rb.variant(BF16, size, size, c, 1) == "split" else
        rb._workspace_bytes(1, size, size, c, True, "general"))


def test_split_budget_matches_source_tiles():
    """The split kernel's tile of 64 pixels is 8 warps of one m16 fragment
    along the pixels by 2 of 32 channels: the general slabs of
    min(64 + 2w + 2, h*w) + 3 rows of 72 bf16 beside a 3-stage ring of 64
    x 72."""
    src = open(SOURCE).read()
    assert "template <typename T, int kTileM = bm(sizeof(T))>" in src
    assert "const auto kernel = split::kernel<split::BM>;" in src
    ring = 3 * 64 * 72 * 2
    rows = min(64 + 2 * 19 + 2, 19 * 19) + 3
    assert rb._general_stage(19, 19, 128, True, 64) == ring + 2 * rows * 72 * 2


@pytest.mark.parametrize("size,c", [(15, 64), (19, 128), (15, 256)])
def test_reference_matches_pallas_bf16_batch1(size, c):
    """One sample, bf16, at the shapes split takes: the plain twin against
    JAX's Pallas kernel in interpret mode, rounded at the same points; the
    f32 sums differ in order (test_reference_matches_pallas_bf16's
    tolerance: atol 3e-2, rtol 1.6e-2)."""
    x, w1, b1, w2, b2 = make_inputs(size + c, size, c, batch=1)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = prb.fused_resblock(bf(x), bf(w1), jnp.asarray(b1), bf(w2),
                              jnp.asarray(b2), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = rb.fused_resblock(tb(x), tb(w1), torch.from_numpy(b1), tb(w2),
                            torch.from_numpy(b2))
    assert rb.variant(BF16, size, size, c, 1) == "split"
    assert got.dtype == torch.bfloat16 and rb.resblock_launches == 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=1.6e-2)


def test_fused_net_matches_jax_19x19_128_batch1():
    """The 19x19_10b bundle's widths (19x19, 128 channels, value head 64)
    at 2 of its 10 blocks, one sample, bf16: the port's fused forward
    against apply_eval_fused (Pallas kernel in interpret mode), at
    test_forwards_match_jax_bf16's tolerance."""
    ref, ref_fused, _, got_fused = run_both(
        19, "bfloat16", seed=19, batch=1, blocks=2, channels=128,
        value_hidden=64)
    assert_close(got_fused, ref_fused, 5e-2, 5e-2)


def test_fused_resblock_as_refuses_cpu():
    """Naming a variant launches a kernel or raises: never the plain twin."""
    x = torch.zeros(1, 15, 15, 64, dtype=BF16)
    w = torch.zeros(9, 64, 64, dtype=BF16)
    b = torch.zeros(64)
    with pytest.raises(RuntimeError, match="launches kernels only"):
        rb.fused_resblock_as("split", x, w, b, w, b)
