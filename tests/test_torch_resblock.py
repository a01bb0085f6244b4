"""Fused residual block: the port's plain version against the Pallas kernel.

On the CPU ``fused_resblock`` runs ``fused_resblock_reference``; the JAX
side runs the Pallas kernel in interpret mode and the 9-tap helper
``_conv3x3_flat`` with ``fold_batchnorm``. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_resblock as prb
from alphafive_tpu_torch.ops import resblock as rb

torch.set_num_threads(1)


def make_inputs(seed, size, c, batch=3):
    rng = np.random.default_rng(seed)
    scale = 1.0 / (3.0 * c ** 0.5)
    x = np.maximum(rng.standard_normal((batch, size, size, c)), 0)
    return [a.astype(np.float32) for a in (
        x, rng.standard_normal((9, c, c)) * scale,
        rng.standard_normal(c) * 0.1, rng.standard_normal((9, c, c)) * scale,
        rng.standard_normal(c) * 0.1)]


@pytest.mark.parametrize("size,c", [(5, 16), (7, 32)])
def test_reference_matches_pallas_f32(size, c):
    args = make_inputs(size, size, c)
    want = np.asarray(prb.fused_resblock(*map(jnp.asarray, args),
                                         interpret=True))
    got = rb.fused_resblock(*map(torch.from_numpy, args))
    assert rb.resblock_launches == 0  # CPU tensors never launch the kernel
    # tests/test_pallas.py's tolerance for the same kernel
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("size,c", [(5, 16), (7, 32)])
def test_reference_matches_fold_and_flat_conv(size, c):
    """Unfolded conv + BN, folded by both packages, then the 9-tap conv."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, size, size, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
    bn = [rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
          rng.standard_normal(c) * 0.1, rng.uniform(0.5, 1.5, c)]
    bn = [b.astype(np.float32) for b in bn]
    wj, bj = prb.fold_batchnorm(jnp.asarray(k), *map(jnp.asarray, bn))
    wt, bt = rb.fold_batchnorm(torch.from_numpy(k), *map(torch.from_numpy, bn))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-7)
    want = np.asarray(prb._conv3x3_flat(
        jnp.asarray(x).reshape(-1, c), prb.pack_conv_kernel(wj), size,
        size)).reshape(x.shape) + np.asarray(bj)
    got = rb.conv3x3_packed(torch.from_numpy(x), rb.pack_conv_kernel(wt)) + bt
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_reference_matches_pallas_bf16():
    """bf16 activations and weights, f32 biases, as on the self-play path.
    Both sides round y and the output to bf16 at the same points; the f32
    sums differ in order, and one ulp of a rounded y (2^-8 relative) moves
    the output by at most about that much again: atol 3e-2 at unit-scale
    activations, rtol 1.6e-2 (two bf16 ulps)."""
    x, w1, b1, w2, b2 = make_inputs(11, 7, 32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = prb.fused_resblock(bf(x), bf(w1), jnp.asarray(b1), bf(w2),
                              jnp.asarray(b2), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = rb.fused_resblock(tb(x), tb(w1), torch.from_numpy(b1), tb(w2),
                            torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=1.6e-2)


def test_kernel_wrapper_rejects_unsupported():
    """The wrapper raises on other devices and on operands of the wrong
    type; every C and board goes to a variant (those that no fast variant
    takes to the general one), as JAX's fused_resblock takes them."""
    x = torch.zeros(1, 5, 5, 16, device="meta")
    w = torch.zeros(9, 16, 16, device="meta")
    b = torch.zeros(16, device="meta")
    with pytest.raises(RuntimeError):
        rb.fused_resblock(x, w, b, w, b)
    t = torch.zeros(2, 15, 15, 64, dtype=torch.bfloat16)
    w = torch.zeros(9, 64, 64, dtype=torch.bfloat16)
    b = torch.zeros(64)
    rb._check(t, w, b, w, b)                    # the main-path shape passes
    w48, b48 = w[:, :48, :48].contiguous(), b[:48].contiguous()
    assert rb._check(t[..., :48].contiguous(), w48, b48, w48,
                     b48) == "general"                           # C = 48
    with pytest.raises(ValueError):
        rb._check(t[..., :48].contiguous(), w, b, w, b)     # w of another C
    with pytest.raises(ValueError):
        rb._check(t, w, b.to(torch.bfloat16), w, b)          # bias dtype
    with pytest.raises(TypeError):
        rb._check(t.half(), w.half(), b, w.half(), b)        # fp16
    big = torch.zeros(1, 25, 25, 128, dtype=torch.bfloat16)
    wb = torch.zeros(9, 128, 128, dtype=torch.bfloat16)
    assert rb._check(big, wb, torch.zeros(128), wb,
                     torch.zeros(128)) == "general"    # beyond streaming


@pytest.mark.parametrize("dtype,size,c,want", [
    (torch.bfloat16, 15, 64, "resident"),   # self-play's pass and root forwards
    (torch.bfloat16, 9, 64, "resident"),
    (torch.bfloat16, 19, 96, "streaming"),
    (torch.bfloat16, 19, 128, "streaming"),
    (torch.bfloat16, 19, 64, "streaming"),  # 19 x 20 positions > 240
    (torch.float32, 15, 64, "tiled"),
    (torch.float32, 9, 64, "tiled"),
    (torch.float32, 19, 64, "f32_plain"),   # 361 pixels > 256
    (torch.float32, 19, 96, "f32_plain"),
    (torch.float32, 19, 128, "f32_plain"),
])
def test_variant_chooser(dtype, size, c, want):
    """The kernel variant per shape, as csrc/resblock.cu's
    resblock_variant() picks it, within one block's shared memory."""
    assert rb.variant(dtype, size, size, c) == want
    need = rb._smem_bytes(want, size, size, c, dtype == torch.bfloat16)
    assert need <= rb._SMEM_LIMIT
    t = torch.zeros(2, size, size, c, dtype=dtype)
    w = torch.zeros(9, c, c, dtype=dtype)
    b = torch.zeros(c)
    assert rb._check(t, w, b, w, b) == want


def test_variant_budgets():
    """Shared-memory bytes of the main-path variants: 18 resident bf16
    taps (147,456 B) beside two 281-row buffers of 8 channel planes."""
    assert rb._smem_bytes("resident", 15, 15, 64, True) == 147_456 + 2 * 281 * 128
    assert rb._smem_bytes("tiled", 15, 15, 64, False) == (
        2 * 64 * 64 + 2 * 17 * 17 * 68) * 4
    # 19x19x128 bf16 streams a ring of 3 taps beside one buffer of 16
    # channel planes of 433 rows (384 positions + 42 shifted + junk)
    assert rb._smem_bytes("streaming", 19, 19, 128, True) == (
        3 * 128 * 128 * 2 + 16 * 433 * 16)
    assert rb._smem_bytes("f32_plain", 19, 19, 128, False) == 19 * 19 * 128 * 4
    # past 384 positions (streaming) or 232,448 B (f32_plain) the fast
    # variants give way to the general one
    assert 25 * 26 > 384
    assert rb.variant(torch.bfloat16, 25, 25, 128) == "general"
    assert rb._smem_bytes("f32_plain", 25, 25, 128, False) == 320_000
    assert rb.variant(torch.float32, 25, 25, 128) == "general"
    with pytest.raises(ValueError, match="at least 1"):
        rb.variant(torch.float32, 5, 5, 0)


def test_variant_codes_match_source():
    """VARIANTS names the codes of csrc/resblock.cu's enum Variant, which
    alphafive_resblock_variant returns and the wrapper counts launches by."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(rb.__file__), os.pardir, "csrc",
                            "resblock.cu")).read()
    enum = re.search(r"enum Variant \{(.*?)\};", src, re.S).group(1)
    codes = {int(v): k for k, v in re.findall(r"k(\w+) = (-?\d+)", enum)}
    names = {-1: "Refused", 0: "Streaming", 1: "Resident", 2: "Tiled",
             3: "F32Plain", 4: "General"}
    assert codes == names
    assert rb.VARIANTS == {0: "streaming", 1: "resident", 2: "tiled",
                           3: "f32_plain", 4: "general"}
    assert set(rb.variant_launches) == set(rb.VARIANTS.values())


def test_check_rejects_misaligned():
    """The kernels move 16 B at a time: an operand that does not start on
    a 16-byte boundary is refused before any launch."""
    c = 64
    flat = torch.zeros(1 + 2 * 15 * 15 * c, dtype=torch.bfloat16)
    x = flat[1:].view(2, 15, 15, c)                  # contiguous, 2 B off
    w = torch.zeros(9, c, c, dtype=torch.bfloat16)
    b = torch.zeros(c)
    with pytest.raises(ValueError, match="16-byte"):
        rb._check(x, w, b, w, b)
