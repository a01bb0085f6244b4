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
    x = torch.zeros(1, 5, 5, 16, device="meta")
    w = torch.zeros(9, 16, 16, device="meta")
    b = torch.zeros(16, device="meta")
    with pytest.raises(RuntimeError):
        rb.fused_resblock(x, w, b, w, b)
    t = torch.zeros(2, 15, 15, 64, dtype=torch.bfloat16)
    w = torch.zeros(9, 64, 64, dtype=torch.bfloat16)
    b = torch.zeros(64)
    rb._check(t, w, b, w, b)                    # the main-path shape passes
    with pytest.raises(ValueError):
        rb._check(t[..., :48].contiguous(), w, b, w, b)     # C = 48
    with pytest.raises(ValueError):
        rb._check(t, w, b.to(torch.bfloat16), w, b)          # bias dtype
    with pytest.raises(ValueError):
        big = torch.zeros(1, 25, 25, 128, dtype=torch.bfloat16)
        wb = torch.zeros(9, 128, 128, dtype=torch.bfloat16)
        rb._check(big, wb, torch.zeros(128), wb, torch.zeros(128))  # smem
