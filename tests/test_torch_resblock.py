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
    # at a batch of 2: a batch of 1 at this shape runs the split variant
    big = torch.zeros(2, 25, 25, 128, dtype=torch.bfloat16)
    wb = torch.zeros(9, 128, 128, dtype=torch.bfloat16)
    assert rb._check(big, wb, torch.zeros(128), wb,
                     torch.zeros(128)) == "general"    # beyond streaming


@pytest.mark.parametrize("dtype,size,c,batch,want", [
    # self-play's pass and root forwards
    (torch.bfloat16, 15, 64, 2048, "resident"),
    (torch.bfloat16, 9, 64, 2048, "resident"),
    (torch.bfloat16, 19, 96, 2048, "streaming"),
    (torch.bfloat16, 19, 128, 2048, "streaming"),
    (torch.bfloat16, 19, 64, 2048, "streaming"),  # 19 x 20 positions > 240
    (torch.float32, 15, 64, 2048, "tiled"),
    (torch.float32, 9, 64, 2048, "tiled"),
    (torch.float32, 19, 64, 2048, "general"),   # 361 pixels > 256
    (torch.float32, 19, 96, 2048, "general"),
    (torch.float32, 19, 128, 2048, "general"),
    # the evals' and cli play's small batches: one sample over a cluster
    (torch.bfloat16, 15, 64, 1, "split"),
    (torch.bfloat16, 15, 64, 2, "split"),
    (torch.bfloat16, 15, 64, 8, "split"),
    (torch.bfloat16, 15, 64, 16, "split"),
    (torch.bfloat16, 19, 128, 1, "split"),
    (torch.bfloat16, 19, 128, 4, "split"),
    (torch.bfloat16, 19, 128, 8, "streaming"),  # split measured slower
    (torch.bfloat16, 19, 128, 16, "streaming"),
    (torch.bfloat16, 15, 256, 1, "split"),
    (torch.bfloat16, 15, 256, 2, "general"),
    (torch.float32, 15, 64, 1, "tiled"),        # f32 never splits
])
def test_variant_chooser(dtype, size, c, batch, want):
    """The kernel variant per shape and batch, as csrc/resblock.cu's
    resblock_variant() picks it, within one block's shared memory."""
    assert rb.variant(dtype, size, size, c, batch) == want
    need = rb._smem_bytes(want, size, size, c, dtype == torch.bfloat16)
    assert need <= rb._SMEM_LIMIT
    t = torch.zeros(batch, size, size, c, dtype=dtype)
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
    # channel planes of 433 rows (384 positions + 42 shifted + junk) and
    # the ring's full and empty mbarriers, 8 B each a stage
    assert rb._smem_bytes("streaming", 19, 19, 128, True) == (
        3 * 128 * 128 * 2 + 16 * 433 * 16 + 2 * 3 * 8) == 209_200
    # f32 19x19 x 128: the general variant's ring and slabs (y, 192,192 B,
    # goes to the workspace)
    assert rb._smem_bytes("general", 19, 19, 128, False) == 66_656
    # past 384 positions (streaming) or 256 pixels (tiled) the fast
    # variants give way to the general one
    assert 25 * 26 > 384
    assert rb.variant(torch.bfloat16, 25, 25, 128) == "general"
    assert rb._smem_bytes("general", 25, 25, 128, False) == 70_112
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
             4: "General", 5: "Split"}
    assert codes == names
    assert rb.VARIANTS == {0: "streaming", 1: "resident", 2: "tiled",
                           4: "general", 5: "split"}
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


def streaming_source() -> tuple:
    """csrc/resblock.cu, and its streaming namespace."""
    import os
    src = open(os.path.join(os.path.dirname(rb.__file__), os.pardir, "csrc",
                            "resblock.cu")).read()
    a = src.index("namespace streaming {")
    return src, src[a:src.index("}  // namespace streaming", a)]


@pytest.mark.parametrize("c", [64, 96, 128])
def test_pack_streaming_taps_matches_kernel_map(c):
    """The plain twin of the streaming variant's tap pack against a numpy
    emulation of the kernel (one 16 B piece a thread, its tap, chunk and
    row from the piece index as pack_taps computes them): every (t, cin,
    cout) reads back W[t, cin, cout] at byte t·C²·2 + (cout / 8)·C·16 +
    cin·16 + (cout % 8)·2, and each tap is one contiguous run of C²·2
    bytes, the bulk copy the kernel makes of it."""
    rng = np.random.default_rng(c)
    w = rng.standard_normal((18, c, c)).astype(np.float32)
    w1, w2 = (torch.from_numpy(w[k * 9:(k + 1) * 9]).bfloat16()
              for k in (0, 1))
    got = rb.pack_streaming_taps(w1, w2)        # CPU: the plain twin
    assert got.shape == (18, c // 8, c, 8) and got.is_contiguous()
    flat = got.view(torch.int16).numpy().reshape(-1)
    src = torch.cat([w1, w2]).view(torch.int16).numpy().reshape(-1, 8)
    per_tap = c * c // 8
    i = np.arange(18 * per_tap)
    t = i // per_tap
    j, cin = (i - t * per_tap) // c, (i - t * per_tap) % c
    np.testing.assert_array_equal(
        flat.reshape(-1, 8), src[t * per_tap + cin * (c // 8) + j])
    tt, ci, co = np.meshgrid(np.arange(18), np.arange(c), np.arange(c),
                             indexing="ij")
    byte = tt * c * c * 2 + co // 8 * c * 16 + ci * 16 + co % 8 * 2
    np.testing.assert_array_equal(
        flat[byte // 2], torch.cat([w1, w2]).view(torch.int16).numpy())
    for k in range(18):      # tap k: bytes [k·C²·2, (k + 1)·C²·2)
        assert got[k].data_ptr() - got.data_ptr() == k * c * c * 2
        assert torch.equal(got[k].view(torch.int16).reshape(-1),
                           got.view(torch.int16).reshape(-1)[
                               k * c * c:(k + 1) * c * c])
        assert set(np.unique(byte[k] // (c * c * 2))) == {k}


@pytest.mark.parametrize("b,size,c", [(4096, 19, 128), (512, 19, 128),
                                      (2048, 19, 96), (256, 19, 64),
                                      (1, 19, 128)])
def test_streaming_workspace_matches_source(b, size, c):
    """The streaming variant's workspace holds both convs' packed taps,
    18·C²·2 bytes whatever the batch: alphafive_resblock_workspace's
    formula and its tap count parsed from csrc/resblock.cu, against the
    wrapper's mirror."""
    import re
    src, body = streaming_source()
    taps = int(re.search(r"constexpr int kTaps = (\d+);", body).group(1))
    assert taps == 18
    fn = src[src.index("long long workspace_bytes("):]
    formula = re.search(r"if \(variant == kStreaming\) return \(long long\)"
                        r"streaming::kTaps((?: \* \w+)+);", fn).group(1)
    want = eval("kTaps" + formula, {}, dict(kTaps=taps, c=c))
    assert want == 18 * c * c * 2
    assert rb.variant(torch.bfloat16, size, size, c) == "streaming"
    # named: a batch of 1 at 19x19 x 128 dispatches to the split variant
    assert rb._workspace_bytes(b, size, size, c, True, "streaming") == want
    assert rb._workspace_bytes(0, size, size, c, True, "streaming") == 0


def test_streaming_smem_matches_source():
    """The mirror's streaming shared memory is the source's smem_bytes: the
    ring of kStages taps, the buffer, and a full and an empty mbarrier a
    stage; it fits at every width the variant takes on a 19x19 board."""
    import re
    _, body = streaming_source()
    stages = int(re.search(r"constexpr int kStages = (\d+);",
                           body).group(1))
    assert re.search(r"return kStages \* c \* c \* 2 \+ c / 8 \* "
                     r"buffer_rows\(w\) \* 16 \+ 2 \* kStages \* 8;", body)
    for c in rb.CHANNELS:
        want = stages * c * c * 2 + c // 8 * 433 * 16 + 2 * stages * 8
        assert rb._smem_bytes("streaming", 19, 19, c, True) == want
        assert want <= rb._SMEM_LIMIT


def test_pack_wrapper_refuses_and_counts_no_cpu_launch():
    """On CPU tensors neither the block nor the pack counts a launch; on
    other devices the pack raises, as the block does."""
    rb.pack_launches = 0
    x = torch.zeros(2, 19, 19, 64, dtype=torch.bfloat16)
    w = torch.zeros(9, 64, 64, dtype=torch.bfloat16)
    b = torch.zeros(64)
    assert rb.variant(x.dtype, 19, 19, 64) == "streaming"
    rb.fused_resblock(x, w, b, w, b)
    rb.pack_streaming_taps(w, w)
    assert rb.pack_launches == 0
    m = torch.zeros(9, 64, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError):
        rb.pack_streaming_taps(m, m)
