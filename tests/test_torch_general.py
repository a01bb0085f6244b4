"""Every shape the Pallas kernels take: the resblock's general variant and
the select kernel's chunk-streaming path, against the JAX package.

JAX's ``fused_resblock`` tiles only the batch, so it takes any C and any
board; JAX's ``select_batch`` takes any ``A_pad``. On CUDA the port runs
those shapes through the resblock kernel's ``general`` variant, and
the select kernel's streaming path (``A_pad`` > 1024). Here: the variant
chooser picks ``general`` exactly where the three fast variants do not fit;
the plain twin and the fused net match JAX's Pallas kernel (interpret
mode) at such shapes; and a numpy emulation of the streaming select
kernel's warp matches JAX's ``select_batch`` (interpret) bit for bit at
A_pad 1152 and 2048. The CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_resblock as prb
from alphafive_tpu.ops import pallas_select as jps
from alphafive_tpu_torch.ops import resblock as rb
from alphafive_tpu_torch.ops import select as ps
from test_torch_net import assert_close, run_both
from test_torch_resblock import make_inputs
from test_torch_select import LANES, better, butterfly, lanes, make_tree

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(rb.__file__), os.pardir, "csrc")

# chip_smoke.py's kernel_vs_plain rows of the general variant: (batch,
# board, channels, dtype)
GENERAL_SHAPES = [(4, 5, 16, torch.float32), (4, 7, 32, torch.float32),
                  (256, 5, 16, torch.bfloat16), (2048, 15, 48, torch.bfloat16),
                  (64, 9, 20, torch.bfloat16), (2048, 15, 256, torch.bfloat16),
                  (2048, 21, 64, torch.bfloat16),
                  (256, 33, 64, torch.bfloat16),
                  (256, 19, 192, torch.float32),
                  (1, 15, 256, torch.bfloat16), (133, 9, 40, torch.bfloat16),
                  (64, 6, 8, torch.bfloat16), (1, 240, 72, torch.bfloat16)]


@pytest.mark.parametrize("b,size,c,dtype", GENERAL_SHAPES)
def test_variant_picks_general(b, size, c, dtype):
    """No fast variant takes these shapes; `variant` and `_check` pick the
    general one, whose shared memory stays within one block's."""
    assert rb.variant(dtype, size, size, c) == "general"
    bf16 = dtype == torch.bfloat16
    assert rb._smem_bytes("general", size, size, c, bf16) <= rb._SMEM_LIMIT
    t = torch.zeros(2, size, size, c, dtype=dtype)
    w = torch.zeros(9, c, c, dtype=dtype)
    bias = torch.zeros(c)
    assert rb._check(t, w, bias, w, bias) == "general"


def general_budget(h, w, c, bf16):
    """csrc/resblock.cu's general variant's shared memory, from the tile
    constants in its source: (ring and slabs, y's bytes, y on chip)."""
    src = open(os.path.join(CSRC, "resblock.cu")).read()
    body = src[src.index("namespace general {"):]
    pick = {k: tuple(map(int, re.search(
        rf"constexpr int {k}\(int elem\) {{\s*return elem == 2 \? (\d+) : "
        rf"(\d+);", body).groups())) for k in ("bk", "stages", "warp_m")}
    warp_n = int(re.search(r"constexpr int kWarpN = (\d+);", body).group(1))
    warps_n = int(re.search(r"constexpr int kWarpsN = (\d+);", body).group(1))
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    i = 0 if bf16 else 1
    elem = 2 if bf16 else 4
    pad = 16 // elem
    bk, stages, bm = pick["bk"][i], pick["stages"][i], pick["warp_m"][i]
    bm *= threads // 32 // warps_n
    bn = warp_n * warps_n
    ring = stages * bk * (bn + pad) * elem
    # span 3 (one slab where a tile reads one and the residual tile fits
    # in it), else span 1
    assert re.search(r"return span == 3 && c <= bk\(elem\) && "
                     r"BN <= bk\(elem\) \? 1 : 2;", body)
    zero = int(re.search(r"constexpr int kZeroRows = (\d+);", body).group(1))
    for reach, slabs in ((2 * w + 2, 1 if c <= bk and bn <= bk else 2),
                         (2, 2)):
        rows = min(bm + reach, h * w) + zero
        stage = ring + slabs * rows * (bk + pad) * elem
        if stage <= rb._SMEM_LIMIT:
            break
    y = (h * w + zero) * (-(-c // (8 * pad)) * 8 * pad + pad) * elem
    return stage, y, stage + y <= rb._SMEM_LIMIT


def test_general_keeps_y_in_shared_memory_where_it_fits():
    """The Python mirror of the general variant's shared memory matches
    the tile constants parsed from its source: y of one sample beside the
    ring and slabs where it fits (15×15 × 256 bf16), in the device
    workspace where it does not (19×19 × 192 f32)."""
    assert general_budget(15, 15, 256, True) == (93_312, 120_384, True)
    assert rb._GENERAL_RING[True] == 27_648
    assert rb._general_stage(15, 15, 256, True) == 93_312
    assert rb._y_in_smem(15, 15, 256, True)
    assert rb._smem_bytes("general", 15, 15, 256, True) == 213_696
    assert general_budget(19, 19, 192, False) == (66_656, 285_376, False)
    assert rb._GENERAL_RING[False] == 17_408
    assert rb._general_stage(19, 19, 192, False) == 66_656
    assert not rb._y_in_smem(19, 19, 192, False)
    assert rb._smem_bytes("general", 19, 19, 192, False) == 66_656


@pytest.mark.parametrize("b,size,c,dtype", GENERAL_SHAPES)
def test_general_budget_and_workspace_match_source(b, size, c, dtype):
    """At every general row: the mirrored shared memory is the source's
    budget, and the workspace is alphafive_resblock_workspace's formula
    (y of one sample per persistent CTA where y is not on chip)."""
    bf16 = dtype == torch.bfloat16
    stage, y, on_chip = general_budget(size, size, c, bf16)
    assert rb._y_in_smem(size, size, c, bf16) == on_chip
    assert rb._smem_bytes("general", size, size, c, bf16) == (
        stage + y if on_chip else stage)
    src = open(os.path.join(CSRC, "resblock.cu")).read()
    body = src[src.index("long long workspace_bytes("):]
    assert "if (general::y_in_smem(h, w, c, elem)) return 0;" in body
    formula = re.search(r"return \(long long\)persistent_grid\(b\)"
                        r"((?: \* \w+)+);", body).group(1)
    want = 0 if on_chip else eval(
        "grid" + formula, {}, dict(grid=min(b, rb._SMS), h=size, w=size,
                                   c=c, elem=2 if bf16 else 4))
    assert rb._workspace_bytes(b, size, size, c, bf16) == want


@pytest.mark.parametrize("size,c", [(5, 16), (7, 32)])
def test_reference_matches_pallas_bf16_small_widths(size, c):
    """bf16 at JAX's own test widths: rounded at the same points; the f32
    sums differ in order (tolerance of test_reference_matches_pallas_bf16)."""
    x, w1, b1, w2, b2 = make_inputs(size + 20, size, c)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = prb.fused_resblock(bf(x), bf(w1), jnp.asarray(b1), bf(w2),
                              jnp.asarray(b2), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = rb.fused_resblock(tb(x), tb(w1), torch.from_numpy(b1), tb(w2),
                            torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16 and rb.resblock_launches == 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=1.6e-2)


def test_reference_matches_pallas_f32_c20():
    """f32 at C = 20 (not a multiple of 8), tests/test_pallas.py's
    tolerance."""
    args = make_inputs(20, 6, 20)
    want = np.asarray(prb.fused_resblock(*map(jnp.asarray, args),
                                         interpret=True))
    got = rb.fused_resblock(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_fused_net_matches_jax_21x21_c24():
    """A 21×21 board at C = 24, f32: the port's fused forward against
    apply_eval_fused with the Pallas kernel in interpret mode and against
    apply_eval (tests/test_pallas.py's tolerance)."""
    ref, ref_fused, _, got_fused = run_both(
        21, "float32", seed=21, batch=2, blocks=1, channels=24,
        value_hidden=16)
    assert_close(got_fused, ref_fused, 2e-4, 2e-4)
    assert_close(got_fused, ref, 2e-4, 2e-4)


# -- the select kernel's chunk-streaming path -------------------------------

GROUP = 8   # csrc/select.cu's kMaxChunks: chunks per streamed group


def stream_score(n, w, p, acts, num_actions, c_puct, forced_k, depth,
                 sqrt_ns, ns_m1):
    """Every slot's exact score as select_stream_kernel's exact_score
    computes it, in f32."""
    f32 = np.float32
    legal = (p >= 0) & (acts < num_actions)
    pp = np.maximum(p, f32(0.0))
    x = c_puct * pp * sqrt_ns
    forced = legal & (depth == 0) & (n > 0) & (n * n < forced_k * pp * ns_m1)
    with np.errstate(all="ignore"):
        q = np.where(n > 0, w / np.maximum(n, f32(1.0)), f32(0.0))
        u = x / (f32(1.0) + n)
        s = (q + u).astype(f32)
    return np.where(~legal, f32(-np.inf), np.where(forced, f32(np.inf), s))


def emulate_stream_kernel(packed, num_actions, depth_limit, c_puct,
                          forced_k):
    """csrc/select.cu's select_stream_kernel in numpy f32, one env (warp)
    at a time: per step a first pass over the row's chunk groups sums N
    lane by lane (then five xor shuffles), a second scores each slot and
    keeps each lane's running best with its child id; the butterfly
    argmax, and the child shuffled from the lane that holds the winner."""
    f32 = np.float32
    e, _, _, a_pad = packed.shape
    j_all = a_pad // 128
    c_puct, forced_k, one = f32(c_puct), f32(forced_k), f32(1.0)
    acts = lanes(np.arange(a_pad))
    leaf, act_out, depth_out = (np.zeros(e, np.int32) for _ in range(3))
    pn = np.zeros((e, depth_limit), np.int32)
    pa = np.zeros((e, depth_limit), np.int32)
    lane = np.arange(LANES)
    for env in range(e):
        cur, depth, act, stopped = 0, 0, -1, False
        for _ in range(depth_limit):
            row = packed[env, cur]
            n, w, p, c = (lanes(row[k]) for k in (ps.SEC_N, ps.SEC_W,
                                                   ps.SEC_P, ps.SEC_CHILD))
            total = np.zeros(LANES, f32)
            for j0 in range(0, j_all, GROUP):
                for k in range(4 * j0, 4 * min(j0 + GROUP, j_all)):
                    total = total + n[:, k]
            for off in (16, 8, 4, 2, 1):
                total = total + total[lane ^ off]
            ns = one + total
            sqrt_ns, ns_m1 = np.sqrt(ns)[:, None], (ns - one)[:, None]
            score = stream_score(n, w, p, acts, num_actions, c_puct,
                                 forced_k, depth, sqrt_ns, ns_m1)
            best = np.full(LANES, -np.inf, f32)
            bidx = np.full(LANES, a_pad)
            child = np.full(LANES, -1.0, f32)
            for j0 in range(0, j_all, GROUP):
                for k in range(4 * j0, 4 * min(j0 + GROUP, j_all)):
                    take = better(score[:, k], acts[:, k], best, bidx)
                    best = np.where(take, score[:, k], best)
                    bidx = np.where(take, acts[:, k], bidx)
                    child = np.where(take, c[:, k], child)
            bi = butterfly(best, bidx)
            holder = (bi % 128) // 4
            assert bidx[holder] == bi   # the holder's own best won
            ch = int(child[holder])
            revisit = row[ps.SEC_META, 0] > 0.5 or depth >= depth_limit
            if not revisit:
                pn[env, depth], pa[env, depth] = cur, bi
                depth += 1
            act = -1 if revisit else bi
            if revisit or ch < 0:
                stopped = True
                break
            cur = ch
        leaf[env], depth_out[env] = cur, depth
        act_out[env] = act if stopped else -1
    return leaf, act_out, depth_out, pn, pa


def assert_stream_same(packed, a, d, c_puct, forced_k):
    want = [np.asarray(x) for x in jps.select_batch(
        jnp.asarray(packed), a, d, c_puct, forced_k, interpret=True)]
    got = ps.select_batch(torch.from_numpy(packed), a, d, c_puct, forced_k)
    emulated = emulate_stream_kernel(packed, a, d, c_puct, forced_k)
    for name, g, w, k in zip(("leaf", "act", "depth", "pn", "pa"), got,
                             want, emulated):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(k, w, err_msg=f"emulated {name}")
    return want


@pytest.mark.parametrize("seed,a,forced_k", [
    pytest.param(0, 33 * 33, 0.0, id="33x33-Apad1152"),
    pytest.param(1, 33 * 33, 2.0, id="33x33-Apad1152-forced"),
    pytest.param(2, 45 * 45, 0.0, id="45x45-Apad2048")])
def test_stream_select_random_trees(seed, a, forced_k):
    assert ps.pad_actions(a) in (1152, 2048)
    packed = make_tree(seed, 3, 12, a)
    if forced_k:   # root children few visits, one favourite: forced gates
        root = packed[:, 0]
        root[:, ps.SEC_N, :a] = np.where(root[:, ps.SEC_CHILD, :a] >= 0,
                                         1.0, 0.0)
        root[:, ps.SEC_N, 5] = 60.0
    _, _, depth, _, _ = assert_stream_same(packed, a, 8, 5.0, forced_k)
    assert (depth > 0).any()


@pytest.mark.parametrize("a", [33 * 33, 45 * 45])
def test_stream_select_first_maximum_across_chunks(a):
    """Tied maxima on both sides of a chunk boundary (actions 127 | 128,
    lanes 31 and 0) and of a streamed group boundary (1023 | 1024): the
    lowest action wins, as in JAX's argmax."""
    packed = make_tree(30, 4, 4, a, expanded=1, uniform=True)
    root = packed[:, 0]
    root[:, ps.SEC_P, :a] = 1e-3
    root[0, ps.SEC_P, [127, 128]] = 0.5
    root[1, ps.SEC_P, [1023, 1024]] = 0.5
    root[2, ps.SEC_P, [1024, 1023 + 128]] = 0.5   # both in the second group
    root[3, ps.SEC_P, [a - 1, 1023]] = 0.5
    _, act, _, _, _ = assert_stream_same(packed, a, 4, 5.0, 0.0)
    assert act.tolist() == [127, 1023, 1024, 1023]


def test_select_check_accepts_wide_rows():
    """A_pad is any multiple of 128: 1152 (33×33) passes `_check` and the
    CPU path; the padding rule still holds."""
    packed = torch.zeros((2, 4, ps.NUM_SEC, 1152))
    ps._check(packed, 33 * 33, 4)
    with pytest.raises(ValueError, match="A_pad"):
        ps._check(packed, 32 * 32, 4)
    assert ps.select_launches == 0
