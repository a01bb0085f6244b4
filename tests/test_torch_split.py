"""The resblock's split variant (one sample over a thread-block cluster):
its dispatch, and its band choice, push map, shared memory and workspace
as csrc/resblock.cu computes them (resblock_source.py), a band-by-band
emulation of the kernel against the plain twin, and the plain twin and
the fused net at the batches it takes against JAX.

On the CPU ``fused_resblock`` runs ``fused_resblock_reference`` whatever
the batch; the JAX side runs the Pallas kernel in interpret mode. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (its ``kernel_vs_plain`` rows, split named by
``fused_resblock_as``).
"""

import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_resblock as prb
from alphafive_tpu_torch.ops import resblock as rb
from alphafive_tpu_torch.utils import trace
from resblock_source import (SMS, smem_bytes, source, source_bands,
                             source_cluster_size, source_split,
                             split_in_smem)
from test_torch_net import assert_close, run_both
from test_torch_resblock import make_inputs

torch.set_num_threads(1)

BF16 = torch.bfloat16
# (board, channels, the variant at a batch that names none): the evals'
# and cli play's 15x15 x 64, the 19x19_10b bundle's 19x19 x 128, a
# 256-channel net's 15x15 and the widest general edge
SHAPES = [(15, 64, "resident"), (19, 128, "streaming"),
          (15, 256, "general"), (240, 72, "general")]
BATCHES = [1, 2, 3, 4, 8, 16, 17, 32, 64, 133, 256, 512, 2048]


def test_split_constants_match_source():
    """The tile `variant` counts in is the source's; the cluster bound, the
    bands, the ring and the barriers are as the tests below state them."""
    S = source_split()
    assert {k: S[k] for k in ("BM", "kClusterMax", "kBands", "kBandMax",
                              "kStages", "kBarBytes")} == {
        "BM": rb.SPLIT_BM, "kClusterMax": 16, "kBands": 4, "kBandMax": 192,
        "kStages": 3, "kBarBytes": 128}
    assert source_bands() == (48, 64, 96, 192)
    assert "constexpr int kStageBytes = 3 * 64 * 64 * 2;" in source()
    assert S["kStageBytes"] == 3 * 64 * 64 * 2


def test_variant_is_chosen_once():
    """ops/resblock.py::variant is the one chooser: the library launches
    the variant it is named and has no choice or crossover of its own, and
    the split crossovers are defined in ops/resblock.py alone."""
    for name in ("alphafive_resblock_variant", "resblock_variant",
                 "kSplitBelow", "alphafive_resblock_as", "workspace_as"):
        assert name not in source(), name
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(root, "alphafive_tpu_torch", "**",
                                          "*.*"), recursive=True)
                   + [os.path.join(root, "chip_smoke.py")])
    defined = [os.path.relpath(f, root) for f in files
               if f.endswith((".py", ".cu")) and re.search(
                   r"^\s*(SPLIT_BELOW\w*|constexpr int kSplit\w*)\s*=",
                   open(f).read(), re.M)]
    assert defined == [os.path.join("alphafive_tpu_torch", "ops",
                                    "resblock.py")]
    assert set(rb.SPLIT_BELOW) == {"resident", "streaming", "general"}


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
    """The source's cluster_size: a power of two from 2 to 16 that covers
    one sample's tiles, halved while the batch's clusters exceed half the
    132 SMs; the tiles `variant` counts are the source's."""
    k = source_cluster_size(b, size, size, c)
    tiles = source_split()["tiles"](size, size, c)
    assert rb.split_tiles(size, size, c) == tiles
    assert k in (2, 4, 8, 16)
    assert k == 2 or b * k <= SMS // 2
    assert k >= min(tiles, 16) or b * 2 * k > SMS // 2


def test_cluster_sizes_at_the_rows():
    """The clusters chip_smoke.py's split rows launch: 4 CTAs a 15x15 x 64
    sample (4 tiles of 64 of its 15 x 16 positions), 16 a 19x19 x 128 one
    (12 tiles) but 8 at 8 samples and 4 at 16 (64 CTAs), 16 at 15x15 x
    256 (16 tiles) and 240x240 x 72, 2 at 64 x 6x6 x 8 (one tile)."""
    assert [source_cluster_size(b, 15, 15, 64) for b in (1, 16)] == [4, 4]
    assert [source_cluster_size(b, 19, 19, 128) for b in (1, 4, 8, 16)] == [
        16, 16, 8, 4]
    assert rb.split_tiles(19, 19, 128) == 12
    assert source_cluster_size(1, 15, 15, 256) == 16
    assert rb.split_tiles(15, 15, 256) == 16
    assert source_cluster_size(1, 240, 240, 72) == 16
    assert source_cluster_size(64, 6, 6, 8) == 2
    # one tile: nothing to split, whatever the batch
    assert rb.variant(BF16, 6, 6, 8, 1) == "general"


# (batch, board, channels, cluster, band, tiles, push): each rank one tile
# where the band allows; 33x33 x 64 leaves 4 of 16 ranks idle; 240x240
# goes through the workspace in bands of 192
BAND_ROWS = [(1, 19, 128, 16, 48, 16, True), (2, 19, 128, 16, 48, 16, True),
             (4, 19, 128, 16, 48, 16, True), (8, 19, 128, 8, 96, 8, True),
             (16, 19, 128, 4, 192, 4, True), (1, 15, 64, 4, 64, 4, True),
             (16, 15, 64, 4, 64, 4, True), (1, 15, 256, 16, 64, 16, True),
             (1, 33, 64, 16, 96, 12, True), (1, 240, 72, 16, 192, 604, False),
             (64, 6, 6, 2, 48, 1, True)]


@pytest.mark.parametrize("b,size,c,k,band,tiles,push", BAND_ROWS)
def test_split_band_choice(b, size, c, k, band, tiles, push):
    """The band: the shortest of 48 / 64 / 96 / 192 positions whose tiles
    the cluster's ranks hold one each, so that one sample's tiles fall
    evenly on the cluster (19x19 x 128: 16 tiles of 48 for 16 ranks at
    batch 1, 8 of 96 for 8 at batch 8, 4 of 192 for 4 at 16; 15x15 x 64: 4
    of 64 for 4); where no band does, the workspace path's 192."""
    S, bands = source_split(), source_bands()
    assert source_cluster_size(b, size, size, c) == k
    assert S["band"](k, size, size, c) == band
    assert S["tiles"](size, size, c, band) == tiles
    assert S["push"](k, size, size, c) == push
    if push:
        assert tiles <= k and (band == bands[0] or S["tiles"](
            size, size, c, bands[bands.index(band) - 1]) > k)
        assert smem_bytes("split", b, size, size, c, True) == (
            S["push_smem"](band, size, c)) <= rb._SMEM_LIMIT
    else:
        assert smem_bytes("split", b, size, size, c, True) == S["ws_smem"]()


# (board, channels): the rows' shapes, the emulated ones and the edges
MIRRORED = [(15, 64), (19, 128), (15, 256), (33, 64), (240, 72), (240, 8),
            (6, 8), (7, 72), (9, 64), (21, 64), (13, 200)]


@pytest.mark.parametrize("size,c", MIRRORED)
def test_split_mirrors_match_source(size, c):
    """split's helpers as the source computes them (translated and run,
    see source_split), at every cluster: the planes, tiles and window rows
    by their definitions; push false wherever the tiles outnumber the
    ranks; the push map (first row and count) over every pair of tiles the
    intersection of t's band with u's window, inside u's window; each of
    u's window positions on the bands arriving from one tile of each
    64-channel group, so that the bytes u receives are its window's rows
    of every group less its own."""
    S = source_split()
    assert S["planes"](c) == -(-c // 64) * 8
    assert S["tiles"](size, size, c) == rb.split_tiles(size, size, c)
    for n in (S["BM"],) + source_bands():
        assert S["tiles"](size, size, c, n) == (
            -(-size * (size + 1) // n) * -(-c // 64))
        assert S["window_rows"](n, size) == (
            (n + 2 * (size + 1) + 2 + 7) // 8 * 8 + 1)
    ng = -(-c // 64)
    for k in (2, 4, 8, 16):
        n = S["band"](k, size, size, c)
        nt = S["tiles"](size, size, c, n)
        if nt > k:
            assert not S["push"](k, size, size, c)
        if nt > 32:            # the workspace path: no push map
            continue
        span = n + 2 * (size + 2)            # a window's positions
        for u in range(nt):
            wa = u // ng * n - size - 2      # u's window's first position
            on_bands = min(wa + span, nt // ng * n) - max(wa, 0)
            rows = [S["push_rows"](t, u, n, size, c) for t in range(nt)]
            for t, (cnt, lo) in enumerate(rows):
                a = t // ng * n
                want = max(min(a + n, wa + span) - max(a, wa), 0)
                assert cnt == want, (k, t, u)
                assert cnt == 0 or (lo == max(a, wa)
                                    and lo - wa + cnt <= span), (k, t, u)
            for g in range(ng):
                assert sum(cnt for cnt, _ in rows[g::ng]) == on_bands
            received = sum(cnt * 8 * 16 for t, (cnt, _) in enumerate(rows)
                           if t != u)
            assert received == (ng * on_bands - rows[u][0]) * 8 * 16, (k, u)


@pytest.mark.parametrize("size,c,on_chip,smem,ws16", [
    (15, 64, True, 100_736, 0), (19, 128, True, 123_520, 0),
    (15, 256, False, 181_376, 16 * 15 * 15 * 256 * 2),
    (240, 72, False, 124_288, 16 * 240 * 240 * 72 * 2),
    (6, 8, True, 90_496, 0)])
def test_split_budget_and_workspace(size, c, on_chip, smem, ws16):
    """Shared memory at batch 1: the barriers, the ring of 3 tap rows of 64
    x 64 slices, and x's and y's windows of every chunk plane over the
    band's tap rows (push path), or one tap row's window and the tile's
    staging rows (the workspace path, 240x240 x 72). The workspace holds y of every
    sample where the push path may not run: at the cluster or at the 8 a
    cluster of 16 narrows to (15x15 x 256 pushes at 16 but not at 8)."""
    assert smem_bytes("split", 1, size, size, c, True) == smem
    assert smem <= rb._SMEM_LIMIT
    assert split_in_smem(1, size, size, c) == on_chip
    src = source()
    body = src[src.index("long long workspace_bytes("):]
    assert ("return split_in_smem(b, h, w, c) ? 0 : (long long)b * h * w * c"
            " * 2;") in body
    assert "if (b < 1) return 0;" in body
    # workspace_bytes at batches 1 and 16, by the source's split_in_smem
    for b, want in ((1, 0 if on_chip else size * size * c * 2), (16, ws16)):
        assert (0 if split_in_smem(b, size, size, c) else
                b * size * size * c * 2) == want, b
    # the launch at batch 1 names split (and asks its workspace) wherever
    # a sample has two tiles; else general
    assert rb.variant(BF16, size, size, c, 1) == (
        "split" if source_split()["tiles"](size, size, c) >= 2 else "general")


def test_split_budget_matches_source_tiles():
    """The source's shared-memory expressions: the push path's two windows
    of planes(C) chunk planes of window_rows (band + 2(w + 1) + 2 rows,
    the junk row, rounded to 1 mod 8), the workspace path's window of one
    tap row (band + 2) and staging rows (band) of 8 planes, each beside
    the barriers and the ring."""
    src = source()
    assert ("return kBarBytes + kStages * kStageBytes +\n"
            "         2 * planes(c) * window_rows(n, w) * 16;") in src
    assert ("return kBarBytes + kStages * kStageBytes +\n"
            "         8 * (rows(kBandMax + 2) + rows(kBandMax)) * 16;") in src
    assert "return rows(n + 2 * (w + 1) + 2);" in src
    assert "return (used + 7) / 8 * 8 + 1;" in src
    assert "return groups(c) * 8; }" in src
    ring = 128 + 3 * 3 * 64 * 64 * 2
    S = source_split()
    # 19x19 x 128 at 16 ranks: bands of 48, 90 rows -> 97, 16 planes
    assert S["window_rows"](48, 19) == 97
    assert smem_bytes("split", 1, 19, 19, 128, True) == (
        ring + 2 * 16 * 97 * 16)
    # at 8 samples, 8 ranks: bands of 96 (138 rows -> 145)
    assert smem_bytes("split", 8, 19, 19, 128, True) == (
        ring + 2 * 16 * 145 * 16)
    assert S["ws_smem"]() == ring + 8 * (201 + 193) * 16


def emulate_split(x, w1, b1, w2, b2, k):
    """csrc/resblock.cu's split kernel on one sample x [h, w, c] (f32 of
    bf16 values), as a cluster of k ranks computes it, band by band over
    the h x (w + 1) grid, with the source's own band, path and push map
    (source_split): the push path (a tile a rank, y owned by its rank and
    moved by the map's rows (8 planes a row) into the
    peers' windows, each window zero where no rank writes) or the
    workspace path (tiles of the longest band, each conv's window one tap
    row of one 64-channel block, y through an NHWC workspace). Returns
    the output and, on the push path, the bytes each tile received."""
    S = source_split()
    h, w, c = x.shape
    pitch, ncell = w + 1, h * (w + 1)
    ng, npl = S["groups"](c), S["planes"](c)
    cp, gp = npl * 8, ng * 64          # channels of the planes, of groups
    push = S["push"](k, h, w, c)
    n = S["band"](k, h, w, c) if push else S["kBandMax"]
    ntiles = S["tiles"](h, w, c, n)

    def grid(a):                       # [h, w, c] -> positions x planes
        g = torch.zeros(h, pitch, cp)
        g[:, :w, :c] = a
        return g.reshape(ncell, cp)

    def window(g, o0, rows):           # positions o0 .. o0 + rows - 1
        out = torch.zeros(rows, g.shape[1])
        lo, hi = max(o0, 0), min(o0 + rows, ncell)
        if hi > lo:
            out[lo - o0:hi - o0] = g[lo:hi]
        return out

    def taps(wt):                      # [9, cp, gp]: zeros past C
        out = torch.zeros(9, cp, gp)
        out[:, :c, :c] = wt
        return out

    def pad(v):
        out = torch.zeros(gp)
        out[:c] = v
        return out

    W1, W2, B1, B2 = taps(w1), taps(w2), pad(b1), pad(b2)
    live = torch.zeros(ncell + n, dtype=torch.bool)
    live[:ncell] = torch.arange(ncell) % pitch != w
    xg = grid(x)
    out = torch.zeros(ncell, gp)

    def bf(v):
        return v.to(torch.bfloat16).float()

    if push:
        rows = n + 2 * pitch + 2
        tile = [(t // ng * n, t % ng) for t in range(ntiles)]
        xw = [window(xg, o0 - pitch - 1, rows) for o0, _ in tile]
        yw = [torch.zeros(rows, cp) for _ in tile]
        acc = []
        for t, (o0, g) in enumerate(tile):
            ch = slice(64 * g, 64 * g + 64)
            a = sum(xw[t][s // 3 * pitch + s % 3:][:n] @ W1[s][:, ch]
                    for s in range(9))
            y = bf(torch.relu(a + B1[ch]))
            own = live[o0:o0 + n]
            rng = slice(64 * g, min(64 * g + 64, cp))
            yw[t][pitch + 1:pitch + 1 + n][own, rng] = y[own][:, :rng.stop -
                                                               rng.start]
            res = torch.zeros(n, 64)
            res[:, :rng.stop - rng.start] = xw[t][pitch + 1:][:n, rng]
            acc.append(B2[ch] + res)
        got = [0] * ntiles
        for t, (o0, g) in enumerate(tile):       # the pushes
            for u, (o1, _) in enumerate(tile):
                cnt, lo = S["push_rows"](t, u, n, w, c)
                if u == t or cnt == 0:
                    continue
                pl = slice(64 * g, 64 * g + 64)
                src = lo - o0 + pitch + 1
                dst = lo - (o1 - pitch - 1)
                yw[u][dst:dst + cnt, pl] = yw[t][src:src + cnt, pl]
                got[u] += cnt * (pl.stop - pl.start) * 2
        for t, (o0, g) in enumerate(tile):
            ch = slice(64 * g, 64 * g + 64)
            z = acc[t] + sum(yw[t][s // 3 * pitch + s % 3:][:n] @ W2[s][:, ch]
                             for s in range(9))
            own = live[o0:o0 + n]
            top = min(o0 + n, ncell)
            out[o0:top, ch] = torch.where(own[:top - o0, None],
                                          bf(torch.relu(z))[:top - o0], 0.)
        return out.reshape(h, pitch, gp)[:, :w, :c], got

    ys = torch.zeros(ncell, cp)                   # the workspace
    for conv in (0, 1):
        src, wt, bias = (ys, W2, B2) if conv else (xg, W1, B1)
        for t in range(ntiles):
            o0, g = t // ng * n, t % ng
            ch = slice(64 * g, 64 * g + 64)
            a = torch.zeros(n, 64)
            for cb in range(-(-c // 64)):
                cin = slice(64 * cb, min(64 * cb + 64, cp))
                for dy in range(3):
                    win = window(src, o0 + (dy - 1) * pitch - 1, n + 2)
                    for dx in range(3):
                        a += win[dx:dx + n, cin] @ wt[3 * dy + dx][cin, ch]
            top = min(o0 + n, ncell)
            own = live[o0:top, None]
            if conv:
                res = torch.zeros(n, 64)
                rng = slice(64 * g, min(64 * g + 64, cp))
                res[:, :rng.stop - rng.start] = window(xg, o0, n)[:, rng]
                v = bf(torch.relu(a + bias[ch] + res))[:top - o0]
                out[o0:top, ch] = torch.where(own, v, 0.)
            else:
                v = bf(torch.relu(a + bias[ch]))[:top - o0]
                rng = slice(64 * g, min(64 * g + 64, cp))
                ys[o0:top, rng] = torch.where(own, v, 0.)[:, :rng.stop -
                                                          rng.start]
    return out.reshape(h, pitch, gp)[:, :w, :c], None


# (batch, board, channels): the rows' shapes at their clusters, and a
# narrow 240x240 (C = 8) through the workspace path
EMULATED = [(1, 15, 64), (16, 15, 64), (1, 19, 128), (8, 19, 128),
            (16, 19, 128), (1, 15, 256), (1, 33, 64), (1, 240, 8),
            (1, 7, 72)]


@pytest.mark.parametrize("b,size,c", EMULATED)
def test_split_push_map_emulation(b, size, c):
    """The kernel's data flow, band by band, on small-integer inputs
    (every f32 sum exact, so only the rounding points matter): each rank's
    windows, its y owned and pushed by the map, conv 2 from what arrived,
    equal to fused_resblock_reference bit for bit; each tile's window
    receives the bytes its ybar expects: its window's rows in the other
    tiles' bands, counted here by intersecting ranges. The kernel's
    copies and expected bytes use the map as emulated."""
    src = source()
    kernel = src[src.index("kernel(const T* __restrict__ x"):]
    for line in ("const bool push_y = push(ranks, h, w, c);",
                 "rows = push_rows(lane, t, N, w, c, lo);",
                 "(uint32_t)rows * 8 * 16);",
                 "for (int i = tid; i < ntiles * 8; i += kThreads) {",
                 "const int to = i >> 3, pl = i & 7;",
                 "const int n = to == t ? 0 : push_rows(t, to, N, w, c, lo);",
                 "const uint32_t src = pa + (lo - o0 + pitch + 1) * 16;",
                 "const uint32_t dst = pa + (lo - (to / ng * N - pitch - 1))"
                 " * 16;",
                 "push_copy(mapa(dst, to), src, n * 16, mapa(ybar, to));"):
        assert line in kernel, line
    pick = src[src.index("SplitKernel split_kernel(int k"):]
    assert ("split::push(k, h, w, c) ? split::band(k, h, w, c) : "
            "split::kBandMax;") in " ".join(pick.split())
    for band in source_bands()[:-1]:
        assert (f"case {band}:\n      return split::kernel<{band // 2}>;"
                in pick)
    rng = np.random.default_rng(size * 1000 + c)
    x = rng.integers(0, 3, (size, size, c)).astype(np.float32)
    w1, w2 = (rng.integers(-1, 2, (9, c, c)).astype(np.float32)
              for _ in range(2))
    b1, b2 = (rng.integers(-2, 3, c).astype(np.float32) for _ in range(2))
    tx, tw1, tb1, tw2, tb2 = map(torch.from_numpy, (x, w1, b1, w2, b2))
    k = source_cluster_size(b, size, size, c)
    got, received = emulate_split(tx, tw1, tb1, tw2, tb2, k)
    bf = torch.bfloat16
    want = rb.fused_resblock_reference(tx[None].to(bf), tw1.to(bf), tb1,
                                       tw2.to(bf), tb2)[0].float()
    assert torch.equal(got, want)
    S = source_split()
    if received is not None:
        n = S["band"](k, size, size, c)
        nt, ng = S["tiles"](size, size, c, n), -(-c // 64)
        span = n + 2 * (size + 2)      # a window's rows of positions
        want = [8 * 16 * sum(
            len(set(range(t // ng * n, t // ng * n + n))
                & set(range(u // ng * n - size - 2, u // ng * n - size - 2
                            + span)))
            for t in range(nt) if t != u) for u in range(nt)]
        assert received == want
    else:
        assert not S["push"](k, size, size, c)


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
    assert got.dtype == torch.bfloat16
    assert trace.snapshot()["counters"].get("resblock_launches", 0) == 0
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
