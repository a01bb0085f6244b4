"""The resblock's split variant (one sample over a thread-block cluster):
its dispatch, band choice, push map, shared memory and workspace against
csrc/resblock.cu, a band-by-band emulation of the kernel against the plain
twin, and the plain twin and the fused net at the batches it takes
against JAX.

On the CPU ``fused_resblock`` runs ``fused_resblock_reference`` whatever
the batch; the JAX side runs the Pallas kernel in interpret mode. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (its ``kernel_vs_plain`` rows, split launched through
``alphafive_resblock_as``).
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_resblock as prb
from alphafive_tpu_torch.ops import resblock as rb
from alphafive_tpu_torch.utils import trace
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
             "kSplitBelowGeneral", "BM", "kClusterMax", "kBands",
             "kBandMax", "kStages", "kBarBytes")
    split = src[src.index("namespace split {"):]
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", split).group(1))
            for k in names}


def source_bands() -> tuple:
    """split::band_at's lengths, parsed from the source."""
    src = open(SOURCE).read()
    body = src[src.index("constexpr int band_at(int i) {"):]
    body = body[:body.index("}")]
    found = [int(v) for v in re.findall(r"\? (\d+)", body)]
    return tuple(found) + (source_constants()["kBandMax"],)


def source_cluster_size(b, h, w, c, sms=rb._SMS) -> int:
    """csrc/resblock.cu's cluster_size, its loops parsed from the source
    and run with the source's constants (tiles of BM positions of the
    h x (w + 1) grid)."""
    src = open(SOURCE).read()
    body = src[src.index("int cluster_size(int b, int h, int w, int c)"):]
    body = body[:body.index("\n}\n")]
    assert "while (k < split::kClusterMax && k < t) k *= 2;" in body
    assert "while (k > 2 && (long long)b * k > sm_count() / 2) k /= 2;" in body
    tiles = src[src.index("constexpr int tiles(int h, int w, int c"):]
    assert "return (cells(h, w) + n - 1) / n * groups(c);" in tiles
    assert "return h * (w + 1); }" in src
    k_max, bm = source_constants()["kClusterMax"], source_constants()["BM"]
    t = -(-h * (w + 1) // bm) * -(-c // 64)
    k = 2
    while k < k_max and k < t:
        k *= 2
    while k > 2 and b * k > sms // 2:
        k //= 2
    return k


def _close(e: str, i: int) -> int:
    """The index of the bracket that closes the one at e[i]."""
    depth = 0
    for j in range(i, len(e)):
        depth += e[j] in "({[" and 1 or -(e[j] in ")}]")
        if depth == 0:
            return j
    raise ValueError(f"unbalanced: {e!r}")


def _py_expr(e: str) -> str:
    """A C expression of split's host/device helpers as Python: the
    ternary (lowest precedence, right-associative), && / || / !, and
    integer division (every quotient in these helpers is of non-negative
    values, where C's and Python's agree)."""
    e = " ".join(e.split()).replace("split::", "")
    depth = 0
    for i, ch in enumerate(e):
        depth += ch == "(" and 1 or -(ch == ")")
        if ch == "?" and depth == 0:
            nest = d = 0
            for j in range(i + 1, len(e)):
                d += e[j] == "(" and 1 or -(e[j] == ")")
                if d == 0 and e[j] == "?":
                    nest += 1
                elif d == 0 and e[j] == ":":
                    if nest == 0:
                        break
                    nest -= 1
            return (f"({_py_expr(e[i + 1:j])} if {_py_expr(e[:i])} else "
                    f"{_py_expr(e[j + 1:])})")
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"!(?!=)", " not ", e)
    return re.sub(r"(?<![/])/(?![/])", "//", e)


def _py_stmt(st: str, ref: str | None, pad: str) -> list:
    """One C statement (no trailing ';') as lines of Python."""
    st = st.strip()
    m = re.match(r"for \(int (\w+) = (.+?); \1 < (.+?); \+\+\1\)", st)
    if m:
        return [f"{pad}for {m[1]} in range({_py_expr(m[2])}, "
                f"{_py_expr(m[3])}):"] + _py_stmt(st[m.end():], ref,
                                                  pad + "    ")
    if st.startswith("if ("):
        j = _close(st, 3)
        return [f"{pad}if {_py_expr(st[4:j])}:"] + _py_stmt(
            st[j + 1:], ref, pad + "    ")
    if st.startswith("return "):
        v = _py_expr(st[len("return "):])
        return [f"{pad}return {v}" + (f", {ref}" if ref else "")]
    st = re.sub(r"^(const )?(int|bool) ", "", st)
    out, depth, start = [], 0, 0
    for i, ch in enumerate(st + ","):
        depth += ch == "(" and 1 or -(ch == ")")
        if ch == "," and depth == 0:
            name, _, v = st[start:i].partition("=")
            out.append(f"{pad}{name.strip()} = {_py_expr(v)}")
            start = i + 1
    return out


@functools.lru_cache(maxsize=None)
def source_split() -> dict:
    """csrc/resblock.cu's namespace split: its constants, and its
    __host__ __device__ helpers (band_at, tiles, band, push, smem_bytes,
    push_rows, ...) translated statement by statement into Python and
    run: what the kernel and launch_split compute, not a mirror of it. A
    reference parameter (push_rows's `lo`) is returned after the value."""
    src = open(SOURCE).read()
    body = src[src.index("namespace split {"):]
    body = body[:body.index("}  // namespace split")]
    env = {"kSmemLimit": int(re.search(r"constexpr int kSmemLimit = (\d+);",
                                       src)[1])}
    head = body[:body.index("__host__")]
    for name, v in re.findall(r"constexpr int (\w+) = ([^;]+);", head):
        env[name] = eval(_py_expr(v), {}, dict(env))
    fn = re.compile(r"__host__ __device__ (?:constexpr|inline) (?:int|bool) "
                    r"(\w+)\(([^)]*)\) \{")
    for m in fn.finditer(body):
        text = body[m.end():_close(body, m.end() - 1)]
        params, ref = [], None
        for p in m[2].split(","):
            p = " ".join(p.split())
            if p.startswith("int& "):
                ref = p[len("int& "):]
                continue
            params.append(re.sub(r"^(int|bool) ", "", p).replace(" = ", "="))
        stmts, depth, start = [], 0, 0
        for i, ch in enumerate(text):
            depth += ch == "(" and 1 or -(ch == ")")
            if ch == ";" and depth == 0:
                stmts.append(text[start:i])
                start = i + 1
        lines = [f"def {m[1]}({', '.join(params)}):"]
        if ref:
            lines.append(f"    {ref} = 0")
        for st in stmts:
            lines += _py_stmt(st, ref, "    ")
        exec("\n".join(lines), env)
    return env


def test_split_constants_match_source():
    """The crossovers, the tile, the cluster bound, the bands, the ring and
    the barriers are the source's."""
    got = source_constants()
    assert got == {"kSplitBelowResident": rb.SPLIT_BELOW_RESIDENT,
                   "kSplitBelowStreaming": rb.SPLIT_BELOW_STREAMING,
                   "kSplitBelowGeneral": rb.SPLIT_BELOW_GENERAL,
                   "BM": rb.SPLIT_BM, "kClusterMax": rb.SPLIT_CLUSTER_MAX,
                   "kBands": len(rb.SPLIT_BANDS),
                   "kBandMax": rb.SPLIT_BANDS[-1],
                   "kStages": rb.SPLIT_STAGES,
                   "kBarBytes": rb.SPLIT_BAR_BYTES}
    assert source_bands() == rb.SPLIT_BANDS
    assert ("constexpr int kStageBytes = 3 * 64 * 64 * 2;"
            in open(SOURCE).read())
    assert rb.SPLIT_STAGE_BYTES == 3 * 64 * 64 * 2
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
    sample (4 tiles of 64 of its 15 x 16 positions), 16 a 19x19 x 128 one
    (12 tiles) but 8 at 8 samples and 4 at 16 (64 CTAs), 16 at 15x15 x
    256 (16 tiles) and 240x240 x 72, 2 at 64 x 6x6 x 8 (one tile)."""
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
    assert rb.cluster_size(b, size, size, c) == k
    assert rb.split_band(k, size, size, c) == band
    assert rb.split_tiles(size, size, c, band) == tiles
    assert rb.split_push(k, size, size, c) == push
    if push:
        assert tiles <= k and (band == rb.SPLIT_BANDS[0] or rb.split_tiles(
            size, size, c, rb.SPLIT_BANDS[rb.SPLIT_BANDS.index(band) - 1])
            > k)
        assert rb._smem_bytes("split", size, size, c, True, b) == (
            rb._split_push_smem(band, size, c)) <= rb._SMEM_LIMIT
    else:
        assert rb._smem_bytes("split", size, size, c, True, b) == (
            rb._SPLIT_WS_SMEM)


# (board, channels): the rows' shapes, the emulated ones and the edges
MIRRORED = [(15, 64), (19, 128), (15, 256), (33, 64), (240, 72), (240, 8),
            (6, 8), (7, 72), (9, 64), (21, 64), (13, 200)]


@pytest.mark.parametrize("size,c", MIRRORED)
def test_split_mirrors_match_source(size, c):
    """ops/resblock.py's mirrors of split's helpers give what the source's
    own give (translated and run, see source_split) at every cluster:
    tiles, band, push, shared memory, window rows, and the push map (first
    row and count) and each tile's expected bytes over every pair of
    tiles."""
    S = source_split()
    assert S["planes"](c) == rb.split_planes(c)
    for n in (S["BM"],) + rb.SPLIT_BANDS:
        assert S["tiles"](size, size, c, n) == rb.split_tiles(size, size, c, n)
        assert S["window_rows"](n, size) == rb.split_window_rows(n, size)
    assert S["ws_smem"]() == rb._SPLIT_WS_SMEM
    for k in (2, 4, 8, 16):
        n = S["band"](k, size, size, c)
        assert n == rb.split_band(k, size, size, c)
        assert S["push"](k, size, size, c) == rb.split_push(k, size, size, c)
        assert S["smem_bytes"](k, size, size, c) == rb._split_smem(
            k, size, size, c)
        nt = S["tiles"](size, size, c, n)
        if nt > 32:            # the workspace path: no push map
            assert not S["push"](k, size, size, c)
            continue
        for u in range(nt):
            tx = 0
            for t in range(nt):
                cnt, lo = S["push_rows"](t, u, n, size, c)
                want_lo, want = rb.split_push_rows(t, u, n, size, c)
                assert cnt == want, (k, t, u)
                assert cnt == 0 or lo == want_lo, (k, t, u)
                tx += cnt * 8 * 16 if t != u else 0
            assert tx == rb.split_push_bytes(u, nt, n, size, c), (k, u)


@pytest.mark.parametrize("size,c,on_chip,smem", [
    (15, 64, True, 100_736), (19, 128, True, 123_520),
    (15, 256, False, 181_376), (240, 72, False, 124_288),
    (6, 8, True, 90_496)])
def test_split_budget_and_workspace(size, c, on_chip, smem):
    """Shared memory at batch 1: the barriers, the ring of 3 tap rows of 64
    x 64 slices, and x's and y's windows of every chunk plane over the
    band's tap rows (push path), or one tap row's window and the tile's
    staging rows (the workspace path, 240x240 x 72). The workspace holds y of every
    sample where the push path may not run: at the cluster or at the 8 a
    cluster of 16 narrows to (15x15 x 256 pushes at 16 but not at 8)."""
    assert rb._smem_bytes("split", size, size, c, True) == smem
    assert smem <= rb._SMEM_LIMIT
    assert rb.split_in_smem(1, size, size, c) == on_chip
    for b in (1, 16):
        want = 0 if rb.split_in_smem(b, size, size, c) else (
            b * size * size * c * 2)
        assert rb._workspace_bytes(b, size, size, c, True, "split") == want
    assert rb._workspace_bytes(1, size, size, c, True, "split") == (
        0 if on_chip else size * size * c * 2)
    src = open(SOURCE).read()
    body = src[src.index("long long workspace_bytes("):]
    assert ("return split_in_smem(b, h, w, c) ? 0 : (long long)b * h * w * c"
            " * 2;") in body
    assert ("return split::push(k, h, w, c) && split::push(k < 8 ? k : 8, h,"
            " w, c);") in src
    # the dispatch's own workspace at batch 1: split's
    assert rb._workspace_bytes(1, size, size, c, True) == (
        rb._workspace_bytes(1, size, size, c, True, "split")
        if rb.variant(BF16, size, size, c, 1) == "split" else
        rb._workspace_bytes(1, size, size, c, True, "general"))


def test_split_budget_matches_source_tiles():
    """The source's shared-memory expressions: the push path's two windows
    of planes(C) chunk planes of window_rows (band + 2(w + 1) + 2 rows,
    the junk row, rounded to 1 mod 8), the workspace path's window of one
    tap row (band + 2) and staging rows (band) of 8 planes, each beside
    the barriers and the ring."""
    src = open(SOURCE).read()
    assert ("return kBarBytes + kStages * kStageBytes +\n"
            "         2 * planes(c) * window_rows(n, w) * 16;") in src
    assert ("return kBarBytes + kStages * kStageBytes +\n"
            "         8 * (rows(kBandMax + 2) + rows(kBandMax)) * 16;") in src
    assert "return rows(n + 2 * (w + 1) + 2);" in src
    assert "return (used + 7) / 8 * 8 + 1;" in src
    assert "return groups(c) * 8; }" in src
    ring = 128 + 3 * 3 * 64 * 64 * 2
    # 19x19 x 128 at 16 ranks: bands of 48, 90 rows -> 97, 16 planes
    assert rb.split_window_rows(48, 19) == 97
    assert rb._smem_bytes("split", 19, 19, 128, True) == (
        ring + 2 * 16 * 97 * 16)
    # at 8 samples, 8 ranks: bands of 96 (138 rows -> 145)
    assert rb._smem_bytes("split", 19, 19, 128, True, 8) == (
        ring + 2 * 16 * 145 * 16)
    assert rb._SPLIT_WS_SMEM == ring + 8 * (201 + 193) * 16


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
    src = open(SOURCE).read()
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
    for band in rb.SPLIT_BANDS[:-1]:
        assert (f"case {band}:\n      return split::kernel<{band // 2}>;"
                in pick)
    rng = np.random.default_rng(size * 1000 + c)
    x = rng.integers(0, 3, (size, size, c)).astype(np.float32)
    w1, w2 = (rng.integers(-1, 2, (9, c, c)).astype(np.float32)
              for _ in range(2))
    b1, b2 = (rng.integers(-2, 3, c).astype(np.float32) for _ in range(2))
    tx, tw1, tb1, tw2, tb2 = map(torch.from_numpy, (x, w1, b1, w2, b2))
    k = rb.cluster_size(b, size, size, c)
    got, received = emulate_split(tx, tw1, tb1, tw2, tb2, k)
    bf = torch.bfloat16
    want = rb.fused_resblock_reference(tx[None].to(bf), tw1.to(bf), tb1,
                                       tw2.to(bf), tb2)[0].float()
    assert torch.equal(got, want)
    if received is not None:
        n = rb.split_band(k, size, size, c)
        nt, ng = rb.split_tiles(size, size, c, n), -(-c // 64)
        span = n + 2 * (size + 2)      # a window's rows of positions
        want = [8 * 16 * sum(
            len(set(range(t // ng * n, t // ng * n + n))
                & set(range(u // ng * n - size - 2, u // ng * n - size - 2
                            + span)))
            for t in range(nt) if t != u) for u in range(nt)]
        assert received == want
    else:
        assert not rb.split_push(k, size, size, c)


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
