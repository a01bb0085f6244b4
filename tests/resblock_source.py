"""csrc/resblock.cu as the resblock tests read it: its constants, and the
host helpers of its split and general variants parsed from the source or
translated into Python and run. ops/resblock.py keeps none of this
geometry (it names the variant; the library launches it), so the tests
hold what the kernels compute to the source itself."""

import functools
import os
import re

from alphafive_tpu_torch.ops import resblock as rb

SOURCE = os.path.join(os.path.dirname(rb.__file__), os.pardir, "csrc",
                      "resblock.cu")
SMS = 132   # an H100 SXM's multiprocessors, which sm_count() reads there


@functools.lru_cache(maxsize=None)
def source() -> str:
    with open(SOURCE) as f:
        return f.read()


def source_bands() -> tuple:
    """split::band_at's lengths, shortest first."""
    S = source_split()
    return tuple(S["band_at"](i) for i in range(S["kBands"]))


def source_cluster_size(b, h, w, c, sms=SMS) -> int:
    """csrc/resblock.cu's cluster_size, its loops parsed from the source
    and run with the source's constants and its translated split::tiles
    (tiles of BM positions of the h x (w + 1) grid)."""
    src = source()
    body = src[src.index("int cluster_size(int b, int h, int w, int c)"):]
    body = body[:body.index("\n}\n")]
    assert "const int t = split::tiles(h, w, c);" in body
    assert "while (k < split::kClusterMax && k < t) k *= 2;" in body
    assert "while (k > 2 && (long long)b * k > sm_count() / 2) k /= 2;" in body
    S = source_split()
    t, k = S["tiles"](h, w, c), 2
    while k < S["kClusterMax"] and k < t:
        k *= 2
    while k > 2 and b * k > sms // 2:
        k //= 2
    return k


def split_in_smem(b, h, w, c) -> bool:
    """csrc/resblock.cu's split_in_smem: y stays on chip (the push path)
    at the batch's cluster and at the 8 a cluster of 16 narrows to."""
    assert ("return split::push(k, h, w, c) && split::push(k < 8 ? k : 8, h,"
            " w, c);") in source()
    S, k = source_split(), source_cluster_size(b, h, w, c)
    return S["push"](k, h, w, c) and S["push"](min(k, 8), h, w, c)


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
    src = source()
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


def _general_tiles(bf16):
    """The general variant's tile constants, parsed from its source:
    (element bytes, elements in 16 B, BM, BK, BN, ring stages)."""
    src = source()
    body = src[src.index("namespace general {"):]
    pick = {k: tuple(map(int, re.search(
        rf"constexpr int {k}\(int elem\) {{\s*return elem == 2 \? (\d+) : "
        rf"(\d+);", body).groups())) for k in ("bk", "stages", "warp_m")}
    warp_n = int(re.search(r"constexpr int kWarpN = (\d+);", body).group(1))
    warps_n = int(re.search(r"constexpr int kWarpsN = (\d+);", body).group(1))
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    i = 0 if bf16 else 1
    elem = 2 if bf16 else 4
    bm = pick["warp_m"][i] * (threads // 32 // warps_n)
    return elem, 16 // elem, bm, pick["bk"][i], warp_n * warps_n, \
        pick["stages"][i]


def general_ring(bf16):
    """The general variant's ring: `stages` weight tiles of BK x BN rows
    padded by 16 B."""
    elem, pad, _, bk, bn, stages = _general_tiles(bf16)
    return stages * bk * (bn + pad) * elem


def general_budget(h, w, c, bf16):
    """csrc/resblock.cu's general variant's shared memory, from the tile
    constants in its source: (ring and slabs, y's bytes, y on chip)."""
    body = source()[source().index("namespace general {"):]
    elem, pad, bm, bk, bn, _ = _general_tiles(bf16)
    ring = general_ring(bf16)
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


def smem_bytes(kind, b, h, w, c, bf16) -> int:
    """Shared memory of variant `kind` at a batch of b: general's and
    split's (at the batch's cluster) from the source; the fast variants'
    from ops/resblock.py, which test_torch_resblock.py holds to it."""
    if kind == "general":
        stage, y, on_chip = general_budget(h, w, c, bf16)
        return stage + y if on_chip else stage
    if kind == "split":
        return source_split()["smem_bytes"](source_cluster_size(b, h, w, c),
                                            h, w, c)
    return rb._smem_bytes(kind, h, w, c)
