"""PUCT descent over a packed tree: the port's plain version against the
Pallas kernel.

On the CPU ``select_batch`` runs ``select_batch_reference``; the JAX side
runs ``pallas_select.select_batch`` in interpret mode. Trees are built
with numpy (random parents, child links, visit counts and value sums), and
the five outputs must be exactly equal. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py; here a numpy
emulation of its warp (lane l holds actions 4l + 128j + i, xor-shuffle
sum and (score, index) argmax, unvisited actions scored without a
division, visited ones filtered by approximate bounds before the exact
score, the child taken from the lane that loaded it) is held against
both on every tree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_select as jps
from alphafive_tpu_torch.ops import select as ps
from alphafive_tpu_torch.utils import trace

torch.set_num_threads(1)


def make_tree(seed, e, nn, a, *, expanded=None, uniform=False,
              chain=False, terminal_root=(), terminal_p=0.05,
              pad_p=-1.0, w_bias=0.0):
    """packed f32[E, NN, 8, A_pad]. The first `expanded` nodes of each env
    form a tree: node k hangs off a random earlier node (the previous one
    with `chain`) under a random legal action that had no child yet."""
    rng = np.random.default_rng(seed)
    a_pad = ps.pad_actions(a)
    expanded = nn if expanded is None else expanded
    packed = np.zeros((e, nn, ps.NUM_SEC, a_pad), np.float32)
    packed[:, :, ps.SEC_CHILD] = -1.0
    packed[:, :, ps.SEC_P, a:] = pad_p
    for env in range(e):
        legal = rng.random((nn, a)) < 0.8
        if uniform:
            legal[:] = True
            p = np.full((nn, a), 1.0 / a, np.float32)
        else:
            logits = rng.standard_normal((nn, a)) * 2
            p = np.exp(logits) * legal
            p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
        packed[env, :, ps.SEC_P, :a] = np.where(legal, p, -1.0)
        for k in range(1, expanded):
            parent = k - 1 if chain else int(rng.integers(k))
            free = np.nonzero(legal[parent]
                              & (packed[env, parent, ps.SEC_CHILD, :a] < 0))[0]
            if free.size == 0:
                continue
            act = int(free[rng.integers(free.size)])
            packed[env, parent, ps.SEC_CHILD, act] = k
        has_child = packed[env, :, ps.SEC_CHILD, :a] >= 0
        if not uniform:
            n = rng.integers(1, 12, size=(nn, a)) * has_child
            packed[env, :, ps.SEC_N, :a] = n
            packed[env, :, ps.SEC_W, :a] = (
                (rng.standard_normal((nn, a)) * 0.5 + w_bias) * n)
        packed[env, :, ps.SEC_META, 0] = rng.random(nn) < terminal_p
        packed[env, 0, ps.SEC_META, 0] = env in terminal_root
    return packed


LANES = 32


def lanes(x):
    """[..., A_pad] → [..., 32, 4J]: lane l's actions 4l + 128j + i in
    the order the kernel scans them (j, then i)."""
    j = x.shape[-1] // 128
    y = x.reshape(x.shape[:-1] + (j, LANES, 4))
    return np.moveaxis(y, -2, -3).reshape(x.shape[:-1] + (LANES, j * 4))


def better(s, i, best, bi):
    return (s > best) | ((s == best) & (i < bi))


def lane_best(score, acts):
    """Each lane's best (score, action) of lanes(score) [32, 4J] under
    better() (a total order: the kernel's pairwise tree gives the same)."""
    best = np.full(LANES, -np.inf, np.float32)
    bidx = np.full(LANES, acts.size)
    for k in range(score.shape[1]):
        take = better(score[:, k], acts[:, k], best, bidx)
        best = np.where(take, score[:, k], best)
        bidx = np.where(take, acts[:, k], bidx)
    return best, bidx


def butterfly(best, bidx):
    """The kernel's five xor-shuffle steps of the (score, index) argmax."""
    lane = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        ob, oi = best[lane ^ off], bidx[lane ^ off]
        take = better(ob, oi, best, bidx)
        best, bidx = np.where(take, ob, best), np.where(take, oi, bidx)
    assert (bidx == bidx[0]).all()   # every lane holds the winner
    return int(bidx[0])


def warp_argmax(score, acts):
    """The kernel's argmax over lanes(score) [32, 4J] with actions
    `acts`: each lane's own best, then the butterfly."""
    return butterfly(*lane_best(score, acts))


def warp_sum(x):
    """lanes(x) [32, 4J] summed in the kernel's order: per lane, then five
    xor-shuffle steps; every lane's total."""
    total = np.zeros(LANES, np.float32)
    for k in range(x.shape[1]):
        total = total + x[:, k]
    lane = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        total = total + total[lane ^ off]
    return total


def visited_score(nk, wk, pk, a, num_actions, c_puct, forced_k, depth,
                  sqrt_ns, ns_m1):
    """The exact score of one visited action as the kernel computes it:
    the plain formula, with a zero dividend over a positive divisor kept
    instead of divided."""
    f32, one = np.float32, np.float32(1.0)
    legal = pk >= 0 and a < num_actions
    pp = max(pk, f32(0.0))
    q = (wk if wk == 0 else wk / max(nk, one)) if nk > 0 else f32(0.0)
    xu, du = c_puct * pp * sqrt_ns, one + nk
    u = xu if xu == 0 and du > 0 else xu / du
    if legal and depth == 0 and nk > 0 and nk * nk < forced_k * pp * ns_m1:
        return f32(np.inf)
    return f32(q + u) if legal else f32(-np.inf)


def emulate_kernel(packed, num_actions, depth_limit, c_puct, forced_k):
    """csrc/select.cu's descent in numpy f32, one env (warp) at a time."""
    f32 = np.float32
    e, _, _, a_pad = packed.shape
    c_puct, forced_k, one = f32(c_puct), f32(forced_k), f32(1.0)
    inf = f32(np.inf)
    rng = np.random.default_rng(a_pad)

    def jitter():
        return rng.uniform(-2.0 ** -21, 2.0 ** -21, (LANES, a_pad // LANES))

    acts = lanes(np.arange(a_pad))
    leaf, act_out, depth_out = (np.zeros(e, np.int32) for _ in range(3))
    pn = np.zeros((e, depth_limit), np.int32)
    pa = np.zeros((e, depth_limit), np.int32)
    for env in range(e):
        cur, depth, act, stopped = 0, 0, -1, False
        for _ in range(depth_limit):
            row = packed[env, cur]
            n, w, p, c = (lanes(row[k]) for k in (ps.SEC_N, ps.SEC_W,
                                                   ps.SEC_P, ps.SEC_CHILD))
            ns = one + warp_sum(n)
            sqrt_ns, ns_m1 = np.sqrt(ns)[:, None], (ns - one)[:, None]
            # every slot's score: exact where no division is needed, else
            # approximate within a margin (here the exact quotients off by
            # up to 4 ulp, where the kernel's rcp.approx errs by 1); a slot
            # that cannot reach the lane's best lower bound is dropped, the
            # other visited ones are scored exactly
            legal = (p >= 0) & (acts < num_actions)
            pp = np.maximum(p, f32(0.0))
            x = c_puct * pp * sqrt_ns
            forced = (legal & (depth == 0) & (n > 0)
                      & (n * n < forced_k * pp * ns_m1))
            approx = legal & ~forced & (n != 0)
            with np.errstate(all="ignore"):
                qa = (w / n * (one + jitter())).astype(f32)
                ua = (x / (one + n) * (one + jitter())).astype(f32)
                sa = qa + ua
                ma = f32(2.0 ** -16) * (np.abs(qa) + np.abs(ua)) \
                    + f32(2.0 ** -120)
                sane = (n >= 1) & (n < 2 ** 24) & np.isfinite(ma)
                sv = np.where(~legal, -inf, np.where(
                    forced, inf, np.where(approx, sa, x))).astype(f32)
                mv = np.where(approx, np.where(sane, ma, inf), f32(0.0))
                lo = np.where(~approx, sv, np.where(
                    sane, np.nextafter(sa - ma, -inf), -inf))
                hi = np.nextafter(sv + mv, inf)
            lower = lo.max(axis=1, keepdims=True)
            verify = (mv != 0) & ~(hi < lower)
            best, bidx = lane_best(np.where(mv == 0, sv, -inf), acts)
            for lane, k in zip(*np.nonzero(verify)):
                a = acts[lane, k]
                sc = visited_score(n[lane, k], w[lane, k], p[lane, k], a,
                                   num_actions, c_puct, forced_k, depth,
                                   sqrt_ns[lane, 0], ns_m1[lane, 0])
                if better(sc, a, best[lane], bidx[lane]):
                    best[lane], bidx[lane] = sc, a
            bi = butterfly(best, bidx)
            holder, k = (bi % 128) // 4, (bi // 128) * 4 + bi % 4
            assert acts[holder, k] == bi
            ch = int(c[holder, k])   # the shuffle from the holding lane
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


def assert_same(packed, a, d, c_puct, forced_k):
    want = [np.asarray(x) for x in jps.select_batch(
        jnp.asarray(packed), a, d, c_puct, forced_k, interpret=True)]
    got = ps.select_batch(torch.from_numpy(packed), a, d, c_puct, forced_k)
    # CPU tensors never launch the kernel
    assert trace.snapshot()["counters"].get("select_launches", 0) == 0
    emulated = emulate_kernel(packed, a, d, c_puct, forced_k)
    for name, g, w, k in zip(("leaf", "act", "depth", "pn", "pa"), got,
                             want, emulated):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(k, w, err_msg=f"emulated {name}")
    return want


@pytest.mark.parametrize("seed,a,nn,d,e", [
    pytest.param(0, 25, 24, 24, 5, id="0-25-24-24"),
    pytest.param(1, 49, 40, 40, 5, id="1-49-40-40"),
    pytest.param(2, 144, 32, 16, 5, id="2-144-32-16"),
    pytest.param(8, 225, 40, 24, 1, id="E1-225-40-24"),
    pytest.param(9, 361, 32, 24, 3, id="a361-Apad384")])
def test_random_trees(seed, a, nn, d, e):
    packed = make_tree(seed, e, nn, a)
    leaf, act, depth, pn, pa = assert_same(packed, a, d, 5.0, 0.0)
    assert (depth > 0).any()
    # path entries are zero beyond each env's depth
    beyond = np.arange(d)[None, :] >= depth[:, None]
    assert not pn[beyond].any() and not pa[beyond].any()


def test_ties_take_the_lowest_action():
    packed = make_tree(3, 3, 4, 25, expanded=1, uniform=True)
    leaf, act, depth, _, pa = assert_same(packed, 25, 4, 5.0, 0.0)
    assert (act == 0).all() and (depth == 1).all() and (pa[:, 0] == 0).all()


def test_pad_lanes_stay_illegal():
    """Pad lanes carrying p = 0 would score 0 and beat legal moves whose Q
    is strongly negative, unless `lane < a` masks them."""
    packed = make_tree(4, 4, 16, 25, expanded=1, uniform=True, pad_p=0.0)
    packed[:, 0, ps.SEC_N, :25] = 4.0
    packed[:, 0, ps.SEC_W, :25] = -12.0
    packed[1, 0, ps.SEC_W, 7] = -11.0     # env 1's best move is 7
    _, act, _, _, pa = assert_same(packed, 25, 16, 1.0, 0.0)
    assert act.tolist() == [0, 7, 0, 0] and (pa < 25).all()


def test_terminal_root_revisits():
    packed = make_tree(5, 4, 16, 25, terminal_root=(0, 2))
    leaf, act, depth, pn, pa = assert_same(packed, 25, 16, 5.0, 0.0)
    for env in (0, 2):
        assert (leaf[env], act[env], depth[env]) == (0, -1, 0)
        assert not pn[env].any() and not pa[env].any()


@pytest.mark.parametrize("d", [1, 3])
def test_depth_cap_exits(d):
    """Long chains: descents that never stop are depth-capped revisits of
    the node they reached, with a full path of d edges."""
    packed = make_tree(6, 4, 12, 25, chain=True, terminal_p=0.0,
                       w_bias=1.0)
    # send every env down the chain: its edges get overwhelming priors
    for env in range(4):
        for k in range(11):
            ch = packed[env, k, ps.SEC_CHILD, :25]
            packed[env, k, ps.SEC_P, :25] = np.where(
                ch >= 0, 1.0, np.minimum(packed[env, k, ps.SEC_P, :25],
                                         0.0))
    leaf, act, depth, pn, _ = assert_same(packed, 25, d, 5.0, 0.0)
    assert (act == -1).all() and (depth == d).all()
    assert (leaf == d).all() and (pn[:, :d] == np.arange(d)).all()


def test_forced_playouts_gate():
    """With forced_k > 0 a visited root child still owed forced visits
    scores +inf; the outputs change against forced_k = 0."""
    packed = make_tree(7, 6, 24, 25)
    # root: one heavily visited favourite, the other children few visits
    packed[:, 0, ps.SEC_N, :25] = np.where(
        packed[:, 0, ps.SEC_CHILD, :25] >= 0, 1.0, 0.0)
    packed[:, 0, ps.SEC_N, 0] = 60.0
    plain = assert_same(packed, 25, 24, 5.0, 0.0)
    forced = assert_same(packed, 25, 24, 5.0, 2.0)
    assert (plain[1] != forced[1]).any() or (plain[0] != forced[0]).any()


def test_wrapper_checks_and_other_devices():
    packed = torch.zeros((2, 4, ps.NUM_SEC, 128))
    with pytest.raises(RuntimeError, match="meta"):
        ps.select_batch(packed.to("meta"), 25, 4, 5.0)
    with pytest.raises(ValueError):
        ps._check(torch.zeros((2, 4, 5, 128)), 25, 4)
    with pytest.raises(ValueError):
        ps._check(packed, 200, 4)   # A_pad must be pad_actions(A)
    with pytest.raises(ValueError):
        ps._check(packed, 25, 5)    # depth beyond the tree
    with pytest.raises(TypeError):
        ps._check(packed.double(), 25, 4)


def test_cpu_calls_check_the_kernel_contract():
    """select_batch checks the tree on the CPU too, before the plain
    version runs, so CPU callers meet the contract the kernel enforces."""
    packed = torch.from_numpy(make_tree(10, 2, 8, 25))
    ps.select_batch(packed, 25, 8, 5.0)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((2, 8, ps.NUM_SEC, 256))
        ps.select_batch(wide[..., ::2], 25, 8, 5.0)
    with pytest.raises(ValueError, match="A_pad"):
        ps.select_batch(torch.zeros((2, 8, ps.NUM_SEC, 256)), 25, 8, 5.0)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(packed.numel() + 1)
        ps.select_batch(flat[1:].view(packed.shape), 25, 8, 5.0)
    assert trace.snapshot()["counters"].get("select_launches", 0) == 0


TIE_A_PADS = (128, 256, 384, 1024)


def tie_rows(a_pad, seed):
    """Rows of scores that tie: all equal, all +inf (forced), all -inf
    (illegal), a maximum tied across lanes within a chunk, across chunks
    j, and random rows of three values."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rows = [np.zeros(a_pad, f32), np.full(a_pad, np.inf, f32),
            np.full(a_pad, -np.inf, f32)]
    r = rng.standard_normal(a_pad).astype(f32)
    r[[4 * 29 + 3, 4 * 7 + 1, 4 * 18 + 2]] = 9.0   # lanes 29, 7, 18 of j 0
    rows.append(r)
    r = np.full(a_pad, -np.inf, f32)
    r[[a_pad - 1, a_pad - 128 + 5]] = 2.0            # the last chunk only
    if a_pad > 128:
        r[4 * 31 + 3 + 128] = 2.0                    # lane 31, chunk 1
    rows.append(r)
    for _ in range(4):
        rows.append(rng.integers(0, 3, a_pad).astype(f32))
        rows.append(np.where(rng.random(a_pad) < 0.5, f32(-np.inf),
                             rng.integers(0, 2, a_pad).astype(f32)))
    return rows


@pytest.mark.parametrize("a_pad", TIE_A_PADS)
def test_warp_argmax_takes_the_first_maximum(a_pad):
    acts = lanes(np.arange(a_pad))
    assert sorted(acts.ravel().tolist()) == list(range(a_pad))
    for k, row in enumerate(tie_rows(a_pad, seed=a_pad)):
        assert warp_argmax(lanes(row), acts) == int(np.argmax(row)), k


def test_unvisited_score_needs_no_division():
    """With N = 0 the plain score Q + U is 0 + c P sqrt(ns) / 1, which is
    c P sqrt(ns) bit for bit: the kernel skips both divisions there."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    p = rng.random(4096).astype(f32)
    p[:8] = [0.0, 1.0, 1e-30, 1e-45, 0.5, 3e-8, 1.0 - 2 ** -24, 2 ** -20]
    ns = f32(1.0) + rng.integers(0, 1 << 23, 4096).astype(f32)
    n = np.zeros(4096, f32)
    for c_puct in (f32(5.0), f32(1.25), f32(0.3)):
        u = c_puct * p * np.sqrt(ns)
        full = f32(0.0) + u / (f32(1.0) + n)   # Q + U at N = 0
        assert np.array_equal(full.view(np.int32), u.view(np.int32))


def test_zero_dividends_keep_their_sign():
    """The kernel keeps a zero dividend over a positive divisor instead of
    dividing (W = 0 over max(N, 1); c P sqrt(ns) = 0 over 1 + N): IEEE
    gives that zero, sign included."""
    f32 = np.float32
    d = np.array([1.0, 1.5, 3.0, 400.0, 2.0 ** 23, np.inf], f32)
    for zero in (f32(0.0), f32(-0.0)):
        q = np.full_like(d, zero) / d
        assert np.array_equal(q.view(np.int32),
                              np.full_like(d, zero).view(np.int32))


@pytest.mark.parametrize("a_pad", TIE_A_PADS)
def test_warp_sum_is_exact_on_visit_counts(a_pad):
    """Integer-valued counts below 2^24 sum exactly in any order: every
    lane's total equals the plain sum."""
    rng = np.random.default_rng(a_pad)
    n = rng.integers(0, 1 << 14, a_pad).astype(np.float32)
    total = warp_sum(lanes(n))
    assert (total == np.float32(n.astype(np.int64).sum())).all()
