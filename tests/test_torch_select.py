"""PUCT descent over a packed tree: the port's plain version against the
Pallas kernel.

On the CPU ``select_batch`` runs ``select_batch_reference``; the JAX side
runs ``pallas_select.select_batch`` in interpret mode. Trees are built
with numpy (random parents, child links, visit counts and value sums), and
the five outputs must be exactly equal. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.ops import pallas_select as jps
from alphafive_tpu_torch.ops import select as ps

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


def assert_same(packed, a, d, c_puct, forced_k):
    want = [np.asarray(x) for x in jps.select_batch(
        jnp.asarray(packed), a, d, c_puct, forced_k, interpret=True)]
    got = ps.select_batch(torch.from_numpy(packed), a, d, c_puct, forced_k)
    assert ps.select_launches == 0  # CPU tensors never launch the kernel
    for name, g, w in zip(("leaf", "act", "depth", "pn", "pa"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return want


@pytest.mark.parametrize("seed,a,nn,d", [(0, 25, 24, 24), (1, 49, 40, 40),
                                          (2, 144, 32, 16)])
def test_random_trees(seed, a, nn, d):
    packed = make_tree(seed, 5, nn, a)
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
