"""The replay ring and the dihedral symmetry tables: the torch port
against the JAX package. Entries are made from a numpy seed; sampling
draws its indices and symmetries the way the JAX sampler draws them from
its key, and hands them to the port as ``idx=``/``sym=``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import ReplayConfig as JReplayConfig
from alphafive_tpu.replay import buffer as jbuffer
from alphafive_tpu.utils import symmetry as jsymmetry
from alphafive_tpu_torch.config import EnvConfig, ReplayConfig
from alphafive_tpu_torch.replay import buffer
from alphafive_tpu_torch.utils import symmetry

torch.set_num_threads(1)

SIZE = 5
ENV, JENV = (EnvConfig(board_size=SIZE, n_in_row=4),
             JEnvConfig(board_size=SIZE, n_in_row=4))


def entries(m, seed=0):
    """numpy (board, to_play, last, pi, z, z_valid, pi_valid)."""
    rng = np.random.default_rng(seed)
    a = SIZE * SIZE
    pi = rng.random((m, a)).astype(np.float32)
    return (rng.integers(-1, 2, size=(m, a)).astype(np.int8),
            rng.choice([1, -1], size=(m,)).astype(np.int8),
            rng.integers(-1, a, size=(m,)).astype(np.int32),
            pi / pi.sum(-1, keepdims=True),
            rng.choice([-1, 0, 1], size=(m,)).astype(np.int8),
            rng.random(m) > 0.3, rng.random(m) > 0.5)


def both_rings(capacity, chunks):
    """The same chunks written into a JAX ring and a port ring."""
    bj = jbuffer.init(JENV, JReplayConfig(capacity=capacity))
    bt = buffer.init(ENV, ReplayConfig(capacity=capacity), device="cpu")
    for ch in chunks:
        bj = jbuffer.write(bj, *map(jnp.asarray, ch))
        buffer.write(bt, *map(torch.from_numpy, ch))
    return bj, bt


@pytest.mark.parametrize("size", [9, 15, 19])
def test_dihedral_tables_match_jax(size):
    perm, inv = symmetry.dihedral_tables(size)
    jperm, jinv = jsymmetry.dihedral_tables(size)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    assert symmetry.NUM_SYMMETRIES == jsymmetry.NUM_SYMMETRIES == 8


def test_symmetry_index_matches_field():
    """apply_symmetry_index maps a one-hot's hot cell where apply_symmetry
    maps the field, -1 passes through, and both equal JAX's."""
    size, n = 6, 16
    rng = np.random.default_rng(3)
    idx = rng.integers(0, size * size, size=(n,)).astype(np.int32)
    idx[0] = -1
    ks = rng.integers(0, symmetry.NUM_SYMMETRIES, size=(n,))
    field = rng.random((n, size * size)).astype(np.float32)
    field[np.arange(n), np.maximum(idx, 0)] = 2.0   # the hot cell
    f = symmetry.apply_symmetry(size, torch.from_numpy(ks),
                                torch.from_numpy(field))
    mapped = symmetry.apply_symmetry_index(size, torch.from_numpy(ks),
                                           torch.from_numpy(idx))
    assert mapped.dtype == torch.int32 and int(mapped[0]) == -1
    np.testing.assert_array_equal(f.argmax(-1)[1:].numpy(),
                                  mapped[1:].numpy())
    np.testing.assert_array_equal(f.numpy(), np.asarray(
        jsymmetry.apply_symmetry(size, jnp.asarray(ks), jnp.asarray(field))))
    np.testing.assert_array_equal(mapped.numpy(), np.asarray(
        jsymmetry.apply_symmetry_index(size, jnp.asarray(ks),
                                       jnp.asarray(idx))))


def test_write_fill_and_wrap_match_jax():
    bj, bt = both_rings(10, [entries(6), entries(6, seed=1)])
    assert (bt.size, bt.ptr) == (int(bj.size), int(bj.ptr)) == (10, 2)
    for name in ("board", "to_play", "last_move", "pi", "z", "z_valid",
                 "pi_valid"):
        np.testing.assert_array_equal(
            getattr(bt, name).float().numpy(),
            np.asarray(getattr(bj, name)).astype(np.float32), err_msg=name)
    assert bt.pi.dtype == torch.bfloat16
    # pi_valid defaults to all-true
    buffer.write(bt, *map(torch.from_numpy, entries(3, seed=2)[:6]))
    assert bool(bt.pi_valid[2:5].all()) and (bt.size, bt.ptr) == (10, 5)
    with pytest.raises(ValueError):
        buffer.write(bt, *map(torch.from_numpy, entries(11)))


def test_sample_matches_jax():
    """For the JAX sampler's own indices and symmetries, every output is
    equal: features of the transformed board, π, z and the flags."""
    bj, bt = both_rings(40, [entries(30, seed=4)])
    key = jax.random.key(7)
    kidx, ksym = jax.random.split(key)
    idx = jax.random.randint(kidx, (64,), 0, jnp.maximum(bj.size, 1))
    sym = jax.random.randint(ksym, (64,), 0, jsymmetry.NUM_SYMMETRIES)
    want = jbuffer.sample(JENV, bj, key, 64)
    got = buffer.sample(ENV, bt, 64, idx=torch.tensor(np.asarray(idx)),
                        sym=torch.tensor(np.asarray(sym)))
    for g, w, name in zip(got, want, ("features", "pi", "z", "z_valid",
                                      "pi_valid")):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].shape == (64, SIZE, SIZE, 4)


def test_sample_features_of_the_transformed_board():
    """Each sampled example's features equal ``vector.features`` of its
    stored board turned by numpy (k mod 4 quarter turns of the board,
    mirrored first for k >= 4), its last move turned the same way, and
    its π turned with the board."""
    from alphafive_tpu_torch.env import vector
    _, bt = both_rings(40, [entries(30, seed=5)])
    idx = torch.arange(16) % 30
    sym = torch.arange(16) % symmetry.NUM_SYMMETRIES
    feats, pi, _, _, _ = buffer.sample(ENV, bt, 16, idx=idx, sym=sym)
    board, to_play, last, pi_np = entries(30, seed=5)[:4]
    turn = lambda x, k: np.rot90(np.fliplr(x) if k >= 4 else x, k % 4)
    for j, (i, k) in enumerate(zip(idx.tolist(), sym.tolist())):
        b = turn(board[i].reshape(SIZE, SIZE), k).reshape(1, -1)
        hot = np.zeros((SIZE, SIZE), np.int32)
        if last[i] >= 0:
            hot.flat[last[i]] = 1
        lm = (int(turn(hot, k).argmax()) if last[i] >= 0 else -1)
        want = vector.features(ENV, torch.from_numpy(b.copy()),
                               torch.tensor([to_play[i]]),
                               torch.tensor([lm], dtype=torch.int32))
        assert torch.equal(feats[j:j + 1], want), (i, k)
        want_pi = turn(pi_np[i].reshape(SIZE, SIZE), k).reshape(-1)
        np.testing.assert_array_equal(
            pi[j].numpy(),
            torch.from_numpy(want_pi.copy()).bfloat16().float().numpy())


def test_sample_generator_and_symmetry_consistency():
    """Drawn samples come from the filled prefix only; π keeps its mass
    and stays off the stones of the transformed board, and the last-move
    plane marks the one stone each entry has."""
    m, a = 10, SIZE * SIZE
    board = np.zeros((m, a), np.int8)
    last = np.arange(m, dtype=np.int32)
    board[np.arange(m), last] = 1
    pi = np.tile(np.arange(a, dtype=np.float32)[None], (m, 1))
    pi[np.arange(m), last] = 0.0
    pi /= pi.sum(-1, keepdims=True)
    bt = buffer.init(ENV, ReplayConfig(capacity=50), device="cpu")
    buffer.write(bt, torch.from_numpy(board), torch.full((m,), -1,
                                                         dtype=torch.int8),
                 torch.from_numpy(last), torch.from_numpy(pi),
                 torch.ones(m, dtype=torch.int8), torch.ones(m, dtype=bool))
    got = buffer.sample(ENV, bt, 32, torch.Generator().manual_seed(0))
    feats, spi, z, zv, _ = got
    assert (z == 1).all() and (zv == 1).all()   # never past the prefix
    np.testing.assert_allclose(spi.sum(-1).numpy(), 1.0, atol=5e-3)
    stones = (feats[..., 0] + feats[..., 1]).reshape(32, -1)
    assert (spi[stones > 0] == 0).all()
    opp, lastp = (feats[..., i].reshape(32, -1) for i in (1, 2))
    assert (opp.sum(-1) == 1).all() and torch.equal(opp, lastp)
    again = buffer.sample(ENV, bt, 32, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(again, got))
