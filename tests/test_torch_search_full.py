"""Full-width and packed-tree search: the torch port against the JAX
package and the NumPy oracle.

Both sides search the same positions with the same frozen dyadic
evaluator (tests/test_torch_search.py): logits, values and every value
sum are exact in f32, so any difference in the visits is a difference in
the search. Root noise is drawn with the JAX package's own functions from
the key the JAX search splits, and handed to the port as ``noise=``.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import MCTSConfig as JMCTSConfig
from alphafive_tpu.mcts import reference
from alphafive_tpu.mcts import search as jsearch
from alphafive_tpu.mcts.search_packed import run_mcts_packed as j_packed
from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import search
from alphafive_tpu_torch.mcts.search_packed import run_mcts_packed
from alphafive_tpu_torch.ops import select as ps
from alphafive_tpu_torch.utils import trace
from test_torch_search import (frozen_weights, jax_frozen_evaluator,
                               jax_state, torch_frozen_evaluator)

torch.set_num_threads(1)


def jax_noise(key, state, alpha):
    """The Dirichlet draw the JAX search makes from `key`."""
    _, knoise, _ = jax.random.split(key, 3)
    legal = jnp.asarray(state.board.numpy() == 0)
    return torch.tensor(np.asarray(
        jsearch.dirichlet_noise(knoise, alpha, legal)))


def play_and_compare(run_j, run_t, env_t, st, plies, sims):
    for ply in range(plies):
        key = jax.random.key(ply)
        rj = run_j(jax_state(st), key)
        rt = run_t(st, key)
        vj = np.asarray(rj.visits)
        np.testing.assert_array_equal(rt.visits.numpy(), vj,
                                      err_msg=f"ply {ply}")
        assert (vj.sum(-1) == sims).all()
        np.testing.assert_allclose(rt.root_value.numpy(),
                                   np.asarray(rj.root_value), atol=1e-6)
        np.testing.assert_allclose(rt.priors.numpy(), np.asarray(rj.priors),
                                   rtol=1e-6, atol=1e-7)
        st = vector.step(env_t, st, torch.from_numpy(
            vj.argmax(-1).astype(np.int32)))
        st = vector.reset_where(env_t, st, st.done)


FULL_CASES = list(itertools.product((1, 4, 8), ("path", "root"),
                                    ("int16", "float32"),
                                    ("bfloat16", "float32")))


@pytest.mark.parametrize("lb,mode,vdt,pdt", FULL_CASES)
def test_full_width_matches_jax(lb, mode, vdt, pdt):
    """Noisy search with forced playouts and a depth cap, every leaf-batch
    and virtual-visit mode and both storage types of W and P."""
    size, sims, e = 5, 24, 3
    kw = dict(num_simulations=sims, leaf_batch=lb, virtual_mode=mode,
              value_dtype=vdt, prior_dtype=pdt, max_depth=12,
              forced_playouts_k=2.0)
    env_j, env_t = (JEnvConfig(board_size=size, n_in_row=4),
                    EnvConfig(board_size=size, n_in_row=4))
    w_l, w_v = frozen_weights(size * size, seed=lb)
    cfg_j, cfg_t = JMCTSConfig(**kw), MCTSConfig(**kw)
    run_j = jax.jit(functools.partial(
        jsearch.run_mcts, env_j, cfg_j, jax_frozen_evaluator(w_l, w_v)))
    ev_t = torch_frozen_evaluator(w_l, w_v)

    def run_t(st, key):
        return search.run_mcts(env_t, cfg_t, ev_t, st,
                               noise=jax_noise(key, st, cfg_t.dirichlet_alpha))

    play_and_compare(run_j, run_t, env_t, vector.init(env_t, e, "cpu"), 2,
                     sims)


# ---------------------------------------------------------------------------
# the NumPy oracle (as tests/test_mcts.py::test_visit_count_parity)
# ---------------------------------------------------------------------------

def _int_weights(size):
    return (np.arange(size * size) % 5 - 2).astype(np.int64)


def np_eval(size):
    weights = _int_weights(size)

    def evaluate(board, to_play, last):
        s = int(np.sum(board.astype(np.int64) * weights))
        return (np.zeros(size * size, np.float32),
                np.float32((s % 7) - 3) / np.float32(8))
    return evaluate


def torch_int_eval(size):
    weights = torch.from_numpy(_int_weights(size))

    def evaluate(board, to_play, last):
        s = (board.long() * weights).sum(-1)
        v = ((s % 7) - 3).float() / 8.0
        return torch.zeros((board.shape[0], size * size)), v
    return evaluate


@pytest.mark.parametrize("size,n_in_row,sims,plies", [
    (5, 4, 60, 0), (5, 4, 60, 8), (5, 4, 120, 18), (9, 5, 50, 10)])
def test_full_width_matches_oracle(size, n_in_row, sims, plies):
    from tests.test_mcts import random_midgame
    games = [random_midgame(size, n_in_row, plies, seed)
             for seed in (1, 2, 3, 4)]
    env_t = EnvConfig(board_size=size, n_in_row=n_in_row)
    st = vector.EnvState(
        board=torch.from_numpy(np.stack([g.board.reshape(-1)
                                         for g in games]).astype(np.int8)),
        to_play=torch.tensor([g.to_play for g in games], dtype=torch.int8),
        last_move=torch.tensor([g.last_move for g in games],
                               dtype=torch.int32),
        move_count=torch.tensor([g.move_count for g in games],
                                dtype=torch.int32),
        done=torch.zeros(4, dtype=torch.bool),
        winner=torch.zeros(4, dtype=torch.int8))
    cfg = MCTSConfig(num_simulations=sims, c_puct=5.0)
    res = search.run_mcts(env_t, cfg, torch_int_eval(size), st,
                          add_noise=False)
    for i, g in enumerate(games):
        ref_n, ref_v = reference.run_mcts_reference(
            g, np_eval(size), sims, c_puct=5.0, root_noise=None)
        np.testing.assert_array_equal(res.visits[i].numpy(), ref_n,
                                      err_msg=f"env {i}")
        np.testing.assert_allclose(res.root_value[i].item(), ref_v,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# packed-tree search (as tests/test_pallas_select.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,sims,plies,max_depth,noise", [
    (5, 24, 3, None, False), (7, 40, 3, None, False), (5, 32, 2, 4, True)])
def test_packed_matches_jax(size, sims, plies, max_depth, noise):
    kw = dict(num_simulations=sims, max_depth=max_depth,
              select_impl="pallas", forced_playouts_k=1.5)
    env_j, env_t = (JEnvConfig(board_size=size, n_in_row=4),
                    EnvConfig(board_size=size, n_in_row=4))
    w_l, w_v = frozen_weights(size * size, seed=size)
    cfg_t = MCTSConfig(**kw)
    run_j = jax.jit(functools.partial(
        j_packed, env_j, JMCTSConfig(**kw), jax_frozen_evaluator(w_l, w_v),
        add_noise=noise, interpret=True))
    ev_t = torch_frozen_evaluator(w_l, w_v)

    def run_t(st, key):
        # through the run_mcts dispatch, as a caller reaches it
        nz = jax_noise(key, st, cfg_t.dirichlet_alpha) if noise else None
        return search.run_mcts(env_t, cfg_t, ev_t, st, add_noise=noise,
                               noise=nz)

    play_and_compare(run_j, run_t, env_t, vector.init(env_t, 4, "cpu"), plies,
                     sims)
    assert trace.snapshot()["counters"].get("select_launches", 0) == 0


def test_packed_equals_full_width_in_f32():
    """The packed tree stores f32 whatever the config says, so it equals
    the full-width search at leaf_batch 1 only with f32 priors and values
    (and may differ under bf16/int16, which it ignores)."""
    env = EnvConfig(board_size=7, n_in_row=4)
    ev = torch_frozen_evaluator(*frozen_weights(49, seed=11))
    st = vector.init(env, 3, "cpu")
    for _ in range(4):
        st = vector.step(env, st, torch.randint(
            0, 49, (3,), generator=torch.Generator().manual_seed(
                int(st.move_count[0]))).int())
    cfg = MCTSConfig(num_simulations=48, max_depth=16)
    full = search.run_mcts(env, cfg, ev, st, add_noise=False)
    res, tree = run_mcts_packed(env, cfg, ev, st, add_noise=False,
                                return_tree=True)
    np.testing.assert_array_equal(res.visits.numpy(), full.visits.numpy())
    np.testing.assert_allclose(res.root_value.numpy(),
                               full.root_value.numpy(), atol=1e-6)
    assert tree.packed.shape == (3, 49, ps.NUM_SEC, 128)
    # the root's visits are the sum of its children's edges
    assert (tree.packed[:, 0, ps.SEC_N].sum(-1) == 48).all()


def test_done_roots_search_as_revisits():
    """A finished game's root is terminal: every descent revisits it at
    depth 0, so its edges get no visits and nothing is expanded."""
    env = EnvConfig(board_size=5, n_in_row=4)
    ev = torch_frozen_evaluator(*frozen_weights(25, seed=2))
    st = vector.init(env, 2, "cpu")
    # env 0: black wins on the top row; env 1: no line of four
    for a, b in zip((0, 5, 1, 6, 2, 7, 3), (12, 0, 18, 4, 6, 24, 20)):
        st = vector.step(env, st, torch.tensor([a, b], dtype=torch.int32))
    assert bool(st.done[0]) and not bool(st.done[1])
    cfg = MCTSConfig(num_simulations=16, select_impl="pallas")
    res, tree = run_mcts_packed(env, cfg, ev, st, add_noise=False,
                                return_tree=True)
    assert res.visits[0].sum() == 0 and res.visits[1].sum() == 16
    assert (tree.packed[0, 0, ps.SEC_CHILD] < 0).all()


def test_dispatch_raises_like_jax():
    env = EnvConfig(board_size=5, n_in_row=4)
    st = vector.init(env, 1, "cpu")
    ev = torch_frozen_evaluator(*frozen_weights(25, 0))
    with pytest.raises(ValueError):
        search.run_mcts(env, MCTSConfig(num_simulations=8, branch_cap=8,
                                        select_impl="pallas"), ev, st)
    with pytest.raises(ValueError):
        search.run_mcts(env, MCTSConfig(num_simulations=8, leaf_batch=8,
                                        select_impl="pallas"), ev, st)
    big = dataclasses.replace(MCTSConfig(), num_simulations=40_000)
    with pytest.raises(ValueError):
        search.run_mcts(env, big, ev, st)
