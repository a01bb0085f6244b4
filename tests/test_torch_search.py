"""Branch-capped search: the torch port against the JAX package.

Both sides search the same positions with the same frozen linear
evaluator, built from numpy weights. The weights are dyadic (integers / 16)
and the value is a clipped linear function instead of tanh, so logits,
values and every value sum are exact in f32 in both frameworks whatever
the summation order: a near-tied PUCT argmax cannot flip on float noise,
and any difference in the visits is a difference in the search.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import MCTSConfig as JMCTSConfig
from alphafive_tpu.env import vector as jvector
from alphafive_tpu.mcts.search_capped import run_mcts_capped as j_run
from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import search
from alphafive_tpu_torch.mcts.search_capped import _stages, run_mcts_capped

torch.set_num_threads(1)


def frozen_weights(a, seed):
    rng = np.random.default_rng(seed)
    w_l = (rng.integers(-12, 13, size=(a, a)) / 16).astype(np.float32)
    w_v = (rng.integers(-3, 4, size=(a,)) / 16).astype(np.float32)
    return w_l, w_v


def jax_frozen_evaluator(w_l, w_v):
    wl, wv = jnp.asarray(w_l), jnp.asarray(w_v)

    def evaluate(board, to_play, last, key):
        del last, key
        x = board.astype(jnp.float32) * to_play[:, None].astype(jnp.float32)
        return x @ wl, jnp.clip(x @ wv, -1.0, 1.0)

    return evaluate


def torch_frozen_evaluator(w_l, w_v):
    wl, wv = torch.from_numpy(w_l), torch.from_numpy(w_v)

    def evaluate(board, to_play, last):
        del last
        x = board.float() * to_play[:, None].float()
        return x @ wl, torch.clamp(x @ wv, -1.0, 1.0)

    return evaluate


def jax_state(st):
    return jvector.EnvState(**{f.name: jnp.asarray(getattr(st, f.name).numpy())
                               for f in dataclasses.fields(st)})


CASES = [
    # (size, sims, leaf_batch, branch_cap, value_dtype, prior_dtype)
    (7, 32, 8, 16, "int16", "bfloat16"),   # the chip_15x15 modes, c < A
    (7, 32, 1, 49, "int16", "float32"),    # packed, sequential, c == A
    (5, 24, 8, 25, "float32", "float32"),  # f32 stats, c == A
    (7, 32, 4, 12, "float32", "bfloat16"),  # f32 stats, binding cap
]


@pytest.mark.parametrize("size,sims,lb,cap,vdt,pdt", CASES)
def test_capped_search_matches_jax(size, sims, lb, cap, vdt, pdt):
    e, plies = 4, 3
    kw = dict(num_simulations=sims, leaf_batch=lb, branch_cap=cap,
              max_depth=16, value_dtype=vdt, prior_dtype=pdt)
    env_j, env_t = (JEnvConfig(board_size=size, n_in_row=4),
                    EnvConfig(board_size=size, n_in_row=4))
    w_l, w_v = frozen_weights(size * size, seed=size + lb)
    run_j = jax.jit(functools.partial(
        j_run, env_j, JMCTSConfig(**kw), jax_frozen_evaluator(w_l, w_v),
        add_noise=False))
    ev_t = torch_frozen_evaluator(w_l, w_v)
    cfg_t = MCTSConfig(**kw)

    st = vector.init(env_t, e)
    for ply in range(plies):
        rj = run_j(jax_state(st), jax.random.key(ply))
        rt = run_mcts_capped(env_t, cfg_t, ev_t, st, add_noise=False)
        vj = np.asarray(rj.visits)
        np.testing.assert_array_equal(rt.visits.numpy(), vj,
                                      err_msg=f"ply {ply}")
        assert (vj.sum(-1) == sims).all()
        # value sums are exact (dyadic leaf values); only the last-bit
        # rounding of the final division may differ
        np.testing.assert_allclose(rt.root_value.numpy(),
                                   np.asarray(rj.root_value), atol=1e-6)
        act = torch.from_numpy(vj.argmax(-1).astype(np.int32))
        st = vector.step(env_t, st, act)
        st = vector.reset_where(env_t, st, st.done)


def test_depth_stages_match_jax_loop():
    """The staged pass loop covers every pass once, with the caps the JAX
    pass loop uses (8, doubling, ending at min(max_depth, passes))."""
    assert _stages(50, 64) == [(0, 8, 8), (8, 16, 16), (16, 32, 32),
                               (32, 50, 50)]
    assert _stages(4, 16) == [(0, 4, 4)]
    assert _stages(100, 64) == [(0, 8, 8), (8, 16, 16), (16, 32, 32),
                                (32, 100, 64)]


def test_unported_modes_raise():
    env = EnvConfig(board_size=5, n_in_row=4)
    st = vector.init(env, 1)
    ev = torch_frozen_evaluator(*frozen_weights(25, 0))
    with pytest.raises(NotImplementedError):
        search.run_mcts(env, MCTSConfig(num_simulations=8), ev, st)
    with pytest.raises(NotImplementedError):
        search.run_mcts(env, MCTSConfig(num_simulations=8, branch_cap=8,
                                        select_impl="pallas"), ev, st)
    with pytest.raises(ValueError):
        search.run_mcts(env, MCTSConfig(num_simulations=8, branch_cap=8,
                                        backup_interval=2), ev, st)


def test_masked_softmax_and_pi_match_jax():
    from alphafive_tpu.mcts import search as jsearch
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 25)).astype(np.float32)
    legal = rng.random((6, 25)) < 0.6
    legal[0] = False   # a row with no legal move returns zeros
    got = search.masked_softmax(torch.from_numpy(logits),
                                torch.from_numpy(legal)).numpy()
    want = np.asarray(jsearch.masked_softmax(jnp.asarray(logits),
                                             jnp.asarray(legal)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    visits = rng.integers(0, 9, size=(6, 25)).astype(np.float32)
    temp = np.array([1.0, 0.5, 1.0, 2.0, 1.0, 1.0], np.float32)
    greedy = np.array([False, False, True, False, True, False])
    got = search.pi_from_visits(torch.from_numpy(visits),
                                torch.from_numpy(temp),
                                torch.from_numpy(greedy)).numpy()
    want = np.asarray(jsearch.pi_from_visits(
        jnp.asarray(visits), jnp.asarray(temp), jnp.asarray(greedy)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_root_noise_and_top_c_ties():
    """A passed-in noise tensor is mixed exactly as JAX mixes its own
    draw, and uniform priors keep the lower actions in the capped root."""
    env = EnvConfig(board_size=5, n_in_row=4)
    cfg = MCTSConfig(num_simulations=8, leaf_batch=8, branch_cap=6,
                     dirichlet_eps=0.25)
    st = vector.init(env, 2)

    def uniform(board, to_play, last):
        return torch.zeros(board.shape, dtype=torch.float32), torch.zeros(
            board.shape[0])

    noise = torch.full((2, 25), 1 / 25.0)
    res = run_mcts_capped(env, cfg, uniform, st, noise=noise)
    np.testing.assert_allclose(res.priors.numpy(), 1 / 25.0, rtol=1e-6)
    # 8 sims over 6 equal-prior root slots = actions 0..5
    assert set(np.nonzero(res.visits.numpy()[0])[0]) <= set(range(6))
    g = torch.Generator().manual_seed(0)
    d = search.dirichlet_noise(g, 0.3, st.board == 0)
    np.testing.assert_allclose(d.sum(-1).numpy(), 1.0, rtol=1e-5)
