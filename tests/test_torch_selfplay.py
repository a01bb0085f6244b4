"""The slice as a whole: ``selfplay_chunk`` in the port against the JAX package.

A small copy of ``chip_15x15`` (7×7, four in a row, 32 sims, leaf_batch 8,
branch cap 16, depth cap 16, bf16 priors, int16 value sums) with Dirichlet
weight 0 and greedy moves from the first ply, so both sides are
deterministic: the noise is drawn but weighs nothing, and moves are the
visit argmax. 4 envs play 6 plies through both packages. The Gumbel root
runs the same copy with each ply's Gumbel table drawn by JAX and handed to
the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu import config as jconfig
from alphafive_tpu.env import vector as jvector
from alphafive_tpu.models.evaluator import net_evaluator as j_net_evaluator
from alphafive_tpu.train import actor as jactor
from alphafive_tpu_torch import config
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import gumbel
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.resnet import init_params
from alphafive_tpu_torch.train import actor

from test_torch_search import (frozen_weights, jax_frozen_evaluator,
                               torch_frozen_evaluator)

torch.set_num_threads(1)

E, PLIES = 4, 6


def small_chip(pkg):
    cfg = pkg.get_preset("chip_15x15")
    return cfg.replace(
        env=pkg.EnvConfig(board_size=7, n_in_row=4),
        net=pkg.NetConfig(blocks=1, channels=16, value_hidden=16,
                          compute_dtype="float32"),
        mcts=dataclasses.replace(cfg.mcts, num_simulations=32, leaf_batch=8,
                                 branch_cap=16, max_depth=16,
                                 dirichlet_eps=0.0, temperature_moves=0))


def run_both(ev_j, ev_t, seed=0):
    cj, ct = small_chip(jconfig), small_chip(config)
    fn = jax.jit(functools.partial(jactor.selfplay_chunk, cj.env, cj.mcts,
                                   ev_j, num_plies=PLIES))
    _, tj, sj = fn(jvector.init(cj.env, E), jax.random.key(seed))
    g = torch.Generator().manual_seed(seed)
    _, tt, st = actor.selfplay_chunk(ct.env, ct.mcts, ev_t,
                                     vector.init(ct.env, E, "cpu"), g,
                                     PLIES)
    return tj, sj, tt, st


def assert_trajectories_equal(tj, tt, pi_atol):
    for name in ("board", "to_play", "last_move", "z", "z_valid",
                 "pi_valid"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tt.pi.numpy(), np.asarray(tj.pi),
                               atol=pi_atol, rtol=0)
    np.testing.assert_allclose(tt.pi.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_selfplay_frozen_evaluator_bit_equal():
    a = 49
    rng = np.random.default_rng(5)
    w_l = (rng.integers(-12, 13, size=(a, a)) / 16).astype(np.float32)
    w_v = (rng.integers(-3, 4, size=(a,)) / 16).astype(np.float32)
    tj, sj, tt, st = run_both(jax_frozen_evaluator(w_l, w_v),
                              torch_frozen_evaluator(w_l, w_v))
    assert_trajectories_equal(tj, tt, pi_atol=1e-6)
    assert st.env_steps == int(sj.env_steps)
    assert st.games_finished == int(sj.games_finished)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_selfplay_converted_net(use_pallas):
    """Random 1-block/16-channel f32 net (numpy seed 0) converted to both
    packages. The JAX side runs ``apply_eval``; the port runs its fused
    forward (the main path's code, on its plain resblock here) or its
    batch-norm twin. Net outputs agree to ~1e-6, below the 1/64 value
    quantum and the bf16 prior rounding of the tree, so with this seed the
    visits and moves are bit-equal and π agrees to 1e-6."""
    cj, ct = small_chip(jconfig), small_chip(config)
    params, bs = init_params(ct.env, ct.net, seed=0)
    jp, jb = (jax.tree.map(jnp.asarray, t) for t in (params, bs))
    ev_j = j_net_evaluator(cj.env, cj.net, jp, jb)
    ev_t = net_evaluator(ct.env, dataclasses.replace(
        ct.net, use_pallas=use_pallas), params, bs, "cpu")
    tj, _, tt, _ = run_both(ev_j, ev_t)
    assert_trajectories_equal(tj, tt, pi_atol=1e-6)


def jax_gumbel_tables(seed, plies, e, a):
    """The g table of each ply of the JAX actor's Gumbel search from
    `seed`: per ply key -> (key, ks, ka, kc), then the search splits ks
    into (key, kg, keval) and draws g from kg."""
    @jax.jit
    def tables(key):
        out = []
        for _ in range(plies):
            key, ks, _, _ = jax.random.split(key, 4)
            _, kg, _ = jax.random.split(ks, 3)
            out.append(jax.random.gumbel(kg, (e, a), jnp.float32))
        return jnp.stack(out)
    return iter(torch.tensor(np.asarray(tables(jax.random.key(seed)))))


@pytest.mark.parametrize("branch_cap", [16, None])
def test_gumbel_selfplay_matches_jax(branch_cap, monkeypatch):
    """Gumbel self-play (32 sims, m = 16: halving 16 -> 8 -> 4 lanes) on
    the slot tree and at full width, each ply's g table the JAX actor's
    own draw handed to the port: boards, moves, z equal, π' within 1e-5
    and a distribution over the empty cells."""
    mcts = dict(root_selection="gumbel", gumbel_m=16, branch_cap=branch_cap)
    cj, ct = small_chip(jconfig), small_chip(config)
    cj = cj.replace(mcts=dataclasses.replace(cj.mcts, **mcts))
    ct = ct.replace(mcts=dataclasses.replace(ct.mcts, **mcts))
    a = ct.env.num_actions
    w_l, w_v = frozen_weights(a, seed=9)
    fn = jax.jit(functools.partial(jactor.selfplay_chunk, cj.env, cj.mcts,
                                   jax_frozen_evaluator(w_l, w_v),
                                   num_plies=PLIES))
    _, tj, _ = fn(jvector.init(cj.env, E), jax.random.key(4))

    tables = jax_gumbel_tables(4, PLIES, E, a)
    run = gumbel.run_gumbel_mcts

    def injected(*args, **kw):
        assert kw.pop("add_noise") is True
        return run(*args, **kw, gumbel=next(tables))

    monkeypatch.setattr(gumbel, "run_gumbel_mcts", injected)
    seen = []
    _, tt, _ = actor.selfplay_chunk(
        ct.env, ct.mcts, torch_frozen_evaluator(w_l, w_v),
        vector.init(ct.env, E, "cpu"), torch.Generator(), PLIES,
        observe=lambda st, res, act: seen.append(
            bool(torch.equal(res.action, act))))
    assert seen == [True] * PLIES
    assert_trajectories_equal(tj, tt, pi_atol=1e-5)
    assert (tt.pi[tt.board != 0] == 0).all()


def test_gumbel_pcr_splits_policy_targets():
    """Gumbel self-play with playout cap randomization: full plies carry
    π targets, cheap plies (4 sims, still Gumbel-sampled) only values."""
    env = config.EnvConfig(board_size=5, n_in_row=4)
    cfg = config.MCTSConfig(num_simulations=12, gumbel_m=8,
                            root_selection="gumbel", small_simulations=4,
                            full_sim_fraction=0.5)
    ev = torch_frozen_evaluator(*frozen_weights(25, 1))
    _, traj, stats = actor.selfplay_chunk(
        env, cfg, ev, vector.init(env, 4, "cpu"),
        torch.Generator().manual_seed(5), 12)
    pv = traj.pi_valid.reshape(12, 4)
    assert pv.all(dim=1).any() and (~pv).all(dim=1).any()
    assert ((pv == pv[:, :1]).all())   # one coin per lockstep ply
    np.testing.assert_allclose(traj.pi.sum(-1).numpy(), 1.0, atol=1e-5)
    assert (traj.pi[traj.board != 0] == 0).all()
    assert stats.env_steps == 48


def test_resolve_chunk_lookahead_matches_jax():
    rng = np.random.default_rng(2)
    t, e, a = 5, 3, 4
    fields = dict(board=rng.integers(-1, 2, (t, e, a)).astype(np.int8),
                  to_play=rng.choice([-1, 1], (t, e)).astype(np.int8),
                  last_move=rng.integers(-1, a, (t, e)).astype(np.int32),
                  pi=rng.random((t, e, a)).astype(np.float32),
                  done=rng.random((t, e)) < 0.3,
                  winner=rng.integers(-1, 2, (t, e)).astype(np.int8),
                  pi_valid=rng.random((t, e)) < 0.5)
    look = {k: v[::-1].copy() for k, v in fields.items()}
    env_j, env_t = jconfig.EnvConfig(board_size=2), config.EnvConfig(
        board_size=2)
    for la in (None, look):
        rj = jactor.resolve_chunk(
            env_j, jactor.Recordings(**{k: jnp.asarray(v)
                                        for k, v in fields.items()}),
            None if la is None else jactor.Recordings(
                **{k: jnp.asarray(v) for k, v in la.items()}))
        rt = actor.resolve_chunk(
            env_t, actor.Recordings(**{k: torch.from_numpy(v)
                                       for k, v in fields.items()}),
            None if la is None else actor.Recordings(
                **{k: torch.from_numpy(v) for k, v in la.items()}))
        for f in dataclasses.fields(rt):
            np.testing.assert_array_equal(
                getattr(rt, f.name).numpy(), np.asarray(getattr(rj, f.name)),
                err_msg=f.name)


def test_prune_forced_visits_matches_jax():
    rng = np.random.default_rng(4)
    visits = rng.integers(0, 30, (5, 25)).astype(np.float32)
    priors = rng.dirichlet(np.ones(25), 5).astype(np.float32)
    got = actor.prune_forced_visits(torch.from_numpy(visits),
                                    torch.from_numpy(priors), 2.0).numpy()
    want = np.asarray(jactor.prune_forced_visits(
        jnp.asarray(visits), jnp.asarray(priors), 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
