"""Deferred backup (``mcts.backup_interval=2``): the port against the JAX
package and against its own scatter-every-pass search.

In packed int16 mode the capped search runs its passes in pairs: the first
pass of a pair skips its stats scatter and the second folds it into its
descent and scatters both. The frozen evaluator of tests/test_torch_search.py
is dyadic, so every value sum is exact and any difference in the visits is
a difference in the search. Elsewhere (f32 value sums, the Gumbel driver)
the setting is read nowhere, as in JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu import config as jconfig
from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import MCTSConfig as JMCTSConfig
from alphafive_tpu.env import vector as jvector
from alphafive_tpu.mcts import gumbel as jgumbel
from alphafive_tpu.mcts.search_capped import run_mcts_capped as j_run
from alphafive_tpu.train import actor as jactor
from alphafive_tpu_torch import config
from alphafive_tpu_torch.config import EnvConfig, MCTSConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import gumbel
from alphafive_tpu_torch.mcts.search_capped import _stages, run_mcts_capped
from alphafive_tpu_torch.train import actor
from alphafive_tpu_torch.utils import trace
from tests.test_gumbel import _gumbel_table, jax_eval
from tests.test_mcts import to_env_state
from test_torch_gumbel import fixture, torch_eval, torch_state
from test_torch_search import (frozen_weights, jax_frozen_evaluator,
                               jax_state, torch_frozen_evaluator)
from test_torch_selfplay import (E, PLIES, assert_trajectories_equal,
                                 jax_gumbel_tables, small_chip)

torch.set_num_threads(1)

PACKED = dict(value_dtype="int16", prior_dtype="bfloat16", max_depth=24)

# (size, sims, leaf_batch, branch_cap): passes = sims / lb, staged by
# _stages at max_depth 24
CASES = [
    (7, 32, 8, 16),    # 4 passes, one stage, binding cap
    (7, 40, 8, 49),    # 5 passes: the last runs alone, c == A
    (9, 72, 4, 12),    # 18 passes over stages 0-8, 8-16, 16-18
    (7, 88, 8, 16),    # 11 passes: stage 8-11 ends on a single pass
    (5, 24, 1, 25),    # sequential: 24 passes over stages 0-8, 8-24
]


def passes_alone(passes, depth=24):
    """Passes that run unpaired: the odd last pass of each stage."""
    return sum((hi - lo) % 2 for lo, hi, _ in _stages(passes, depth))


def search_counting(env, cfg, ev, st, **kw):
    trace.reset()
    res = run_mcts_capped(env, cfg, ev, st, **kw)
    return res, trace.snapshot()["counters"].get("backup_scatters", 0)


@pytest.mark.parametrize("size,sims,lb,cap", CASES)
def test_deferred_matches_jax(size, sims, lb, cap):
    """Interval 2 against JAX's interval 2 over 3 plies of greedy play:
    visits bit-equal, root values to the last bit of the final division,
    and one stats scatter a pair of passes."""
    kw = dict(num_simulations=sims, leaf_batch=lb, branch_cap=cap,
              backup_interval=2, **PACKED)
    w_l, w_v = frozen_weights(size * size, seed=size + lb)
    run_j = jax.jit(functools.partial(
        j_run, JEnvConfig(board_size=size, n_in_row=4), JMCTSConfig(**kw),
        jax_frozen_evaluator(w_l, w_v), add_noise=False))
    env = EnvConfig(board_size=size, n_in_row=4)
    ev = torch_frozen_evaluator(w_l, w_v)
    passes = sims // lb
    st = vector.init(env, 4, "cpu")
    for ply in range(3):
        rj = run_j(jax_state(st), jax.random.key(ply))
        rt, scatters = search_counting(env, MCTSConfig(**kw), ev, st,
                                       add_noise=False)
        vj = np.asarray(rj.visits)
        np.testing.assert_array_equal(rt.visits.numpy(), vj,
                                      err_msg=f"ply {ply}")
        assert (vj.sum(-1) == sims).all()
        np.testing.assert_allclose(rt.root_value.numpy(),
                                   np.asarray(rj.root_value), atol=1e-6)
        alone = passes_alone(passes)
        assert scatters == (passes - alone) // 2 + alone
        act = torch.from_numpy(vj.argmax(-1).astype(np.int32))
        st = vector.step(env, st, act)
        st = vector.reset_where(env, st, st.done)


@pytest.mark.parametrize("size,sims,lb,cap,forced_k", [
    (7, 32, 8, 16, 0.0),
    (7, 40, 8, 49, 1.5),
    (9, 72, 4, 12, 2.0),
    (9, 400, 8, 128, 2.0),   # the presets' pass count: 50 passes
])
def test_deferred_bit_equal_to_every_pass(size, sims, lb, cap, forced_k):
    """Interval 2 and interval 1 of the port on the same positions, with
    a noisy root (an explicit noise table) and the forced-playout gate,
    which reads the folded real visits: visits and root values bit-equal;
    half the stats scatters where the passes pair up."""
    env = EnvConfig(board_size=size, n_in_row=4)
    ev = torch_frozen_evaluator(*frozen_weights(size * size, seed=3))
    rng = np.random.default_rng(size + sims)
    st = vector.init(env, 3, "cpu")
    for _ in range(4):
        legal = vector.legal_mask(st)
        u = torch.from_numpy(rng.random(legal.shape).astype(np.float32))
        st = vector.step(env, st, (u * legal).argmax(-1).int())
    noise = torch.from_numpy(rng.dirichlet(np.full(size * size, 0.3),
                                           size=3).astype(np.float32))
    runs = {}
    for interval in (1, 2):
        cfg = MCTSConfig(num_simulations=sims, leaf_batch=lb, branch_cap=cap,
                         forced_playouts_k=forced_k,
                         backup_interval=interval, **PACKED)
        runs[interval] = search_counting(env, cfg, ev, st, noise=noise)
    (r1, n1), (r2, n2) = runs[1], runs[2]
    assert torch.equal(r1.visits, r2.visits)
    assert torch.equal(r1.root_value, r2.root_value)
    assert torch.equal(r1.priors, r2.priors)
    passes = sims // lb
    alone = passes_alone(passes)
    assert (n1, n2) == (passes, (passes - alone) // 2 + alone)
    if (size, sims) == (9, 400):
        assert (n1, n2) == (50, 25)


def test_f32_value_sums_ignore_the_interval():
    """f32 value sums (no packed stats): the interval is read nowhere, as
    in JAX; both intervals scatter every pass and equal JAX's search."""
    size, sims, lb = 7, 40, 8
    kw = dict(num_simulations=sims, leaf_batch=lb, branch_cap=16,
              max_depth=24, value_dtype="float32", prior_dtype="bfloat16")
    env = EnvConfig(board_size=size, n_in_row=4)
    w_l, w_v = frozen_weights(size * size, seed=11)
    ev = torch_frozen_evaluator(w_l, w_v)
    st = vector.init(env, 4, "cpu")
    st = vector.step(env, st, torch.tensor([24, 0, 10, 48],
                                           dtype=torch.int32))
    (r1, n1), (r2, n2) = (
        search_counting(env, MCTSConfig(**kw, backup_interval=i), ev, st,
                        add_noise=False) for i in (1, 2))
    assert torch.equal(r1.visits, r2.visits)
    assert torch.equal(r1.root_value, r2.root_value)
    assert n1 == n2 == sims // lb
    rj = jax.jit(functools.partial(
        j_run, JEnvConfig(board_size=size, n_in_row=4),
        JMCTSConfig(**kw, backup_interval=2),
        jax_frozen_evaluator(w_l, w_v), add_noise=False))(
            jax_state(st), jax.random.key(0))
    np.testing.assert_array_equal(r2.visits.numpy(), np.asarray(rj.visits))


@pytest.mark.parametrize("branch_cap", [None, 12])
def test_gumbel_ignores_the_interval(branch_cap):
    """The Gumbel search at interval 2, full width and on the packed slot
    tree, against JAX's Gumbel search at interval 2 (which never reads
    the field): every output equal; the capped driver scatters every
    pass."""
    size, n_in_row, sims, plies, m = 5, 4, 17, 8, 8
    kw = dict(num_simulations=sims, c_puct=5.0, gumbel_m=m, max_depth=16,
              root_selection="gumbel", prior_dtype="bfloat16",
              value_dtype="int16", branch_cap=branch_cap, backup_interval=2)
    games = fixture(size, n_in_row, plies)
    gtab = _gumbel_table(size, len(games))
    rj = jax.jit(functools.partial(
        jgumbel.run_gumbel_mcts,
        JEnvConfig(board_size=size, n_in_row=n_in_row), JMCTSConfig(**kw),
        jax_eval(size)))(to_env_state(games), jax.random.key(0),
                         gumbel=jnp.asarray(gtab))
    trace.reset()
    rt = gumbel.run_gumbel_mcts(
        EnvConfig(board_size=size, n_in_row=n_in_row), MCTSConfig(**kw),
        torch_eval(size), torch_state(games), gumbel=torch.from_numpy(gtab))
    for name in ("visits", "action", "root_value"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(rt.pi_target.numpy(),
                               np.asarray(rj.pi_target), atol=1e-5)
    passes = sum(p for _, p in gumbel.build_schedule(sims, m))
    if branch_cap is not None:
        assert trace.snapshot()["counters"].get("backup_scatters", 0) == passes


@pytest.mark.parametrize("root", ["puct", "gumbel"])
def test_selfplay_deferred_matches_jax(root, monkeypatch):
    """``selfplay_chunk`` at interval 2 against the JAX actor at interval
    2 on tests/test_torch_selfplay.py's small chip_15x15 copy (greedy,
    noise weightless): boards, moves and z equal, π within the bars of
    that file. The Gumbel root gets each ply's g table from JAX's draw."""
    mcts = dict(backup_interval=2)
    if root == "gumbel":
        mcts.update(root_selection="gumbel", gumbel_m=16)
    cj, ct = small_chip(jconfig), small_chip(config)
    cj = cj.replace(mcts=dataclasses.replace(cj.mcts, **mcts))
    ct = ct.replace(mcts=dataclasses.replace(ct.mcts, **mcts))
    a = ct.env.num_actions
    w_l, w_v = frozen_weights(a, seed=5)
    fn = jax.jit(functools.partial(jactor.selfplay_chunk, cj.env, cj.mcts,
                                   jax_frozen_evaluator(w_l, w_v),
                                   num_plies=PLIES))
    _, tj, sj = fn(jvector.init(cj.env, E), jax.random.key(2))
    if root == "gumbel":
        tables = jax_gumbel_tables(2, PLIES, E, a)
        run = gumbel.run_gumbel_mcts

        def injected(*args, **kw):
            assert kw.pop("add_noise") is True
            return run(*args, **kw, gumbel=next(tables))

        monkeypatch.setattr(gumbel, "run_gumbel_mcts", injected)
    _, tt, st = actor.selfplay_chunk(
        ct.env, ct.mcts, torch_frozen_evaluator(w_l, w_v),
        vector.init(ct.env, E, "cpu"), torch.Generator().manual_seed(2),
        PLIES)
    assert_trajectories_equal(tj, tt, pi_atol=1e-5 if root == "gumbel"
                              else 1e-6)
    assert st.env_steps == int(sj.env_steps)
