"""Cross-play: the port against the JAX package on the same bundle.

``pretrained/9x9`` plays itself, once searched by the JAX package
(``mcts.search.run_mcts`` over its ``net_evaluator``) and once by the port
(``search.run_mcts`` over its ``net_evaluator`` on the CPU), both in f32,
with no root noise and greedy moves (the visit argmax, lowest index on
ties). Games start from seeded random openings of ``OPENING_PLIES`` moves
(``train/evaluate.py::random_openings``' rules: an even count, far below
a winning line) and each opening is played twice, the port black once and
white once. All games advance in lockstep; at every ply BOTH packages
search every live position in one batch each, so every position also
compares the two searches, whichever side moves.

Both nets agree to ~1e-6 (tests/test_torch_net.py), so the searches can
differ only where two PUCT scores tie to that level. When every position
agrees, the two games of an opening are the same game with the colours
swapped and the port scores exactly 0.5. The bars:

* the visit argmax agrees on at least ``MIN_AGREEMENT`` of the positions;
* where it does not, both searches rank the two moves within
  ``TIE_VISITS`` visits of each other (a near-tie, not a different
  evaluation);
* the port's score is 0.5 within ``SCORE_TOL``: one opening whose two
  games diverge can move it by at most 1 / (2 · openings).
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import torch

from alphafive_tpu.mcts import search as jsearch
from alphafive_tpu.models.evaluator import net_evaluator as j_net_evaluator
from alphafive_tpu.train import checkpoint as jckpt
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.mcts import search
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.train import checkpoint
from test_torch_search import jax_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPENINGS, OPENING_PLIES, SIMS = 8, 4, 32
MIN_AGREEMENT = 0.95
TIE_VISITS = 3   # of SIMS
SCORE_TOL = 1 / (2 * OPENINGS)


def random_openings(env_cfg, n, plies, seed):
    """`n` positions after `plies` uniformly random legal moves."""
    assert plies % 2 == 0 and plies < 2 * env_cfg.n_in_row - 1
    rng = np.random.default_rng(seed)
    st = vector.init(env_cfg, n, "cpu")
    for _ in range(plies):
        u = torch.from_numpy(rng.random(st.board.shape).astype(np.float32))
        st = vector.step(env_cfg, st, (u * vector.legal_mask(st)).argmax(-1)
                         .int())
    return st


def test_port_and_jax_play_even():
    path = os.path.join(ROOT, "pretrained", "9x9")
    params, bs, cfg = checkpoint.load_model(path)
    jparams, jbs, jcfg = jckpt.load_model(path)
    f32 = dict(compute_dtype="float32")
    mcts = dict(num_simulations=SIMS, prior_dtype="float32",
                value_dtype="float32")
    env, net = cfg.env, dataclasses.replace(cfg.net, **f32)
    mcts_t = dataclasses.replace(cfg.mcts, **mcts)
    ev_t = net_evaluator(env, net, params, bs, "cpu")
    run_j = jax.jit(functools.partial(
        jsearch.run_mcts, jcfg.env, dataclasses.replace(jcfg.mcts, **mcts),
        j_net_evaluator(jcfg.env, dataclasses.replace(jcfg.net, **f32),
                        jparams, jbs), add_noise=False))

    opening = random_openings(env, OPENINGS, OPENING_PLIES, seed=13)
    st = vector.EnvState(**{f.name: getattr(opening, f.name).repeat(
        (2,) + (1,) * (getattr(opening, f.name).dim() - 1))
        for f in dataclasses.fields(opening)})
    # the port plays black in the first copy of each opening
    port_colour = torch.tensor([1] * OPENINGS + [-1] * OPENINGS,
                               dtype=torch.int8)
    positions, disagreements = 0, []
    for ply in range(env.num_actions - OPENING_PLIES):
        live = ~st.done
        if not live.any():
            break
        vj = torch.from_numpy(np.array(
            run_j(jax_state(st), jax.random.key(ply)).visits))
        vt = search.run_mcts(env, mcts_t, ev_t, st, add_noise=False).visits
        aj, at = vj.argmax(-1), vt.argmax(-1)
        positions += int(live.sum())
        for g in torch.nonzero(live & (aj != at))[:, 0].tolist():
            a, b = int(at[g]), int(aj[g])
            disagreements.append((g, ply, float(vt[g, a] - vt[g, b]),
                                  float(vj[g, b] - vj[g, a])))
        st = vector.step(env, st, torch.where(st.to_play == port_colour,
                                              at, aj).int())
    assert st.done.all()

    agreement = 1 - len(disagreements) / positions
    assert agreement >= MIN_AGREEMENT, (agreement, disagreements)
    for g, ply, gap_t, gap_j in disagreements:
        assert gap_t <= TIE_VISITS and gap_j <= TIE_VISITS, (g, ply, gap_t,
                                                             gap_j)
    win = (st.winner == port_colour).float() + 0.5 * (st.winner == 0).float()
    score = float(win.mean())
    assert abs(score - 0.5) <= SCORE_TOL, (score, st.winner.tolist())
    if not disagreements:
        assert score == 0.5
