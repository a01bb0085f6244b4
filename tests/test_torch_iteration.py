"""The single-device actor-learner iteration: the torch port against the
JAX package's ``make_train_iteration`` on a one-device mesh.

JAX's random draws cannot be reproduced in torch, so the parity test
rebuilds them from the JAX iteration's keys — each ply's Gumbel table
and each sampled batch's indices and symmetries — and hands them to the
port's ``run_gumbel_mcts`` and ``replay.buffer.sample``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu import parallel as jparallel
from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.train import actor as jactor
from alphafive_tpu.utils import symmetry as jsymmetry
from alphafive_tpu_torch import parallel
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.mcts import gumbel
from alphafive_tpu_torch.models.evaluator import net_evaluator
from alphafive_tpu_torch.models.resnet import FusedPolicyValueNet
from alphafive_tpu_torch.parallel import mesh
from alphafive_tpu_torch.replay import buffer
from alphafive_tpu_torch.train import actor, learner

torch.set_num_threads(1)

RING = ("board", "to_play", "last_move", "pi", "z", "z_valid", "pi_valid")


def with_fields(cfg, **sections):
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in sections.items()})


def test_init_recordings_matches_jax():
    cfg, jcfg = get_preset("tiny_test"), j_get_preset("tiny_test")
    got = actor.init_recordings(cfg.env, 3, 5, "cpu")
    want = jactor.init_recordings(jcfg.env, 3, 5)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert tuple(g.shape) == w.shape, f.name
        assert str(g.dtype) == f"torch.{w.dtype}", f.name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_live_evaluator_equals_numpy_built(use_pallas):
    """The evaluator built from a live net after two learner steps (BN
    statistics and weights moved) gives exactly the outputs of the one
    built from the same weights as numpy trees, and is a snapshot: a
    later step does not change it. With ``use_pallas`` the fused forward
    (its plain resblock on the CPU; ``plain=True`` the same here)."""
    cfg = with_fields(get_preset("tiny_test"),
                      net=dict(use_pallas=use_pallas),
                      train=dict(lr_warmup_steps=1))
    carry = parallel.init_carry(cfg, "cpu", seed=3)
    ts = carry.train_state
    rng = np.random.default_rng(4)
    s, a, b = cfg.env.board_size, cfg.env.num_actions, 16
    batch = (torch.from_numpy((rng.random((b, s, s, 4)) < 0.3)
                              .astype(np.float32)),
             torch.softmax(torch.from_numpy(rng.standard_normal((b, a))
                                            .astype(np.float32)), -1),
             torch.ones(b), torch.ones(b))
    for _ in range(2):
        learner.train_step(cfg.env, cfg.net, cfg.train, ts, batch)
    live = net_evaluator(cfg.env, cfg.net, ts.net)
    built = net_evaluator(cfg.env, cfg.net, *ts.net.to_flax(), device="cpu")
    st = carry.env_state
    board = torch.from_numpy(rng.integers(-1, 2, (b, a)).astype(np.int8))
    to_play = torch.from_numpy(rng.choice([-1, 1], b).astype(np.int8))
    last = torch.from_numpy(rng.integers(-1, a, b).astype(np.int32))
    out_live = live(board, to_play, last)
    for g, w in zip(out_live, built(board, to_play, last)):
        assert torch.equal(g, w)
    if use_pallas:
        feats = torch.from_numpy((rng.random((b, s, s, 4)) < 0.3)
                                 .astype(np.float32))
        plain = FusedPolicyValueNet.from_module(cfg.env, cfg.net, ts.net,
                                                plain=True)
        fused = FusedPolicyValueNet.from_module(cfg.env, cfg.net, ts.net)
        for g, w in zip(plain(feats), fused(feats)):
            assert torch.equal(g, w)
    learner.train_step(cfg.env, cfg.net, cfg.train, ts, batch)
    for g, w in zip(live(board, to_play, last), out_live):
        assert torch.equal(g, w)
    assert st is carry.env_state


def jax_iteration_draws(key, cfg, size):
    """The Gumbel table of each ply and the (idx, sym) of the probe batch
    and each learner step that JAX's one-device iteration draws from
    `key` when the ring holds `size` rows after the write."""
    e, a = cfg.train.num_envs, cfg.env.num_actions
    bs, k = cfg.replay.batch_size, cfg.train.learner_steps_per_iter

    @jax.jit
    def draws(key):
        key = jax.random.fold_in(key, 0)
        _, kplay, ksample = jax.random.split(key, 3)
        tables = []
        for _ in range(cfg.train.selfplay_plies_per_iter):
            kplay, ks, _, _ = jax.random.split(kplay, 4)
            _, kg, _ = jax.random.split(ks, 3)
            tables.append(jax.random.gumbel(kg, (e, a), jnp.float32))
        kprobe, kscan = jax.random.split(ksample)
        picks = []
        for kb in [kprobe, *jax.random.split(kscan, k)]:
            kidx, ksym = jax.random.split(kb)
            picks.append((
                jax.random.randint(kidx, (bs,), 0,
                                   jnp.maximum(jnp.int32(size), 1)),
                jax.random.randint(ksym, (bs,), 0,
                                   jsymmetry.NUM_SYMMETRIES)))
        return jnp.stack(tables), picks

    tables, picks = draws(key)
    to_t = lambda x: torch.tensor(np.asarray(x))
    return ([to_t(t) for t in tables],
            [(to_t(i), to_t(s)) for i, s in picks])


def inject(monkeypatch, tables, picks):
    run, sample = gumbel.run_gumbel_mcts, buffer.sample

    def run_injected(*args, **kw):
        assert kw.pop("add_noise") is True
        return run(*args, **kw, gumbel=tables.pop(0))

    def sample_injected(env, buf, batch_size, generator=None):
        idx, sym = picks.pop(0)
        return sample(env, buf, batch_size, idx=idx, sym=sym)

    monkeypatch.setattr(gumbel, "run_gumbel_mcts", run_injected)
    monkeypatch.setattr(buffer, "sample", sample_injected)


# f32 parity after the learner has moved the weights: the metrics within
# 1e-4 relative (losses and norms of 25-100-row batches; KL values are
# ~1e-5 and get 1e-7 absolute), params within 1e-5 + 1e-4 relative; the
# ring's π is stored in bf16, where a 1e-6 difference of π' can round to
# the neighbouring value: one bf16 step at 1.0 (2^-8)
METRIC_TOL, PARAM_TOL, RING_PI_ATOL = (1e-7, 1e-4), (1e-5, 1e-4), 2 ** -8


@pytest.mark.parametrize("train", [
    {},
    dict(learner_steps_per_iter=3, lr_warmup_steps=2, kl_stop_factor=4.0),
], ids=["tiny_test", "three_steps_kl_stop"])
def test_iterations_match_jax(train, monkeypatch):
    """Three iterations of tiny_test with the Gumbel root, f32, from the
    same weights: the port against JAX's make_train_iteration on a
    one-device mesh, the draws injected. Every metric of every
    iteration, the ring (contents, pointer and size) and at the end the
    params and batch statistics."""
    sections = dict(mcts=dict(root_selection="gumbel"), train=train)
    jcfg = with_fields(j_get_preset("tiny_test"), **sections)
    cfg = with_fields(get_preset("tiny_test"), **sections)
    jmesh = jparallel.make_mesh(1)
    jcarry = jparallel.init_carry(jcfg, jax.random.key(0), jmesh)
    jit = jparallel.make_train_iteration(jcfg, jmesh, donate=False)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    carry = parallel.init_carry(
        cfg, "cpu", params=to_np(jcarry.train_state.params),
        batch_stats=to_np(jcarry.train_state.batch_stats))
    it = parallel.make_train_iteration(cfg)
    chunk = cfg.train.num_envs * cfg.train.selfplay_plies_per_iter
    for i in range(3):
        key = jax.random.key(i + 1)
        jcarry, jm = jit(jcarry, key)
        tables, picks = jax_iteration_draws(key, jcfg, int(jm["buffer_size"]))
        inject(monkeypatch, tables, picks)
        carry, m = it(carry)
        monkeypatch.undo()
        assert set(m) == set(jm)
        assert not tables, "every ply drew its table"
        k = cfg.train.learner_steps_per_iter
        assert len(picks) == (k - m["executed_steps"] if m["updated"]
                              else k + 1)
        for k in m:
            np.testing.assert_allclose(m[k], float(jm[k]), atol=METRIC_TOL[0],
                                       rtol=METRIC_TOL[1],
                                       err_msg=f"iteration {i} {k}")
        jbuf = jcarry.buffer
        assert carry.buffer.size == int(jbuf.size[0]) == chunk * i
        assert carry.buffer.ptr == int(jbuf.ptr[0])
        for name in RING:
            got = getattr(carry.buffer, name).float().numpy()
            want = np.asarray(getattr(jbuf, name)).astype(np.float32)
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=RING_PI_ATOL if name == "pi" else 0,
                err_msg=f"iteration {i} ring {name}")
    assert m["updated"] == 1.0 and m["step"] > 0
    got_p, got_s = carry.train_state.net.to_flax()
    for got, want in ((got_p, jcarry.train_state.params),
                      (got_s, jcarry.train_state.batch_stats)):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(to_np(want))[0]):
            np.testing.assert_allclose(g, w, atol=PARAM_TOL[0],
                                       rtol=PARAM_TOL[1],
                                       err_msg=jax.tree_util.keystr(path))
    assert carry.train_state.step == int(jcarry.train_state.step)
    assert float(carry.train_state.lr_scale) == pytest.approx(
        float(jcarry.train_state.lr_scale))


def test_train_iteration_z_coverage():
    """Twin of tests/test_train.py::test_train_iteration_z_coverage: the
    first iteration writes nothing, and the staged chunks, resolved with
    the next chunk as lookahead, reach far more value targets than each
    chunk resolved alone. (The JAX test's absolute bar, a mean above
    0.75, sits at this configuration's expected coverage: 3-chunk means
    of 0.64-0.89 over seeds on the port, whose resolution equals JAX's
    under the same draws in test_iterations_match_jax. Resolved alone the
    same chunks reach 0.16-0.24.)"""
    cfg = with_fields(get_preset("tiny_test"),
                      train=dict(selfplay_plies_per_iter=7))
    carry = parallel.init_carry(cfg, "cpu")
    it = parallel.make_train_iteration(cfg)
    sizes, fracs, alone = [], [], []
    for _ in range(4):
        staged = actor.resolve_chunk(cfg.env, carry.pending)
        carry, metrics = it(carry)
        sizes.append(int(metrics["buffer_size"]))
        fracs.append(float(metrics["z_valid_frac"]))
        alone.append(float(staged.z_valid.float().mean()))
    chunk = 7 * cfg.train.num_envs
    assert sizes[0] == 0 and sizes[1] == chunk and sizes[3] == 3 * chunk
    assert fracs[0] == 0.0
    assert all(f >= a for f, a in zip(fracs[1:], alone[1:])), (fracs, alone)
    assert np.mean(fracs[1:]) > max(0.5, 2 * np.mean(alone[1:])), (fracs,
                                                                   alone)


def test_kl_early_stop_masks_steps():
    """Twin of tests/test_train.py::test_kl_early_stop_masks_steps: with a
    huge lr and a tiny threshold only the tripping step executes (and
    leaves the optimizer count and step where it put them); with the
    guard effectively off all four steps run."""
    def run(kl_stop_factor):
        cfg = with_fields(
            get_preset("tiny_test"),
            train=dict(learner_steps_per_iter=4, learning_rate=1.0,
                       lr_warmup_steps=1, kl_target=0.02,
                       kl_stop_factor=kl_stop_factor),
            replay=dict(min_fill=32, batch_size=32))
        carry = parallel.init_carry(cfg, "cpu")
        it = parallel.make_train_iteration(cfg)
        carry, m = it(carry)   # stages only (lookahead)
        assert m["updated"] == 0.0 and m["executed_steps"] == 0.0
        carry, m = it(carry)
        assert m["updated"] == 1.0
        return carry, m

    carry_stop, m_stop = run(kl_stop_factor=0.25)   # threshold 0.005
    carry_all, m_all = run(kl_stop_factor=1e9)      # never trips
    assert m_all["executed_steps"] == 4.0
    assert m_stop["executed_steps"] < 4.0
    assert m_stop["kl_update"] > 0.005
    ts_stop, ts_all = carry_stop.train_state, carry_all.train_state
    assert ts_stop.step < ts_all.step
    assert ts_stop.opt_state.count == ts_stop.step == m_stop["step"]


def test_no_update_metrics_are_zero():
    """Below min_fill the learner's metrics are the JAX zero dict."""
    cfg = get_preset("tiny_test")
    carry = parallel.init_carry(cfg, "cpu")
    carry, m = parallel.make_train_iteration(cfg)(carry)
    assert all(m[k] == 0.0 for k in mesh.AUX_KEYS + ("z_valid_frac",))
    assert m["env_steps"] == cfg.train.num_envs * 25 and m["step"] == 0.0
    assert carry.has_pending and carry.buffer.size == 0
