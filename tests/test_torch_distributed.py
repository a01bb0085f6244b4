"""The data-parallel actor-learner iteration: two gloo ranks of the port
against the JAX package's ``make_train_iteration`` on a two-device mesh,
and the single-process behaviour of ``parallel/distributed.py`` (twins
of ``tests/test_distributed.py``'s unit cases).

JAX's random draws cannot be reproduced in torch, so the test rebuilds
each device's draws from the JAX iteration's keys — ``fold_in(key, r)``,
then each ply's Gumbel table and each sampled batch's indices and
symmetries at the device's local shapes — and the ranks hand them to
``run_gumbel_mcts`` and ``replay.buffer.sample``. The ranks run in
processes of their own (``tests/torch_distributed_worker.py``, which
imports nothing of JAX)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_distributed_worker as worker
from alphafive_tpu import parallel as jparallel
from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.utils import symmetry as jsymmetry
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.parallel import distributed

torch.set_num_threads(1)

WORLD, ITERS = 2, 3
# the one-device parity test's bars (tests/test_torch_iteration.py): f32
# metrics within 1e-4 relative (KL values ~1e-5 get 1e-7 absolute), params
# within 1e-5 + 1e-4 relative, the ring's bf16 π within one bf16 step
METRIC_TOL, PARAM_TOL, RING_PI_ATOL = (1e-7, 1e-4), (1e-5, 1e-4), 2 ** -8


def with_fields(cfg, **sections):
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in sections.items()})


def rank_draws(key, cfg, rank, local_size):
    """The Gumbel table of each ply and the (idx, sym) of the probe batch
    and each learner step that device `rank` of JAX's two-device
    iteration draws from `key` when its ring shard holds `local_size`
    rows after the write."""
    e = cfg.train.num_envs // WORLD
    bs = cfg.replay.batch_size // WORLD
    a, k = cfg.env.num_actions, cfg.train.learner_steps_per_iter

    @jax.jit
    def draws(key):
        key = jax.random.fold_in(key, rank)
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
                                   jnp.maximum(jnp.int32(local_size), 1)),
                jax.random.randint(ksym, (bs,), 0,
                                   jsymmetry.NUM_SYMMETRIES)))
        return tables, picks

    tables, picks = draws(key)
    out = {f"table{p}": np.asarray(t) for p, t in enumerate(tables)}
    for j, (idx, sym) in enumerate(picks):
        out[f"idx{j}"], out[f"sym{j}"] = np.asarray(idx), np.asarray(sym)
    out["n_picks"] = np.int64(len(picks))
    return out


def test_single_process_defaults():
    assert distributed.is_primary()
    assert (distributed.world(), distributed.rank()) == (1, 0)
    assert distributed.group() is None
    distributed.barrier("test")   # no-op without peers
    assert distributed.broadcast_object({"a": 1}) == {"a": 1}


def test_initialize_noop_for_one_process(monkeypatch):
    # must not wire a group for a one-process run
    distributed.initialize(num_processes=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    distributed.initialize(device="cpu")    # torchrun's world of one
    assert not torch.distributed.is_initialized()
    assert distributed.group() is None


def test_initialize_refuses_partial_flags(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="--process-id"):
        distributed.initialize("127.0.0.1:1", 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_scale_for_processes():
    # with a single process every global count is its own local share
    assert distributed.scale_for_processes(8) == 8
    assert distributed.scale_for_processes(7) == 7


def assert_trees_equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
            f"{what} {k}"


@pytest.mark.parametrize("train", [
    {},
    dict(learner_steps_per_iter=3, lr_warmup_steps=2, kl_stop_factor=4.0),
], ids=["tiny_test", "three_steps_kl_stop"])
def test_two_ranks_match_jax_two_devices(train, tmp_path):
    """Three iterations of tiny_test with the Gumbel root, f32, from the
    same weights: two gloo ranks of the port against JAX's
    make_train_iteration on a two-device mesh, each rank with its
    device's draws. Every metric of every iteration, each rank's ring
    shard (contents, pointer and size) and at the end the params and
    batch statistics; after every iteration both ranks' weights and
    statistics are bit-identical."""
    sections = dict(mcts=dict(root_selection="gumbel"), train=train,
                    mesh=dict(data=WORLD))
    jcfg = with_fields(j_get_preset("tiny_test"), **sections)
    cfg = with_fields(get_preset("tiny_test"), **sections)
    jmesh = jparallel.make_mesh(WORLD)
    jcarry = jparallel.init_carry(jcfg, jax.random.key(0), jmesh)
    np.savez(tmp_path / "init.npz", **worker.flat_tree(
        jax.device_get(jcarry.train_state.params), "params/"),
        **worker.flat_tree(jax.device_get(jcarry.train_state.batch_stats),
                           "batch_stats/"))
    jit = jparallel.make_train_iteration(jcfg, jmesh, donate=False)
    jm, jbufs = [], []
    for i in range(ITERS):
        key = jax.random.key(i + 1)
        jcarry, m = jit(jcarry, key)
        jm.append(jax.device_get(m))
        jbufs.append(jax.device_get(jcarry.buffer))
        for r in range(WORLD):
            np.savez(tmp_path / f"draws_{i}_rank{r}.npz", **rank_draws(
                key, jcfg, r, int(jbufs[-1].size[r])))

    worker.spawn_ranks(worker.run, (WORLD, worker.free_port(), cfg.to_json(),
                                    str(tmp_path), ITERS), WORLD)
    outs = [dict(np.load(tmp_path / f"out_rank{r}.npz"))
            for r in range(WORLD)]

    k = cfg.train.learner_steps_per_iter
    chunk = cfg.train.num_envs // WORLD * cfg.train.selfplay_plies_per_iter
    cap = cfg.replay.capacity // WORLD
    for i in range(ITERS):
        for r, out in enumerate(outs):
            m = {key[len(f"{i}/m/"):]: float(v) for key, v in out.items()
                 if key.startswith(f"{i}/m/")}
            assert set(m) == set(jm[i]), (i, r)
            assert out[f"{i}/tables_left"] == 0
            assert out[f"{i}/picks_left"] == (
                k - m["executed_steps"] if m["updated"] else k + 1)
            for name, v in m.items():
                np.testing.assert_allclose(
                    v, float(jm[i][name]), atol=METRIC_TOL[0],
                    rtol=METRIC_TOL[1], err_msg=f"iteration {i} rank {r} "
                                                f"{name}")
            jbuf = jbufs[i]
            assert out[f"{i}/size"] == int(jbuf.size[r]) == chunk * i
            assert out[f"{i}/ptr"] == int(jbuf.ptr[r])
            for name in worker.RING:
                want = np.asarray(getattr(jbuf, name))[r * cap:(r + 1) * cap]
                np.testing.assert_allclose(
                    out[f"{i}/ring/{name}"], want.astype(np.float32), rtol=0,
                    atol=RING_PI_ATOL if name == "pi" else 0,
                    err_msg=f"iteration {i} rank {r} ring {name}")
        # the ranks' weights and statistics, bit for bit
        for part in ("params/", "batch_stats/", "step", "lr_scale"):
            pick = lambda out: {key: v for key, v in out.items()
                                if key.startswith(f"{i}/{part}")}
            assert_trees_equal(pick(outs[0]), pick(outs[1]),
                               f"iteration {i} ranks 0/1")
    assert jm[-1]["updated"] == 1.0 and jm[-1]["step"] > 0
    want = {**worker.flat_tree(jax.device_get(jcarry.train_state.params),
                               "params/"),
            **worker.flat_tree(jax.device_get(
                jcarry.train_state.batch_stats), "batch_stats/")}
    last = ITERS - 1
    for key, w in want.items():
        np.testing.assert_allclose(outs[0][f"{last}/{key}"], w,
                                   atol=PARAM_TOL[0], rtol=PARAM_TOL[1],
                                   err_msg=key)
    assert outs[0][f"{last}/step"] == int(jcarry.train_state.step)
    assert float(outs[0][f"{last}/lr_scale"]) == pytest.approx(
        float(jcarry.train_state.lr_scale))


@pytest.mark.parametrize("world,train,refused", [
    (3, {}, "train.num_envs=4"),
    (3, dict(num_envs=6), "replay.capacity=1024"),
    (64, dict(num_envs=64), "replay.batch_size=32"),
])
def test_init_carry_refuses_an_uneven_world(world, train, refused,
                                            monkeypatch):
    """A world that does not divide the envs, the ring or the batch
    raises before any collective, as JAX's init_carry asserts."""
    from alphafive_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "_world_rank", lambda group: (world, 0))
    cfg = with_fields(get_preset("tiny_test"), train=train)
    with pytest.raises(ValueError, match=f"{refused} does not divide over "
                                         f"a world of {world}"):
        mesh.init_carry(cfg, "cpu", group=object())


def test_one_process_refuses_a_data_axis(capsys):
    """Without a process group `cli train` refuses mesh.data > 1 with the
    launch command (JAX's make_mesh asserts the devices exist), and
    `bench --mode iteration` clamps mesh.data to the world of one, as
    JAX's bench clamps it to the device count."""
    from alphafive_tpu_torch import cli
    from alphafive_tpu_torch.train import loop
    from alphafive_tpu_torch.utils.logging import MetricsLogger
    cfg = with_fields(get_preset("tiny_test"), mesh=dict(data=2))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        loop.train(cfg, None, 1, logger=MetricsLogger(None, quiet=True),
                   device="cpu")
    assert cli.main(["bench", "--mode", "iteration", "--preset",
                     "tiny_test", "--device", "cpu", "--set", "mesh.data=4",
                     "--set", "train.selfplay_plies_per_iter=2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"chips": 1' in out
