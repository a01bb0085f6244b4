"""Full-state checkpoints and bundles: the port's own checkpoint format
round-trips every piece of the carry, and its bundle export is
byte-equal to flax's, read by the JAX package and reading the JAX
package's exports (twins of ``tests/test_train.py``'s checkpoint and
export tests)."""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from alphafive_tpu import parallel as jparallel
from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.train import checkpoint as jckpt
from alphafive_tpu.train import learner as jlearner
from alphafive_tpu.utils.elo import LadderState as JLadderState
from alphafive_tpu_torch import cli, parallel
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.models.resnet import PolicyValueNet, init_params
from alphafive_tpu_torch.train import checkpoint as ckpt
from alphafive_tpu_torch.train import loop
from alphafive_tpu_torch.utils.elo import LadderState
from alphafive_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    """A tiny_test carry after three iterations: a filled ring, a staged
    chunk, moved weights, moments and statistics, a used generator."""
    cfg = get_preset("tiny_test")
    carry = parallel.init_carry(cfg, "cpu")
    it = parallel.make_train_iteration(cfg)
    for _ in range(3):
        carry, m = it(carry)
    assert m["updated"] == 1.0 and carry.has_pending
    return cfg, carry


def fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_carry_equal(a, b):
    for part in ("env_state", "buffer", "pending"):
        for k, v in fields(getattr(a, part)).items():
            w = fields(getattr(b, part))[k]
            if isinstance(v, torch.Tensor):
                assert v.dtype == w.dtype and torch.equal(v, w), (part, k)
            else:
                assert v == w, (part, k)
    assert a.has_pending == b.has_pending
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    ta, tb = a.train_state, b.train_state
    for (k, v), (k2, w) in zip(ta.net.state_dict().items(),
                               tb.net.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k
    assert ta.opt_state.count == tb.opt_state.count
    for v, w in zip(ta.opt_state.mu + ta.opt_state.nu,
                    tb.opt_state.mu + tb.opt_state.nu):
        assert torch.equal(v, w)
    assert ta.step == tb.step and torch.equal(ta.lr_scale, tb.lr_scale)


def test_checkpoint_roundtrip(trained, tmp_path):
    """Every carry tensor, the ring's ptr/size, has_pending, the
    generator, the ladder and the config come back bit-equal into a
    fresh carry of another seed; the generator then draws the same."""
    cfg, carry = trained
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ladder = LadderState(level=2, max_rollouts=800,
                         history=[{"step": 1, "score": 0.5, "elo": 1.0}])
    assert ckpt.save(mgr, 7, carry, cfg, ladder)
    assert sorted(os.listdir(mgr.step_dir(7))) == ["carry.pt", "meta.json",
                                                   "model.pt"]
    fresh = parallel.init_carry(cfg, "cpu", seed=123)
    it, back, cfg2, ladder2 = ckpt.restore(mgr, fresh)
    assert it == 7 and back is fresh and cfg2 == cfg and ladder2 == ladder
    assert back.buffer.size == carry.buffer.size > 0
    assert back.buffer.ptr == carry.buffer.ptr
    assert_carry_equal(back, carry)
    assert ckpt.read_meta(mgr) == (7, cfg, ladder)
    draw = lambda c: torch.rand(4, generator=c.generator)
    assert torch.equal(draw(back), draw(carry))


def test_restore_refuses_another_configuration(trained, tmp_path):
    cfg, carry = trained
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ckpt.save(mgr, 1, carry, cfg, LadderState())
    other = cfg.replace(replay=dataclasses.replace(cfg.replay, capacity=64))
    with pytest.raises(ValueError, match="buffer"):
        ckpt.restore(mgr, parallel.init_carry(other, "cpu"))


def test_max_to_keep_and_atomic_steps(trained, tmp_path):
    cfg, carry = trained
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    for step in range(1, 6):
        assert ckpt.save(mgr, step, carry, cfg, LadderState())
    assert mgr.all_steps() == [3, 4, 5]
    # orbax's rule: a step at or below the latest is not written
    assert not ckpt.save(mgr, 5, carry, cfg, LadderState())
    assert not ckpt.save(mgr, 2, carry, cfg, LadderState())
    assert mgr.all_steps() == [3, 4, 5]
    best = ckpt.make_manager(str(tmp_path / "best"), max_to_keep=1)
    for step in (2, 4):
        ckpt.save(best, step, carry, cfg, LadderState())
    assert best.all_steps() == [4]
    # a save killed before its rename leaves <step>.tmp, which is no step
    os.makedirs(mgr.step_dir(9) + ".tmp")
    assert mgr.latest_step() == 5
    assert ckpt.save(mgr, 9, carry, cfg, LadderState())
    assert mgr.all_steps() == [4, 5, 9]
    os.makedirs(mgr.step_dir(10))
    with pytest.raises(ValueError, match="meta.json"):
        mgr.latest_step()


def test_restore_train_state_from_any_preset(trained, tmp_path):
    """restore_train_state builds the net from the SAVED config and reads
    meta.json and model.pt alone (no ring, envs or generator)."""
    cfg, carry = trained
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ckpt.save(mgr, 3, carry, cfg, LadderState())
    os.remove(os.path.join(mgr.step_dir(3), "carry.pt"))
    ts, saved = ckpt.restore_train_state(mgr, device="cpu")
    assert saved == cfg and saved.train.num_envs == cfg.train.num_envs
    want = carry.train_state
    for (k, v), w in zip(ts.net.state_dict().items(),
                         want.net.state_dict().values()):
        assert torch.equal(v, w), k
    assert ts.step == want.step and ts.opt_state.count == \
        want.opt_state.count
    assert torch.equal(ts.lr_scale, want.lr_scale)
    # cli._load_model takes the checkpoint path, under any preset
    params, _, net_cfg = cli._load_model(get_preset("smoke_9x9").replace(
        env=cfg.env), str(tmp_path))
    assert net_cfg == cfg.net
    np.testing.assert_array_equal(params["stem_conv"]["kernel"],
                                  want.net.to_flax()[0]["stem_conv"]
                                  ["kernel"])


def test_export_is_flax_bytes_and_jax_reads_it(tmp_path):
    """The port's export of a net is byte-for-byte what JAX's
    export_model writes for the same trees (model.msgpack and
    config.json), and JAX's load_model reads it bit-equal."""
    from flax import serialization

    cfg, jcfg = get_preset("tiny_test"), j_get_preset("tiny_test")
    params, stats = init_params(cfg.env, cfg.net, seed=3)
    net = PolicyValueNet.from_flax(cfg.env, cfg.net, params, stats, "cpu")
    p, s = net.to_flax()
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.export_model(ours, p, s, cfg, extra={"iteration": 42})
    jckpt.export_model(theirs, p, s, jcfg, extra={"iteration": 42})
    for name in ("model.msgpack", "config.json"):
        assert filecmp.cmp(os.path.join(ours, name),
                           os.path.join(theirs, name), shallow=False), name
    with open(os.path.join(ours, "model.msgpack"), "rb") as f:
        assert f.read() == serialization.to_bytes(
            {"params": jax.device_get(p), "batch_stats": jax.device_get(s)})
    jp, js, jc = jckpt.load_model(ours)
    assert jc == jcfg
    for got, want in ((jp, p), (js, s)):
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w,
                                          err_msg=str(path))


def test_port_reads_jax_export(tmp_path):
    """JAX's export_model output, read by the port bit-equal (twin of
    test_model_export_roundtrip)."""
    jcfg = j_get_preset("tiny_test")
    ts = jlearner.init_train_state(jcfg.env, jcfg.net, jcfg.train,
                                   jax.random.key(4))
    d = str(tmp_path / "model")
    jckpt.export_model(d, ts.params, ts.batch_stats, jcfg,
                       extra={"iteration": 42})
    params, stats, cfg = ckpt.load_model(d)
    assert cfg.to_json() == jcfg.to_json()
    for got, want in ((params, ts.params), (stats, ts.batch_stats)):
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.device_get(want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_jax_orbax_checkpoint_is_refused_clearly(tmp_path):
    """A JAX run's orbax ckpt/ dir is named as such, with `cli export` as
    the way across, wherever the port would read it."""
    jcfg = j_get_preset("tiny_test")
    mesh = jparallel.make_mesh(1)
    jcarry = jparallel.init_carry(jcfg, jax.random.key(0), mesh)
    jmgr = jckpt.make_manager(str(tmp_path / "ckpt"))
    jckpt.save(jmgr, 3, jcarry, jax.random.key(1), jcfg, JLadderState())
    with pytest.raises(ValueError, match="orbax.*cli export"):
        ckpt.make_manager(str(tmp_path / "ckpt")).latest_step()
    with pytest.raises(ValueError, match="cli export"):
        cli._load_model(get_preset("tiny_test"), str(tmp_path))
    with pytest.raises(ValueError, match="cli export"):
        loop.train(get_preset("tiny_test"), workdir=str(tmp_path),
                   total_iters=1, resume=True, device="cpu",
                   logger=MetricsLogger(None, quiet=True))


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, -1, -32, -33,
    -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, "", "a" * 31,
    "a" * 32, "a" * 255, "a" * 256, "a" * 65536, b"", b"x" * 256,
    b"x" * 65536, [1] * 15, [1] * 16, list(range(65536)), None, True,
    {f"k{i}": i for i in range(16)}, {"a": {"b": [1, "x", b"y"]}}],
    ids=lambda o: f"{type(o).__name__}{len(o) if hasattr(o, '__len__') else o}")
def test_packb_is_msgpacks_encoding(obj):
    """Each msgpack format at its size boundaries, byte-equal to
    msgpack-python's packb and read back by the port's reader."""
    import msgpack
    assert ckpt.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert ckpt.unpackb(ckpt.packb(obj)) == (list(obj) if isinstance(
        obj, tuple) else obj)


@pytest.mark.parametrize("shape", [(), (1,), (3,), (2, 3, 4), (70000,)])
def test_packb_ndarray_ext_is_flax(shape):
    """ndarray leaves as flax's ext type 1, fixext and ext8/16/32 alike."""
    from flax import serialization
    a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    tree = {"x": a, "i": a.astype(np.int8)}
    assert ckpt.packb(tree) == serialization.to_bytes(tree)
    back = ckpt.unpackb(ckpt.packb(tree))
    np.testing.assert_array_equal(back["x"], a)


def test_an_interrupted_save_leaves_no_step(trained, tmp_path, monkeypatch):
    """A save that dies while writing leaves only `<step>.tmp`: the
    latest step stays the last complete one, and the next save of that
    step succeeds."""
    cfg, carry = trained
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    ckpt.save(mgr, 2, carry, cfg, LadderState())
    real_save = torch.save

    def dying(obj, f):
        if "env_state" in obj:
            raise OSError("disk full")
        real_save(obj, f)

    monkeypatch.setattr(torch, "save", dying)
    with pytest.raises(OSError):
        ckpt.save(mgr, 4, carry, cfg, LadderState())
    assert mgr.all_steps() == [2]
    assert os.path.isdir(mgr.step_dir(4) + ".tmp")
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.save(mgr, 4, carry, cfg, LadderState())
    assert mgr.all_steps() == [2, 4]
    assert not os.path.exists(mgr.step_dir(4) + ".tmp")
