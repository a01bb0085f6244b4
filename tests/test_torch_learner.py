"""The learner and the training forward: the torch port against the JAX
package. Weights come from ``init_params`` (a numpy seed) and batches
from numpy seeds; both packages get the same arrays. The tight parity
tests run the net in f32; bf16 is held to a looser, stated tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.models import resnet as jresnet
from alphafive_tpu.train import learner as jlearner
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.models.resnet import (PolicyValueNet, init_params,
                                               numpy_tree)
from alphafive_tpu_torch.train import learner

torch.set_num_threads(1)

AUX = learner.AUX_KEYS + ("grad_norm", "lr_scale")


def small(pkg_get_preset, dtype="float32", **train):
    """tiny_test with two blocks (7×7, 16 channels) in `dtype`, and the
    train config's fields in `train`."""
    cfg = pkg_get_preset("tiny_test")
    return cfg.replace(
        env=dataclasses.replace(cfg.env, board_size=7),
        net=dataclasses.replace(cfg.net, blocks=2, compute_dtype=dtype),
        train=dataclasses.replace(cfg.train, **train))


def batch(cfg, b, seed):
    """(features, pi, z, z_valid, pi_valid) as numpy f32: binary feature
    planes, π a distribution over a random support, z in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    s, a = cfg.env.board_size, cfg.env.num_actions
    feats = (rng.random((b, s, s, 4)) < 0.3).astype(np.float32)
    logits = rng.standard_normal((b, a))
    pi = np.where(rng.random((b, a)) < 0.6, np.exp(logits), 0.0)
    pi[:, 0] += 1e-3
    pi = (pi / pi.sum(-1, keepdims=True)).astype(np.float32)
    z = rng.integers(-1, 2, b).astype(np.float32)
    zv = (rng.random(b) < 0.7).astype(np.float32)
    pv = (rng.random(b) < 0.8).astype(np.float32)
    return feats, pi, z, zv, pv


def to_torch(arrays):
    return tuple(torch.from_numpy(np.asarray(x)) for x in arrays)


def to_jax(arrays):
    return tuple(jnp.asarray(x) for x in arrays)


def assert_trees_close(got, want, atol, rtol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], what
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=rtol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def both_nets(seed=0, dtype="float32"):
    cj, ct = small(j_get_preset, dtype), small(get_preset, dtype)
    params, stats = init_params(ct.env, ct.net, seed)
    net = PolicyValueNet.from_flax(ct.env, ct.net, params, stats, "cpu")
    return cj, ct, params, stats, net


def test_to_flax_round_trip():
    _, ct, params, stats, net = both_nets(seed=3)
    got_p, got_s = net.to_flax()
    assert_trees_close(got_p, params, 0, 0, "params")
    assert_trees_close(got_s, stats, 0, 0, "batch_stats")
    assert got_p["block1"]["conv2"]["kernel"].shape == (3, 3, 16, 16)
    assert got_p["policy_fc"]["kernel"].shape == (98, 49)


# (logits/value atol, rtol; batch stats atol, rtol). f32: summation order
# only. bf16: both packages round the conv inputs and the normalised
# activations to bf16 at the same points, but a one-ulp difference (2^-8
# relative) of an activation moves the next layer's outputs by about as
# much again through two blocks and the heads.
FWD_TOL = {"float32": ((2e-5, 2e-5), (1e-6, 1e-5)),
           "bfloat16": ((6e-2, 3e-2), (1e-2, 1e-2))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_apply_train(dtype):
    cj, ct, params, stats, net = both_nets(seed=1, dtype=dtype)
    feats = batch(ct, 32, seed=2)[0]
    (lj, vj), bsj = jresnet.apply_train(
        jresnet.PolicyValueNet(cj.env, cj.net),
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jnp.asarray(feats))
    (lt, vt), new = net.forward_train(torch.from_numpy(feats))
    (atol, rtol), (satol, srtol) = FWD_TOL[dtype]
    assert lt.dtype == vt.dtype == torch.float32
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj),
                               atol=atol, rtol=rtol)
    # the module's own statistics are untouched until they are set
    assert_trees_close(net.to_flax()[1], stats, 0, 0, "running stats")
    net.set_batch_stats(new)
    assert_trees_close(net.to_flax()[1], jax.tree.map(np.asarray, bsj),
                       satol, srtol, "new batch stats")


def test_forward_train_biased_running_variance():
    """The running variance moves toward the biased batch variance, as
    flax's does (torch's own batch norm would take n/(n-1) of it)."""
    _, ct, params, stats, net = both_nets(seed=4)
    feats = torch.from_numpy(batch(ct, 8, seed=5)[0])
    _, new = net.forward_train(feats)
    layer = net.stem
    y = layer._conv(feats.permute(0, 3, 1, 2))
    var = y.var((0, 2, 3), unbiased=False)
    want = 0.99 * layer.bn.running_var + (1 - 0.99) * var
    torch.testing.assert_close(new[0][1], want, atol=1e-6, rtol=1e-5)


def jax_grads(cj, params, stats, b):
    model = jresnet.PolicyValueNet(cj.env, cj.net)
    return jax.grad(lambda p: jlearner.loss_fn(
        p, jax.tree.map(jnp.asarray, stats), model, to_jax(b),
        cj.train)[0])(jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_loss_gradients_match_jax(optimizer):
    """Every gradient of ``loss_fn``, leaf by leaf in flax layout, within
    1e-5 + 1e-4 relative of ``jax.grad`` (f32; the L2 term's gradient
    under sgd included)."""
    cj, ct, params, stats, net = both_nets(seed=6)
    cj = cj.replace(train=dataclasses.replace(cj.train, optimizer=optimizer))
    ct = ct.replace(train=dataclasses.replace(ct.train, optimizer=optimizer))
    b = batch(ct, 32, seed=7)
    loss, _ = learner.loss_fn(net, to_torch(b), ct.train)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert_trees_close(numpy_tree(net.flax_tree(grads)),
                       jax_grads(cj, params, stats, b), 1e-5, 1e-4, "grad")


def jax_opt_state(opt_state, optimizer):
    inner = opt_state[1][0]
    if optimizer == "sgd":
        return {"count": int(opt_state[1][1].count), "trace": inner.trace}
    assert int(inner.count) == int(opt_state[1][2].count)
    return {"count": int(inner.count), "mu": inner.mu, "nu": inner.nu}


STEPS = 4
# moments: the gradient test's 1e-5 carried through each moment's update
# (gradients are clipped to norm <= 1): the trace sums 4 steps at weights
# <= 1 (3.44e-5), Adam's mu weighs them by 0.1, nu takes 0.001 · 2|g| of
# the error per step
MOMENT_ATOL = {"trace": 4e-5, "mu": 4e-6, "nu": 1e-7}


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_train_steps_match_jax(optimizer):
    """Four steps from equal weights on four numpy batches, warm-up 2 (lr
    0, then half, then the full rate) at lr_scale 1.5: every aux metric
    of each step, then params, batch stats, the optimizer's moments,
    its count and ``step``. f32; params and batch stats within 1e-6 +
    1e-4 relative (an Adam step moves a weight by about lr · lr_scale,
    3e-3 here), the moments within MOMENT_ATOL + 1e-4 relative."""
    train = dict(optimizer=optimizer, lr_warmup_steps=2, l2_coef=1e-2)
    cj, ct = small(j_get_preset, **train), small(get_preset, **train)
    params, stats = init_params(ct.env, ct.net, seed=8)
    jts = jlearner.TrainState(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=jlearner.make_optimizer(cj.train).init(
            jax.tree.map(jnp.asarray, params)),
        step=jnp.zeros((), jnp.int32), lr_scale=jnp.float32(1.5))
    ts = learner.init_train_state(ct.env, ct.net, ct.train, params, stats,
                                  "cpu")
    ts.lr_scale = torch.tensor(1.5)
    jstep = jax.jit(lambda t, b: jlearner.train_step(cj.env, cj.net,
                                                     cj.train, t, b))
    for i in range(STEPS):
        b = batch(ct, 32, seed=10 + i)
        jts, jaux = jstep(jts, to_jax(b))
        ts, aux = learner.train_step(ct.env, ct.net, ct.train, ts,
                                     to_torch(b))
        assert set(aux) == set(jaux) == set(AUX)
        for k in AUX:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert ts.step == int(jts.step) == STEPS
    got_p, got_s = ts.net.to_flax()
    assert_trees_close(got_p, jts.params, 1e-6, 1e-4, "params")
    assert_trees_close(got_s, jts.batch_stats, 1e-6, 1e-4, "batch_stats")
    got, want = (learner.opt_state_to_flax(ts),
                 jax_opt_state(jts.opt_state, optimizer))
    assert got.keys() == want.keys() and got["count"] == want["count"]
    for k in got.keys() - {"count"}:
        assert_trees_close(got[k], want[k], MOMENT_ATOL[k], 1e-4, k)
    # the parameters really moved (lr > 0 from the second step)
    moved = max(np.abs(got_p["policy_fc"]["kernel"]
                       - params["policy_fc"]["kernel"]).max(), 0)
    assert moved > 1e-4


def test_first_update_has_lr_zero():
    """optax's schedule reads its count before incrementing it: the first
    learning rate is 0, the next learning_rate / warm-up."""
    cfg = get_preset("tiny_test").train
    assert learner.learning_rate(cfg, 0) == 0.0
    # f32 arithmetic as optax's: (0 - lr) · 0.99 + lr
    np.testing.assert_allclose(learner.learning_rate(cfg, 1),
                               cfg.learning_rate / cfg.lr_warmup_steps,
                               rtol=1e-5)
    assert learner.learning_rate(cfg, 10 ** 6) == np.float32(
        cfg.learning_rate)
    sched = jlearner.optax.linear_schedule(0.0, cfg.learning_rate,
                                           cfg.lr_warmup_steps)
    for c in (0, 1, 7, 99, 100, 250):
        assert learner.learning_rate(cfg, c) == float(sched(c)), c


def tiny_state(cfg):
    params, stats = init_params(cfg.env, cfg.net, seed=0)
    return learner.init_train_state(cfg.env, cfg.net, cfg.train, params,
                                    stats, "cpu")


def test_adapt_lr_scale_directions():
    cfg = get_preset("tiny_test")
    target = cfg.train.kl_target
    scale = lambda kl: float(learner.adapt_lr_scale(
        tiny_state(cfg), torch.tensor(kl), target).lr_scale)
    assert scale(target / 4) > 1.0
    assert scale(target * 4) < 1.0
    assert scale(target) == 1.0


def test_adapt_lr_scale_clamped():
    cfg = get_preset("tiny_test")
    ts = tiny_state(cfg)
    for _ in range(20):
        ts = learner.adapt_lr_scale(ts, torch.tensor(1e9),
                                    cfg.train.kl_target)
    assert float(ts.lr_scale) >= 0.1 - 1e-6
    ts2 = tiny_state(cfg)
    for _ in range(20):
        ts2 = learner.adapt_lr_scale(ts2, torch.tensor(0.0),
                                     cfg.train.kl_target)
    assert float(ts2.lr_scale) <= 10.0 + 1e-6


def test_adapt_lr_scale_respects_cap():
    """Twin of tests/test_train.py::test_adapt_lr_scale_respects_cap."""
    ts = tiny_state(get_preset("tiny_test"))
    for _ in range(10):
        ts = learner.adapt_lr_scale(ts, torch.tensor(1e-5), 0.02,
                                    scale_max=3.0)
    assert float(ts.lr_scale) == pytest.approx(3.0)
    ts = learner.adapt_lr_scale(ts, torch.tensor(1.0), 0.02, scale_max=3.0)
    assert float(ts.lr_scale) == pytest.approx(2.0)


def test_adapt_lr_scale_matches_jax():
    cfg = get_preset("tiny_test")
    ts, jts = tiny_state(cfg), jlearner.TrainState(
        params={}, batch_stats={}, opt_state=(), step=jnp.int32(0),
        lr_scale=jnp.float32(1.0))
    for kl in (1e-4, 1e-4, 0.5, 1e-3, 0.03, 1e-5, 1e-5, 1e-5, 0.09):
        ts = learner.adapt_lr_scale(ts, torch.tensor(kl), 0.02, 3.0)
        jts = jlearner.adapt_lr_scale(jts, jnp.float32(kl), 0.02, 3.0)
        assert float(ts.lr_scale) == float(jts.lr_scale), kl


def test_loss_terms_zero_masked_value():
    """Positions with z_valid = 0 contribute nothing to the value loss."""
    cfg = get_preset("tiny_test")
    ts = tiny_state(cfg)
    b, s, a = 16, cfg.env.board_size, cfg.env.num_actions
    feats = torch.zeros((b, s, s, 4))
    pi = torch.full((b, a), 1.0 / a)
    z = torch.ones(b)
    _, (_, aux) = learner.loss_fn(ts.net, (feats, pi, z, torch.zeros(b)),
                                  cfg.train)
    assert float(aux["value_loss"]) == 0.0
    _, (_, aux2) = learner.loss_fn(ts.net, (feats, pi, z, torch.ones(b)),
                                   cfg.train)
    assert float(aux2["value_loss"]) > 0.0


def test_sgd_option_steps():
    cfg = get_preset("tiny_test")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, optimizer="sgd"))
    ts = tiny_state(cfg)
    assert ts.opt_state.nu == []
    b, s, a = 8, cfg.env.board_size, cfg.env.num_actions
    ts, aux = learner.train_step(
        cfg.env, cfg.net, cfg.train, ts,
        (torch.zeros((b, s, s, 4)), torch.full((b, a), 1.0 / a),
         torch.zeros(b), torch.ones(b)))
    assert ts.step == 1 and ts.opt_state.count == 1
    assert np.isfinite(float(aux["loss"]))
    # the L2 term is in the sgd loss
    np.testing.assert_allclose(
        float(aux["loss"]), float(aux["policy_loss"] + aux["value_loss"]
                                  + aux["l2_loss"]), rtol=1e-6)


def test_adam_loss_excludes_l2_term():
    """Under adam the L2 term stays out of the loss (it is decoupled
    decay in the optimizer); l2_loss stays logged."""
    cfg = get_preset("tiny_test")
    ts = tiny_state(cfg)
    b, s, a = 4, cfg.env.board_size, cfg.env.num_actions
    loss, (_, aux) = learner.loss_fn(
        ts.net, (torch.zeros((b, s, s, 4)), torch.full((b, a), 1.0 / a),
                 torch.zeros(b), torch.ones(b)), cfg.train)
    expect = (float(aux["policy_loss"])
              + cfg.train.value_loss_weight * float(aux["value_loss"]))
    assert float(loss.detach()) == np.float32(expect)
    assert float(aux["l2_loss"]) > 0.0


def test_head_collapse_mechanism_adam_l2_vs_adamw():
    """Twin of tests/test_learner.py's head-collapse reproduction, on the
    port's optimizer. A linear policy head with input-independent targets
    (the bias-only point is the data optimum, so the data gradient
    vanishes): Adam with L2 in the loss (decay off) drives the kernel to
    zero at a rate set by lr, not by the L2 coefficient; the shipped
    decoupled decay keeps essentially all of the kernel's mass."""
    d_in, n_act, b = 8, 5, 64
    lr, n_steps = 1e-3, 400
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b, d_in)).astype(np.float32))
    pi = torch.full((b, n_act), 1.0 / n_act)
    base = dataclasses.replace(get_preset("tiny_test").train,
                               learning_rate=lr, lr_warmup_steps=1)

    def run(cfg, l2_in_loss):
        w = torch.full((d_in, n_act), 0.1, requires_grad=True)
        bias = torch.zeros(n_act, requires_grad=True)
        st = learner.init_opt_state(cfg, [w, bias])
        kmax = []
        for _ in range(n_steps):
            logp = torch.log_softmax(x @ w + bias, -1)
            loss = -(pi * logp).sum(-1).mean() + l2_in_loss * w.square().sum()
            grads = torch.autograd.grad(loss, [w, bias])
            updates, _ = learner.optimizer_update(
                cfg, st, [w, bias], [True, False], list(grads),
                torch.tensor(1.0))
            with torch.no_grad():
                torch._foreach_add_([w, bias], updates)
            kmax.append(float(w.detach().abs().max()))
        return np.asarray(kmax)

    no_decay = dataclasses.replace(base, l2_coef=0.0)
    k_old_a = run(no_decay, 1e-4)
    k_old_b = run(no_decay, 1e-3)
    # collapsed by three orders of magnitude. (JAX's twin reaches 1e-7:
    # near w = 0 torch's log-softmax gradient keeps ~1e-8 of rounding
    # noise beside the 2·l2·w pull, and Adam normalises it, so the kernel
    # settles near 1e-5 at l2 1e-4 and 1e-6 at 1e-3.)
    assert k_old_a[-1] < 1e-4, k_old_a[-1]
    assert k_old_b[-1] < 1e-4, k_old_b[-1]
    first_dead = lambda k: int(np.argmax(k < 1e-3))
    da, db = first_dead(k_old_a), first_dead(k_old_b)
    assert 0 < db <= da and (da - db) / da < 0.25, (da, db)
    shipped = dataclasses.replace(base, l2_coef=1e-4)
    assert shipped.optimizer == "adam"
    k_new = run(shipped, 0.0)
    assert k_new[-1] > 0.9 * 0.1, k_new[-1]


def test_decoupled_decay_is_coefficient_bounded():
    """Twin of tests/test_train.py::test_decoupled_decay_is_coefficient_
    bounded: with zero gradients, the third update shrinks a kernel by
    exactly lr·l2_coef·w (lr at count 2) and leaves the bias alone."""
    cfg = get_preset("tiny_test").train
    assert cfg.optimizer == "adam"
    params = [torch.full((4, 4), 0.5), torch.full((4,), 0.5)]
    st = learner.init_opt_state(cfg, params)
    zero = [torch.zeros(4, 4), torch.zeros(4)]
    for _ in range(3):
        (u_kernel, u_bias), _ = learner.optimizer_update(
            cfg, st, params, [True, False], zero, torch.tensor(1.0))
    # the third update call sees schedule count 2 (counts start at 0)
    lr_now = min(2 / max(cfg.lr_warmup_steps, 1), 1.0) * cfg.learning_rate
    expect = -lr_now * cfg.l2_coef * 0.5
    np.testing.assert_allclose(u_kernel.numpy(), expect, rtol=1e-5)
    np.testing.assert_array_equal(u_bias.numpy(), 0.0)
    assert abs(expect) < cfg.learning_rate * 1e-3


def test_learner_step_decreases_loss():
    """Twin of tests/test_train.py::test_learner_step_decreases_loss: 40
    steps on one batch lower its loss."""
    cfg = get_preset("tiny_test")
    ts = tiny_state(cfg)
    rng = np.random.default_rng(0)
    b, s, a = 64, cfg.env.board_size, cfg.env.num_actions
    feats = torch.from_numpy(rng.random((b, s, s, 4)).astype(np.float32))
    pi = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, a)).astype(np.float32)), -1)
    z = torch.from_numpy(np.sign(rng.standard_normal(b)).astype(np.float32))
    losses = []
    for _ in range(40):
        ts, aux = learner.train_step(cfg.env, cfg.net, cfg.train, ts,
                                     (feats, pi, z, torch.ones(b)))
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], losses[:3] + losses[-3:]
    assert ts.step == 40


def test_clip_divides_by_the_norm():
    """Above norm 1 the gradients are divided by their global norm exactly
    (optax), not by norm + 1e-6 (torch's clip_grad_norm_); below it they
    pass unchanged. sgd with momentum 0 and lr 1 exposes the clipped
    gradient as the update."""
    cfg = dataclasses.replace(get_preset("tiny_test").train, optimizer="sgd",
                              momentum=0.0, learning_rate=1.0,
                              lr_warmup_steps=1)
    for scale in (3.0, 0.25):
        g = [torch.tensor([3.0, 4.0]) * scale / 5, torch.tensor([0.0])]
        p = [torch.zeros(2), torch.zeros(1)]
        st = learner.init_opt_state(cfg, p)
        st.count = 1
        (u, _), norm = learner.optimizer_update(cfg, st, p, [True, False],
                                                g, torch.tensor(1.0))
        want = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(x.numpy()) for x in g], None)[0]
        assert float(norm) == pytest.approx(scale)
        np.testing.assert_array_equal(-u.numpy(), np.asarray(want[0]))


def test_debug_nans_raises_on_a_nan_batch():
    """Under autograd's anomaly mode (``cli --debug-nans``, the
    counterpart of ``jax_debug_nans``) a batch holding a NaN raises
    FloatingPointError naming the loss before any weight moves; without
    it the step runs and returns the NaN loss."""
    cfg = get_preset("tiny_test")
    ts = tiny_state(cfg)
    rng = np.random.default_rng(0)
    b, s, a = 8, cfg.env.board_size, cfg.env.num_actions
    feats = torch.from_numpy(rng.random((b, s, s, 4)).astype(np.float32))
    feats[3, 1, 2, 0] = float("nan")
    nan_batch = (feats, torch.full((b, a), 1.0 / a), torch.ones(b),
                 torch.ones(b))
    before = [p.clone() for p in ts.net.parameters()]
    with torch.autograd.detect_anomaly():
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            learner.train_step(cfg.env, cfg.net, cfg.train, ts, nan_batch)
    assert ts.step == 0
    assert all(torch.equal(p, q) for p, q in zip(before,
                                                 ts.net.parameters()))
    _, aux = learner.train_step(cfg.env, cfg.net, cfg.train, ts, nan_batch)
    assert np.isnan(float(aux["loss"]))


def test_check_finite_names_the_first_non_finite_tensor():
    ok = torch.ones(3)
    learner.check_finite([("a", ok), ("b", torch.zeros(()))])
    with pytest.raises(FloatingPointError, match="non-finite b$"):
        learner.check_finite([("a", ok), ("b", torch.tensor([1.0, np.inf])),
                              ("c", torch.tensor(np.nan))])


def test_debug_nans_checks_the_iteration_metrics(monkeypatch, capsys):
    """`--debug-nans` turns the anomaly mode on; under it a non-finite
    metric of the iteration raises FloatingPointError naming it."""
    from alphafive_tpu_torch import cli, parallel
    from alphafive_tpu_torch.parallel import mesh

    try:
        assert cli.main(["bench", "--preset", "tiny_test", "--device", "cpu",
                         "--plies", "1", "--set", "train.num_envs=2",
                         "--debug-nans"]) == 0
        assert torch.is_anomaly_enabled()
        capsys.readouterr()
        cfg = get_preset("tiny_test")
        cfg = cfg.replace(replay=dataclasses.replace(cfg.replay, min_fill=0))
        nan_loss = dict.fromkeys(mesh.AUX_KEYS, 0.0) | {
            "loss": torch.tensor(np.nan)}
        monkeypatch.setattr(mesh, "learner_phase", lambda *a: nan_loss)
        carry = parallel.init_carry(cfg, "cpu")
        with pytest.raises(FloatingPointError, match="'loss'"):
            parallel.make_train_iteration(cfg)(carry)
    finally:
        torch.autograd.set_detect_anomaly(False)
