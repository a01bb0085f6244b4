"""Model surgery: the port's ``models/surgery.py`` against the JAX
package's on the same flax-layout trees, with JAX's random draws
rebuilt from its keys and injected, and the port's own function
preservation (twins of ``tests/test_surgery.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import NetConfig as JNetConfig
from alphafive_tpu.models import surgery as jsurgery
from alphafive_tpu.models.resnet import PolicyValueNet as JNet
from alphafive_tpu.models.resnet import apply_train, init_variables
from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.models import surgery
from alphafive_tpu_torch.models.resnet import PolicyValueNet

torch.set_num_threads(1)

NET = dict(blocks=2, channels=8, value_hidden=16, compute_dtype="float32")


def numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def trained_ish(size, key):
    """A JAX init moved by two train-mode forwards, so the batch
    statistics are not trivial (``tests/test_surgery.py``'s source)."""
    env, net = JEnvConfig(board_size=size), JNetConfig(**NET)
    variables = init_variables(env, net, key)
    params, bs = variables["params"], variables["batch_stats"]
    for i in range(2):
        x = jax.random.normal(jax.random.fold_in(key, i), (2, size, size, 4))
        _, bs = apply_train(JNet(env, net), params, bs, x)
    return numpy_tree({"params": params, "batch_stats": bs})


@pytest.fixture(scope="module")
def src():
    return trained_ish(7, jax.random.key(7))


def widen_draws(key, old_c, new_c, blocks):
    """JAX widen's draws from `key`: the map g, then the noise of the
    stem and of each block's two convs, in its split order."""
    key, kg = jax.random.split(key)
    extra = jax.random.randint(kg, (new_c - old_c,), 0, old_c)
    g = np.concatenate([np.arange(old_c), np.asarray(extra)])
    key, k0 = jax.random.split(key)
    eps = [jax.random.normal(k0, (3, 3, 4, new_c - old_c), jnp.float32)]
    for _ in range(blocks):
        key, k1, k2 = jax.random.split(key, 3)
        eps += [jax.random.normal(k, (3, 3, new_c, new_c - old_c),
                                  jnp.float32) for k in (k1, k2)]
    return g, [np.asarray(e) for e in eps]


def deepen_draws(key, c, old_blocks, new_blocks):
    he = jax.nn.initializers.he_normal()
    out = []
    for _ in range(old_blocks, new_blocks):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(he(k1, (3, 3, c, c), jnp.float32)))
    return out


def assert_trees(got, want, atol=0.0):
    assert jax.tree.structure(got) == jax.tree.structure(numpy_tree(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if atol:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("noise", [0.0, 1e-2])
def test_widen_matches_jax(src, noise):
    key = jax.random.key(1)
    want = jsurgery.widen(src, 12, key, noise=noise)
    g, eps = widen_draws(key, 8, 12, 2)
    got = surgery.widen(src, 12, noise=noise, g=g, eps=eps)
    assert_trees(got, want, atol=1e-6)


def test_deepen_matches_jax(src):
    key = jax.random.key(3)
    want = jsurgery.deepen(src, 4, key)
    got = surgery.deepen(src, 4, he=deepen_draws(key, 8, 2, 4))
    assert_trees(got, want)


@pytest.mark.parametrize("old,new", [(9, 15), (15, 19), (15, 9)])
def test_resize_board_matches_jax(old, new):
    """jax.image.resize's linear kernel, antialiased when shrinking,
    applied axis by axis: within 1e-6 of JAX's einsum."""
    v = trained_ish(old, jax.random.key(old))
    want = jsurgery.resize_board(v, old, new)
    got = surgery.resize_board(v, old, new)
    assert_trees(got, want, atol=1e-6)


def test_transfer_matches_jax(src):
    key = jax.random.key(6)
    dst_env = JEnvConfig(board_size=9, rules="renju")
    dst_net = JNetConfig(blocks=4, channels=12, value_hidden=16,
                         compute_dtype="float32")
    want = jsurgery.transfer(src, JEnvConfig(board_size=7), JNetConfig(**NET),
                             dst_env, dst_net, key)
    k1, k2 = jax.random.split(key)
    g, eps = widen_draws(k1, 8, 12, 2)
    got = surgery.transfer(
        src, EnvConfig(board_size=7), NetConfig(**NET),
        EnvConfig(board_size=9, rules="renju"),
        NetConfig(blocks=4, channels=12, value_hidden=16,
                  compute_dtype="float32"),
        g=g, eps=eps, he=deepen_draws(k2, 12, 2, 4))
    assert_trees(got, want, atol=1e-6)


def outputs(size, net, variables, x, train=False):
    m = PolicyValueNet.from_flax(EnvConfig(board_size=size), NetConfig(**net),
                                 variables["params"],
                                 variables["batch_stats"], "cpu")
    x = torch.from_numpy(x)
    if train:
        return [t.detach().numpy() for t in m.forward_train(x)[0]]
    return [t.numpy() for t in m(x)]


X7 = np.random.default_rng(2).standard_normal((5, 7, 7, 4)).astype(np.float32)


def test_widen_preserves_function(src):
    wide = surgery.widen(src, 12, torch.Generator().manual_seed(1),
                         noise=0.0)
    for got, want in zip(outputs(7, dict(NET, channels=12), wide, X7),
                         outputs(7, NET, src, X7)):
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_widen_noise_breaks_symmetry(src):
    wide = surgery.widen(src, 12, torch.Generator().manual_seed(1),
                         noise=1e-2)
    k = wide["params"]["block0"]["conv1"]["kernel"]
    assert not np.allclose(k[..., 8:], 0.0)
    diffs = [np.abs(k[..., j] - k[..., i]).max()
             for j in range(8, 12) for i in range(8)]
    assert min(diffs) > 0.0
    # the generator makes the draws: the same seed, the same result
    again = surgery.widen(src, 12, torch.Generator().manual_seed(1),
                          noise=1e-2)
    np.testing.assert_array_equal(again["params"]["block0"]["conv1"]
                                  ["kernel"], k)


@pytest.mark.parametrize("train", [False, True])
def test_deepen_preserves_function(src, train):
    """Exact in eval mode; in train mode batch norm of the zero conv2
    output stays zero, so the first steps after surgery see the same
    function."""
    deep = surgery.deepen(src, 4, torch.Generator().manual_seed(3))
    got = outputs(7, dict(NET, blocks=4), deep, X7, train)
    want = outputs(7, NET, src, X7, train)
    for g, w in zip(got, want):
        if train:
            np.testing.assert_allclose(g, w, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


def test_resize_board_shapes_and_structure(src):
    big = surgery.resize_board(src, 7, 9)
    p = big["params"]
    assert p["policy_fc"]["kernel"].shape == (2 * 81, 81)
    assert p["policy_fc"]["bias"].shape == (81,)
    assert p["value_fc1"]["kernel"].shape == (81, 16)
    assert np.isfinite(p["policy_fc"]["kernel"]).all()

    def diag_ratio(kernel, s):
        w = np.abs(np.asarray(kernel).reshape(s, s, 2, s, s))
        idx = np.arange(s)
        diag = w[idx[:, None], idx[None, :], :, idx[:, None],
                 idx[None, :]].mean()
        return diag / w.mean()
    assert diag_ratio(p["policy_fc"]["kernel"], 9) > 0.5 * diag_ratio(
        src["params"]["policy_fc"]["kernel"], 7)
    # the resized net runs at the new board size
    x = np.random.default_rng(3).standard_normal((2, 9, 9, 4)).astype(
        np.float32)
    logits, value = outputs(9, NET, big, x)
    assert logits.shape == (2, 81) and np.isfinite(logits).all()
    assert np.isfinite(value).all()


def test_transfer_rejects_narrowing(src):
    with pytest.raises(ValueError, match="narrow"):
        surgery.transfer(src, EnvConfig(board_size=7), NetConfig(**NET),
                         EnvConfig(board_size=7),
                         NetConfig(blocks=2, channels=4, value_hidden=16),
                         torch.Generator().manual_seed(0))


def test_make_transfer_init_script(tmp_path):
    """The port's make_transfer_init writes a bundle for the destination
    preset that JAX's load_model reads; at noise 0 the widened, deepened
    net computes the source's function on the same board."""
    from alphafive_tpu.train import checkpoint as jckpt
    from alphafive_tpu_torch.config import get_preset
    from alphafive_tpu_torch.models.resnet import init_params
    from alphafive_tpu_torch.scripts import make_transfer_init
    from alphafive_tpu_torch.train import checkpoint as ckpt

    dst = get_preset("tiny_test")
    src_cfg = dst.replace(net=NetConfig(blocks=1, channels=8,
                                        value_hidden=16,
                                        compute_dtype="float32"))
    params, stats = init_params(src_cfg.env, src_cfg.net, seed=5)
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    ckpt.export_model(src, params, stats, src_cfg)
    assert make_transfer_init.main(["--src", src, "--preset", "tiny_test",
                                    "--out", out, "--noise", "0"]) == 0
    jp, js, jcfg = jckpt.load_model(out)
    assert jcfg.name == "tiny_test" and jcfg.net.channels == 16
    got = numpy_tree({"params": jp, "batch_stats": js})
    x = np.random.default_rng(4).standard_normal((3, 5, 5, 4)).astype(
        np.float32)
    size = dst.env.board_size
    for g, w in zip(outputs(size, dict(NET, blocks=1, channels=16), got, x),
                    outputs(size, dict(NET, blocks=1), {
                        "params": params, "batch_stats": stats}, x)):
        np.testing.assert_allclose(g, w, atol=2e-4)
