"""Policy-value net and bundle loading: the torch port against the JAX package.

Flax variables (initialised, then perturbed with numpy noise so batch-norm
folding is not trivial) go through ``from_flax`` into the port's two
forwards; the JAX side runs ``apply_eval`` and ``apply_eval_fused`` with
the Pallas kernel in interpret mode. The bundles are read by the port's
own msgpack decoder and by flax.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafive_tpu.config import EnvConfig as JEnvConfig
from alphafive_tpu.config import NetConfig as JNetConfig
from alphafive_tpu.models.resnet import (PolicyValueNet as JNet, apply_eval,
                                         apply_eval_fused, init_variables)
from alphafive_tpu.train import checkpoint as jckpt
from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.models.resnet import (FusedPolicyValueNet,
                                               PolicyValueNet, init_params)
from alphafive_tpu_torch.train import checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = sorted(os.path.basename(os.path.dirname(p)) for p in
                 glob.glob(os.path.join(ROOT, "pretrained", "*",
                                        "model.msgpack")))


def perturbed_variables(env, net, seed):
    rng = np.random.default_rng(seed)
    v = init_variables(env, net, jax.random.key(seed))
    to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    bs = jax.tree.map(lambda a: a + 0.3 * rng.random(a.shape, np.float32)
                      + 0.05, to_np(v["batch_stats"]))
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), to_np(v["params"]))
    return params, bs


def both_configs(size, **net_kw):
    return ((JEnvConfig(board_size=size, n_in_row=4), JNetConfig(**net_kw)),
            (EnvConfig(board_size=size, n_in_row=4), NetConfig(**net_kw)))


def run_both(size, dtype, seed, batch=4, **net_kw):
    (ej, nj), (et, nt) = both_configs(size, compute_dtype=dtype, **net_kw)
    params, bs = perturbed_variables(ej, nj, seed)
    x = np.random.default_rng(seed + 1).random(
        (batch, size, size, 4)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, bs)
    ref = jax.jit(lambda p, b, f: apply_eval(JNet(ej, nj), p, b, f))(
        jp, jb, jnp.asarray(x))
    ref_fused = apply_eval_fused(ej, nj, jp, jb, jnp.asarray(x),
                                 interpret=True)
    xt = torch.from_numpy(x)
    got = PolicyValueNet.from_flax(et, nt, params, bs, "cpu")(xt)
    got_fused = FusedPolicyValueNet(et, nt, params, bs, "cpu")(xt)
    return ref, ref_fused, got, got_fused


def assert_close(got, want, atol, rtol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("size,blocks,channels", [(5, 1, 16), (7, 2, 32)])
def test_forwards_match_jax_f32(size, blocks, channels):
    ref, ref_fused, got, got_fused = run_both(
        size, "float32", seed=size, blocks=blocks, channels=channels,
        value_hidden=16)
    # tests/test_pallas.py's tolerance between the two JAX forwards
    assert_close(got, ref, 2e-4, 2e-4)
    assert_close(got_fused, ref_fused, 2e-4, 2e-4)
    assert_close(got_fused, ref, 2e-4, 2e-4)


def test_forwards_match_jax_bf16():
    """bf16 trunk, f32 heads. The frameworks round the conv outputs and
    batch norm to bf16 at different points (flax normalizes in bf16, the
    port in f32), so activations differ by a few bf16 ulps (2^-8
    relative) per layer; over two blocks and the f32 heads that stays
    under 5e-2 absolute on logits of unit scale."""
    ref, ref_fused, got, got_fused = run_both(
        7, "bfloat16", seed=3, blocks=2, channels=32, value_hidden=16)
    assert_close(got, ref, 5e-2, 5e-2)
    assert_close(got_fused, ref_fused, 5e-2, 5e-2)


@pytest.mark.parametrize("bundle", BUNDLES)
def test_bundle_reader_matches_flax(bundle):
    path = os.path.join(ROOT, "pretrained", bundle)
    params, bs, cfg = checkpoint.load_model(path)
    jparams, jbs, jcfg = jckpt.load_model(path)
    assert cfg.to_json() == jcfg.to_json()
    for mine, theirs in ((params, jparams), (bs, jbs)):
        flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
        assert [k for k, _ in flat_m] == [k for k, _ in flat_t]
        for (k, a), (_, b) in zip(flat_m, flat_t):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_pretrained_9x9_forward_matches_jax():
    params, bs, cfg = checkpoint.load_model(
        os.path.join(ROOT, "pretrained", "9x9"))
    jparams, jbs, jcfg = jckpt.load_model(
        os.path.join(ROOT, "pretrained", "9x9"))
    net_t = dataclasses.replace(cfg.net, compute_dtype="float32")
    net_j = dataclasses.replace(jcfg.net, compute_dtype="float32")
    x = (np.random.default_rng(9).random((8, 9, 9, 4)) < 0.3).astype(
        np.float32)
    ref = jax.jit(lambda p, b, f: apply_eval(JNet(jcfg.env, net_j), p, b,
                                             f))(jparams, jbs, jnp.asarray(x))
    xt = torch.from_numpy(x)
    assert_close(PolicyValueNet.from_flax(cfg.env, net_t, params, bs,
                                         "cpu")(xt),
                 ref, 2e-4, 2e-4)
    assert_close(FusedPolicyValueNet(cfg.env, net_t, params, bs, "cpu")(xt),
                 ref, 2e-4, 2e-4)


def test_unknown_msgpack_content_raises():
    ext = bytes([0xC7, 3, 2, 1, 2, 3])          # ext 8 with code 2
    with pytest.raises(ValueError):
        checkpoint.unpackb(ext)
    with pytest.raises(ValueError):
        checkpoint.unpackb(bytes([0xC1]))       # never-used type byte
    assert checkpoint.unpackb(bytes([0x82, 0xA1, 0x61, 0x01, 0xA1, 0x62,
                                     0xCB]) + np.float64(2.5).tobytes()[::-1]
                              ) == {"a": 1, "b": 2.5}


def test_init_params_matches_flax_layout():
    (ej, nj), (et, nt) = both_configs(7, blocks=2, channels=32,
                                      value_hidden=16)
    v = init_variables(ej, nj, jax.random.key(0))
    params, bs = init_params(et, nt, seed=0)
    for mine, theirs in ((params, v["params"]), (bs, v["batch_stats"])):
        shapes_m = jax.tree.map(np.shape, mine)
        shapes_t = jax.tree.map(np.shape, theirs)
        assert shapes_m == shapes_t
