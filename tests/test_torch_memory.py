"""The memory guard's estimate: the port's ``utils/memory.py`` against the
JAX package's, term by term."""

import dataclasses

import pytest
import torch

from alphafive_tpu.config import PRESETS
from alphafive_tpu.config import get_preset as j_get_preset
from alphafive_tpu.utils import memory as jmemory
from alphafive_tpu_torch import cli
from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.utils import memory

JAX_BYTES = {"float32": 4, "bfloat16": 2, "int16": 2}


def jax_terms(cfg, n):
    """alphafive_tpu/utils/memory.py's estimate, term by term."""
    e = -(-cfg.train.num_envs // n)
    a, nn = cfg.env.num_actions, cfg.mcts.num_simulations + 1
    c = cfg.mcts.branch_cap or a
    slot = (2 + JAX_BYTES[cfg.mcts.value_dtype]
            + JAX_BYTES[cfg.mcts.prior_dtype] + 2 + 2)
    per_env_tree = nn * c * slot + nn * (1 + 1 + 4 + 4) + nn * a
    return {
        "tree": int(e * per_env_tree * 1.5),
        "act": e * cfg.mcts.leaf_batch * a * cfg.net.channels
        * JAX_BYTES[cfg.net.compute_dtype] * 4,
        "replay": (cfg.replay.capacity // n) * (3 * a + 3),
        "pending": 2 * cfg.train.selfplay_plies_per_iter * e * (5 * a + 3),
        "params": 64_000_000}


@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("n", [1, 8])
def test_terms_follow_jax(name, n):
    """Equal where the layouts agree (ring, recordings row, tree nodes,
    parameters); the port's widths and copies where they differ: int32
    tree slots, f32 activations over the Gumbel lanes, three staged
    chunks, and the learner's activations."""
    jcfg, cfg = j_get_preset(name), get_preset(name)
    want = jax_terms(jcfg, n)
    assert sum(want.values()) == jmemory.estimate_device_bytes(jcfg, n)
    got = memory.estimate_terms(cfg, n)
    assert memory.estimate_device_bytes(cfg, n) == sum(got.values())
    assert got["params"] == want["params"]
    assert got["replay"] == want["replay"]
    assert got["pending"] * 2 == want["pending"] * 3
    m = cfg.mcts
    lanes = m.gumbel_m if m.root_selection == "gumbel" else m.leaf_batch
    assert got["act"] * JAX_BYTES[cfg.net.compute_dtype] * m.leaf_batch \
        == want["act"] * 4 * lanes
    # the tree: JAX's formula with 4-byte n, w and child, and cand_act
    # only on the capped tree
    e = -(-cfg.train.num_envs // n)
    a, nn = cfg.env.num_actions, m.num_simulations + 1
    c = m.branch_cap or a
    slot = 12 + JAX_BYTES[m.prior_dtype] + (4 if m.branch_cap else 0)
    assert got["tree"] == int(e * (nn * c * slot + nn * 10 + nn * a) * 1.5)
    layers = 2 * cfg.net.blocks + 3
    assert got["learner"] == (cfg.replay.batch_size // n) * a \
        * cfg.net.channels * 8 * layers


def test_unknown_dtype_is_no_key_error():
    """A dtype the table does not list (float16) takes torch's itemsize;
    the JAX guard raises a bare KeyError there. A name that is no dtype
    at all is refused by name."""
    cfg = get_preset("chip_15x15")
    f16 = cfg.replace(net=dataclasses.replace(cfg.net, compute_dtype="float16"),
                      mcts=dataclasses.replace(cfg.mcts,
                                               prior_dtype="float16"))
    assert memory.estimate_device_bytes(f16) == \
        memory.estimate_device_bytes(cfg.replace(mcts=dataclasses.replace(
            cfg.mcts, prior_dtype="bfloat16")))
    jcfg = j_get_preset("chip_15x15")
    with pytest.raises(KeyError):
        jmemory.estimate_device_bytes(jcfg.replace(mcts=dataclasses.replace(
            jcfg.mcts, prior_dtype="float16")), 1)
    bad = cfg.replace(mcts=dataclasses.replace(cfg.mcts, prior_dtype="nope"))
    with pytest.raises(ValueError, match="nope"):
        memory.estimate_device_bytes(bad)


def test_budget_error_and_the_cpu_skip():
    cfg = get_preset("pod_v5p16")
    est = memory.estimate_device_bytes(cfg)
    assert memory.budget_error(cfg, 1, budget=est) is None
    msg = memory.budget_error(cfg, 1, budget=est - 1)
    assert "refusing" in msg and "--allow-oversubscribe" in msg

    class Args:
        allow_oversubscribe = False
    # host memory is not guarded, whatever the estimate
    assert cli._check_device_budget(cfg, Args, torch.device("cpu")) is None


def test_the_guard_sizes_each_rank(monkeypatch):
    """The CLI's guard passes the world size: pod_v5p16 (8,192 envs, a
    1,000,000-row ring, meant for 8 devices) is refused on one rank of a
    card whose budget is below its whole estimate and fits on each of 8
    ranks, which hold an eighth of the envs, the ring and the batch."""
    from alphafive_tpu_torch.parallel import distributed
    cfg = get_preset("pod_v5p16")
    whole, share = (memory.estimate_device_bytes(cfg, n) for n in (1, 8))
    budget = (whole + share) // 2

    class Args:
        allow_oversubscribe = False
    monkeypatch.setattr(memory, "device_budget", lambda device: budget)
    cuda = torch.device("cuda")
    monkeypatch.setattr(distributed, "world", lambda: 1)
    with pytest.raises(SystemExit, match="over 1 device"):
        cli._check_device_budget(cfg, Args, cuda)
    monkeypatch.setattr(distributed, "world", lambda: 8)
    assert cli._check_device_budget(cfg, Args, cuda) is None
    assert share < whole / 7
