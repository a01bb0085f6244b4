"""Config: the port's copy serializes and loads exactly as the JAX package's."""

import glob
import json
import os

import pytest
import torch

from alphafive_tpu import config as jconfig
from alphafive_tpu_torch import config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_json_equal(name):
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    assert config.get_preset(name).to_json() == \
        jconfig.get_preset(name).to_json()


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "pretrained", "*",
                                          "config.json"))))
def test_bundle_config_loads_equal(path):
    with open(path) as f:
        raw = json.dumps(json.load(f)["config"])
    got = config.RunConfig.from_json(raw)
    assert got.to_json() == jconfig.RunConfig.from_json(raw).to_json()
    # round trip
    assert config.RunConfig.from_json(got.to_json()) == got


def test_apply_overrides():
    cfg = config.apply_overrides(
        config.get_preset("chip_15x15"),
        ["net.use_pallas=true", "mcts.branch_cap=64", "mcts.max_depth=none",
         "train.num_envs=8", "mcts.c_puct=2.5", "env.rules=renju"])
    assert cfg.net.use_pallas is True
    assert cfg.mcts.branch_cap == 64 and cfg.mcts.max_depth is None
    assert cfg.train.num_envs == 8 and cfg.mcts.c_puct == 2.5
    assert cfg.env.rules == "renju"
    for bad in (["net.use_pallas=maybe"], ["train.num_envs=none"],
                ["mcts.nonexistent=1"], ["net.channels"]):
        with pytest.raises(ValueError):
            config.apply_overrides(cfg, bad)
