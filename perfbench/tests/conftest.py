"""Tests of the benchmark harness. They run on the CPU at small sizes
through the program's plain kernels; tests marked ``chip`` need an NVIDIA
card and skip elsewhere. Run from the repository root:

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small configurations of each kind of traffic: the cells' mixes and
# roles at a 9×9 board, two blocks of 32 channels and random weights
TINY_ROLES = {
    "selfplay": {"preset": "chip_15x15", "weights": "random",
                 "set": ["train.num_envs=4", "mcts.num_simulations=32"]},
    "play": {"preset": "chip_15x15", "weights": "random",
             "set": ["mcts.num_simulations=32"]},
    "train": {"preset": "train_lowsim_15x15", "weights": "random",
              "set": ["train.num_envs=8", "train.selfplay_plies_per_iter=4",
                      "replay.capacity=400", "replay.batch_size=256",
                      "replay.min_fill=16"]},
}
MIXES = {"selfplay": "selfplay400", "play": "play400",
         "train": "gumbel16_train"}
# the cells whose limits a small run of each kind is held to
CELLS = {"selfplay": "gomoku15_4x64.selfplay400",
         "play": "renju19_10x128.play400",
         "train": "gomoku15_4x64.gumbel16_train"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips on the CPU)")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")


def tiny(kind: str, rules: str = "freestyle", sets=()):
    """(configuration, mix) of a small cell of `kind`, with `sets` added
    to its role's overrides."""
    from perfbench import generator
    cfg_doc = {"name": "tiny",
               "env": {"board_size": 9, "n_in_row": 5, "rules": rules},
               "net": {"blocks": 2, "channels": 32, "value_hidden": 32,
                       "compute_dtype": "bfloat16", "use_pallas": True},
               "roles": copy.deepcopy(TINY_ROLES)}
    cfg_doc["roles"][kind]["set"] += list(sets)
    mix = generator.load_json(os.path.join(ROOT, "perfbench", "traffic",
                                         f"{MIXES[kind]}.json"))
    mix["capture"].update(eval_p=0.5, step_p=0.5, root_every=1)
    mix["profile_units"] = 1
    if "device_units" in mix:
        mix["device_units"] = 2
    return cfg_doc, mix


# the small training cell's Gumbel targets swing more than the cell's
# (random weights give flat logits, so σ(q) decides more of π'): its
# search_tv (0.004–0.034 on sound runs) is held to this limit instead
TINY_LIMITS = {"train": {"search_tv": 0.1}}


def cell_limits(kind: str):
    from perfbench import generator
    limits = generator.load_json(os.path.join(ROOT, "perfbench", "limits",
                                            f"{CELLS[kind]}.json"))
    return dict(limits, **TINY_LIMITS.get(kind, {}))


def run_tiny(kind: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
             rules: str = "freestyle", trace: bool = False,
             control: bool = False, limits=None, sets=(),
             stretch: bool = False):
    from perfbench import harness
    cfg_doc, mix = tiny(kind, rules, sets)
    return harness.run(cfg_doc, mix, limits or cell_limits(kind),
                       workload="tiny", seed=seed, seconds=seconds,
                       trace=trace, device="cpu", root=ROOT,
                       t_start=time.perf_counter(), metrics=["setup_s"],
                       control=control, stretch=stretch)
