"""The general traffic generator: what every kind of traffic shares, and
the kinds found by name.

A kind of traffic is a file ``perfbench/kinds/<kind>.py`` with a class
``Kind`` (a subclass of ``Base``); a mix's data file
(``perfbench/traffic/<mix>.json``) names its kind and sets it, with a
configuration (``perfbench/configs/<config>.json``). A kind builds its
state from the configuration and the seed, warms up every shape its
traffic uses (set-up), then runs one whole unit a call of ``unit()`` (a
lockstep ply of self-play, a training iteration, an AI move). Each unit
is a closed loop: the next starts when the last ends. ``Kind.NUMBERS``
names the numbers its check compares, each with a limit in the cell's
``perfbench/limits/<workload>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import bundle as ref_bundle

HERE = os.path.dirname(os.path.abspath(__file__))


def run_config(cfg_doc: Dict, mix: Dict):
    """The program's RunConfig for a configuration under a mix: the
    role's preset with the configuration's env and net and the role's
    and the mix's ``--set`` overrides."""
    from alphafive_tpu_torch.config import apply_overrides, get_preset
    role = cfg_doc["roles"][mix["role"]]
    sets = ([f"env.{k}={v}" for k, v in cfg_doc["env"].items()]
            + [f"net.{k}={v}" for k, v in cfg_doc["net"].items()]
            + role.get("set", []) + mix.get("set", []))
    return apply_overrides(get_preset(role["preset"]), sets)


def random_weights(env: Dict, net: Dict, seed: int):
    """Flax-layout (params, batch_stats) drawn from `seed` (He-scaled
    kernels, perturbed batch norm): for configurations that name no
    bundle, as the CPU tests' small ones."""
    rng = np.random.default_rng(seed)
    c, a, hid = net["channels"], env["board_size"] ** 2, net["value_hidden"]
    f32 = np.float32

    def conv(k, cin, cout):
        return {"kernel": (rng.standard_normal((k, k, cin, cout))
                           * (2.0 / (k * k * cin)) ** 0.5).astype(f32)}

    def dense(cin, cout):
        return {"kernel": (rng.standard_normal((cin, cout))
                           * cin ** -0.5).astype(f32),
                "bias": (0.1 * rng.standard_normal(cout)).astype(f32)}

    def bn(n):
        return ({"scale": (1 + 0.1 * rng.standard_normal(n)).astype(f32),
                 "bias": (0.1 * rng.standard_normal(n)).astype(f32)},
                {"mean": (0.1 * rng.standard_normal(n)).astype(f32),
                 "var": (1 + 0.2 * rng.random(n)).astype(f32)})

    params, stats = {"stem_conv": conv(3, 4, c)}, {}
    params["stem_bn"], stats["stem_bn"] = bn(c)
    for i in range(net["blocks"]):
        p, s = {}, {}
        p["conv1"], p["conv2"] = conv(3, c, c), conv(3, c, c)
        (p["bn1"], s["bn1"]), (p["bn2"], s["bn2"]) = bn(c), bn(c)
        params[f"block{i}"], stats[f"block{i}"] = p, s
    params["policy_conv"] = conv(1, c, 2)
    params["policy_bn"], stats["policy_bn"] = bn(2)
    params["policy_fc"] = dense(2 * a, a)
    params["value_conv"] = conv(1, c, 1)
    params["value_bn"], stats["value_bn"] = bn(1)
    params["value_fc1"], params["value_fc2"] = dense(a, hid), dense(hid, 1)
    return params, stats


def load_weights(ctx) -> tuple:
    """(params, batch_stats) of the role's bundle, read by the
    benchmark's own reader and checked against the configuration's
    sizes; handed as the same numpy trees to the program and to the
    reference."""
    path = ctx.cfg_doc["roles"][ctx.mix["role"]]["weights"]
    if path == "random":
        return random_weights(ctx.cfg_doc["env"], ctx.cfg_doc["net"],
                              ctx.seed)
    params, stats, saved = ref_bundle.load(os.path.join(ctx.root, path))
    want = (ctx.cfg_doc["env"]["board_size"], ctx.cfg_doc["net"]["blocks"],
            ctx.cfg_doc["net"]["channels"],
            ctx.cfg_doc["net"]["value_hidden"])
    got = (saved["env"]["board_size"], saved["net"]["blocks"],
           saved["net"]["channels"], saved["net"]["value_hidden"])
    if want != got:
        raise ValueError(f"{path} holds board, blocks, channels, "
                         f"value_hidden {got}; the configuration {want}")
    return params, stats


class Base:
    """Shared by the kinds. ``NUMBERS``: the numbers the check compares;
    ``EVAL_IN_SETUP``: the check also samples the net's evaluations in
    set-up; ``RECORDS_GAMES``: it follows a sample of envs' games and the
    ring rows written from them."""

    NUMBERS: tuple = ()
    EVAL_IN_SETUP = False
    RECORDS_GAMES = False
    envs = None

    def forward_batches(self) -> List[tuple]:
        """[(batch, calls)] of the net's forwards one unit needs."""
        raise NotImplementedError

    def positions_per_unit(self) -> int:
        return sum(b * n for b, n in self.forward_batches())

    @staticmethod
    def greedy(state, mcts):
        """Which roots of a PUCT search play their most visited move."""
        return torch.ones_like(state.done)


def load_kind(name: str, root: str = HERE):
    """The class ``Kind`` of ``kinds/<name>.py``."""
    path = os.path.join(root, "kinds", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_kind_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Kind


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
