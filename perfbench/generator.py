"""The general traffic generator: what every kind of traffic shares, the
kinds and the architectures found by name, and the weights.

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

A configuration's net is an architecture, ``perfbench/archs/<arch>.py``
(``Arch``): the reference net, its weights, its FLOPs and the kernels
whose rooflines the benchmark reads.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

import torch

from perfbench.reference import bundle as ref_bundle
from perfbench.reference import net as ref_net

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = os.path.join(HERE, "archs")


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


def load_weights(ctx) -> tuple:
    """(params, batch_stats) of the role's bundle, read by the
    benchmark's own reader and checked by the architecture against the
    configuration, or drawn by it from the seed where the role names
    ``random``; handed as the same numpy trees to the program and to the
    reference."""
    path = ctx.cfg_doc["roles"][ctx.mix["role"]]["weights"]
    if path == "random":
        return ctx.arch.random_weights(ctx.seed)
    params, stats, saved = ref_bundle.load(os.path.join(ctx.root, path))
    try:
        ctx.arch.check_bundle(saved)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    return params, stats


class Arch:
    """A configuration's architecture: the module ``archs/<name>.py``
    named by the configuration's ``"arch"`` (``resnet`` where it names
    none), bound to the configuration's env and net. What the module does
    not define is shared: ``features`` (``reference/net.py``'s input
    planes) and ``evaluate``, built on the module's ``forward``."""

    def __init__(self, cfg_doc: Dict):
        self.name = cfg_doc.get("arch", "resnet")
        self.env, self.net = cfg_doc["env"], cfg_doc["net"]
        self.mod = load_module(ARCHS, self.name)
        self.forward = self.mod.forward
        self.forward_train = self.mod.forward_train
        self.features = getattr(self.mod, "features", ref_net.features)
        self.program_trees = self.mod.program_trees
        self.leaf_name = self.mod.leaf_name

    def random_weights(self, seed: int) -> tuple:
        return self.mod.random_weights(self.env, self.net, seed)

    def check_bundle(self, saved: Dict) -> None:
        self.mod.check_bundle(saved, self.env, self.net)

    def flops_per_position(self) -> float:
        return self.mod.flops_per_position(self.env, self.net)

    def kernels(self) -> List[tuple]:
        return self.mod.kernels(self.env, self.net)

    def kernel_work(self, span: str, batch: int) -> List[tuple]:
        return self.mod.kernel_work(span, batch, self.env, self.net)

    def evaluate(self, params, stats, size: int, board, to_play, last,
                 block: int = 1024, quant: Optional[Callable] = None):
        """`forward` on flat boards, `block` rows at a time: (log-policy
        over the empty cells [B, S²] with −inf elsewhere, value [B])."""
        logps, values = [], []
        for lo in range(0, board.shape[0], block):
            sl = slice(lo, lo + block)
            logits, value = self.forward(params, stats, self.features(
                size, board[sl], to_play[sl], last[sl]), quant)
            logps.append(ref_net.masked_log_softmax(logits, board[sl] == 0))
            values.append(value)
        return torch.cat(logps), torch.cat(values)


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

    def device_start(self) -> None:
        """Where the device stretch starts (``harness.device_stretch``):
        here, where the window stopped; a kind whose units' device work
        depends on where its state stands starts it from a fixed one."""

    def positions_per_unit(self) -> int:
        return sum(b * n for b, n in self.forward_batches())

    @staticmethod
    def greedy(state, mcts):
        """Which roots of a PUCT search play their most visited move."""
        return torch.ones_like(state.done)


def load_module(directory: str, name: str):
    """The module ``<directory>/<name>.py``, found by its name."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{os.path.basename(directory)}_{name.replace('.', '_')}",
        os.path.join(directory, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(name: str, root: str = HERE):
    """The class ``Kind`` of ``kinds/<name>.py``."""
    return load_module(os.path.join(root, "kinds"), name).Kind


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
