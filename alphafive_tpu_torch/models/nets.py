"""The one place that builds the configured net (``NetConfig.arch``).

``resnet``: ``models/resnet.py`` (``PolicyValueNet``, inference through
``FusedPolicyValueNet``); ``katago_nbt``: ``models/katago_nbt.py``
(``NestedBottleneckNet``, ``FusedNestedBottleneckNet``). The evaluator,
the learner, the mesh, checkpoints and the CLI build nets through these
functions, never by naming a class.
"""

from __future__ import annotations

import torch

from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.models import katago_nbt, resnet

ARCHS = {"resnet": (resnet.PolicyValueNet, resnet.FusedPolicyValueNet,
                    resnet.init_params),
         "katago_nbt": (katago_nbt.NestedBottleneckNet,
                        katago_nbt.FusedNestedBottleneckNet,
                        katago_nbt.init_params)}


def _arch(net: NetConfig) -> tuple:
    if net.arch not in ARCHS:
        raise ValueError(f"unknown net.arch {net.arch!r}; known: "
                         f"{sorted(ARCHS)}")
    return ARCHS[net.arch]


def init_params(env: EnvConfig, net: NetConfig, seed: int = 0):
    """(params, batch_stats): random flax-layout numpy trees from `seed`."""
    return _arch(net)[2](env, net, seed)


def build(env: EnvConfig, net: NetConfig, device="cuda") -> torch.nn.Module:
    """The training net with placeholder weights (to load a state into)."""
    return _arch(net)[0](env, net).to(device)


def from_flax(env: EnvConfig, net: NetConfig, params, batch_stats,
              device="cuda") -> torch.nn.Module:
    """The training net (autograd, batch norm) from flax-layout trees."""
    return _arch(net)[0].from_flax(env, net, params, batch_stats, device)


def fused(env: EnvConfig, net: NetConfig, params, batch_stats,
          device="cuda", plain: bool = False) -> torch.nn.Module:
    """The inference net through the port's kernels, from flax-layout
    trees (``plain``: the kernels' plain twins, on any device)."""
    return _arch(net)[1](env, net, params, batch_stats, device, plain)


def fused_from_module(env: EnvConfig, net: NetConfig,
                      module: torch.nn.Module,
                      plain: bool = False) -> torch.nn.Module:
    """The inference net folded from a live training net's weights on its
    own device (copies)."""
    return _arch(net)[1].from_module(env, net, module, plain)


def require_resnet(net: NetConfig, what: str) -> None:
    """Raises for a net that `what` (resnet-only surgery) cannot take."""
    if net.arch != "resnet":
        raise ValueError(f"{what} works on the resnet only; net.arch is "
                         f"{net.arch!r}")
