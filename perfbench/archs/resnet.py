"""resnet: the AlphaGo Zero-style residual policy-value net that
``alphafive_tpu_torch/models/resnet.py`` runs (``PolicyValueNet``, and
``FusedPolicyValueNet`` for inference): a 3×3 conv stem, ``blocks``
post-activation residual blocks of two 3×3 convs at ``channels``, a
policy head (1×1 conv to 2 planes, dense) and a value head (1×1 conv to
1 plane, dense to ``value_hidden``, dense, tanh).

The equations are ``perfbench/reference/net.py``'s, the FLOPs and the
residual blocks' work ``perfbench/yardstick.py``'s. Imports nothing of
the program: the kernels are named by ``"module:attribute"``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import yardstick
from perfbench.reference import net as ref_net

forward = ref_net.forward
forward_train = ref_net.forward_train


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


def check_bundle(saved: Dict, env: Dict, net: Dict) -> None:
    """Raises unless a bundle's saved config has the configuration's
    board, blocks, channels and value head."""
    want = (env["board_size"], net["blocks"], net["channels"],
            net["value_hidden"])
    got = (saved["env"]["board_size"], saved["net"]["blocks"],
           saved["net"]["channels"], saved["net"]["value_hidden"])
    if want != got:
        raise ValueError(f"the bundle holds board, blocks, channels, "
                         f"value_hidden {got}; the configuration {want}")


def leaf_name(torch_name: str) -> str:
    """The flax leaf ("layer/param") of a ``PolicyValueNet`` parameter."""
    parts = torch_name.split(".")
    if parts[0] == "blocks":
        j = int(parts[2]) + 1
        conv, bn, rest = (f"block{parts[1]}/conv{j}", f"block{parts[1]}/bn{j}",
                          parts[3:])
    elif parts[0] in ("stem", "policy", "value") and parts[1] in ("conv",
                                                                  "bn"):
        conv, bn, rest = f"{parts[0]}_conv", f"{parts[0]}_bn", parts[1:]
    else:
        return f"{parts[0]}/{'kernel' if parts[1] == 'weight' else 'bias'}"
    if rest[0] == "conv":
        return f"{conv}/kernel"
    return f"{bn}/{'scale' if rest[1] == 'weight' else 'bias'}"


def program_trees(module) -> tuple:
    """f32 copies of a ``PolicyValueNet``'s weights as flax-layout trees
    (params, batch_stats): conv kernels HWIO, dense kernels [in, out]."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    with torch.no_grad():
        for name, v in module.named_parameters():
            path = leaf_name(name).split("/")
            t = v.detach().float().clone()
            if path[-1] == "kernel":
                t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()
            put(params, path, t.contiguous())
        for name, v in module.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("running_mean", "running_var"):
                path = leaf_name(name.rsplit(".", 1)[0]
                                 + ".weight").split("/")[:-1]
                put(stats, path + [leaf[len("running_"):]],
                    v.detach().float().clone())
    return params, stats


def flops_per_position(env: Dict, net: Dict) -> float:
    return yardstick.net_flops(env["board_size"], net["blocks"],
                               net["channels"], net["value_hidden"])


def kernels(env: Dict, net: Dict) -> List[tuple]:
    """The fused residual block: one call a block of every forward."""
    return [("resblock", "alphafive_tpu_torch.ops.resblock:fused_resblock")]


def kernel_work(span: str, batch: int, env: Dict, net: Dict) -> List[tuple]:
    """[(FLOPs, bytes, dtype, calls)] of `span`'s kernel in one forward
    of `batch` positions: ``blocks`` residual blocks."""
    if span != "resblock":
        raise KeyError(f"resnet has no kernel {span!r}")
    f, b = yardstick.resblock_work(batch, env["board_size"], net["channels"],
                                   net["compute_dtype"])
    return [(f, b, net["compute_dtype"], net["blocks"])]
