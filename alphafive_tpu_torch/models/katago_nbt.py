"""KataGo's nested-bottleneck policy-value net (``b18c384nbt``).

The equations are ``models/katago_nbt_reference.py``'s: a 5×5 stem from
the 4 input planes to the trunk's ``channels``; ``blocks`` nested
bottleneck blocks (a 1×1 down to ``mid_channels``, two pre-activation 3×3
pairs, the first of each of the 1-based ``gpool_blocks`` a global-pooling
pair with ``gpool_channels`` pooled, a 1×1 back up, added to the trunk);
the trunk's one batch norm and ReLU; KataGo's policy head (a pooled bias
on ``head_channels`` planes, a 1×1 to one logit a cell) and value head
(pooled planes, a dense layer of ``value_hidden``, tanh). Every other norm
is a per-channel affine.

* ``NestedBottleneckNet``: plain torch with autograd, the trunk in the
  compute dtype, the affines, the batch norm and the heads in f32.
  ``forward`` uses the batch norm's running statistics, ``forward_train``
  the batch's and returns the new running statistics beside the outputs
  (the module's own are left as they were), as ``PolicyValueNet`` does.
  Parameters are held in the flax layout under flax's names (HWIO conv
  kernels, ``[in, out]`` dense kernels): ``from_flax``, ``flax_tree``,
  ``flax_trees`` and ``to_flax`` move trees in and out as they do for the
  resnet.
* ``FusedNestedBottleneckNet``: inference through ``ops/katago_nbt.py``,
  one ``preact_pair``, ``gpool_pair`` or ``conv1x1`` call each, called as
  attributes of the module (a wrapper installed there sees every call).
  The stem and the heads stay plain torch, as the resnet's do; spans
  ``stem`` and ``heads`` (and ``gpool``, the pooling pair's reduction and
  dense layer, inside ``ops/katago_nbt.py``).

``init_params`` draws a tree from a seed. The last conv of each residual
branch is scaled down (``BRANCH_SCALE``) so that the trunk's RMS grows
slowly over 18 blocks, and the batch norm's running statistics are drawn
near the trunk's own, so that a random net's policy is not flat and its
value not saturated.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.models.resnet import _put, compute_dtype, numpy_tree
from alphafive_tpu_torch.ops import katago_nbt as nbt_ops
from alphafive_tpu_torch.utils import trace

BN_EPS = 1e-5
BN_MOMENTUM = 0.99
BRANCH_SCALE = 0.2      # the residual branches' last convs, × He
TRUNK_VAR = 4.0         # the running variance drawn for the trunk's norm
POLICY_SCALE = 3.0      # the policy's last 1×1, × He
VALUE_SCALE = 1.0       # the value's last dense, × 1/√in
BIAS_STD = 0.5          # the affines' β


def check_config(net: NetConfig) -> None:
    """Raises unless `net` describes a nested-bottleneck net."""
    bad = [b for b in net.gpool_blocks if not 1 <= b <= net.blocks]
    if bad:
        raise ValueError(f"net.gpool_blocks {bad} outside blocks 1..."
                         f"{net.blocks}")
    if not 0 < net.gpool_channels < net.mid_channels:
        raise ValueError(f"net.gpool_channels {net.gpool_channels} must lie "
                         f"in 1..mid_channels - 1 ({net.mid_channels - 1})")


def _pooling(net: NetConfig, i: int) -> bool:
    """Whether 0-based block `i` is a pooling block."""
    return i + 1 in net.gpool_blocks


def param_shapes(env: EnvConfig, net: NetConfig) -> Dict[str, Any]:
    """The flax-layout tree of parameter shapes."""
    check_config(net)
    c, m, g, hh = (net.channels, net.mid_channels, net.gpool_channels,
                   net.head_channels)
    norm = lambda n: {"scale": (n,), "bias": (n,)}
    conv = lambda k, i, o: {"kernel": (k, k, i, o)}
    tree: Dict[str, Any] = {"stem_conv": conv(5, 4, c)}
    for i in range(net.blocks):
        blk = {"norm_p": norm(c), "conv_p": conv(1, c, m),
               "norm_q": norm(m), "conv_q": conv(1, m, c)}
        for j in (0, 1):
            if j == 0 and _pooling(net, i):
                blk[f"pair{j}"] = {
                    "norm1": norm(m), "conv1r": conv(3, m, m - g),
                    "conv1g": conv(3, m, g), "normg": norm(g),
                    "linear_g": {"kernel": (3 * g, m - g)},
                    "norm2": norm(m - g), "conv2": conv(3, m - g, m)}
            else:
                blk[f"pair{j}"] = {"norm1": norm(m), "conv1": conv(3, m, m),
                                   "norm2": norm(m), "conv2": conv(3, m, m)}
        tree[f"block{i}"] = blk
    tree["trunk_bn"] = norm(c)
    tree["policy_conv"] = conv(1, c, hh)
    tree["policy_gconv"] = conv(1, c, hh)
    tree["policy_gnorm"] = norm(hh)
    tree["policy_linear_g"] = {"kernel": (3 * hh, hh)}
    tree["policy_bias"] = {"bias": (hh,)}
    tree["policy_out"] = conv(1, hh, 1)
    tree["value_conv"] = conv(1, c, hh)
    tree["value_norm"] = norm(hh)
    tree["value_fc1"] = {"kernel": (3 * hh, net.value_hidden),
                         "bias": (net.value_hidden,)}
    tree["value_fc2"] = {"kernel": (net.value_hidden, 1), "bias": (1,)}
    return tree


def init_params(env: EnvConfig, net: NetConfig, seed: int = 0):
    """(params, batch_stats): random flax-layout numpy trees from `seed`.
    Conv kernels He-scaled (the residual branches' last convs, ``conv2``
    and ``conv_q``, × ``BRANCH_SCALE``), dense kernels 1/√in, affines
    1 + 0.1 N(0, 1) and ``BIAS_STD`` N(0, 1), the value's biases 0."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def draw(path, shape):
        leaf = path[-1]
        if leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(f32)
        if leaf == "bias":
            if path[0] in ("value_fc1", "value_fc2"):
                return np.zeros(shape, f32)
            return (BIAS_STD * rng.standard_normal(shape)).astype(f32)
        if len(shape) == 4:
            k, _, cin, _ = shape
            std = (2.0 / (k * k * cin)) ** 0.5
            if path[-2] in ("conv2", "conv_q"):
                std *= BRANCH_SCALE
            if path[0] == "policy_out":
                std *= POLICY_SCALE
        else:
            std = shape[0] ** -0.5
            if path[0] == "value_fc2":
                std *= VALUE_SCALE
        return (rng.standard_normal(shape) * std).astype(f32)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v) for k, v in tree.items()}

    params = walk(param_shapes(env, net), ())
    n = net.channels
    stats = {"trunk_bn": {
        "mean": (0.1 * rng.standard_normal(n)).astype(f32),
        "var": (TRUNK_VAR * (1.0 + 0.2 * rng.random(n))).astype(f32)}}
    return params, stats


def _t(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32,
                             memory_format=torch.contiguous_format, copy=True)
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


class _Tree(nn.Module):
    """A flax-layout tree of shapes as modules: a dict a module, a leaf a
    zero parameter of its shape."""

    def __init__(self, shapes: Dict[str, Any]):
        super().__init__()
        for k, v in shapes.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(torch.zeros(v)))


def _affine(x, p):
    """A(x) of NCHW `x` in f32."""
    return torch.relu(x.float() * p.scale[:, None, None]
                      + p.bias[:, None, None])


def _conv(x, p):
    """`x`'s dtype; the f32 kernel cast to it on use, as flax does."""
    k = p.kernel
    return F.conv2d(x, k.permute(3, 2, 0, 1).to(x.dtype),
                    padding=k.shape[0] // 2)


def _pool_g(z):
    mean = z.mean((2, 3))
    return torch.cat([mean, mean * nbt_ops.pool_scale(z.shape[-1]),
                      z.amax((2, 3))], 1)


def _pool_v(z):
    mean, k = z.mean((2, 3)), z.shape[-1] - 14
    return torch.cat([mean, mean * k / 10.0, mean * (k * k / 100.0 - 0.1)], 1)


class NestedBottleneckNet(nn.Module):
    """Plain torch twin of the reference, with autograd: ``forward``
    (running statistics), ``forward_train`` (the batch's)."""

    def __init__(self, env: EnvConfig, net: NetConfig):
        super().__init__()
        self.dtype = compute_dtype(net)
        self.blocks = net.blocks
        for k, v in param_shapes(env, net).items():
            self.add_module(k, _Tree(v))
        c = net.channels
        self.trunk_bn.register_buffer("mean", torch.zeros(c))
        self.trunk_bn.register_buffer("var", torch.ones(c))
        self.eval()

    def kernels(self):
        """The conv and dense kernels (decayed and L2-penalised by the
        learner; affines, biases and the batch norm are not)."""
        return [p for name, p in self.named_parameters()
                if name.endswith(".kernel")]

    @classmethod
    def from_flax(cls, env: EnvConfig, net: NetConfig, params, batch_stats,
                  device="cuda") -> "NestedBottleneckNet":
        m = cls(env, net)
        with torch.no_grad():
            for name, p in m.named_parameters():
                src = params
                for k in name.split("."):
                    src = src[k]
                t = _t(src)
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: the tree holds "
                                     f"{tuple(t.shape)}, the net "
                                     f"{tuple(p.shape)}")
                p.copy_(t)
            for k in ("mean", "var"):
                getattr(m.trunk_bn, k).copy_(_t(batch_stats["trunk_bn"][k]))
        return m.to(device)

    def flax_tree(self, tensors):
        """One tensor per parameter, in ``parameters()`` order, as a
        flax-layout tree of detached tensors under the parameters'
        names."""
        out: Dict[str, Any] = {}
        for (name, _), t in zip(self.named_parameters(), tensors):
            _put(out, name.split("."), t.detach())
        return out

    def flax_trees(self):
        """(params, batch_stats): detached views of the live weights."""
        return self.flax_tree(self.parameters()), {"trunk_bn": {
            "mean": self.trunk_bn.mean, "var": self.trunk_bn.var}}

    def to_flax(self):
        return tuple(numpy_tree(t) for t in self.flax_trees())

    @torch.no_grad()
    def set_batch_stats(self, stats) -> None:
        ((mean, var),) = stats
        self.trunk_bn.mean.copy_(mean)
        self.trunk_bn.var.copy_(var)

    def _stem(self, features):
        return _conv(features.permute(0, 3, 1, 2).to(self.dtype),
                     self.stem_conv)

    def _trunk(self, x):
        dt = self.dtype
        for i in range(self.blocks):
            blk = getattr(self, f"block{i}")
            h = _conv(_affine(x, blk.norm_p).to(dt), blk.conv_p)
            for pr in (blk.pair0, blk.pair1):
                u = _affine(h, pr.norm1).to(dt)
                if hasattr(pr, "conv1g"):
                    r = _conv(u, pr.conv1r).float()
                    g = _affine(_conv(u, pr.conv1g), pr.normg)
                    r = r + (_pool_g(g) @ pr.linear_g.kernel)[:, :, None, None]
                else:
                    r = _conv(u, pr.conv1)
                y = _conv(_affine(r, pr.norm2).to(dt), pr.conv2)
                h = (h.float() + y.float()).to(dt)
            y = _conv(_affine(h, blk.norm_q).to(dt), blk.conv_q)
            x = (x.float() + y.float()).to(dt)
        return x.float()

    def _heads(self, xf):
        p = _conv(xf, self.policy_conv)
        g = _affine(_conv(xf, self.policy_gconv), self.policy_gnorm)
        p = torch.relu(p + self.policy_bias.bias[:, None, None]
                       + (_pool_g(g) @ self.policy_linear_g.kernel
                          )[:, :, None, None])
        logits = _conv(p, self.policy_out).reshape(xf.shape[0], -1)
        v = _affine(_conv(xf, self.value_conv), self.value_norm)
        v = torch.relu(_pool_v(v) @ self.value_fc1.kernel
                       + self.value_fc1.bias)
        v = torch.tanh(v @ self.value_fc2.kernel + self.value_fc2.bias)
        return logits, v[:, 0]

    @torch.no_grad()
    def forward(self, features: torch.Tensor):
        with trace.span("stem"):
            x = self._stem(features)
        x = self._trunk(x)
        with trace.span("heads"):
            bn = self.trunk_bn
            inv = torch.rsqrt(bn.var + BN_EPS) * bn.scale
            xf = torch.relu((x - bn.mean[:, None, None]) * inv[:, None, None]
                            + bn.bias[:, None, None])
            return self._heads(xf)

    def forward_train(self, features: torch.Tensor):
        """Training forward, with autograd: ((logits, value), [(new
        running mean, new running var)] of the trunk's batch norm)."""
        x = self._trunk(self._stem(features))
        bn = self.trunk_bn
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        inv = torch.rsqrt(var + BN_EPS) * bn.scale
        xf = torch.relu((x - mean[:, None, None]) * inv[:, None, None]
                        + bn.bias[:, None, None])
        new = (BN_MOMENTUM * bn.mean + (1 - BN_MOMENTUM) * mean.detach(),
               BN_MOMENTUM * bn.var + (1 - BN_MOMENTUM) * var.detach())
        return self._heads(xf), [new]


class FusedNestedBottleneckNet(nn.Module):
    """Inference through ``ops/katago_nbt.py``'s kernels (bf16 on the
    card); ``plain=True`` runs their plain twins instead, on any device
    (the comparison the card's smoke check makes)."""

    def __init__(self, env: EnvConfig, net: NetConfig, params, batch_stats,
                 device="cuda", plain: bool = False):
        super().__init__()
        check_config(net)
        self.dtype = dt = compute_dtype(net)
        self.plain = plain
        t = lambda a: _t(a, device).contiguous()
        pk = lambda layer: nbt_ops.pack_conv(t(layer["kernel"])).to(dt)
        aff = lambda p: (t(p["scale"]), t(p["bias"]))
        # the stem's weights rounded to the compute dtype, widened so that
        # its conv sums exact products in f32 (as the resnet's stem)
        self.stem_w = t(params["stem_conv"]["kernel"]).to(dt).float().permute(
            3, 2, 0, 1).contiguous()
        self.blocks = []
        for i in range(net.blocks):
            p = params[f"block{i}"]
            pairs = []
            for j in (0, 1):
                pr = p[f"pair{j}"]
                if "conv1g" in pr:
                    w1 = torch.cat([t(pr["conv1r"]["kernel"]),
                                    t(pr["conv1g"]["kernel"])], -1)
                    pairs.append(("gpool", (
                        *aff(pr["norm1"]), nbt_ops.pack_conv(w1).to(dt),
                        *aff(pr["normg"]), t(pr["linear_g"]["kernel"]),
                        *aff(pr["norm2"]), pk(pr["conv2"]))))
                else:
                    pairs.append(("preact", (
                        *aff(pr["norm1"]), pk(pr["conv1"]),
                        *aff(pr["norm2"]), pk(pr["conv2"]))))
            self.blocks.append(((*aff(p["norm_p"]), pk(p["conv_p"])), pairs,
                                (*aff(p["norm_q"]), pk(p["conv_q"]))))
        bn, st = params["trunk_bn"], batch_stats["trunk_bn"]
        inv = t(bn["scale"]) * torch.rsqrt(t(st["var"]) + BN_EPS)
        self.final = (inv, t(bn["bias"]) - t(st["mean"]) * inv)
        k = lambda name: t(params[name]["kernel"])[0, 0]     # 1×1: [in, out]
        hh = net.head_channels
        # the three 1×1 head convs as one product over the trunk
        self.w_heads = torch.cat([k("policy_conv"), k("policy_gconv"),
                                  k("value_conv")], 1)
        self.hh = hh
        self.head = {
            "gnorm": aff(params["policy_gnorm"]),
            "linear_g": t(params["policy_linear_g"]["kernel"]),
            "bias": t(params["policy_bias"]["bias"]),
            "out": k("policy_out"),
            "vnorm": aff(params["value_norm"]),
            "fc1": (t(params["value_fc1"]["kernel"]),
                    t(params["value_fc1"]["bias"])),
            "fc2": (t(params["value_fc2"]["kernel"]),
                    t(params["value_fc2"]["bias"]))}

    @classmethod
    @torch.no_grad()
    def from_module(cls, env: EnvConfig, net: NetConfig,
                    module: NestedBottleneckNet, plain: bool = False
                    ) -> "FusedNestedBottleneckNet":
        """From a live ``NestedBottleneckNet``'s weights and running
        statistics, on its device; the result holds copies."""
        params, stats = module.flax_trees()
        return cls(env, net, params, stats, module.stem_conv.kernel.device,
                   plain)

    @torch.no_grad()
    def forward(self, features: torch.Tensor):
        dt = self.dtype
        if self.plain:
            pre, gp, c1 = (nbt_ops.preact_pair_reference,
                           nbt_ops.gpool_pair_reference,
                           nbt_ops.conv1x1_reference)
        else:
            pre, gp, c1 = (nbt_ops.preact_pair, nbt_ops.gpool_pair,
                           nbt_ops.conv1x1)
        with trace.span("stem"):
            x = features.to(dt).float().permute(0, 3, 1, 2)
            x = F.conv2d(x, self.stem_w, padding=2).permute(0, 2, 3, 1)
            x = x.to(dt).contiguous()
        for down, pairs, up in self.blocks:
            h = c1(x, *down)
            for kind, args in pairs:
                h = gp(h, *args) if kind == "gpool" else pre(h, *args)
            x = c1(h, *up, residual=x)
        with trace.span("heads"):
            hd, hh, bsz = self.head, self.hh, x.shape[0]
            xf = torch.relu(x.float() * self.final[0] + self.final[1])
            y = xf @ self.w_heads                     # [B, S, S, 3H]
            p, g, v = y[..., :hh], y[..., hh:2 * hh], y[..., 2 * hh:]
            g = torch.relu(g * hd["gnorm"][0] + hd["gnorm"][1])
            g = g.permute(0, 3, 1, 2)
            p = torch.relu(p + hd["bias"] + (_pool_g(g) @ hd["linear_g"]
                                            )[:, None, None, :])
            logits = (p @ hd["out"]).reshape(bsz, -1)
            v = torch.relu(v * hd["vnorm"][0] + hd["vnorm"][1])
            v = torch.relu(_pool_v(v.permute(0, 3, 1, 2)) @ hd["fc1"][0]
                           + hd["fc1"][1])
            v = torch.tanh(v @ hd["fc2"][0] + hd["fc2"][1])
            return logits, v[:, 0]
