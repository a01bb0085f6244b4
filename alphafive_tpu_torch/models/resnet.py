"""Residual policy-value network (port of ``alphafive_tpu/models/resnet.py``).

[B, S, S, 4] NHWC features → (policy logits [B, S*S], value [B]): a 3×3
conv stem, ``blocks`` residual blocks of two 3×3 convs, a policy head
(1×1 conv → FC) and a value head (1×1 conv → FC → FC → tanh). Convs and
batch norm run in the compute dtype; heads and outputs are f32.

Three forwards, as in the JAX package:

* ``PolicyValueNet.forward`` keeps batch norm as separate layers with its
  running statistics — the twin of ``apply_eval``.
* ``PolicyValueNet.forward_train`` normalises by the batch's statistics and
  returns the updated running statistics beside the outputs — the twin of
  ``apply_train``. It never touches the module's own statistics, and
  neither forward reads the module's train/eval flag.
* ``FusedPolicyValueNet`` folds batch norm into the convolutions once, at
  construction, and runs each residual block through
  ``ops.resblock.fused_resblock`` (the CUDA kernel on the card) — the twin
  of ``apply_eval_fused``. The stem and the 1×1 heads stay plain torch, as
  the JAX package leaves them to XLA. ``from_module`` builds it from a live
  ``PolicyValueNet`` on its device, as the JAX iteration refolds its
  evaluator from the learner's weights.

Both inference forwards span (``utils/trace.py``) their ``stem`` and
their ``heads``; the residual blocks between them are the resblock.

Weights arrive as flax-layout trees (``train.checkpoint.load_model`` or
``init_params``), and ``PolicyValueNet.to_flax`` gives them back in that
layout. The heads flatten NHWC (h, w, c) as flax does, so the FC rows need
no permutation.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.ops import resblock as rb
from alphafive_tpu_torch.utils import trace

BN_EPS = 1e-5
BN_MOMENTUM = 0.99   # flax's: running = 0.99 · running + 0.01 · batch


def compute_dtype(cfg: NetConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def init_params(env: EnvConfig, net: NetConfig, seed: int = 0):
    """(params, batch_stats): random flax-layout numpy trees from `seed`
    (He-scaled conv and dense kernels, perturbed batch-norm statistics)."""
    rng = np.random.default_rng(seed)
    c, a, hid = net.channels, env.num_actions, net.value_hidden

    def conv(kh, cin, cout):
        std = (2.0 / (kh * kh * cin)) ** 0.5
        return {"kernel": (rng.standard_normal((kh, kh, cin, cout)) * std
                           ).astype(np.float32)}

    def dense(cin, cout):
        return {"kernel": (rng.standard_normal((cin, cout))
                           * (1.0 / cin) ** 0.5).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    def bn(n):
        return ({"scale": (1.0 + 0.1 * rng.standard_normal(n)
                           ).astype(np.float32),
                 "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)},
                {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                 "var": (1.0 + 0.2 * rng.random(n)).astype(np.float32)})

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["stem_conv"] = conv(3, 4, c)
    params["stem_bn"], stats["stem_bn"] = bn(c)
    for i in range(net.blocks):
        blk, bst = {}, {}
        blk["conv1"] = conv(3, c, c)
        blk["bn1"], bst["bn1"] = bn(c)
        blk["conv2"] = conv(3, c, c)
        blk["bn2"], bst["bn2"] = bn(c)
        params[f"block{i}"], stats[f"block{i}"] = blk, bst
    params["policy_conv"] = conv(1, c, 2)
    params["policy_bn"], stats["policy_bn"] = bn(2)
    params["policy_fc"] = dense(2 * a, a)
    params["value_conv"] = conv(1, c, 1)
    params["value_bn"], stats["value_bn"] = bn(1)
    params["value_fc1"] = dense(a, hid)
    params["value_fc2"] = dense(hid, 1)
    return params, stats


def _t(a, device=None) -> torch.Tensor:
    """A contiguous f32 copy of a numpy array or a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32,
                             memory_format=torch.contiguous_format,
                             copy=True)
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def numpy_tree(tree):
    """A tree of tensors as f32 numpy copies."""
    return {k: numpy_tree(v) if isinstance(v, dict) else
            v.detach().float().cpu().numpy().copy() for k, v in tree.items()}


class _ConvBN(nn.Module):
    """Bias-free conv followed by batch norm."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=0.01)

    def load_flax(self, conv, bn, stats):
        with torch.no_grad():
            self.conv.weight.copy_(_t(conv["kernel"]).permute(3, 2, 0, 1))
            self.bn.weight.copy_(_t(bn["scale"]))
            self.bn.bias.copy_(_t(bn["bias"]))
            self.bn.running_mean.copy_(_t(stats["mean"]))
            self.bn.running_var.copy_(_t(stats["var"]))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        # flax casts the f32 kernel to the compute dtype on use
        return F.conv2d(x, self.conv.weight.to(x.dtype),
                        padding=self.conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in the compute dtype → BN output (running statistics) in
        the same dtype."""
        y = F.batch_norm(self._conv(x).float(), self.bn.running_mean,
                         self.bn.running_var, self.bn.weight, self.bn.bias,
                         False, 0.0, BN_EPS)
        return y.to(x.dtype)

    def forward_train(self, x: torch.Tensor):
        """NCHW in the compute dtype → (BN output normalised by the batch's
        statistics, (new running mean, new running var)).

        flax 0.12's ``BatchNorm`` in train mode: f32 reductions even for
        bf16 inputs, the fast variance E[y²] − E[y]² clipped at 0, the
        biased variance both to normalise and in the running update.
        (``F.batch_norm(training=True)`` would update the running variance
        with the unbiased one.)"""
        y = self._conv(x).float()
        mean = y.mean((0, 2, 3))
        var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.bn.weight
        out = ((y - mean[:, None, None]) * mul[:, None, None]
               + self.bn.bias[:, None, None])
        bn = self.bn
        new = (BN_MOMENTUM * bn.running_mean
               + (1 - BN_MOMENTUM) * mean.detach(),
               BN_MOMENTUM * bn.running_var
               + (1 - BN_MOMENTUM) * var.detach())
        return out.to(x.dtype), new


def _flat_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PolicyValueNet(nn.Module):
    """Batch-norm twin of the flax module: ``forward`` is ``apply_eval``,
    ``forward_train`` is ``apply_train``."""

    def __init__(self, env: EnvConfig, net: NetConfig):
        super().__init__()
        c, a = net.channels, env.num_actions
        self.dtype = compute_dtype(net)
        self.stem = _ConvBN(4, c, 3)
        self.blocks = nn.ModuleList(
            nn.ModuleList([_ConvBN(c, c, 3), _ConvBN(c, c, 3)])
            for _ in range(net.blocks))
        self.policy = _ConvBN(c, 2, 1)
        self.policy_fc = nn.Linear(2 * a, a)
        self.value = _ConvBN(c, 1, 1)
        self.value_fc1 = nn.Linear(a, net.value_hidden)
        self.value_fc2 = nn.Linear(net.value_hidden, 1)
        self.eval()

    def conv_bns(self):
        """(flax conv path, flax batch-norm path, layer) of every conv, in
        the order of ``forward_train``'s new statistics."""
        out = [(("stem_conv",), ("stem_bn",), self.stem)]
        for i, (c1, c2) in enumerate(self.blocks):
            out += [((f"block{i}", "conv1"), (f"block{i}", "bn1"), c1),
                    ((f"block{i}", "conv2"), (f"block{i}", "bn2"), c2)]
        return out + [(("policy_conv",), ("policy_bn",), self.policy),
                      (("value_conv",), ("value_bn",), self.value)]

    def denses(self):
        return [("policy_fc", self.policy_fc), ("value_fc1", self.value_fc1),
                ("value_fc2", self.value_fc2)]

    def kernels(self):
        """The conv and dense kernels: the weights that flax names
        ``kernel`` (decayed and L2-penalised by the learner; batch-norm
        scales and biases and dense biases are not)."""
        return ([m.conv.weight for _, _, m in self.conv_bns()]
                + [lin.weight for _, lin in self.denses()])

    @classmethod
    def from_flax(cls, env: EnvConfig, net: NetConfig, params, batch_stats,
                  device="cuda") -> "PolicyValueNet":
        m = cls(env, net)
        for conv, bn, layer in m.conv_bns():
            layer.load_flax(_at(params, conv), _at(params, bn),
                            _at(batch_stats, bn))
        with torch.no_grad():
            for name, lin in m.denses():
                lin.weight.copy_(_t(params[name]["kernel"]).T)
                lin.bias.copy_(_t(params[name]["bias"]))
        return m.to(device)

    def flax_tree(self, tensors):
        """One tensor per parameter, in ``parameters()`` order (the weights
        themselves, their gradients or optimizer moments), as a flax-layout
        tree of detached views: HWIO conv kernels, ``[in, out]`` dense
        kernels, flax's names."""
        where = {}
        for conv, bn, m in self.conv_bns():
            where[id(m.conv.weight)] = (conv + ("kernel",), (2, 3, 1, 0))
            where[id(m.bn.weight)] = (bn + ("scale",), None)
            where[id(m.bn.bias)] = (bn + ("bias",), None)
        for name, lin in self.denses():
            where[id(lin.weight)] = ((name, "kernel"), (1, 0))
            where[id(lin.bias)] = ((name, "bias"), None)
        out = {}
        for p, t in zip(self.parameters(), tensors):
            path, perm = where[id(p)]
            _put(out, path, t.detach().permute(*perm) if perm
                 else t.detach())
        return out

    def flax_trees(self):
        """(params, batch_stats) as flax-layout trees of tensors on the
        module's device, detached views of the live weights."""
        stats = {}
        for _, bn, m in self.conv_bns():
            _put(stats, bn + ("mean",), m.bn.running_mean)
            _put(stats, bn + ("var",), m.bn.running_var)
        return self.flax_tree(self.parameters()), stats

    def to_flax(self):
        """(params, batch_stats) as flax-layout numpy trees: the inverse of
        ``from_flax``."""
        return tuple(numpy_tree(t) for t in self.flax_trees())

    @torch.no_grad()
    def set_batch_stats(self, stats) -> None:
        for (mean, var), (_, _, m) in zip(stats, self.conv_bns()):
            m.bn.running_mean.copy_(mean)
            m.bn.running_var.copy_(var)

    def _heads(self, policy, value):
        p = _flat_nhwc(torch.relu(policy)).float()
        logits = self.policy_fc(p)
        v = _flat_nhwc(torch.relu(value)).float()
        v = self.value_fc2(torch.relu(self.value_fc1(v)))
        return logits, torch.tanh(v)[:, 0]

    @torch.no_grad()
    def forward(self, features: torch.Tensor):
        with trace.span("stem"):
            x = features.permute(0, 3, 1, 2).to(self.dtype)
            x = torch.relu(self.stem(x))
        for c1, c2 in self.blocks:
            y = torch.relu(c1(x))
            x = torch.relu(x + c2(y))
        with trace.span("heads"):
            return self._heads(self.policy(x), self.value(x))

    def forward_train(self, features: torch.Tensor):
        """Training forward, with autograd: ((logits, value), [(new running
        mean, new running var)] in ``conv_bns()`` order, for
        ``set_batch_stats``). The module's own statistics are left as they
        were."""
        stats = []

        def bn(layer, x):
            y, new = layer.forward_train(x)
            stats.append(new)
            return y

        x = features.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(bn(self.stem, x))
        for c1, c2 in self.blocks:
            y = torch.relu(bn(c1, x))
            x = torch.relu(x + bn(c2, y))
        policy = bn(self.policy, x)
        return self._heads(policy, bn(self.value, x)), stats


class FusedPolicyValueNet(nn.Module):
    """Inference forward with batch norm folded and each residual block one
    ``fused_resblock`` call (twin of ``apply_eval_fused``). ``plain=True``
    runs every block through ``fused_resblock_reference`` instead, on any
    device — the comparison the card's smoke check makes."""

    def __init__(self, env: EnvConfig, net: NetConfig, params, batch_stats,
                 device="cuda", plain: bool = False):
        super().__init__()
        self.dtype = dt = compute_dtype(net)
        self.plain = plain

        def fold(conv, bn, stats):
            return rb.fold_batchnorm(
                _t(conv["kernel"], device), _t(bn["scale"], device),
                _t(bn["bias"], device), _t(stats["mean"], device),
                _t(stats["var"], device))

        w, b = fold(params["stem_conv"], params["stem_bn"],
                    batch_stats["stem_bn"])
        # stem weights rounded to the compute dtype, then widened so the
        # conv accumulates exact products in f32 (JAX: preferred f32)
        self.register_buffer("stem_w", w.to(dt).float().permute(3, 2, 0, 1)
                             .contiguous())
        self.register_buffer("stem_b", b)
        self.blocks = []
        for i in range(net.blocks):
            p, s = params[f"block{i}"], batch_stats[f"block{i}"]
            w1, b1 = fold(p["conv1"], p["bn1"], s["bn1"])
            w2, b2 = fold(p["conv2"], p["bn2"], s["bn2"])
            self.blocks.append(
                (rb.pack_conv_kernel(w1).to(dt).contiguous(), b1.contiguous(),
                 rb.pack_conv_kernel(w2).to(dt).contiguous(), b2.contiguous()))
        wp, self.bp = fold(params["policy_conv"], params["policy_bn"],
                           batch_stats["policy_bn"])
        wv, self.bv = fold(params["value_conv"], params["value_bn"],
                           batch_stats["value_bn"])
        self.wp, self.wv = wp[0, 0], wv[0, 0]                 # [C, 2], [C, 1]
        self.fc = {k: (_t(params[k]["kernel"], device),
                       _t(params[k]["bias"], device))
                   for k in ("policy_fc", "value_fc1", "value_fc2")}

    @classmethod
    @torch.no_grad()
    def from_module(cls, env: EnvConfig, net: NetConfig,
                    module: PolicyValueNet, plain: bool = False
                    ) -> "FusedPolicyValueNet":
        """Fold a live ``PolicyValueNet``'s weights and running statistics
        on its own device, with no host copy. The result holds copies: a
        later training step does not change it."""
        params, stats = module.flax_trees()
        return cls(env, net, params, stats, module.stem.conv.weight.device,
                   plain)

    @torch.no_grad()
    def forward(self, features: torch.Tensor):
        dt = self.dtype
        with trace.span("stem"):
            x = features.to(dt).float().permute(0, 3, 1, 2)
            x = F.conv2d(x, self.stem_w, padding=1).permute(0, 2, 3, 1)
            x = torch.relu(x + self.stem_b).to(dt).contiguous()
        block = rb.fused_resblock_reference if self.plain else \
            rb.fused_resblock
        for w1, b1, w2, b2 in self.blocks:
            x = block(x, w1, b1, w2, b2)
        with trace.span("heads"):
            bsz = x.shape[0]
            xf = x.float()
            p = torch.relu(xf @ self.wp + self.bp).reshape(bsz, -1)
            wk, bk = self.fc["policy_fc"]
            logits = p @ wk + bk
            v = torch.relu(xf @ self.wv + self.bv).reshape(bsz, -1)
            wk, bk = self.fc["value_fc1"]
            v = torch.relu(v @ wk + bk)
            wk, bk = self.fc["value_fc2"]
            return logits, torch.tanh(v @ wk + bk)[:, 0]
