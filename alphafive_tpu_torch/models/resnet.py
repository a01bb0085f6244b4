"""Residual policy-value network (port of ``alphafive_tpu/models/resnet.py``).

[B, S, S, 4] NHWC features → (policy logits [B, S*S], value [B]): a 3×3
conv stem, ``blocks`` residual blocks of two 3×3 convs, a policy head
(1×1 conv → FC) and a value head (1×1 conv → FC → FC → tanh). Convs and
batch norm run in the compute dtype; heads and outputs are f32.

Two forwards, as in the JAX package:

* ``PolicyValueNet`` keeps batch norm as separate layers — the twin of
  ``apply_eval``.
* ``FusedPolicyValueNet`` folds batch norm into the convolutions once, at
  construction, and runs each residual block through
  ``ops.resblock.fused_resblock`` (the CUDA kernel on the card) — the twin
  of ``apply_eval_fused``. The stem and the 1×1 heads stay plain torch, as
  the JAX package leaves them to XLA.

Weights arrive as flax-layout numpy trees (``train.checkpoint.load_model``
or ``init_params``). The heads flatten NHWC (h, w, c) as flax does, so the
FC rows need no permutation.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.ops import resblock as rb

BN_EPS = 1e-5


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
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


class _ConvBN(nn.Module):
    """Bias-free conv followed by inference batch norm."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in the compute dtype → BN output in the same dtype."""
        y = F.conv2d(x, self.conv.weight.to(x.dtype),
                     padding=self.conv.padding)
        y = F.batch_norm(y.float(), self.bn.running_mean,
                         self.bn.running_var, self.bn.weight, self.bn.bias,
                         False, 0.0, BN_EPS)
        return y.to(x.dtype)


def _flat_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PolicyValueNet(nn.Module):
    """Batch-norm twin of the flax module (``apply_eval``), eval mode."""

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

    @classmethod
    def from_flax(cls, env: EnvConfig, net: NetConfig, params, batch_stats,
                  device="cpu") -> "PolicyValueNet":
        m = cls(env, net)
        m.stem.load_flax(params["stem_conv"], params["stem_bn"],
                         batch_stats["stem_bn"])
        for i, (c1, c2) in enumerate(m.blocks):
            p, s = params[f"block{i}"], batch_stats[f"block{i}"]
            c1.load_flax(p["conv1"], p["bn1"], s["bn1"])
            c2.load_flax(p["conv2"], p["bn2"], s["bn2"])
        m.policy.load_flax(params["policy_conv"], params["policy_bn"],
                           batch_stats["policy_bn"])
        m.value.load_flax(params["value_conv"], params["value_bn"],
                          batch_stats["value_bn"])
        with torch.no_grad():
            for lin, name in ((m.policy_fc, "policy_fc"),
                              (m.value_fc1, "value_fc1"),
                              (m.value_fc2, "value_fc2")):
                lin.weight.copy_(_t(params[name]["kernel"]).T)
                lin.bias.copy_(_t(params[name]["bias"]))
        return m.to(device)

    @torch.no_grad()
    def forward(self, features: torch.Tensor):
        x = features.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(self.stem(x))
        for c1, c2 in self.blocks:
            y = torch.relu(c1(x))
            x = torch.relu(x + c2(y))
        p = _flat_nhwc(torch.relu(self.policy(x))).float()
        logits = self.policy_fc(p)
        v = _flat_nhwc(torch.relu(self.value(x))).float()
        v = self.value_fc2(torch.relu(self.value_fc1(v)))
        return logits, torch.tanh(v)[:, 0]


class FusedPolicyValueNet(nn.Module):
    """Inference forward with batch norm folded and each residual block one
    ``fused_resblock`` call (twin of ``apply_eval_fused``). ``plain=True``
    runs every block through ``fused_resblock_reference`` instead, on any
    device — the comparison the card's smoke check makes."""

    def __init__(self, env: EnvConfig, net: NetConfig, params, batch_stats,
                 device="cpu", plain: bool = False):
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

    @torch.no_grad()
    def forward(self, features: torch.Tensor):
        dt = self.dtype
        x = features.to(dt).float().permute(0, 3, 1, 2)
        x = F.conv2d(x, self.stem_w, padding=1).permute(0, 2, 3, 1)
        x = torch.relu(x + self.stem_b).to(dt).contiguous()
        block = rb.fused_resblock_reference if self.plain else \
            rb.fused_resblock
        for w1, b1, w2, b2 in self.blocks:
            x = block(x, w1, b1, w2, b2)
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
