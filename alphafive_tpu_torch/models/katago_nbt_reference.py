"""KataGo's nested-bottleneck net (``b18c384nbt``), from its equations, in
f32: the plain reference that ``models/katago_nbt.py`` is tested against.

Plain torch, TF32 off; imports no kernel of the port and nothing of JAX.
Sources: github.com/lightvector/KataGo ``python/modelconfigs.py``
(``b18c384nbt``) and ``python/model_pytorch.py``
(``NestedBottleneckResBlock``, ``ResBlock``, ``KataConvAndGPool``,
``KataGPool``, ``KataValueHeadGPool``, ``PolicyHead``, ``ValueHead``);
Wu, "Accelerating Self-Play Learning in Go", arXiv:1902.10565 (global
pooling).

Notation: NCHW; A(·) a per-channel affine γ⊙x + β followed by ReLU;
conv_k a k×k convolution with zero padding of its input and no bias;
on an S×S board (the board is always full: no mask)

    Pool_g(z) = [mean z, mean z · (S − 14)/10, max z]
    Pool_v(z) = [mean z, mean z · (S − 14)/10, mean z · ((S − 14)²/100 − 0.1)]

over the board, per channel. The net:

    x = conv_5(f; W_stem)                         4 input planes → C
    block:  h = conv_1(A_p(x); W_p)               C → M
            two inner pairs on h (the first a pooling pair in a
            pooling block), then x ← x + conv_1(A_q(h); W_q)   M → C
    plain pair:   h ← h + conv_3(A_2(conv_3(A_1(h); W_1)); W_2)
    pooling pair: u = A_1(h); r = conv_3(u; W_1r) (M → M − G);
                  g = A_g(conv_3(u; W_1g)) (M → G);
                  r ← r + Dense(Pool_g(g)) (3G → M − G, broadcast);
                  h ← h + conv_3(A_2(r); W_2) (M − G → M)
    x_f = ReLU(BN(x))     the one batch norm: batch statistics in
                          training, running statistics in inference
    policy: P = conv_1(x_f) to H; Q = A(conv_1(x_f)) to H;
            P ← ReLU(β + P + Dense(Pool_g(Q)))   (3H → H);
            logits = conv_1(P) to 1 over the S² cells
    value:  V = A(conv_1(x_f)) to H;
            v = tanh(Dense(ReLU(Dense(Pool_v(V))))) (3H → value_hidden → 1)

with C = ``channels``, M = ``mid_channels``, G = ``gpool_channels``, H =
``head_channels``. Weights are flax-layout trees (conv kernels HWIO, dense
kernels ``[in, out]``) of the names ``init_params`` in
``models/katago_nbt.py`` draws. ``quant``, where given, is applied to
every conv and dense input and weight.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.99


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _ident(x):
    return x


def pool_g(z: torch.Tensor) -> torch.Tensor:
    mean = z.mean((2, 3))
    return torch.cat([mean, mean * (z.shape[-1] - 14) / 10.0,
                      z.amax((2, 3))], 1)


def pool_v(z: torch.Tensor) -> torch.Tensor:
    mean, k = z.mean((2, 3)), z.shape[-1] - 14
    return torch.cat([mean, mean * k / 10.0, mean * (k * k / 100.0 - 0.1)], 1)


def _act(x, p):
    return torch.relu(x * p["scale"][:, None, None] + p["bias"][:, None, None])


def _conv(x, layer, q):
    k = layer["kernel"]
    return F.conv2d(q(x), q(k.permute(3, 2, 0, 1)), padding=k.shape[0] // 2)


def _dense(x, layer, q):
    y = q(x) @ q(layer["kernel"])
    return y + layer["bias"] if "bias" in layer else y


def _apply(params, feats, q, final_norm):
    x = _conv(feats.permute(0, 3, 1, 2), params["stem_conv"], q)
    i = 0
    while f"block{i}" in params:
        blk = params[f"block{i}"]
        h = _conv(_act(x, blk["norm_p"]), blk["conv_p"], q)
        for j in (0, 1):
            pr = blk[f"pair{j}"]
            u = _act(h, pr["norm1"])
            if "conv1g" in pr:
                r = _conv(u, pr["conv1r"], q)
                g = _act(_conv(u, pr["conv1g"], q), pr["normg"])
                r = r + _dense(pool_g(g), pr["linear_g"], q)[:, :, None, None]
            else:
                r = _conv(u, pr["conv1"], q)
            h = h + _conv(_act(r, pr["norm2"]), pr["conv2"], q)
        x = x + _conv(_act(h, blk["norm_q"]), blk["conv_q"], q)
        i += 1
    xf = torch.relu(final_norm(x))
    p = _conv(xf, params["policy_conv"], q)
    g = _act(_conv(xf, params["policy_gconv"], q), params["policy_gnorm"])
    p = torch.relu(p + params["policy_bias"]["bias"][:, None, None]
                   + _dense(pool_g(g), params["policy_linear_g"],
                            q)[:, :, None, None])
    logits = _conv(p, params["policy_out"], q).reshape(x.shape[0], -1)
    v = _act(_conv(xf, params["value_conv"], q), params["value_norm"])
    v = torch.relu(_dense(pool_v(v), params["value_fc1"], q))
    v = torch.tanh(_dense(v, params["value_fc2"], q))
    return logits, v[:, 0]


def forward(params: Dict, stats: Dict, feats: torch.Tensor,
            quant: Optional[Callable] = None):
    """Inference (the final batch norm's running statistics): (logits
    [B, S²], value [B]) in f32 from NHWC planes [B, S, S, 4]."""
    bn, st = params["trunk_bn"], stats["trunk_bn"]

    def final(x):
        inv = torch.rsqrt(st["var"] + BN_EPS) * bn["scale"]
        return ((x - st["mean"][:, None, None]) * inv[:, None, None]
                + bn["bias"][:, None, None])

    with no_tf32(), torch.no_grad():
        return _apply(params, feats.float(), quant or _ident, final)


def forward_train(params: Dict, stats: Dict, feats: torch.Tensor,
                  quant: Optional[Callable] = None):
    """Training (the final batch norm on the batch's statistics, biased
    variance E[y²] − E[y]² clipped at 0), with autograd: ((logits,
    value), the new running statistics {"trunk_bn": {"mean", "var"}})."""
    bn, st, new = params["trunk_bn"], stats["trunk_bn"], {}

    def final(x):
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        new["trunk_bn"] = {
            "mean": BN_MOMENTUM * st["mean"] + (1 - BN_MOMENTUM) * mean.detach(),
            "var": BN_MOMENTUM * st["var"] + (1 - BN_MOMENTUM) * var.detach()}
        inv = torch.rsqrt(var + BN_EPS) * bn["scale"]
        return ((x - mean[:, None, None]) * inv[:, None, None]
                + bn["bias"][:, None, None])

    with no_tf32():
        out = _apply(params, feats.float(), quant or _ident, final)
    return out, new
