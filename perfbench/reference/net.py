"""The residual policy-value net, from its equations, in f32.

Input planes ``[B, S, S, 4]`` (own stones, the opponent's, the last move,
black to play) → a 3×3 conv stem, ``blocks`` residual blocks of two 3×3
convs, a policy head (1×1 conv to 2 planes → a dense layer to S² logits)
and a value head (1×1 conv to 1 plane → a dense layer to ``value_hidden``
→ a dense layer to 1 → tanh). Every conv is bias-free and followed by
batch norm (eps 1e-5) and, but for a block's second conv, a ReLU; the
second conv's output is added to the block's input before its ReLU. The
heads flatten (h, w, c). Weights are flax-layout trees: conv kernels
HWIO, dense kernels ``[in, out]``.

``forward`` normalises by the running statistics (inference);
``forward_train`` by the batch's statistics, with the biased variance
``E[y²] − E[y]²`` clipped at 0. ``quant`` (a function applied to every
conv and dense input and weight) turns the same equations into a lower
precision: ``fp8`` is the control that must come out as not correct.
Matmuls run with TF32 off. This is the ``resnet`` architecture's net
(``perfbench/archs/resnet.py``); ``features`` and the masked softmax are
shared by every architecture.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0   # largest finite float8_e4m3fn


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions in f32 (TF32 off), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded through float8 e4m3 with one scale per leading row
    (its largest magnitude maps to 448), back in f32. The gradient passes
    straight through."""
    dims = tuple(range(1, x.dim())) if x.dim() > 1 else (0,)
    amax = x.detach().abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


def features(size: int, board: torch.Tensor, to_play: torch.Tensor,
             last: torch.Tensor) -> torch.Tensor:
    """f32 ``[B, S, S, 4]`` planes of flat boards ``int8[B, S²]``."""
    b = board.shape[0]
    tp = to_play.reshape(b, 1).to(board.dtype)
    own = (board == tp).float()
    opp = (board == -tp).float()
    lm = torch.zeros_like(own)
    has = last >= 0
    rows = torch.arange(b, device=board.device)[has]
    lm[rows, last[has].long()] = 1.0
    black = (to_play.reshape(b, 1) > 0).float().expand_as(own)
    return torch.stack([own, opp, lm, black], -1).reshape(b, size, size, 4)


def tree_to_torch(tree, device) -> Dict:
    """A flax-layout tree of numpy arrays (or tensors) as f32 tensors on
    `device`."""
    return {k: tree_to_torch(v, device) if isinstance(v, dict) else
            v.to(device, torch.float32) if isinstance(v, torch.Tensor) else
            torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def _ident(x):
    return x


def _conv(x, kernel, quant):
    """NCHW x, HWIO kernel, same padding."""
    w = kernel.permute(3, 2, 0, 1)
    return F.conv2d(quant(x), quant(w), padding=kernel.shape[0] // 2)


def _bn_eval(y, bn, st):
    inv = torch.rsqrt(st["var"] + BN_EPS) * bn["scale"]
    return (y - st["mean"][:, None, None]) * inv[:, None, None] \
        + bn["bias"][:, None, None]


def _bn_train(y, bn):
    mean = y.mean((0, 2, 3))
    var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + BN_EPS) * bn["scale"]
    return (y - mean[:, None, None]) * inv[:, None, None] \
        + bn["bias"][:, None, None]


def _dense(x, layer, quant):
    return quant(x) @ quant(layer["kernel"]) + layer["bias"]


def _flat(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _apply(params, feats, quant, norm):
    """(logits, value) with `norm(y, path)` as the batch norm after the
    conv whose batch-norm parameters sit at `path`."""
    x = feats.permute(0, 3, 1, 2)
    x = torch.relu(norm(_conv(x, params["stem_conv"]["kernel"], quant),
                        ("stem_bn",)))
    i = 0
    while f"block{i}" in params:
        blk = params[f"block{i}"]
        y = torch.relu(norm(_conv(x, blk["conv1"]["kernel"], quant),
                            (f"block{i}", "bn1")))
        x = torch.relu(x + norm(_conv(y, blk["conv2"]["kernel"], quant),
                                (f"block{i}", "bn2")))
        i += 1
    p = torch.relu(norm(_conv(x, params["policy_conv"]["kernel"], quant),
                        ("policy_bn",)))
    logits = _dense(_flat(p), params["policy_fc"], quant)
    v = torch.relu(norm(_conv(x, params["value_conv"]["kernel"], quant),
                        ("value_bn",)))
    v = torch.relu(_dense(_flat(v), params["value_fc1"], quant))
    v = torch.tanh(_dense(v, params["value_fc2"], quant))
    return logits, v[:, 0]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def forward(params, stats, feats: torch.Tensor,
            quant: Optional[Callable] = None):
    """Inference forward (running statistics): (logits [B, S²], value
    [B]) in f32."""
    q = quant or _ident
    with no_tf32(), torch.no_grad():
        return _apply(params, feats.float(), q,
                      lambda y, path: _bn_eval(y, _at(params, path),
                                               _at(stats, path)))


def forward_train(params, feats: torch.Tensor,
                  quant: Optional[Callable] = None):
    """Training forward (batch statistics), with autograd."""
    q = quant or _ident
    return _apply(params, feats.float(), q,
                  lambda y, path: _bn_train(y, _at(params, path)))


def masked_log_softmax(logits: torch.Tensor,
                       legal: torch.Tensor) -> torch.Tensor:
    x = torch.where(legal, logits.float(), float("-inf"))
    return torch.log_softmax(x, dim=-1)
