"""Function-preserving model surgery on flax-layout numpy trees: warm-start
a bigger preset from a trained smaller model (port of
``alphafive_tpu/models/surgery.py``).

* ``widen``: Net2WiderNet (Chen, Goodfellow & Shlens, ICLR'16). One global
  channel map g duplicates trunk channels (the skip-adds force one channel
  identity through the whole trunk); every consumer divides a duplicated
  fan-in by its replication count; batch-norm parameters and statistics
  are duplicated alongside. Function-preserving at noise 0; small noise on
  the duplicated output filters breaks the symmetry.
* ``deepen``: append residual blocks whose second conv kernel is zero, so
  each is an exact identity (in train mode too: batch norm of a zero
  activation is zero); the first conv gets a He init.
* ``resize_board``: only the two FC heads see the board. Their kernels
  are resized spatially (the policy FC as a [S, S, 2, S, S] position →
  action map, the value FC1 as H maps over [S, S]) by
  ``jax.image.resize``'s "linear" method and rescaled by (S_old/S_new)².

``transfer`` composes the three. The random draws (the map g, the noise
and the He init) come from a ``torch.Generator``; ``g``, ``eps`` and
``he`` take them as arrays instead, in the order the functions draw them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from alphafive_tpu_torch.config import EnvConfig, NetConfig

Tree = Dict[str, Any]
# jax.nn.initializers.he_normal: a normal truncated to ±2 std, rescaled
# by 1 / (the std of that truncated normal)
TRUNC_STD = 0.87962566103423978


def _copy(tree: Tree) -> Tree:
    return {k: _copy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _take_out(kernel: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Duplicate conv output channels (last axis) by the map g."""
    return np.take(kernel, g, axis=-1)


def _take_in(kernel: np.ndarray, g: np.ndarray,
             count: np.ndarray) -> np.ndarray:
    """Duplicate conv input channels (axis -2), dividing by the
    replication count so the widened sum equals the original."""
    k = np.take(kernel, g, axis=-2)
    return k / count[g].reshape((1,) * (k.ndim - 2) + (-1, 1))


def _normal(generator: Optional[torch.Generator], shape) -> np.ndarray:
    return torch.randn(tuple(shape), generator=generator).numpy()


def widen(variables: Tree, new_channels: int,
          generator: Optional[torch.Generator] = None, noise: float = 1e-2,
          g: Optional[np.ndarray] = None,
          eps: Optional[Sequence[np.ndarray]] = None) -> Tree:
    """Net2WiderNet widening of the trunk (stem, residual blocks, the
    heads' 1×1 convs on their input side). Draws, unless given: the new
    channels' sources ``g[old_c:]`` (uniform), then a standard normal per
    noisy kernel: the stem, then each block's conv1 and conv2 (``eps``,
    each shaped like the kernel's new output filters)."""
    params, stats = _copy(variables["params"]), _copy(variables["batch_stats"])
    old_c = params["stem_conv"]["kernel"].shape[-1]
    if new_channels < old_c:
        raise ValueError(f"cannot narrow {old_c} channels to {new_channels}")
    if new_channels == old_c:
        return {"params": params, "batch_stats": stats}

    if g is None:
        extra = torch.randint(0, old_c, (new_channels - old_c,),
                              generator=generator).numpy()
        g = np.concatenate([np.arange(old_c), extra])
    g = np.asarray(g, np.int64)
    count = np.zeros((old_c,), np.float32)
    np.add.at(count, g, 1.0)
    draws: List[np.ndarray] = list(eps) if eps is not None else []

    def noisy(kernel: np.ndarray) -> np.ndarray:
        """Perturb only the duplicated (j >= old_c) output filters."""
        if noise == 0.0:
            return kernel
        e = (draws.pop(0) if eps is not None
             else _normal(generator, kernel[..., old_c:].shape))
        std = np.std(kernel) * np.float32(noise)
        out = kernel.copy()
        out[..., old_c:] += np.asarray(e, np.float32) * std
        return out

    def widen_bn(p, s, name):
        p[name] = {"scale": p[name]["scale"][g], "bias": p[name]["bias"][g]}
        s[name] = {"mean": s[name]["mean"][g], "var": s[name]["var"][g]}

    params["stem_conv"] = {
        "kernel": noisy(_take_out(params["stem_conv"]["kernel"], g))}
    widen_bn(params, stats, "stem_bn")
    n_blocks = sum(1 for name in params if name.startswith("block"))
    for i in range(n_blocks):
        blk, bst = params[f"block{i}"], stats[f"block{i}"]
        for conv in ("conv1", "conv2"):
            blk[conv] = {"kernel": noisy(_take_out(
                _take_in(blk[conv]["kernel"], g, count), g))}
        for bn in ("bn1", "bn2"):
            widen_bn(blk, bst, bn)
    for head in ("policy_conv", "value_conv"):
        params[head] = {"kernel": _take_in(params[head]["kernel"], g, count)}
    return {"params": params, "batch_stats": stats}


def he_normal(generator: Optional[torch.Generator], shape) -> np.ndarray:
    """``jax.nn.initializers.he_normal`` for an HWIO conv kernel: a
    normal truncated to ±2, × sqrt(2 / fan_in) / TRUNC_STD."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(2.0 / fan_in) / TRUNC_STD
    w = torch.empty(tuple(shape))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).numpy()


def deepen(variables: Tree, new_blocks: int,
           generator: Optional[torch.Generator] = None,
           he: Optional[Sequence[np.ndarray]] = None) -> Tree:
    """Append identity residual blocks (zero second conv). Exact. Each new
    block's conv1 kernel is a He-normal draw, unless given in ``he``."""
    params, stats = _copy(variables["params"]), _copy(variables["batch_stats"])
    old_blocks = sum(1 for name in params if name.startswith("block"))
    if new_blocks < old_blocks:
        raise ValueError(f"cannot drop blocks ({old_blocks} → {new_blocks})")
    c = params["stem_conv"]["kernel"].shape[-1]
    ones, zeros = np.ones((c,), np.float32), np.zeros((c,), np.float32)
    for j, i in enumerate(range(old_blocks, new_blocks)):
        w1 = (np.asarray(he[j], np.float32) if he is not None
              else he_normal(generator, (3, 3, c, c)))
        params[f"block{i}"] = {
            "conv1": {"kernel": w1},
            "conv2": {"kernel": np.zeros((3, 3, c, c), np.float32)},
            "bn1": {"scale": ones.copy(), "bias": zeros.copy()},
            "bn2": {"scale": ones.copy(), "bias": zeros.copy()},
        }
        stats[f"block{i}"] = {
            "bn1": {"mean": zeros.copy(), "var": ones.copy()},
            "bn2": {"mean": zeros.copy(), "var": ones.copy()},
        }
    return {"params": params, "batch_stats": stats}


def _resize_weights(m: int, n: int) -> np.ndarray:
    """[m, n] weights of ``jax.image.scale_and_translate``'s linear kernel
    (antialiased, translation 0) in f32, as JAX computes them: half-pixel
    sample centres, a triangle widened by the inverse scale when
    shrinking, columns normalised, samples outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n / m)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear(x: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.image.resize(x, shape, "linear")``: axis by axis, each axis
    whose size changes contracted with its weight matrix (in f64, then
    rounded to x's dtype)."""
    out = np.asarray(x, np.float64)
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = _resize_weights(m, n).astype(np.float64)
            out = np.moveaxis(np.tensordot(out, w, axes=([d], [0])), -1, d)
    return out.astype(x.dtype)


def resize_board(variables: Tree, old_size: int, new_size: int) -> Tree:
    """Rebuild the FC heads for a new board size by spatial interpolation
    of their kernels (the conv trunk transfers untouched)."""
    params, stats = _copy(variables["params"]), _copy(variables["batch_stats"])
    if new_size == old_size:
        return {"params": params, "batch_stats": stats}
    so, sn = old_size, new_size
    area_fix = (so / sn) ** 2

    # policy FC: rows are the flattened [S, S, 2] policy_conv output
    # (channel-minor), columns the [S, S] action grid
    pk = params["policy_fc"]["kernel"].reshape(so, so, 2, so, so)
    pk = resize_linear(pk, (sn, sn, 2, sn, sn)) * np.float32(area_fix)
    pb = resize_linear(params["policy_fc"]["bias"].reshape(so, so), (sn, sn))
    params["policy_fc"] = {"kernel": pk.reshape(2 * sn * sn, sn * sn),
                           "bias": pb.reshape(sn * sn)}

    # value FC1: H spatial maps over the [S, S] value_conv output
    h = params["value_fc1"]["kernel"].shape[-1]
    vk = params["value_fc1"]["kernel"].reshape(so, so, h)
    vk = resize_linear(vk, (sn, sn, h)) * np.float32(area_fix)
    params["value_fc1"] = {"kernel": vk.reshape(sn * sn, h),
                           "bias": params["value_fc1"]["bias"]}
    return {"params": params, "batch_stats": stats}


def _shapes(tree: Tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype)) for k, v in tree.items()}


def transfer(variables: Tree, src_env: EnvConfig, src_net: NetConfig,
             dst_env: EnvConfig, dst_net: NetConfig,
             generator: Optional[torch.Generator] = None,
             noise: float = 1e-2, g=None, eps=None, he=None) -> Tree:
    """Full surgery, source model → dst preset: widen, deepen, resize.
    `generator` draws for widen then deepen; ``g``/``eps``/``he`` inject
    their draws."""
    from alphafive_tpu_torch.models.nets import require_resnet
    from alphafive_tpu_torch.models.resnet import init_params

    require_resnet(src_net, "model surgery")
    require_resnet(dst_net, "model surgery")
    if dst_net.channels < src_net.channels:
        raise ValueError("cannot narrow")
    if dst_net.blocks < src_net.blocks:
        raise ValueError("cannot shallow")
    if dst_net.value_hidden != src_net.value_hidden:
        raise ValueError("value_hidden mismatch (resize not supported)")
    v = widen(variables, dst_net.channels, generator, noise=noise, g=g,
              eps=eps)
    v = deepen(v, dst_net.blocks, generator, he=he)
    v = resize_board(v, src_env.board_size, dst_env.board_size)
    params, stats = init_params(dst_env, dst_net)
    if _shapes(v) != _shapes({"params": params, "batch_stats": stats}):
        raise ValueError("surgery produced a mismatched parameter tree")
    return v
