"""katago_nbt: KataGo's nested-bottleneck net (``b18c384nbt``), as
``alphafive_tpu_torch/models/katago_nbt.py`` runs it (inference through
``ops/katago_nbt.py``'s kernels).

The benchmark's own copy of the equations (independent of the program:
imports nothing of it, nor JAX; the kernels are named by
``"module:attribute"``). Sources: github.com/lightvector/KataGo
``python/modelconfigs.py`` (``b18c384nbt``), ``python/model_pytorch.py``
(``NestedBottleneckResBlock``, ``KataConvAndGPool``, ``KataGPool``,
``KataValueHeadGPool``, ``PolicyHead``, ``ValueHead``); Wu,
arXiv:1902.10565 (global pooling). NCHW; A(·) a per-channel affine γ⊙x + β
then ReLU; conv_k with zero padding of its input, no bias; on a full S×S
board (no mask)

    Pool_g(z) = [mean z, mean z · (S − 14)/10, max z],
    Pool_v(z) = [mean z, mean z · (S − 14)/10, mean z · ((S − 14)²/100 − 0.1)];

    x = conv_5(f; W_stem)                                   4 → C
    block i: h = conv_1(A_p(x); W_p)                        C → M
             two pairs on h, then x ← x + conv_1(A_q(h); W_q)     M → C
    plain pair:   h ← h + conv_3(A_2(conv_3(A_1(h); W_1)); W_2)
    pooling pair (the first of a pooling block): u = A_1(h);
                  r = conv_3(u; W_1r) (M → M − G); g = A_g(conv_3(u; W_1g));
                  r ← r + Dense(Pool_g(g)); h ← h + conv_3(A_2(r); W_2)
    x_f = ReLU(BN(x))   (running statistics in inference)
    policy: P = conv_1(x_f); Q = A(conv_1(x_f)); P ← ReLU(β + P +
            Dense(Pool_g(Q))); logits = conv_1(P) to one plane
    value:  V = A(conv_1(x_f)); v = tanh(Dense(ReLU(Dense(Pool_v(V)))))

``quant`` (applied to every conv and dense input and weight) turns the
equations into a lower precision: ``reference.net.fp8`` is the control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import net as ref_net

BN_EPS = 1e-5
# the random draw (PERF.md §4): residual branches' last convs × He, the
# policy's last 1×1 × He, the value's last dense × 1/√in
BRANCH_SCALE, POLICY_SCALE, VALUE_SCALE = 0.2, 3.0, 1.0
BIAS_STD = 0.5               # the affines' β (a wrong border shows)
CALIBRATION_POSITIONS = 8    # the trunk norm's running statistics' batch
# the program's defaults of the keys a configuration may leave out
# (alphafive_tpu_torch/config.py NetConfig: b18c384nbt's)
DEFAULTS = {"mid_channels": 192, "gpool_channels": 64,
            "gpool_blocks": [3, 6, 9, 12, 15], "head_channels": 32}


def _net(net: Dict) -> Dict:
    return {**DEFAULTS, **net}


def _ident(x):
    return x


def _pool_g(z):
    mean = z.mean((2, 3))
    return torch.cat([mean, mean * (z.shape[-1] - 14) / 10.0,
                      z.amax((2, 3))], 1)


def _pool_v(z):
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


def _trunk(params, feats, q):
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
                r = r + _dense(_pool_g(g), pr["linear_g"], q)[:, :, None, None]
            else:
                r = _conv(u, pr["conv1"], q)
            h = h + _conv(_act(r, pr["norm2"]), pr["conv2"], q)
        x = x + _conv(_act(h, blk["norm_q"]), blk["conv_q"], q)
        i += 1
    return x


def _heads(params, xf, q):
    p = _conv(xf, params["policy_conv"], q)
    g = _act(_conv(xf, params["policy_gconv"], q), params["policy_gnorm"])
    p = torch.relu(p + params["policy_bias"]["bias"][:, None, None]
                   + _dense(_pool_g(g), params["policy_linear_g"],
                            q)[:, :, None, None])
    logits = _conv(p, params["policy_out"], q).reshape(xf.shape[0], -1)
    v = _act(_conv(xf, params["value_conv"], q), params["value_norm"])
    v = torch.relu(_dense(_pool_v(v), params["value_fc1"], q))
    return logits, torch.tanh(_dense(v, params["value_fc2"], q))[:, 0]


def forward(params, stats, feats: torch.Tensor, quant=None):
    """Inference (running statistics): (logits [B, S²], value [B]), f32."""
    q = quant or _ident
    bn, st = params["trunk_bn"], stats["trunk_bn"]
    with ref_net.no_tf32(), torch.no_grad():
        x = _trunk(params, feats.float(), q)
        inv = torch.rsqrt(st["var"] + BN_EPS) * bn["scale"]
        xf = torch.relu((x - st["mean"][:, None, None]) * inv[:, None, None]
                        + bn["bias"][:, None, None])
        return _heads(params, xf, q)


def _batch_norm(x, bn):
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + BN_EPS) * bn["scale"]
    return ((x - mean[:, None, None]) * inv[:, None, None]
            + bn["bias"][:, None, None]), mean, var


def forward_train(params, feats: torch.Tensor, quant=None):
    """Training (the batch's statistics, biased variance), with autograd."""
    q = quant or _ident
    with ref_net.no_tf32():
        x = _trunk(params, feats.float(), q)
        return _heads(params, torch.relu(_batch_norm(x, params["trunk_bn"])[0]),
                      q)


def _shapes(env: Dict, net: Dict) -> Dict:
    net = _net(net)
    c, m, g = net["channels"], net["mid_channels"], net["gpool_channels"]
    hh, vh = net["head_channels"], net["value_hidden"]
    pools = set(net["gpool_blocks"])
    norm = lambda n: {"scale": (n,), "bias": (n,)}
    conv = lambda k, i, o: {"kernel": (k, k, i, o)}
    tree = {"stem_conv": conv(5, 4, c)}
    for i in range(net["blocks"]):
        blk = {"norm_p": norm(c), "conv_p": conv(1, c, m),
               "norm_q": norm(m), "conv_q": conv(1, m, c)}
        for j in (0, 1):
            blk[f"pair{j}"] = ({
                "norm1": norm(m), "conv1r": conv(3, m, m - g),
                "conv1g": conv(3, m, g), "normg": norm(g),
                "linear_g": {"kernel": (3 * g, m - g)},
                "norm2": norm(m - g), "conv2": conv(3, m - g, m)}
                if j == 0 and i + 1 in pools else {
                "norm1": norm(m), "conv1": conv(3, m, m),
                "norm2": norm(m), "conv2": conv(3, m, m)})
        tree[f"block{i}"] = blk
    tree.update({
        "trunk_bn": norm(c), "policy_conv": conv(1, c, hh),
        "policy_gconv": conv(1, c, hh), "policy_gnorm": norm(hh),
        "policy_linear_g": {"kernel": (3 * hh, hh)},
        "policy_bias": {"bias": (hh,)}, "policy_out": conv(1, hh, 1),
        "value_conv": conv(1, c, hh), "value_norm": norm(hh),
        "value_fc1": {"kernel": (3 * hh, vh), "bias": (vh,)},
        "value_fc2": {"kernel": (vh, 1), "bias": (1,)}})
    return tree


def random_weights(env: Dict, net: Dict, seed: int):
    """Flax-layout (params, batch_stats) from `seed`: conv kernels
    He-scaled (the residual branches' last convs, the policy's last 1×1
    and the value's last dense scaled as above), affines 1 + 0.1 N and
    ``BIAS_STD`` N, value biases 0; the trunk norm's running statistics those of
    the trunk over ``CALIBRATION_POSITIONS`` positions drawn from the
    seed (0–39 stones, alternating colours), as a trained net's hold the
    trunk's own, so that the policy is not flat and the value not
    saturated."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def draw(path, shape):
        if path[-1] == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(f32)
        if path[-1] == "bias":
            if path[0] in ("value_fc1", "value_fc2"):
                return np.zeros(shape, f32)
            return (BIAS_STD * rng.standard_normal(shape)).astype(f32)
        if len(shape) == 4:
            std = (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
            std *= (BRANCH_SCALE if path[-2] in ("conv2", "conv_q") else
                    POLICY_SCALE if path[0] == "policy_out" else 1.0)
        else:
            std = shape[0] ** -0.5 * (VALUE_SCALE if path[0] == "value_fc2"
                                      else 1.0)
        return (rng.standard_normal(shape) * std).astype(f32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v) for k, v in tree.items()}

    params = walk(_shapes(env, net))
    size = env["board_size"]
    n = CALIBRATION_POSITIONS
    board = np.zeros((n, size * size), np.int8)
    for b in range(n):
        k = int(rng.integers(0, 40))
        cells = rng.permutation(size * size)[:k]
        board[b, cells] = np.where(np.arange(k) % 2 == 0, 1, -1)
    to_play = np.where(np.count_nonzero(board, 1) % 2 == 0, 1, -1)
    feats = ref_net.features(size, torch.from_numpy(board),
                             torch.from_numpy(to_play.astype(np.int8)),
                             torch.full((n,), -1, dtype=torch.int32))
    p = ref_net.tree_to_torch(params, "cpu")
    with ref_net.no_tf32(), torch.no_grad():
        _, mean, var = _batch_norm(_trunk(p, feats, _ident), p["trunk_bn"])
    stats = {"trunk_bn": {"mean": mean.numpy().astype(f32),
                          "var": var.numpy().astype(f32)}}
    return params, stats


def check_bundle(saved: Dict, env: Dict, net: Dict) -> None:
    """Raises unless a bundle's saved config is this net at the
    configuration's widths (the repository holds no such bundle)."""
    net = _net(net)
    keys = ("arch", "blocks", "channels", "mid_channels", "gpool_channels",
            "head_channels", "value_hidden")
    want = (env["board_size"],) + tuple(net[k] for k in keys)
    got = (saved["env"]["board_size"],) + tuple(saved["net"].get(k)
                                                 for k in keys)
    if want != got:
        raise ValueError(f"the bundle holds board and {keys} {got}; the "
                         f"configuration {want}")


def leaf_name(torch_name: str) -> str:
    """The flax leaf of a ``NestedBottleneckNet`` parameter: the program
    names its parameters by their flax paths."""
    return torch_name.replace(".", "/")


def program_trees(module) -> tuple:
    """f32 copies of a ``NestedBottleneckNet``'s weights as flax-layout
    trees (params, batch_stats): it holds them in that layout."""
    params: Dict = {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    with torch.no_grad():
        for name, v in module.named_parameters():
            put(params, leaf_name(name).split("/"), v.detach().float().clone())
        bufs = dict(module.named_buffers())
        stats = {"trunk_bn": {k: bufs[f"trunk_bn.{k}"].detach().float().clone()
                              for k in ("mean", "var")}}
    return params, stats


def _block_flops(s2: int, net: Dict, pooling: bool) -> float:
    c, m, g = net["channels"], net["mid_channels"], net["gpool_channels"]
    f = 2 * 2 * s2 * c * m                      # the two 1×1s
    f += 2 * 2 * s2 * 9 * m * m                 # a plain pair
    if pooling:
        f += 2 * s2 * 9 * m * m + 2 * s2 * 9 * (m - g) * m \
            + 2 * 3 * g * (m - g)               # the pooling pair
    else:
        f += 2 * 2 * s2 * 9 * m * m
    return f


def flops_per_position(env: Dict, net: Dict) -> float:
    """Multiply-adds × 2 of one position's forward: the 5×5 stem, the
    blocks' convs and pooling dense layers, the heads' 1×1 convs and
    dense layers."""
    net = _net(net)
    s2, c = env["board_size"] ** 2, net["channels"]
    hh, vh = net["head_channels"], net["value_hidden"]
    pools = set(net["gpool_blocks"])
    f = 2 * s2 * 25 * 4 * c
    f += sum(_block_flops(s2, net, i + 1 in pools)
             for i in range(net["blocks"]))
    f += 3 * 2 * s2 * c * hh + 2 * 3 * hh * hh + 2 * s2 * hh
    f += 2 * 3 * hh * vh + 2 * vh
    return float(f)


def kernels(env: Dict, net: Dict) -> List[tuple]:
    mod = "alphafive_tpu_torch.ops.katago_nbt"
    return [("nbt_pair", f"{mod}:preact_pair"),
            ("nbt_gpool", f"{mod}:gpool_pair"),
            ("nbt_conv1x1", f"{mod}:conv1x1")]


def kernel_work(span: str, batch: int, env: Dict, net: Dict) -> List[tuple]:
    """[(FLOPs, bytes, dtype, calls)] of `span`'s entry point in one
    forward of `batch` positions: the products it needs; its input and
    output activations read and written once, its weights (bf16) and
    affines (f32) read once."""
    net = _net(net)
    s2, dt = env["board_size"] ** 2, net["compute_dtype"]
    c, m, g = net["channels"], net["mid_channels"], net["gpool_channels"]
    eb = 2 if dt == "bfloat16" else 4
    pools = sum(1 for b in set(net["gpool_blocks"])
                if 1 <= b <= net["blocks"])
    act = lambda ch: batch * s2 * ch * eb
    if span == "nbt_pair":
        f = 2 * 2 * batch * s2 * 9 * m * m
        b = 2 * act(m) + 2 * 9 * m * m * eb + 4 * m * 4
        return [(float(f), float(b), dt, 2 * net["blocks"] - pools)]
    if span == "nbt_gpool":
        cr = m - g
        f = (2 * batch * s2 * 9 * m * m + 2 * batch * s2 * 9 * cr * m
             + 2 * batch * 3 * g * cr)
        b = (2 * act(m) + (9 * m * m + 9 * cr * m) * eb
             + (2 * m + 2 * g + 2 * cr + 3 * g * cr) * 4)
        return [(float(f), float(b), dt, pools)]
    if span == "nbt_conv1x1":
        f = 2 * batch * s2 * c * m
        down = act(c) + act(m) + c * m * eb + 2 * c * 4
        up = act(m) + 2 * act(c) + c * m * eb + 2 * m * 4
        return [(float(f), float(down), dt, net["blocks"]),
                (float(f), float(up), dt, net["blocks"])]
    raise KeyError(f"katago_nbt has no kernel {span!r}")
