"""KataGo's nested-bottleneck net (``net.arch=katago_nbt``) against its
plain f32 reference (``models/katago_nbt_reference.py``), at a small size
on the CPU: each kernel's plain twin, the training net's forward, loss
and gradients, the fused inference net, the bf16 path, the benchmark's
own copy of the equations, and the normal path (the factory, the CLI's
train and play, checkpoints)."""

from __future__ import annotations

import builtins
import importlib.util
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from alphafive_tpu_torch import cli, parallel
from alphafive_tpu_torch.config import (EnvConfig, NetConfig, RunConfig,
                                        apply_overrides, get_preset)
from alphafive_tpu_torch.models import katago_nbt as nbt
from alphafive_tpu_torch.models import katago_nbt_reference as ref
from alphafive_tpu_torch.models import nets
from alphafive_tpu_torch.ops import katago_nbt as ops
from alphafive_tpu_torch.train import checkpoint as ckpt
from alphafive_tpu_torch.utils import trace

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = EnvConfig(board_size=9)
# 9×9, trunk 32, mid 16, 8 pooled channels, 3 blocks, block 3 pooling
NET = NetConfig(arch="katago_nbt", blocks=3, channels=32, mid_channels=16,
                gpool_channels=8, gpool_blocks=(3,), head_channels=8,
                value_hidden=16, compute_dtype="float32")
NBT_SETS = ["net.arch=katago_nbt", "net.blocks=3", "net.channels=32",
            "net.mid_channels=16", "net.gpool_channels=8",
            "net.gpool_blocks=[3]", "net.head_channels=8",
            "net.value_hidden=16", "net.compute_dtype=float32"]


def tensors(tree):
    return {k: tensors(v) if isinstance(v, dict) else
            torch.tensor(np.asarray(v, np.float32)) for k, v in tree.items()}


def features(n=6, seed=0, size=9):
    g = torch.Generator().manual_seed(seed)
    board = torch.zeros(n, size * size)
    for b in range(n):
        k = int(torch.randint(0, size * size // 2, (1,), generator=g))
        cells = torch.randperm(size * size, generator=g)[:k]
        board[b, cells] = torch.where(torch.arange(k) % 2 == 0, 1.0, -1.0)
    last = torch.zeros_like(board)
    last[:, 0] = 1.0
    f = torch.stack([(board == 1).float(), (board == -1).float(), last,
                     torch.ones_like(board)], -1)
    return f.reshape(n, size, size, 4), board


def fp8(x):
    """`x` through float8 e4m3, one scale a leading row (the control)."""
    dims = tuple(range(1, x.dim())) if x.dim() > 1 else (0,)
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    return (x * (448.0 / amax)).to(torch.float8_e4m3fn).float() * amax / 448.0


def policy_tv(logits, want, board):
    legal = board == 0
    p = torch.log_softmax(logits.masked_fill(~legal, float("-inf")), -1)
    q = torch.log_softmax(want.masked_fill(~legal, float("-inf")), -1)
    return 0.5 * (p.exp() - q.exp()).abs().sum(-1).max().item()


# --- the kernels' plain twins ---------------------------------------------

def affine(n, g, bias=0.0):
    return ((1 + 0.1 * torch.randn(n, generator=g)).float(),
            (bias + 0.2 * torch.randn(n, generator=g)).float())


@pytest.fixture
def operands():
    g = torch.Generator().manual_seed(5)
    m, c, gp = 16, 32, 8
    hwio = lambda k, i, o: torch.randn(k, k, i, o, generator=g) * (
        2.0 / (k * k * i)) ** 0.5
    return {"g": g, "h": torch.randn(2, 9, 9, m, generator=g),
            "x": torch.randn(2, 9, 9, c, generator=g),
            # β₁ > 0: padding with A_1(0) = ReLU(β₁) in place of zeros shows
            "a1": affine(m, g, bias=0.5), "a2": affine(m, g),
            "ag": affine(gp, g), "a2r": affine(m - gp, g),
            "ap": affine(c, g, bias=0.3), "aq": affine(m, g),
            "w1": hwio(3, m, m), "w2": hwio(3, m, m),
            "w1r": hwio(3, m, m - gp), "w1g": hwio(3, m, gp),
            "wl": torch.randn(3 * gp, m - gp, generator=g) / 5,
            "w2r": hwio(3, m - gp, m), "wp": hwio(1, c, m),
            "wq": hwio(1, m, c)}


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def r_act(x, a):
    return ref._act(x, {"scale": a[0], "bias": a[1]})


def r_conv(x, k):
    return ref._conv(x, {"kernel": k}, ref._ident)


def test_preact_pair_twin_is_the_equation(operands):
    o = operands
    got = ops.preact_pair(o["h"], *o["a1"], ops.pack_conv(o["w1"]),
                          *o["a2"], ops.pack_conv(o["w2"]))
    h = nchw(o["h"])
    want = h + r_conv(r_act(r_conv(r_act(h, o["a1"]), o["w1"]), o["a2"]),
                      o["w2"])
    torch.testing.assert_close(got, nhwc(want), rtol=1e-5, atol=1e-5)
    # the padding is zeros of A_1(h), not A_1 of a zero-padded h
    hp = F.pad(h, (1, 1, 1, 1))
    wrong = h + r_conv(r_act(F.conv2d(r_act(hp, o["a1"]), o["w1"].permute(
        3, 2, 0, 1)), o["a2"]), o["w2"])
    assert (got - nhwc(wrong)).abs().max() > 1e-2


def test_gpool_pair_twin_is_the_equation(operands):
    o = operands
    w1 = ops.pack_conv(torch.cat([o["w1r"], o["w1g"]], -1))
    got = ops.gpool_pair(o["h"], *o["a1"], w1, *o["ag"], o["wl"], *o["a2r"],
                         ops.pack_conv(o["w2r"]))
    h = nchw(o["h"])
    u = r_act(h, o["a1"])
    gg = r_act(r_conv(u, o["w1g"]), o["ag"])
    r = r_conv(u, o["w1r"]) + (ref.pool_g(gg) @ o["wl"])[:, :, None, None]
    want = h + r_conv(r_act(r, o["a2r"]), o["w2r"])
    torch.testing.assert_close(got, nhwc(want), rtol=1e-5, atol=1e-5)
    # the pooled bias matters
    r0 = r_conv(u, o["w1r"])
    dropped = h + r_conv(r_act(r0, o["a2r"]), o["w2r"])
    assert (got - nhwc(dropped)).abs().max() > 1e-2


@pytest.mark.parametrize("residual", [False, True])
def test_conv1x1_twin_is_the_equation(operands, residual):
    o = operands
    if residual:   # W_q: mid → trunk, + x
        got = ops.conv1x1(o["h"], *o["aq"], ops.pack_conv(o["wq"]),
                          residual=o["x"])
        want = nchw(o["x"]) + r_conv(r_act(nchw(o["h"]), o["aq"]), o["wq"])
    else:          # W_p: trunk → mid
        got = ops.conv1x1(o["x"], *o["ap"], ops.pack_conv(o["wp"]))
        want = r_conv(r_act(nchw(o["x"]), o["ap"]), o["wp"])
    torch.testing.assert_close(got, nhwc(want), rtol=1e-5, atol=1e-5)


def test_twins_count_no_launch_on_the_cpu(operands):
    """Counters count kernel launches: none on CPU tensors; the pooling
    pair's reduction is spanned."""
    o = operands
    trace.reset()
    trace.enable()
    try:
        ops.gpool_pair(o["h"], *o["a1"], ops.pack_conv(
            torch.cat([o["w1r"], o["w1g"]], -1)), *o["ag"], o["wl"],
            *o["a2r"], ops.pack_conv(o["w2r"]))
        spans = trace.snapshot()["spans"]
    finally:
        trace.disable()
    assert {k: trace.counter("nbt_launches." + k) for k in ops.KERNELS} == {
        k: 0 for k in ops.KERNELS}
    assert spans["gpool"]["calls"] == 1


# --- the mainloops: the host's choice, refusals, counters, the tiling -----

CU = os.path.join(ROOT, "alphafive_tpu_torch", "csrc", "katago_nbt.cu")


def wg_constants() -> dict:
    """csrc/katago_nbt.cu's namespace wg constants that are plain numbers."""
    with open(CU) as f:
        src = f.read()
    wg = src[src.index("namespace wg {"):]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", wg)}


def test_wg_mirrors_match_the_source():
    """ops' mirror of wg::kMaxWidth (the widest board whose slabs fit,
    which decides the mainloop) and of the mainloop codes is the
    source's."""
    c = wg_constants()
    with open(CU) as f:
        src = f.read()
    assert "return (kBM + 2 * w + 4 + 7) / 8 * 8;" in src
    assert ("return 1024 + kStages * kStageBytes + kSlabs * slab_rows(w) * "
            "128 +\n         2 * (kStages + kSlabs) * 8 + 2 * kBN * 4;") in src
    assert "constexpr int kStageBytes = kBN * kBK * 2;" in src
    assert "constexpr int kBM = 64 * kConsumers;" in src
    bm = 64 * c["kConsumers"]
    smem = lambda w: (1024 + c["kStages"] * c["kBN"] * c["kBK"] * 2
                      + c["kSlabs"] * ((bm + 2 * w + 4 + 7) // 8 * 8) * 128
                      + 2 * (c["kStages"] + c["kSlabs"]) * 8 + 2 * c["kBN"] * 4)
    assert smem(ops.WG_MAX_WIDTH) <= c["kSmemLimit"]
    assert smem(ops.WG_MAX_WIDTH + 1) > c["kSmemLimit"]
    assert ("return ks == 3 && (cin == 128 || cin == 192) && cout == kBN &&"
            in src and c["kBN"] == 192)
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = dict((k.strip(), int(v)) for k, v in
                 (e.split("=") for e in enum.split(",")))
    assert codes == {"kMma": ops._CODES["mma"],
                     "kWgmma": ops._CODES["wgmma3x3"]}


@pytest.mark.parametrize("ks, cin, cout, width, want", [
    (3, 192, 192, 19, "wgmma3x3"),     # preact_pair's convs, gpool conv 1
    (3, 128, 192, 19, "wgmma3x3"),     # gpool conv 2 (ldx 192)
    (3, 192, 192, 15, "wgmma3x3"),
    (3, 192, 192, 110, "wgmma3x3"),    # the widest board that fits
    (3, 192, 192, 111, "mma"),
    (3, 192, 384, 19, "mma"),          # one n-tile of 192 only
    (3, 64, 192, 19, "mma"),           # one chunk: not instantiated
    (3, 256, 192, 19, "mma"),
    (3, 192, 64, 19, "mma"),           # cout 64
    (1, 384, 192, 19, "mma"),          # the bottleneck 1x1s
    (1, 192, 384, 19, "mma"),
])
def test_conv_variant_by_shape(ks, cin, cout, width, want):
    """The mainloop depends on the shape alone; the batch does not
    matter (every batch of a b18c384nbt forward runs the same)."""
    assert ops.conv_variant(ks, cin, cout, width) == want


@pytest.mark.parametrize("ks, cin, cout", [(3, 96, 192), (3, 192, 96),
                                           (1, 32, 64), (5, 192, 192),
                                           (3, 0, 192)])
def test_conv_variant_refuses_what_no_mainloop_takes(ks, cin, cout):
    with pytest.raises(ValueError, match="cin and cout multiples of 64"):
        ops.conv_variant(ks, cin, cout, 19)


def test_conv_counters_by_mainloop_are_zero_on_the_cpu(operands):
    """``nbt_conv_launches.<variant>`` counts kernel launches by mainloop:
    none for the twins."""
    o = operands
    trace.reset()
    ops.preact_pair(o["h"], *o["a1"], ops.pack_conv(o["w1"]), *o["a2"],
                    ops.pack_conv(o["w2"]))
    ops.conv1x1(o["x"], *o["ap"], ops.pack_conv(o["wp"]))
    assert ops.VARIANTS == ("wgmma3x3", "mma")
    assert {k: trace.counter("nbt_conv_launches." + k)
            for k in ops.VARIANTS} == {"wgmma3x3": 0, "mma": 0}
    assert not any(k.startswith("nbt_conv_launches.")
                   for k in trace.snapshot()["counters"])


def wg_emulate(x, ldx, cin, w, cout, pro=None, shift_stride=0, epi=None,
               relu_from=None, res=None):
    """wg::conv3x3 on the CPU, by the kernel's own index arithmetic (the
    tiles, the slab's grid rows and zeros, the taps' row offsets, the
    epilogue's grid rows), in f32 from bf16 operands."""
    b, h, wd, _ = x.shape
    bm, bn = 192, 192
    pitch, rows = wd + 1, bm + 2 * wd + 4
    parts = (h * pitch + bm - 1) // bm
    tiles = b * parts
    xf = x.reshape(b * h * wd, ldx)[:, :cin].float()
    wt = w.float().reshape(cout, 9, cin)
    out = torch.full((b * h * wd, cout), float("nan"))
    for i in range(tiles):
        sb, part = i // parts, i % parts
        q0 = part * bm - pitch - 1
        slab = torch.zeros(rows, cin)
        for r in range(rows):
            q = q0 + r
            y = q // pitch if q >= 0 else -1
            if q >= 0 and y < h and q - y * pitch < wd:
                v = xf[sb * h * wd + q - y]
                if pro is not None:
                    sh = pro[1].reshape(-1)[sb * shift_stride:][:cin]
                    v = torch.relu(v * pro[0] + sh).to(x.dtype).float()
                slab[r] = v
        acc = torch.zeros(bm, bn)
        for tap in range(9):
            off = (tap // 3) * pitch + tap % 3
            acc += slab[off:off + bm] @ wt[:, tap].T
        for o in range(bm):
            g = part * bm + o
            y, xx = g // pitch, g % pitch
            if y >= h or xx >= wd:
                continue
            pos = sb * h * wd + y * wd + xx
            v = acc[o]
            if epi is not None:
                v = v * epi[0] + epi[1]
            rf = cout if relu_from is None else relu_from
            v = torch.where(torch.arange(bn) >= rf, torch.relu(v), v)
            if res is not None:
                v = v + res.reshape(-1, cout)[pos].float()
            out[pos] = v
    return out.to(x.dtype).reshape(b, h, wd, cout)


@pytest.mark.parametrize("b, side, cin, ldx, cout, per_sample", [
    (2, 19, 192, 192, 192, False),   # two tiles a sample
    (3, 9, 192, 192, 192, False),    # one tile a sample
    (1, 15, 128, 192, 192, True),    # gpool conv 2: r of [r | g], shift
    (1, 23, 192, 192, 192, False),   # three tiles a sample
    (2, 5, 128, 128, 192, True),
])
def test_wg_tiling_is_the_convolution(b, side, cin, ldx, cout, per_sample):
    """The new mainloop's tiling (tiles of 192 grid rows of one sample's
    board bordered by a zero column, the slab of every row the taps
    reach, landed once a chunk with zeros off the board and the prologue
    applied as it lands, the 9 taps as row offsets into it) computes the
    twin's convolution."""
    g = torch.Generator().manual_seed(24 + side)
    x = torch.randn(b, side, side, ldx, generator=g).bfloat16()
    w = ops.pack_conv(torch.randn(3, 3, cin, cout, generator=g)
                      * (2 / (9 * cin)) ** 0.5).bfloat16()
    scale = 1 + 0.1 * torch.randn(cin, generator=g)
    shift = 0.5 + 0.2 * torch.randn(b if per_sample else 1, cin, generator=g)
    es, et = 1 + 0.1 * torch.randn(cout, generator=g), 0.1 * torch.randn(
        cout, generator=g)
    res = torch.randn(b, side, side, cout, generator=g).bfloat16()
    relu_from = cout // 3
    got = wg_emulate(x, ldx, cin, w, cout, pro=(scale, shift),
                     shift_stride=cin if per_sample else 0, epi=(es, et),
                     relu_from=relu_from, res=res)
    u = ops._prologue(x[..., :cin], scale,
                      shift if per_sample else shift[0])
    z = ops._conv(u, w) * es + et
    z = torch.cat([z[..., :relu_from], torch.relu(z[..., relu_from:])], -1)
    want = (z + res.float()).to(x.dtype)
    assert not torch.isnan(got.float()).any()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


# --- the nets against the reference ----------------------------------------

@pytest.fixture(scope="module")
def weights():
    return nbt.init_params(ENV, NET, seed=3)


def test_forward_matches_the_reference(weights):
    params, stats = weights
    net = nets.from_flax(ENV, NET, params, stats, "cpu")
    f, _ = features()
    logits, value = net(f)
    want = ref.forward(tensors(params), tensors(stats), f)
    # f32 on both sides, the same operations: summation order only
    torch.testing.assert_close(logits, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(value, want[1], rtol=1e-5, atol=1e-5)


def test_forward_train_loss_and_gradients_match_the_reference(weights):
    """Outputs, the loss (policy cross-entropy and value MSE on seeded
    targets), every parameter's gradient and the new running statistics,
    f32: within 1e-4 of each gradient's largest entry (summation order)."""
    params, stats = weights
    net = nets.from_flax(ENV, NET, params, stats, "cpu")
    f, _ = features(8, seed=1)
    g = torch.Generator().manual_seed(2)
    pi = torch.softmax(torch.randn(8, 81, generator=g), -1)
    z = torch.randn(8, generator=g).clamp(-1, 1)

    def loss(out):
        logits, value = out
        return (-(pi * torch.log_softmax(logits, -1)).sum(-1).mean()
                + ((value - z) ** 2).mean())

    out, new = net.forward_train(f)
    lp = loss(out)
    grads = torch.autograd.grad(lp, list(net.parameters()))
    tp = tensors(params)
    leaves = []

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)
    walk(tp)
    rout, rnew = ref.forward_train(tp, tensors(stats), f)
    lr = loss(rout)
    torch.testing.assert_close(lp, lr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[0], rout[0], rtol=1e-5, atol=1e-5)
    rgrads = dict(zip([id(x) for x in leaves],
                      torch.autograd.grad(lr, leaves)))
    tree_grads = net.flax_tree(grads)

    def compare(a, b, path=""):
        for k in b:
            if isinstance(b[k], dict):
                compare(a[k], b[k], f"{path}{k}/")
            else:
                want = rgrads[id(b[k])]
                tol = 1e-4 * max(float(want.abs().max()), 1e-8)
                assert (a[k] - want).abs().max() <= tol, path + k
    compare(tree_grads, tp)
    assert len(grads) == len(leaves) == len(list(net.kernels())) + sum(
        1 for n, _ in net.named_parameters() if not n.endswith(".kernel"))
    torch.testing.assert_close(new[0][0], rnew["trunk_bn"]["mean"])
    torch.testing.assert_close(new[0][1], rnew["trunk_bn"]["var"])


def test_fused_net_through_the_twins_matches_the_net(weights):
    params, stats = weights
    f, _ = features()
    want = nets.from_flax(ENV, NET, params, stats, "cpu")(f)
    got = nets.fused(ENV, NET, params, stats, "cpu")(f)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    live = nets.from_flax(ENV, NET, params, stats, "cpu")
    folded = nets.fused_from_module(ENV, NET, live)(f)
    torch.testing.assert_close(folded[0], got[0], rtol=0, atol=0)


# the bf16 path against the f32 reference: policy total variation and
# value gap. bf16 reads ~0.005 / ~0.001 here (f32 sums of bf16 operands,
# rounded at each kernel's output); the float8 control ~0.05 / ~0.01
BF16_TV, BF16_GAP = 0.02, 0.005


def test_bf16_path_is_within_tolerance_and_float8_is_not(weights):
    params, stats = weights
    f, board = features(16, seed=4)
    net16 = NetConfig(**{**NET.__dict__, "compute_dtype": "bfloat16"})
    logits, value = nets.fused(ENV, net16, params, stats, "cpu")(f)
    rp, rs = tensors(params), tensors(stats)
    want = ref.forward(rp, rs, f)
    assert policy_tv(logits, want[0], board) < BF16_TV
    assert (value - want[1]).abs().max() < BF16_GAP
    low = ref.forward(rp, rs, f, quant=fp8)
    assert (policy_tv(low[0], want[0], board) > BF16_TV
            or (low[1] - want[1]).abs().max() > BF16_GAP)


# --- the benchmark's copy --------------------------------------------------

def bench_arch():
    spec = importlib.util.spec_from_file_location(
        "bench_katago_nbt", os.path.join(ROOT, "perfbench", "archs",
                                         "katago_nbt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH_NET = {"arch": "katago_nbt", "blocks": 3, "channels": 32,
             "mid_channels": 16, "gpool_channels": 8, "gpool_blocks": [3],
             "head_channels": 8, "value_hidden": 16,
             "compute_dtype": "float32"}


def test_bench_copy_is_the_reference(weights):
    """The benchmark's own equations (loaded by path) give the program's
    reference's outputs on the same trees, inference and training."""
    arch = bench_arch()
    params, stats = weights
    rp, rs = tensors(params), tensors(stats)
    f, _ = features()
    got, want = arch.forward(rp, rs, f), ref.forward(rp, rs, f)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    got = arch.forward_train(rp, f)
    want, _ = ref.forward_train(rp, rs, f)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_bench_weights_load_into_the_program():
    """``random_weights``' layout is the program's: it loads into
    ``from_flax`` and the fused net, ``program_trees`` gives it back, and
    ``leaf_name`` names every parameter by its path."""
    arch = bench_arch()
    env = {"board_size": 9, "n_in_row": 5, "rules": "freestyle"}
    params, stats = arch.random_weights(env, BENCH_NET, 2 ** 31 + 3)
    net = nets.from_flax(ENV, NET, params, stats, "cpu")
    f, _ = features()
    torch.testing.assert_close(nets.fused(ENV, NET, params, stats, "cpu")(
        f)[0], net(f)[0], rtol=1e-4, atol=1e-4)
    back_p, back_s = arch.program_trees(net)

    def same(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert np.array_equal(np.asarray(a[k]), b[k].numpy()), k
    same(params, back_p)
    same(stats, back_s)
    for name, _ in net.named_parameters():
        path = arch.leaf_name(name).split("/")
        leaf = params
        for k in path:
            leaf = leaf[k]
    assert arch.flops_per_position(env, BENCH_NET) > 0


# --- configuration and the normal path -------------------------------------

def test_config_keys_and_resnet_json_unchanged():
    cfg = apply_overrides(get_preset("renju_19x19"), NBT_SETS)
    assert cfg.net.gpool_blocks == (3,) and cfg.net.arch == "katago_nbt"
    assert RunConfig.from_json(cfg.to_json()) == cfg
    assert '"gpool_blocks"' in cfg.to_json()
    assert '"arch"' not in get_preset("renju_19x19").to_json()
    many = apply_overrides(cfg, ["net.gpool_blocks=[1, 2, 3]"])
    assert many.net.gpool_blocks == (1, 2, 3)
    with pytest.raises(ValueError, match="gpool_blocks"):
        nets.build(cfg.env, apply_overrides(cfg, ["net.gpool_blocks=[4]"]
                                            ).net, "cpu")
    with pytest.raises(ValueError, match="net.arch"):
        nets.build(cfg.env, apply_overrides(cfg, ["net.arch=nope"]).net,
                   "cpu")


def small_renju(tmp_path=None):
    sets = NBT_SETS + ["train.num_envs=2", "train.selfplay_plies_per_iter=2",
                       "train.learner_steps_per_iter=1",
                       "mcts.num_simulations=8", "replay.capacity=64",
                       "replay.min_fill=2", "replay.batch_size=4"]
    return [x for s in sets for x in ("--set", s)]


def test_cli_train_and_play_run_the_net(tmp_path, monkeypatch, capsys):
    """`cli train --preset renju_19x19 --set net.arch=katago_nbt …` runs
    iterations (the learner's steps among them) and checkpoints the net; `cli play` with the same keys loads
    that checkpoint and plays an AI move."""
    wd = str(tmp_path / "run")
    common = ["--preset", "renju_19x19", "--device", "cpu", *small_renju()]
    assert cli.main(["train", *common, "--workdir", wd, "--iters", "3"]) == 0
    ts, saved = ckpt.restore_train_state(ckpt.make_manager(f"{wd}/ckpt"),
                                         device="cpu")
    assert isinstance(ts.net, nbt.NestedBottleneckNet)
    assert saved.net.arch == "katago_nbt" and ts.step >= 1   # learned
    moves = iter(["9 9"])

    def fake_input(prompt=""):
        try:
            return next(moves)
        except StopIteration:
            raise EOFError
    monkeypatch.setattr(builtins, "input", fake_input)
    capsys.readouterr()
    assert cli.main(["play", *common, "--workdir", wd, "--sims", "8"]) == 0
    out = capsys.readouterr().out
    assert "AI plays" in out


def test_checkpoint_reloads_bit_equal(tmp_path):
    cfg = apply_overrides(get_preset("renju_19x19"),
                          NBT_SETS + ["train.num_envs=2",
                                      "replay.capacity=64",
                                      "replay.batch_size=4"])
    carry = parallel.init_carry(cfg, "cpu", seed=7)
    mgr = ckpt.make_manager(str(tmp_path / "ckpt"))
    from alphafive_tpu_torch.utils.elo import LadderState
    assert ckpt.save(mgr, 1, carry, cfg, LadderState())
    fresh = parallel.init_carry(cfg, "cpu", seed=8)
    _, back, cfg2, _ = ckpt.restore(mgr, fresh)
    f, _ = features(4, size=19)
    a, b = carry.train_state.net(f), back.train_state.net(f)
    assert cfg2 == cfg
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ts, _ = ckpt.restore_train_state(mgr, device="cpu")
    assert torch.equal(ts.net(f)[0], a[0])


def test_surgery_and_transfer_init_refuse_the_net(tmp_path):
    from alphafive_tpu_torch.models import surgery
    from alphafive_tpu_torch.scripts import make_transfer_init
    cfg = apply_overrides(get_preset("renju_19x19"), NBT_SETS)
    params, stats = nets.init_params(cfg.env, cfg.net, 0)
    with pytest.raises(ValueError, match="resnet only"):
        surgery.transfer({"params": params, "batch_stats": stats},
                         cfg.env, cfg.net, cfg.env,
                         get_preset("renju_19x19").net)
    src = str(tmp_path / "src")
    ckpt.export_model(src, params, stats, cfg)
    with pytest.raises(ValueError, match="resnet only"):
        make_transfer_init.main(["--src", src, "--preset", "renju_19x19",
                                 "--out", str(tmp_path / "out")])
