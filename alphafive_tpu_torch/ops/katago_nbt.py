"""KataGo nested-bottleneck kernels: CUDA wrappers and plain versions.

The convolutions of ``models/katago_nbt.py``'s trunk, in the notation of
``models/katago_nbt_reference.py`` (A(·) a per-channel affine and ReLU,
conv_k with zero padding of its input). Activations are NHWC ``[B, H, W,
C]`` in bf16; conv weights are packed ``[Cout, k·k·Cin]`` (`pack_conv`);
affines are f32 ``[C]`` scales and shifts. Three entry points, each
launching ``csrc/katago_nbt.cu`` on CUDA tensors and running its plain
twin (``*_reference``, the kernel's rounding points) on CPU tensors; on
any other device they raise. The fused net calls them as module
attributes, so that a wrapper installed on the module sees every call.

* ``preact_pair(h, …)``: h + conv_3(A_2(conv_3(A_1(h); W_1)); W_2), two
  launches (conv 1 with the prologue A_1 and the epilogue A_2, conv 2
  with the residual). Bound by the tensor cores: 0.96 GFLOP against
  ~0.55 MB a position at 192 channels.
* ``gpool_pair(h, …)``: the pooling pair (r and g in one conv, g's A_g in
  its epilogue; the board's mean, scaled mean and max of g and the dense
  layer in one small kernel that folds them with A_2 into a per-sample
  shift; conv 2 with that prologue and the residual): three launches.
  Bound by the tensor cores, as above.
* ``conv1x1(x, …)``: conv_1(A(x); W) [+ residual], one launch: the
  bottleneck 384 → 192 and back. Bound by HBM (64 FLOP a byte).

Each convolution runs one of two mainloops of the kernel, picked by shape
(`conv_variant`): ``wgmma3x3`` (the 3×3s at 192 output channels: one slab
of the activated input a channel chunk, ``wgmma`` fed by a warp-specialised
producer) or ``mma`` (the 1×1s and every other shape: ``mma.sync`` over a
``cp.async`` ring).
``preact_pair_as`` and ``gpool_pair_as`` run a named mainloop, for timing.

Counters (``utils/trace.py``): ``nbt_launches.<entry point>``, one a call
on CUDA tensors (0 on the CPU); ``nbt_conv_launches.<variant>``, one a
convolution launched, by mainloop. Span ``gpool``: the pooling pair's
reduction and dense layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alphafive_tpu_torch.utils import trace

KERNELS = ("preact_pair", "gpool_pair", "conv1x1")
VARIANTS = ("wgmma3x3", "mma")  # the mainloops, csrc/katago_nbt.cu's enum
_CODES = {"mma": 0, "wgmma3x3": 1}  # Variant codes

# wg::kMaxWidth (csrc/katago_nbt.cu): the widest board whose slabs fit
WG_MAX_WIDTH = 110


def conv_variant(ks: int, cin: int, cout: int, w: int) -> str:
    """The mainloop a convolution takes: ``wgmma3x3`` for a 3×3 of 128 or
    192 input channels to 192 on a board at most `WG_MAX_WIDTH` wide,
    else ``mma``. Raises ValueError for a shape neither takes."""
    if ks not in (1, 3) or cin <= 0 or cout <= 0 or cin % 64 or cout % 64:
        raise ValueError(f"katago_nbt conv does not take cin {cin}, cout "
                         f"{cout}, {ks}x{ks}: it takes 1x1 and 3x3 with cin "
                         f"and cout multiples of 64")
    if ks == 3 and cin in (128, 192) and cout == 192 and w <= WG_MAX_WIDTH:
        return "wgmma3x3"
    return "mma"


def pack_conv(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel [k, k, Cin, Cout] → [Cout, k·k·Cin] (tap-major K:
    tap = ky · k + kx, then the input channel), contiguous."""
    k, _, cin, cout = kernel.shape
    return kernel.permute(3, 0, 1, 2).reshape(cout, k * k * cin).contiguous()


def pool_scale(side: int) -> float:
    """Pool_g's and Pool_v's (√HW − 14)/10 on a full side × side board."""
    return (side - 14) / 10.0


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic (bf16 operands, f32 sums) and
# rounding points

def _conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC `u` (the conv's input, activated and rounded) with packed `w`
    → NHWC f32; zero padding, f32 products of the rounded operands."""
    cin = u.shape[-1]
    k = int(round((w.shape[1] // cin) ** 0.5))
    wt = w.float().reshape(w.shape[0], k, k, cin).permute(0, 3, 1, 2)
    y = F.conv2d(u.float().permute(0, 3, 1, 2), wt, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def _prologue(x: torch.Tensor, scale, shift) -> torch.Tensor:
    """A(x) rounded to x's dtype; `shift` [C] or per sample [B, C]."""
    sh = shift[:, None, None, :] if shift.dim() == 2 else shift
    return torch.relu(x.float() * scale + sh).to(x.dtype)


def preact_pair_reference(h, s1, t1, w1, s2, t2, w2) -> torch.Tensor:
    """Plain `preact_pair`."""
    y = torch.relu(_conv(_prologue(h, s1, t1), w1) * s2 + t2).to(h.dtype)
    return (_conv(y, w2) + h.float()).to(h.dtype)


def gpool_shift_reference(g, wl, s2, t2) -> torch.Tensor:
    """Plain pool kernel: s2 · Dense(Pool_g(g)) + t2 per sample, [B, Cr]."""
    gf = g.float()
    mean = gf.sum((1, 2)) / (g.shape[1] * g.shape[2])
    pooled = torch.cat([mean, mean * pool_scale(g.shape[1]),
                        gf.amax((1, 2))], 1)
    return s2 * (pooled @ wl) + t2


def gpool_pair_reference(h, s1, t1, w1, sg, tg, wl, s2, t2,
                         w2) -> torch.Tensor:
    """Plain `gpool_pair`."""
    cr, dt = wl.shape[1], h.dtype
    z = _conv(_prologue(h, s1, t1), w1)
    r = z[..., :cr].to(dt)
    g = torch.relu(z[..., cr:] * sg + tg).to(dt)
    with trace.span("gpool"):
        shift = gpool_shift_reference(g, wl, s2, t2)
    v = _prologue(r, s2, shift)
    return (_conv(v, w2) + h.float()).to(dt)


def conv1x1_reference(x, s, t, w, residual=None) -> torch.Tensor:
    """Plain `conv1x1`."""
    y = _conv(_prologue(x, s, t), w)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launches

def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(x, *tensors) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous bf16 [B, H, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    for t in tensors:
        if t is not None and (t.device != x.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"operands must be contiguous, 16-byte aligned "
                             f"and on {x.device}")


def _launch_conv(lib, x, ldx, cin, w, out, pro=None, shift_stride=0,
                 epi=None, relu_from=None, res=None, variant=None) -> None:
    """One ``alphafive_nbt_conv``: `x` rows of `ldx` elements, the first
    `cin` read; `pro` = (scale, shift) of the prologue, `epi` = (scale,
    shift) of the epilogue; `variant` a mainloop of `VARIANTS` (timing),
    or None: the shape's (`conv_variant`), counted."""
    b, h, w_, _ = out.shape
    cout = out.shape[-1]
    if w.dtype != torch.bfloat16 or w.shape[0] != cout:
        raise ValueError(f"packed weights must be bf16 [{cout}, k*k*{cin}], "
                         f"got {w.dtype} {tuple(w.shape)}")
    ks = {cin: 1, 9 * cin: 3}.get(w.shape[1])
    if ks is None:
        raise ValueError(f"packed weights {tuple(w.shape)} are not 1x1 or "
                         f"3x3 over {cin} channels")
    chosen = conv_variant(ks, cin, cout, w_)
    ps, pt = pro if pro is not None else (None, None)
    es, et = epi if epi is not None else (None, None)
    err = lib.alphafive_nbt_conv(
        x.data_ptr(), ldx, w.data_ptr(), _ptr(ps), _ptr(pt), shift_stride,
        _ptr(es), _ptr(et), cout if relu_from is None else relu_from,
        _ptr(res), out.data_ptr(), b * h * w_, h * w_, h, w_, cin, cout, ks,
        _CODES[variant or chosen], torch.cuda.current_stream().cuda_stream)
    if err == 1:
        raise ValueError(
            f"katago_nbt conv: mainloop {variant or chosen} does not take "
            f"cin {cin} of rows of {ldx}, cout {cout}, {ks}x{ks}, a "
            f"{w_}-wide board (both: cin and cout multiples of 64, rows "
            f"of a multiple of 8; wgmma3x3 also: 3x3, cin 128 or 192, cout "
            f"192, boards at most {WG_MAX_WIDTH} wide)")
    if err != 0:
        raise RuntimeError(f"katago_nbt conv launch failed: CUDA error {err}")
    if variant is None:
        trace.count("nbt_conv_launches." + chosen)


def _device(x) -> bool:
    """True: launch the kernel (CUDA); False: the plain twin (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no katago_nbt kernel for device {x.device}")
    return True


def preact_pair(h, s1, t1, w1, s2, t2, w2) -> torch.Tensor:
    """h + conv_3(A_2(conv_3(A_1(h); W_1)); W_2). h [B, H, W, M] bf16;
    s*/t* f32 [M]; w1, w2 packed [M, 9M] bf16."""
    if not _device(h):
        return preact_pair_reference(h, s1, t1, w1, s2, t2, w2)
    out = _preact_pair(None, h, s1, t1, w1, s2, t2, w2)
    trace.count("nbt_launches.preact_pair")
    return out


def preact_pair_as(variant, h, s1, t1, w1, s2, t2, w2) -> torch.Tensor:
    """`preact_pair` on CUDA tensors with both convs on the mainloop
    `variant` (of `VARIANTS`), whatever the shape's: timing only, counts
    nothing."""
    return _preact_pair(variant, h, s1, t1, w1, s2, t2, w2)


def _preact_pair(variant, h, s1, t1, w1, s2, t2, w2) -> torch.Tensor:
    _check(h, s1, t1, w1, s2, t2, w2)
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    m = h.shape[-1]
    with torch.cuda.device(h.device):
        y = torch.empty_like(h)
        _launch_conv(lib, h, m, m, w1, y, pro=(s1, t1), epi=(s2, t2),
                     relu_from=0, variant=variant)
        out = torch.empty_like(h)
        _launch_conv(lib, y, m, m, w2, out, res=h, variant=variant)
    return out


def gpool_pair(h, s1, t1, w1, sg, tg, wl, s2, t2, w2) -> torch.Tensor:
    """The pooling pair: u = A_1(h); [r | g] = conv_3(u; W_1) with g ←
    A_g(g); r ← r + Dense(Pool_g(g)); h + conv_3(A_2(r); W_2). h [B, H, W,
    M] bf16; s1/t1 f32 [M]; w1 packed [Cr + G, 9M] (r's kernel, then g's);
    sg/tg f32 [G]; wl f32 [3G, Cr]; s2/t2 f32 [Cr]; w2 packed [M, 9Cr]."""
    if not _device(h):
        return gpool_pair_reference(h, s1, t1, w1, sg, tg, wl, s2, t2, w2)
    out = _gpool_pair(None, h, s1, t1, w1, sg, tg, wl, s2, t2, w2)
    trace.count("nbt_launches.gpool_pair")
    return out


def gpool_pair_as(variant, h, s1, t1, w1, sg, tg, wl, s2, t2,
                  w2) -> torch.Tensor:
    """`gpool_pair` on CUDA tensors with both convs on the mainloop
    `variant`: timing only, counts nothing."""
    return _gpool_pair(variant, h, s1, t1, w1, sg, tg, wl, s2, t2, w2)


def _gpool_pair(variant, h, s1, t1, w1, sg, tg, wl, s2, t2,
                w2) -> torch.Tensor:
    _check(h, s1, t1, w1, sg, tg, wl, s2, t2, w2)
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    b, side, side2, m = h.shape
    cr, cg = wl.shape[1], sg.shape[0]
    with torch.cuda.device(h.device):
        # A_g on g's channels alone: an identity affine on r's, ReLU from cr
        es = torch.cat([torch.ones(cr, device=h.device), sg])
        et = torch.cat([torch.zeros(cr, device=h.device), tg])
        rg = torch.empty((b, side, side2, cr + cg), dtype=h.dtype,
                         device=h.device)
        _launch_conv(lib, h, m, m, w1, rg, pro=(s1, t1), epi=(es, et),
                     relu_from=cr, variant=variant)
        shift = torch.empty((b, cr), dtype=torch.float32, device=h.device)
        with trace.span("gpool"):
            err = lib.alphafive_nbt_pool(
                rg.data_ptr() + 2 * cr, cr + cg, b, side * side2, cg, cr,
                pool_scale(side), wl.data_ptr(), s2.data_ptr(),
                t2.data_ptr(), shift.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"katago_nbt pool launch failed: CUDA error "
                               f"{err}")
        out = torch.empty_like(h)
        _launch_conv(lib, rg, cr + cg, cr, w2, out, pro=(s2, shift),
                     shift_stride=cr, res=h, variant=variant)
    return out


def conv1x1(x, s, t, w, residual=None) -> torch.Tensor:
    """conv_1(A(x); W) [+ residual]. x [B, H, W, Cin] bf16; s/t f32 [Cin];
    w packed [Cout, Cin] bf16; residual [B, H, W, Cout] bf16 or None."""
    if not _device(x):
        return conv1x1_reference(x, s, t, w, residual)
    _check(x, s, t, w, residual)
    from alphafive_tpu_torch.ops import _build
    lib = _build.load()
    b, hh, ww, cin = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty((b, hh, ww, w.shape[0]), dtype=x.dtype,
                          device=x.device)
        _launch_conv(lib, x, cin, cin, w, out, pro=(s, t), res=residual)
    trace.count("nbt_launches.conv1x1")
    return out
