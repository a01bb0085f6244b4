// Fused inference residual block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel alphafive_tpu/ops/pallas_resblock.py::
// fused_resblock (body _resblock_kernel, conv _conv3x3_flat). With batch
// norm folded into the weights it computes, per NHWC sample,
//
//     y   = round_to_T(relu(conv3x3(x; W1) + b1))
//     out = round_to_T(relu(conv3x3(y; W2) + b2 + x))
//
// accumulating in f32, with T the compute type (bf16 on the self-play path,
// f32 for parity checks). Weights are packed [9, Cin, Cout] with tap
// t = (dy + 1) * 3 + (dx + 1), as pack_conv_kernel writes them; b1/b2 are
// f32 [C].
//
// What bounds it on this card: at the self-play shape (2048 samples of
// 15x15x64 per forward) the two convs are 67.9 GFLOP against 59 MB of
// activations in and out, about 1,150 FLOP per byte, so it is bound by the
// tensor cores (69 us at 989 TFLOP/s) if they are fed; the bytes need 18 us.
// A 3x3 'same' conv is nine shifted [HW, C] x [C, C] products, and what
// feeds them is shared memory.
//
// Five kernels; the host picks one per shape with resblock_variant()
// (ops/resblock.py::variant mirrors it):
//
//   resident (bf16, C = 64, boards up to 15x15): the self-play path.
//     * Persistent: one 256-thread CTA per SM walks samples b, b + grid, ...
//     * Both convs' 18 weight taps (147,456 B) are loaded into shared memory
//       once per CTA, transposed to [Cout][Cin] rows of 128 B in the
//       128-byte-swizzled K-major layout a wgmma descriptor reads. This is
//       the TPU kernel's constant-index weight BlockSpec: weights resident
//       across the grid.
//     * Each conv is out^T = sum over taps of W_t^T x_t^T: M = the 64
//       output channels (the taps, operand A), N = the pixels (operand B),
//       K = the 64 input channels. x and y live in buffers of channel-chunk
//       planes (chunk c of row r at c * plane + r * 16 B) over a grid of
//       h x (w + 1) positions whose extra column is the zero border left of
//       one row and right of the row above; a tap (dy, dx) of output
//       position o is then row o + (1 + dy)(w + 1) + 1 + dx, so every
//       tap's B operand is one contiguous run of rows, which a no-swizzle
//       K-major descriptor reads from any row: no bounds checks, no copies.
//     * Warpgroup g owns positions [120 g, 120 g + 120) (240 = 15 x 16: 15
//       junk) and issues one conv as 36 back-to-back wgmma.mma_async
//       m64n120k16 (9 taps x 4 k16 steps), both operands from shared
//       memory: 5.75 KB of shared reads per 123k MACs, against 16 KB for
//       pixels as M (N = 64: the channels), which bounds that layout by
//       shared-memory bandwidth.
//     * Epilogues go through stmatrix/ldmatrix .trans: the [channel]
//       [position] accumulator fragments move as 16 B channel chunks of
//       buffer rows. Conv 1's epilogue writes y to the second buffer and
//       restarts the accumulators at b2 + x (x read from its buffer), so
//       conv 2 accumulates the residual for free; conv 2's epilogue stages
//       relu(acc) in y's buffer, copied to device memory in coalesced 16 B
//       pieces between the taps of the next sample's conv 1.
//     * x's buffer is free once conv 1's epilogue has read it: the next
//       sample's x lands there by cp.async between the taps of conv 2.
//     * Every shared-memory address a thread uses is computed once per
//       launch (no division in the sample loop). Four block barriers per
//       sample, none per tap. benchmarks/resblock_profile.py times each
//       phase on the card from the `// stamp` lines below.
//   streaming (bf16, every other shape up to 19x19: C = 96, 128): the
//     taps of one conv (166 KB at C = 96, 295 KB at 128) do not fit beside
//     a sample, so they stream from L2 through a 3-stage cp.async ring, one
//     tap ahead of the tensor cores, one block barrier per tap.
//     * Persistent CTAs of three warpgroups, 128 positions each (384 >=
//       19 x 20), the same position grid and channel-chunk planes as the
//       resident kernel, but ONE activation buffer: y is written over x in
//       place (conv 1 is done with x), x is reloaded from L2 for the
//       residual after conv 2, and the output is written over it.
//     * M = output channels in two 64-row tiles (at C = 96 the second
//       covers 32..95 and stores 64..95), wgmma m64n128k16 with the tap as
//       an MN-major (transposed) A operand: a [Cin][Cout] tap is copied
//       as is, no transpose.
//   tiled (f32, C = 64, boards up to 15x15): register-blocked SIMT. TF32
//     would round the inputs, so no tensor cores. Persistent CTAs; x and y
//     in halo buffers; each thread owns 8 pixels x 8 output channels (64
//     accumulators, 16 shared loads of 16 B per 256 FMAs); the weight taps
//     stream through a cp.async double buffer, tap t+1 landing while tap t
//     multiplies.
//   f32 plain (f32, C = 64, 96 or 128 where y of one sample fits in shared
//     memory): plain FMA, one sample per block, x read from device memory,
//     y in shared memory.
//   general (bf16 or f32, every shape the four above refuse: any C >= 1, any
//     board): the Pallas kernel tiles only the batch, so it takes any C and
//     board; this variant does too. Persistent CTAs, one sample at a time;
//     each conv is an implicit GEMM of the sample's h*w pixels (M) by the C
//     output channels (N) over the 9 taps x C input channels (K), in 64 x 64
//     output tiles, K in steps of 16 of one tap, staged as f32 through a
//     double buffer in shared memory; each thread owns 4 pixels x 4
//     channels. SIMT FMA with f32 accumulators, scalar loads with bounds
//     checks, so no width or alignment is assumed. y sits in shared memory
//     where it fits, else in this CTA's slice of a device workspace (grid x
//     h*w*C elements) that the caller allocates. C is a runtime argument.
//     Simple and slow: no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

enum Variant {
  kRefused = -1,
  kStreaming = 0,
  kResident = 1,
  kTiled = 2,
  kF32Plain = 3,
  kGeneral = 4
};

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every cp.async of this thread, committed or not.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// No-swizzle K-major operand: 8-row core matrices of 16 B rows (rows 16 B
// apart), the next 8 rows SBO = 128 B on, the next 8-element K chunk LBO
// bytes on.
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, int lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D[64 x N] += A[64 x 16] * B[16 x N], both from shared-memory
// descriptors, f32 accumulators (N / 2 per thread). B is K-major; A is
// K-major, or MN-major when trans_a (a compile-time constant at each call).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int trans_a);

#define WGMMA_OUT8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int trans_a) {
#define WGMMA_128(TA)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, " \
      "1, " #TA ", 0;\n}\n"                                                  \
      : WGMMA_OUT8(0), WGMMA_OUT8(8), WGMMA_OUT8(16), WGMMA_OUT8(24),       \
        WGMMA_OUT8(32), WGMMA_OUT8(40), WGMMA_OUT8(48), WGMMA_OUT8(56)      \
      : "l"(da), "l"(db), "r"(1))
  if (trans_a)
    WGMMA_128(1);
  else
    WGMMA_128(0);
#undef WGMMA_128
}

template <>
__device__ __forceinline__ void wgmma_ss<120>(float (&d)[60], uint64_t da,
                                              uint64_t db, int) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59}, %60, %61, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT8(0), WGMMA_OUT8(8), WGMMA_OUT8(16), WGMMA_OUT8(24),
        WGMMA_OUT8(32), WGMMA_OUT8(40), WGMMA_OUT8(48), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da,
                                             uint64_t db, int) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, "
      "0;\n}\n"
      : WGMMA_OUT8(0), WGMMA_OUT8(8), WGMMA_OUT8(16)
      : "l"(da), "l"(db), "r"(1));
}
#undef WGMMA_OUT8

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Orders generic-proxy shared stores before later wgmma (async-proxy) reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Halo-buffer row of pixel p of an h x w board: (p / w + 1, p % w + 1).
__device__ __forceinline__ int halo_row(int p, int w) {
  return (p / w + 1) * (w + 2) + p % w + 1;
}

// ---------------------------------------------------------------------------
// resident: bf16, C = 64, persistent CTAs, weights resident, wgmma

namespace resident {

constexpr int C = 64;
constexpr int kTapBytes = C * C * 2;          // 8,192: one [Cout][Cin] tap
constexpr int kWeightBytes = 18 * kTapBytes;  // 147,456: both convs

// Output positions o = r * pitch + c, pitch = w + 1, over h rows: column
// c = w is junk (dropped). Warpgroup g owns positions [g N, g N + N).
// Pixel (r, c) sits in buffer row (r + 1) * pitch + c + 1, so column 0 of
// each row is the zero border left of it and right of the row above, and
// tap (dy, dx) of position o reads row o + (1 + dy) * pitch + 1 + dx.
__host__ __device__ constexpr int positions_per_wg(int h, int w) {
  return h * (w + 1) <= 96 ? 48 : 120;
}

// Rows of one buffer: every row a tap reads plus one junk row (the last)
// that no tap reads, rounded to 1 mod 8 so the 8 channel planes start in
// different banks.
__host__ __device__ constexpr int buffer_rows(int h, int w) {
  return (2 * positions_per_wg(h, w) + 2 * (w + 1) + 2 + 7) / 8 * 8 + 1;
}

__host__ __device__ constexpr int smem_bytes(int h, int w) {
  return kWeightBytes + 2 * buffer_rows(h, w) * C * 2;
}

__host__ __device__ constexpr bool fits(int h, int w) {
  return h * (w + 1) <= 240 && smem_bytes(h, w) <= kSmemLimit;
}

// w1/w2 [9][Cin][Cout] → ws[18][Cout][Cin], each 128 B row's 16 B chunk j
// stored at chunk j ^ (row & 7): the K-major 128-byte-swizzled A operand.
// One thread moves an 8 x 8 block: eight 16 B rows in, transposed in
// registers, eight 16 B rows out.
__device__ void load_weights(const __nv_bfloat16* __restrict__ w1,
                             const __nv_bfloat16* __restrict__ w2,
                             unsigned char* ws) {
  for (int idx = threadIdx.x; idx < 18 * 64; idx += kThreads) {
    const int kb = idx & 7, nb = (idx >> 3) & 7, ct = idx >> 6;
    const __nv_bfloat16* src =
        (ct < 9 ? w1 + ct * C * C : w2 + (ct - 9) * C * C) + kb * 8 * C +
        nb * 8;
    uint4 r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = __ldg(reinterpret_cast<const uint4*>(src + i * C));
    const uint32_t* u = reinterpret_cast<const uint32_t*>(r);
    unsigned char* tile = ws + ct * kTapBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // word q of output row n0 + j: (w[k0 + 2q][n0 + j], w[k0 + 2q + 1][n0 + j])
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = __byte_perm(u[(2 * q) * 4 + j / 2], u[(2 * q + 1) * 4 + j / 2],
                           (j & 1) ? 0x7632 : 0x5410);
      const int n = nb * 8 + j;
      *reinterpret_cast<uint4*>(tile + n * 128 + ((kb ^ j) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Activation buffers are channel-chunk planes: chunk c of row r at byte
// c * plane + r * 16, plane = buffer_rows * 16.
//
// Every address a thread uses is fixed for the whole launch, so it is
// computed once (no division in the sample loop):
//   frag[k]  — the ldmatrix/stmatrix row of fragment pair k (below);
//   piece[k] — piece threadIdx.x + 256 k of a sample, pixel i / 8 and
//              chunk i % 8, or kNone past the sample.
constexpr uint32_t kNone = 0xFFFFFFFFu;

template <int N>
struct Offsets {
  static constexpr int kPairs = (N / 8 + 1) / 2;
  static constexpr int kPieces = (2 * N * 8 + kThreads - 1) / kThreads;
  uint32_t frag[kPairs];
  uint32_t piece[kPieces];

  // Accumulator 4j + 2h + e of warp q of warpgroup g is output channel
  // 16 q + 8 h + gid at position g N + 8 j + 2 tig + e: (j, h) is one 8 x 8
  // fragment, which stmatrix/ldmatrix .trans move to/from 8 buffer rows
  // (positions) of 8 channels (chunk 2 q + h). For pair k this lane
  // addresses row lane % 8 of fragment (2k + lane / 16, lane / 8 % 2);
  // junk positions (column w, past the board, past N / 8 fragments) go to
  // the junk row.
  __device__ void init(int h, int w, int plane) {
    const int lane = threadIdx.x & 31, pitch = w + 1;
    const uint32_t junk = (plane / 16 - 1) * 16;
    const uint32_t chunk =
        (2 * ((threadIdx.x >> 5) & 3) + ((lane >> 3) & 1)) * plane;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int j = 2 * k + (lane >> 4);
      const int o = (threadIdx.x >> 7) * N + 8 * j + (lane & 7);
      const bool live = j < N / 8 && o < h * pitch && o % pitch != w;
      frag[k] = live ? chunk + (o + pitch + 1) * 16 : junk;
    }
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int i = threadIdx.x + k * kThreads, p = i >> 3;
      piece[k] = i < h * w * 8 ? (i & 7) * plane +
                                     ((p / w + 1) * pitch + p % w + 1) * 16
                               : kNone;
    }
  }
};

// Issue one conv's 36 wgmmas (9 taps x 4 k16 steps) for this warpgroup
// onto `acc`: A = the taps at descriptor `da`, B = the shifted positions at
// `db` (the warpgroup's first position, tap (-1, -1)). `side(t)` runs after
// tap t's four wgmmas are issued: work that overlaps the tensor cores (a
// warp that issued all 36 at once would first stall on the full queue).
template <int N, typename Side>
__device__ __forceinline__ void conv_issue(float (&acc)[N / 2], uint64_t da,
                                           uint64_t db, int pitch, int plane,
                                           Side side) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
  const uint32_t kstep = (2 * plane) >> 4;  // B: two channel chunks
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    // opaque to the compiler, so each tap's descriptors are formed here and
    // not all 72 of a conv up front (they took 144 registers and spilled)
    uint64_t a = da + (uint64_t)(t * (kTapBytes >> 4));
    uint64_t b = db + (uint64_t)((((t / 3) * pitch + t % 3) * 16) >> 4);
    asm volatile("" : "+l"(a), "+l"(b));
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss<N>(acc, a + (uint64_t)(kc * 2), b + (uint64_t)(kc * kstep),
                  0);
    side(t);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void conv_wait(float (&acc)[N / 2]) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
}

// Conv 1's epilogue: y = bf16(relu(acc + b1)) into buffer `ya`, and acc
// restarted as b2 + x (x read from buffer `xa`), which conv 2 accumulates
// onto: the residual costs no registers across conv 2 and x's buffer is
// free for the next sample while conv 2 runs.
template <int N>
__device__ __forceinline__ void epilogue_y(float (&acc)[N / 2],
                                           const float (&b1)[2],
                                           const float (&b2)[2], uint32_t ya,
                                           uint32_t xa, const Offsets<N>& off) {
#pragma unroll
  for (int k = 0; k < Offsets<N>::kPairs; ++k) {
    uint32_t v[4], xr[4];
    ldmatrix_x4_trans(xr, xa + off.frag[k]);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 2 * k + (m >> 1), hh = m & 1;
      if (j >= N / 8) {
        v[m] = 0;
        continue;
      }
      float& lo = acc[4 * j + 2 * hh];
      float& hi = acc[4 * j + 2 * hh + 1];
      v[m] = pack_bf16(fmaxf(lo + b1[hh], 0.f), fmaxf(hi + b1[hh], 0.f));
      const float2 xf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xr[m]));
      lo = b2[hh] + xf.x;
      hi = b2[hh] + xf.y;
    }
    stmatrix_x4_trans(ya + off.frag[k], v);
  }
}

// Conv 2's epilogue: out = bf16(relu(acc)) staged in buffer `ya`.
template <int N>
__device__ __forceinline__ void epilogue_out(const float (&acc)[N / 2],
                                             uint32_t ya,
                                             const Offsets<N>& off) {
#pragma unroll
  for (int k = 0; k < Offsets<N>::kPairs; ++k) {
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 2 * k + (m >> 1), hh = m & 1;
      v[m] = j < N / 8 ? pack_bf16(fmaxf(acc[4 * j + 2 * hh], 0.f),
                                   fmaxf(acc[4 * j + 2 * hh + 1], 0.f))
                       : 0;
    }
    stmatrix_x4_trans(ya + off.frag[k], v);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
           const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
           __nv_bfloat16* __restrict__ out, int nb, int h, int w) {
  constexpr int kPieces = Offsets<N>::kPieces;  // at most 8 < 9 taps
  extern __shared__ __align__(1024) unsigned char smem_resident[];
  unsigned char* ws = smem_resident;
  unsigned char* xs = smem_resident + kWeightBytes;
  const int hw = h * w, pitch = w + 1, plane = buffer_rows(h, w) * 16;
  unsigned char* ys = xs + 8 * plane;
  const uint32_t xa = smem_u32(xs), ya = smem_u32(ys);
  if (xa & 1023) __trap();  // the weights' swizzle needs 1024 B alignment

  Offsets<N> off;
  off.init(h, w, plane);
  // piece t of sample s's x, cp.async'd into x's buffer
  auto stage_x = [&](int s, int t) {
    if (t < kPieces && off.piece[t] != kNone)
      cp_async16(xa + off.piece[t],
                 reinterpret_cast<const uint4*>(x + (size_t)s * hw * C) +
                     threadIdx.x + t * kThreads);
  };
  for (int i = threadIdx.x; i < plane; i += kThreads)  // both buffers
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();  // borders zeroed before the interior is written
#pragma unroll
  for (int t = 0; t < kPieces; ++t) stage_x(blockIdx.x, t);
  load_weights(w1, w2, ws);
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();

  // output channels 16 q + gid (+ 8) of this lane
  const int ch = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  const float bias1[2] = {__ldg(b1 + ch), __ldg(b1 + ch + 8)};
  const float bias2[2] = {__ldg(b2 + ch), __ldg(b2 + ch + 8)};
  const uint64_t da1 = sw128_desc(smem_u32(ws));
  const uint64_t da2 = sw128_desc(smem_u32(ws + 9 * kTapBytes));
  const uint32_t pos0 = (threadIdx.x >> 7) * N * 16;  // this warpgroup's
  const uint64_t db1 = plain_desc(xa + pos0, plane);
  const uint64_t db2 = plain_desc(ya + pos0, plane);
  // piece t of the output staged in y's buffer, to sample s
  auto copy_out = [&](int s, int t) {
    if (t < kPieces && off.piece[t] != kNone)
      reinterpret_cast<uint4*>(out + (size_t)s * hw * C)[threadIdx.x +
                                                         t * kThreads] =
          *reinterpret_cast<const uint4*>(ys + off.piece[t]);
  };

  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    // stamp: 0
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    // under conv 1: the previous sample's staged output, piece t after tap t
    conv_issue<N>(acc, da1, db1, pitch, plane, [&](int t) {
      if (b != (int)blockIdx.x) copy_out(b - gridDim.x, t);
    });
    conv_wait<N>(acc);
    __syncthreads();  // the staged output is copied: y may be overwritten
    // stamp: 1
    epilogue_y<N>(acc, bias1, bias2, ya, xa, off);
    fence_async_shared();
    __syncthreads();  // y complete; x read
    // stamp: 2
    // under conv 2: the next sample's x into x's buffer
    const int bn = b + gridDim.x;
    conv_issue<N>(acc, da2, db2, pitch, plane, [&](int t) {
      if (bn < nb) stage_x(bn, t);
    });
    cp_async_commit();
    conv_wait<N>(acc);
    __syncthreads();  // every warpgroup is done reading y: it takes the output
    // stamp: 3
    epilogue_out<N>(acc, ya, off);
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // output staged; next x in place
    // stamp: 4
  }
  const int last = blockIdx.x + (nb - 1 - blockIdx.x) / gridDim.x * gridDim.x;
#pragma unroll
  for (int t = 0; t < kPieces; ++t) copy_out(last, t);
}

}  // namespace resident

// ---------------------------------------------------------------------------
// tiled: f32, C = 64, persistent CTAs, register-blocked SIMT

namespace tiled {

constexpr int C = 64;
constexpr int kRow = C + 4;          // floats per halo row (272 B)
constexpr int kTap = C * C;          // floats per [Cin][Cout] tap
constexpr int kPix = 8;              // pixels per thread, strided by 32

__host__ __device__ constexpr int smem_bytes(int h, int w) {
  return (2 * kTap + 2 * (h + 2) * (w + 2) * kRow) * 4;
}

// cp.async tap s (0..8 conv 1, 9..17 conv 2) into wbuf.
__device__ __forceinline__ void stage_tap(const float* __restrict__ w1,
                                          const float* __restrict__ w2, int s,
                                          uint32_t wbuf) {
  const float* src = s < 9 ? w1 + s * kTap : w2 + (s - 9) * kTap;
  for (int i = threadIdx.x; i < kTap / 4; i += kThreads)
    cp_async16(wbuf + i * 16, src + i * 4);
}

// acc[i][n] += sum over k of src[row_i + off][k] * wt[k][chan(n)], with
// chan(n) = 4 cg + n for n < 4 and 32 + 4 cg + n - 4 above.
__device__ __forceinline__ void tap(float (&acc)[kPix][8], const float* src,
                                    const int (&row)[kPix], int off,
                                    const float* wt, int cg) {
#pragma unroll
  for (int k = 0; k < C; k += 4) {
    float4 a[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      a[i] = *reinterpret_cast<const float4*>(src + (row[i] + off) * kRow + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo =
          *reinterpret_cast<const float4*>(wt + (k + kk) * C + 4 * cg);
      const float4 hi =
          *reinterpret_cast<const float4*>(wt + (k + kk) * C + 32 + 4 * cg);
      const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                       : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(av, wv[n], acc[i][n]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out, int nb,
           int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_tiled[];
  const int hw = h * w, wp = w + 2, halo = (h + 2) * wp;
  float* wbuf = reinterpret_cast<float*>(smem_tiled);  // [2][Cin][Cout]
  float* xs = wbuf + 2 * kTap;                   // [halo][kRow]
  float* ys = xs + halo * kRow;
  for (int i = threadIdx.x; i < 2 * halo * kRow / 4; i += kThreads)
    reinterpret_cast<float4*>(xs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  int row[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = pg + 32 * i;
    row[i] = p < hw ? halo_row(p, w) : wp + 1;
  }
  const float4 bias1[2] = {*reinterpret_cast<const float4*>(b1 + 4 * cg),
                           *reinterpret_cast<const float4*>(b1 + 32 + 4 * cg)};
  const float4 bias2[2] = {*reinterpret_cast<const float4*>(b2 + 4 * cg),
                           *reinterpret_cast<const float4*>(b2 + 32 + 4 * cg)};

  stage_tap(w1, w2, 0, smem_u32(wbuf));
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const float* xb = x + (size_t)b * hw * C;
    for (int i = threadIdx.x; i < hw * (C / 4); i += kThreads) {
      const int p = i >> 4, c = i & 15;
      cp_async16(smem_u32(xs + halo_row(p, w) * kRow + c * 4), xb + p * C + c * 4);
    }
    cp_async_commit();
    float acc[kPix][8];
    for (int s = 0; s < 18; ++s) {
      cp_async_wait_all();
      __syncthreads();  // tap s (and x) landed; every thread is past tap s-1
      if (s < 17 || b + (int)gridDim.x < nb)
        stage_tap(w1, w2, (s + 1) % 18, smem_u32(wbuf + ((s + 1) & 1) * kTap));
      cp_async_commit();
      if (s == 0 || s == 9) {
#pragma unroll
        for (int i = 0; i < kPix; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = 0.f;
      }
      const int t = s % 9;
      tap(acc, s < 9 ? xs : ys, row, (t / 3 - 1) * wp + (t % 3 - 1),
          wbuf + (s & 1) * kTap, cg);
      if (s == 8) {  // y = relu(acc + b1); the barrier of tap 9 publishes it
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          if (pg + 32 * i >= hw) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 bv = bias1[half];
            *reinterpret_cast<float4*>(ys + row[i] * kRow + half * 32 + 4 * cg) =
                make_float4(fmaxf(acc[i][4 * half] + bv.x, 0.f),
                            fmaxf(acc[i][4 * half + 1] + bv.y, 0.f),
                            fmaxf(acc[i][4 * half + 2] + bv.z, 0.f),
                            fmaxf(acc[i][4 * half + 3] + bv.w, 0.f));
          }
        }
      }
    }
    float* ob = out + (size_t)b * hw * C;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = pg + 32 * i;
      if (p >= hw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = half * 32 + 4 * cg;
        const float4 bv = bias2[half];
        const float4 xr = *reinterpret_cast<const float4*>(xs + row[i] * kRow + col);
        *reinterpret_cast<float4*>(ob + p * C + col) =
            make_float4(fmaxf(acc[i][4 * half] + bv.x + xr.x, 0.f),
                        fmaxf(acc[i][4 * half + 1] + bv.y + xr.y, 0.f),
                        fmaxf(acc[i][4 * half + 2] + bv.z + xr.z, 0.f),
                        fmaxf(acc[i][4 * half + 3] + bv.w + xr.w, 0.f));
      }
    }
    __syncthreads();  // residual reads of xs done before the next x lands
  }
  cp_async_wait_all();
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// streaming: bf16 at every other shape (19x19 with C = 96 or 128): taps
// streamed through a cp.async ring, one activation buffer per CTA

namespace streaming {

constexpr int kWarpgroups = 3;
constexpr int kThreadsS = 128 * kWarpgroups;
constexpr int N = 128;     // positions per warpgroup: 384 >= 19 x 20
constexpr int kStages = 3;  // weight taps in flight

// One buffer: the board grid of the resident kernel (h x (w + 1)
// positions, column w junk) in C / 8 channel-chunk planes, every row a tap
// reads plus a junk row, rounded to 1 mod 8.
__host__ __device__ constexpr int buffer_rows(int w) {
  return (kWarpgroups * N + 2 * (w + 1) + 2 + 7) / 8 * 8 + 1;
}

__host__ __device__ constexpr int smem_bytes(int w, int c) {
  return kStages * c * c * 2 + c / 8 * buffer_rows(w) * 16;
}

__host__ __device__ constexpr bool fits(int h, int w, int c) {
  return h * (w + 1) <= kWarpgroups * N && smem_bytes(w, c) <= kSmemLimit;
}

// The weights are the A operand in the MN-major layout (transposed A), so
// a [Cin][Cout] tap needs no transpose: the 16 B piece (cin, Cout chunk j)
// goes to row cin of plane j (plane = C * 16 B). Groups of 8 threads take 8
// consecutive cin of one chunk: 128 B of shared memory, 16 B pieces of
// 64 B global runs.
template <int C>
__device__ __forceinline__ void stage_tap(const __nv_bfloat16* __restrict__ w,
                                          uint32_t stage) {
  for (int i = threadIdx.x; i < C * C / 8; i += kThreadsS) {
    const int g = i >> 3, j = g % (C / 8), cin = (g / (C / 8)) * 8 + (i & 7);
    cp_async16(stage + j * C * 16 + cin * 16, w + cin * C + j * 8);
  }
}

// MN-major no-swizzle A: 8 rows (K) of 16 B (8 M elements) per core
// matrix, K groups LBO = 128 B apart, M chunks SBO = `plane` apart.
__device__ __forceinline__ uint64_t mn_desc(uint32_t saddr, int plane) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(plane >> 4) << 32);
}

template <int C>
struct Shape {
  // M-tiles over the output channels: 64..127 at C = 128; at C = 96 the
  // second tile is channels 32..95 and keeps only 64..95 (its warps 0-1
  // duplicate the first tile's rows and store nothing)
  static constexpr int kTiles = C > 64 ? 2 : 1;
  static constexpr int kTile1 = C - 64;   // first channel of tile 1
  static constexpr int kPieces = C / 8;   // 16 B pieces per pixel
};

// Pixel p's buffer row and the byte offset of piece i (pixel i / (C / 8),
// chunk i % (C / 8)); r = p / w by a multiply-high with magic = 2^32 / w + 1.
template <int C>
__device__ __forceinline__ uint32_t piece_offset(int i, int pitch,
                                                 uint32_t magic, int plane) {
  const int p = i / Shape<C>::kPieces, c = i % Shape<C>::kPieces;
  const int r = __umulhi((uint32_t)p, magic);
  return c * plane + (p + r + pitch + 1) * 16;
}

// All pieces of sample x's activations into the buffer by cp.async.
template <int C>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ xb,
                                        uint32_t buf, int hw, int pitch,
                                        uint32_t magic, int plane) {
  const uint4* src = reinterpret_cast<const uint4*>(xb);
  for (int i = threadIdx.x; i < hw * Shape<C>::kPieces; i += kThreadsS)
    cp_async16(buf + piece_offset<C>(i, pitch, magic, plane), src + i);
}

// acc (tile m, 4j + 2h + e) of warp q of warpgroup g: channel tile0(m) +
// 16 q + 8 h + gid, position g N + 8 j + 2 tig + e. Fragment pair k (j =
// 2k, 2k + 1) moves by ldmatrix/stmatrix .trans through the rows of chunk
// plane tile0(m) / 8 + 2 q + (lane / 8) % 2 that this lane addresses: row
// lane % 8 of fragment 2k + lane / 16, junk positions to the junk row (the
// last). With kResidual, the stored value is relu(acc + b + x) with x read
// first from the same rows (each warp reads and writes only its own
// fragments: in place). Rows and biases are formed here, not held in
// registers across the taps.
template <int C, bool kResidual>
__device__ __forceinline__ void epilogue(
    const float (&acc)[Shape<C>::kTiles][N / 2],
    const float* __restrict__ bias, uint32_t buf, int h, int w, int plane) {
  const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3;
  const int hsel = (lane >> 3) & 1, pitch = w + 1;
  uint32_t row[N / 16];
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    const int o = (threadIdx.x >> 7) * N + 8 * (2 * k + (lane >> 4)) +
                  (lane & 7);
    const bool live = o < h * pitch && o % pitch != w;
    row[k] = (live ? o + pitch + 1 : plane / 16 - 1) * 16;
  }
#pragma unroll
  for (int m = 0; m < Shape<C>::kTiles; ++m) {
    if (m == 1 && Shape<C>::kTile1 < 64 && 16 * q < 64 - Shape<C>::kTile1)
      continue;  // C = 96: channels 32..63 belong to tile 0
    const int c0 = (m ? Shape<C>::kTile1 : 0) + 16 * q + (lane >> 2);
    const float bv[2] = {__ldg(bias + c0), __ldg(bias + c0 + 8)};
    const uint32_t chunk =
        buf + ((m ? Shape<C>::kTile1 : 0) / 8 + 2 * q + hsel) * plane;
#pragma unroll
    for (int k = 0; k < N / 16; ++k) {
      uint32_t v[4], xr[4];
      if (kResidual) ldmatrix_x4_trans(xr, chunk + row[k]);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = 2 * k + (f >> 1), hh = f & 1;
        float lo = acc[m][4 * j + 2 * hh] + bv[hh];
        float hi = acc[m][4 * j + 2 * hh + 1] + bv[hh];
        if (kResidual) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xr[f]));
          lo += xf.x;
          hi += xf.y;
        }
        v[f] = pack_bf16(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
      }
      stmatrix_x4_trans(chunk + row[k], v);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreadsS, 1)
    bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w1,
                const float* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2,
                const float* __restrict__ b2,
                __nv_bfloat16* __restrict__ out, int nb, int h, int w) {
  using S = Shape<C>;
  constexpr int kTap = C * C * 2;
  extern __shared__ __align__(128) unsigned char smem_streaming[];
  const uint32_t stages = smem_u32(smem_streaming);
  const uint32_t buf = stages + kStages * kTap;
  const int hw = h * w, pitch = w + 1, rows = buffer_rows(w);
  const int plane = rows * 16;
  const uint32_t magic = 0xFFFFFFFFu / w + 1;
  for (int i = threadIdx.x; i < S::kPieces * plane / 16; i += kThreadsS)
    reinterpret_cast<uint4*>(smem_streaming + kStages * kTap)[i] =
        make_uint4(0, 0, 0, 0);
  const uint64_t db = plain_desc(buf + (threadIdx.x >> 7) * N * 16, plane);
  const uint32_t kstep_b = (2 * plane) >> 4;
  __syncthreads();  // buffer zeroed before the first x lands

  // the tap stream: use u reads stage u % 3 and holds tap u % 18 (conv 1
  // for 0..8, conv 2 for 9..17); its load is issued one use ahead
  auto load_tap = [&](int u) {
    const int t = u % 18;
    stage_tap<C>((t < 9 ? w1 : w2) + (t % 9) * C * C,
                 stages + (u % kStages) * kTap);
  };
  stage_x<C>(x + (size_t)blockIdx.x * hw * C, buf, hw, pitch, magic, plane);
  load_tap(0);
  cp_async_commit();
  int u = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const bool more = b + (int)gridDim.x < nb;
    float acc[S::kTiles][N / 2];
    // tap use u: wait for its stage, free stage (u + 1) % 3 and fill it
    // with the next use's tap, then issue this tap's wgmmas (a load issued
    // behind the wgmmas lands later: slower on the card). Nothing in it
    // touches acc, so the wgmmas of consecutive taps overlap.
    auto tap = [&](int s) {
      cp_async_wait_all();  // tap u (and, at s = 0, x) landed
      wgmma_wait<1>();      // this warpgroup's use u - 2 is done
      fence_async_shared();
      // ablate: barrier
      __syncthreads();      // for every warpgroup: stage (u + 1) % 3 free
      // stamp: s
      // ablate: loads
      if (s < 17 || more) load_tap(u + 1);
      cp_async_commit();
      const int t = s % 9;
      uint64_t a = mn_desc(stages + (u % kStages) * kTap, C * 16);
      uint64_t bd = db + (uint64_t)((((t / 3) * pitch + t % 3) * 16) >> 4);
      asm volatile("" : "+l"(a), "+l"(bd));
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc)
#pragma unroll
        for (int m = 0; m < S::kTiles; ++m)
          wgmma_ss<N>(acc[m],
                      a + (uint64_t)(((m ? S::kTile1 / 8 : 0) * C * 16 +
                                      kc * 256) >> 4),
                      bd + (uint64_t)(kc * kstep_b), 1);
      wgmma_commit();
    };
    auto zero = [&]() {
#pragma unroll
      for (int m = 0; m < S::kTiles; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          acc[m][i] = 0.f;
          fence_operand(acc[m][i]);
        }
    };
    auto drain = [&]() {  // every warpgroup's wgmmas done, acc readable
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < S::kTiles; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_operand(acc[m][i]);
      __syncthreads();
    };
    zero();
    for (int s = 0; s < 9; ++s, ++u) tap(s);
    drain();
    epilogue<C, false>(acc, b1, buf, h, w, plane);  // y over x, in place
    fence_async_shared();  // the barrier of tap 9 publishes y
    zero();
    for (int s = 9; s < 18; ++s, ++u) tap(s);
    drain();
    // stamp: 18
    // x again for the residual (from L2), then out over it, in place
    stage_x<C>(x + (size_t)b * hw * C, buf, hw, pitch, magic, plane);
    cp_async_wait_all();
    __syncthreads();
    // stamp: 19
    epilogue<C, true>(acc, b2, buf, h, w, plane);
    __syncthreads();
    // stamp: 20
    uint4* ob = reinterpret_cast<uint4*>(out + (size_t)b * hw * C);
    for (int i = threadIdx.x; i < hw * S::kPieces; i += kThreadsS)
      ob[i] = *reinterpret_cast<const uint4*>(
          smem_streaming + kStages * kTap +
          piece_offset<C>(i, pitch, magic, plane));
    __syncthreads();  // copied out: the next x may land
    // stamp: 21
    if (more)
      stage_x<C>(x + (size_t)(b + gridDim.x) * hw * C, buf, hw, pitch, magic,
                 plane);
  }
  cp_async_wait_all();
}

}  // namespace streaming

// ---------------------------------------------------------------------------
// f32 plain: every f32 shape the tiled kernel does not take

namespace f32_plain {

// Source pixel of output pixel p under tap (dy, dx), or -1 when p is past
// the sample or the shifted pixel lies off the board.
__device__ __forceinline__ int shifted_pixel(int p, int dy, int dx, int h,
                                             int w) {
  if (p >= h * w) return -1;
  int r = p / w + dy;
  int c = p - (p / w) * w + dx;
  if (r < 0 || r >= h || c < 0 || c >= w) return -1;
  return r * w + c;
}

// f32: thread item = (8 consecutive pixels, one output channel).
constexpr int kPix = 8;

template <int C, bool kSecond>
__device__ void conv_f32(const float* src, const float* __restrict__ wg,
                         const float* __restrict__ bias, float* dst_smem,
                         const float* __restrict__ res,
                         float* __restrict__ dst_global, int h, int w) {
  const int hw = h * w;
  const int groups = (hw + kPix - 1) / kPix;
  for (int item = threadIdx.x; item < groups * C; item += kThreads) {
    const int g = item / C;
    const int n = item - g * C;
    float acc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) acc[j] = 0.f;
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3 - 1;
      const int dx = t % 3 - 1;
      int q[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        q[j] = shifted_pixel(g * kPix + j, dy, dx, h, w);
      const float* wt = wg + (size_t)t * C * C + n;
      for (int k = 0; k < C; ++k) {
        const float wv = wt[k * C];
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (q[j] >= 0) acc[j] = fmaf(src[q[j] * C + k], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = g * kPix + j;
      if (p >= hw) continue;
      float v = acc[j] + bias[n];
      if (kSecond) {
        v += res[p * C + n];
        dst_global[p * C + n] = fmaxf(v, 0.f);
      } else {
        dst_smem[p * C + n] = fmaxf(v, 0.f);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int h,
               int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);
  const size_t base = (size_t)blockIdx.x * h * w * C;
  conv_f32<C, false>(x + base, w1, b1, ys, nullptr, nullptr, h, w);
  __syncthreads();
  conv_f32<C, true>(ys, w2, b2, nullptr, x + base, out + base, h, w);
}

}  // namespace f32_plain

// ---------------------------------------------------------------------------
// general: bf16 or f32, any C >= 1 and any board, SIMT implicit GEMM

namespace general {

constexpr int BM = 64;        // pixels per output tile
constexpr int BN = 64;        // output channels per output tile
constexpr int BK = 16;        // input channels of one tap per K step
constexpr int kRowA = BM + 4;  // floats per staged A row (2-way conflicts)
constexpr int kStageFloats = BK * kRowA + BK * BN;
constexpr int kStageBytes = 2 * kStageFloats * 4;  // 16,896: double buffer

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr long long y_bytes(int h, int w, int c,
                                                int elem) {
  return ((long long)h * w * c * elem + 15) / 16 * 16;
}

// y of one sample in shared memory beside the staging buffers, or not
__host__ __device__ constexpr bool y_in_smem(int h, int w, int c, int elem) {
  return kStageBytes + y_bytes(h, w, c, elem) <= kSmemLimit;
}

__host__ __device__ constexpr int smem_bytes(int h, int w, int c, int elem) {
  return kStageBytes +
         (y_in_smem(h, w, c, elem) ? (int)y_bytes(h, w, c, elem) : 0);
}

// One 3x3 'same' conv of one sample, src [h*w][c] -> dst [h*w][c]:
// dst = T(relu(conv(src) + bias (+ res))). `src` may be shared or device
// memory written earlier in this launch, so it is read by plain loads. K
// step s is tap s / kc, input channels (s % kc) * BK + [0, BK). Loader
// roles: A element (pixel tid / 16 + 16 j, channel tid % 16), B element
// (input channel tid / 64 + 4 j, output channel tid % 64), j < 4.
template <typename T, bool kResidual>
__device__ void conv(const T* src, const T* __restrict__ wt,
                     const float* __restrict__ bias,
                     const T* __restrict__ res, T* dst, int h, int w, int c,
                     float* stage) {
  const int tid = threadIdx.x, hw = h * w;
  const int tm = tid >> 4, tn = tid & 15;  // compute: 4 pixels x 4 channels
  const int kc = (c + BK - 1) / BK, steps = 9 * kc;
  for (int m0 = 0; m0 < hw; m0 += BM) {
    int pr[4], pc[4];  // this thread's A pixels (row, column), pr < 0: none
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = m0 + (tid >> 4) + 16 * j;
      pr[j] = p < hw ? p / w : -h - 2;
      pc[j] = p < hw ? p - (p / w) * w : 0;
    }
    for (int n0 = 0; n0 < c; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][n] = 0.f;
      float ra[4], rb[4];
      auto load = [&](int s) {
        const int t = s / kc, k0 = (s - t * kc) * BK;
        const int dy = t / 3 - 1, dx = t % 3 - 1;
        const int ci = k0 + (tid & 15);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = pr[j] + dy, q = pc[j] + dx;
          const bool ok = ci < c && r >= 0 && r < h && q >= 0 && q < w;
          ra[j] = ok ? widen(src[((size_t)r * w + q) * c + ci]) : 0.f;
        }
        const int n = n0 + (tid & 63);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + (tid >> 6) + 4 * j;
          rb[j] = k < c && n < c ? widen(wt[((size_t)t * c + k) * c + n])
                                 : 0.f;
        }
      };
      auto store = [&](int buf) {
        float* as = stage + buf * kStageFloats;
        float* bs = as + BK * kRowA;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          as[(tid & 15) * kRowA + (tid >> 4) + 16 * j] = ra[j];
          bs[((tid >> 6) + 4 * j) * BN + (tid & 63)] = rb[j];
        }
      };
      load(0);
      store(0);
      __syncthreads();
      for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) load(s + 1);  // in flight under this step's FMAs
        const float* as = stage + (s & 1) * kStageFloats;
        const float* bs = as + BK * kRowA;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a =
              *reinterpret_cast<const float4*>(as + kk * kRowA + 4 * tm);
          const float4 b =
              *reinterpret_cast<const float4*>(bs + kk * BN + 4 * tn);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
        }
        // the other buffer was last read in step s - 1, before the barrier
        if (s + 1 < steps) store((s + 1) & 1);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + 4 * tm + i;
        if (p >= hw) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int ch = n0 + 4 * tn + n;
          if (ch >= c) continue;
          float v = acc[i][n] + __ldg(bias + ch);
          if (kResidual) v += widen(res[(size_t)p * c + ch]);
          dst[(size_t)p * c + ch] = narrow<T>(fmaxf(v, 0.f));
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, T* __restrict__ out, T* workspace,
           int nb, int h, int w, int c) {
  extern __shared__ __align__(16) unsigned char smem_general[];
  float* stage = reinterpret_cast<float*>(smem_general);
  const size_t sample = (size_t)h * w * c;
  T* ys = y_in_smem(h, w, c, sizeof(T))
              ? reinterpret_cast<T*>(smem_general + kStageBytes)
              : workspace + blockIdx.x * sample;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const T* xb = x + b * sample;
    conv<T, false>(xb, w1, b1, nullptr, ys, h, w, c, stage);
    __syncthreads();  // y complete before conv 2 reads it
    conv<T, true>(ys, w2, b2, xb, out + b * sample, h, w, c, stage);
    __syncthreads();  // y read before the next sample's conv 1 writes it
  }
}

}  // namespace general

// ---------------------------------------------------------------------------
// host side

int resblock_variant(int dtype, int h, int w, int c) {
  if ((dtype != 0 && dtype != 1) || h < 1 || w < 1 || c < 1) return kRefused;
  const bool fast = c == 64 || c == 96 || c == 128;  // instantiated widths
  if (dtype == 1) {
    if (c == 64 && resident::fits(h, w)) return kResident;
    if (fast && streaming::fits(h, w, c)) return kStreaming;
    return kGeneral;
  }
  if (c == 64 && h * w <= 256 && tiled::smem_bytes(h, w) <= kSmemLimit)
    return kTiled;
  if (fast && h * w * c * 4 <= kSmemLimit) return kF32Plain;
  return kGeneral;
}

int persistent_grid(int b) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return b < sms ? b : sms;
}

// Bytes of device workspace the general variant needs for a batch of b:
// y of one sample per CTA where it does not fit in shared memory, else 0.
long long workspace_bytes(int dtype, int b, int h, int w, int c) {
  if (b < 1 || resblock_variant(dtype, h, w, c) != kGeneral) return 0;
  const int elem = dtype == 1 ? 2 : 4;
  if (general::y_in_smem(h, w, c, elem)) return 0;
  return (long long)persistent_grid(b) * h * w * c * elem;
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, int grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_per_channels(int variant, const void* x, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* out, int b, int h,
                                int w, cudaStream_t s) {
  if (variant == kStreaming)
    return launch(streaming::bf16_kernel<C>, persistent_grid(b),
                  streaming::kThreadsS, streaming::smem_bytes(w, C), s,
                  static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w1),
                  static_cast<const float*>(b1),
                  static_cast<const __nv_bfloat16*>(w2),
                  static_cast<const float*>(b2),
                  static_cast<__nv_bfloat16*>(out), b, h, w);
  return launch(f32_plain::f32_kernel<C>, b, kThreads, h * w * C * 4, s,
                static_cast<const float*>(x), static_cast<const float*>(w1),
                static_cast<const float*>(b1), static_cast<const float*>(w2),
                static_cast<const float*>(b2), static_cast<float*>(out), h,
                w);
}

}  // namespace

// Which kernel alphafive_resblock runs for this shape: 0 streaming (bf16),
// 1 resident (bf16), 2 tiled (f32), 3 f32 plain, 4 general (either type,
// any C >= 1 and board), -1 refused (a dtype other than 0 or 1, or a
// dimension below 1).
extern "C" int alphafive_resblock_variant(int dtype, int h, int w, int c) {
  return resblock_variant(dtype, h, w, c);
}

// Bytes of device workspace alphafive_resblock needs for this batch and
// shape (0 for every variant but general where y does not fit in shared
// memory); the caller allocates it and passes it as `workspace`.
extern "C" long long alphafive_resblock_workspace(int dtype, int b, int h,
                                                  int w, int c) {
  return workspace_bytes(dtype, b, h, w, c);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller has checked shapes, types, contiguity and alignment, and
// passes alphafive_resblock_workspace bytes at `workspace` (may be null
// when that is 0). Launches on `stream` and does not synchronise.
extern "C" int alphafive_resblock(int dtype, const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* workspace,
                                  int b, int h, int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return cudaSuccess;
  const int variant = resblock_variant(dtype, h, w, c);
  switch (variant) {
    case kResident: {
      const auto* xb = static_cast<const __nv_bfloat16*>(x);
      const auto* w1b = static_cast<const __nv_bfloat16*>(w1);
      const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
      const auto* b1f = static_cast<const float*>(b1);
      const auto* b2f = static_cast<const float*>(b2);
      auto* ob = static_cast<__nv_bfloat16*>(out);
      const int grid = persistent_grid(b);
      const int smem = resident::smem_bytes(h, w);
      if (resident::positions_per_wg(h, w) == 48)
        return launch(resident::kernel<48>, grid, kThreads, smem, s, xb, w1b,
                      b1f, w2b, b2f, ob, b, h, w);
      return launch(resident::kernel<120>, grid, kThreads, smem, s, xb, w1b,
                    b1f, w2b, b2f, ob, b, h, w);
    }
    case kTiled:
      return launch(tiled::kernel, persistent_grid(b), kThreads,
                    tiled::smem_bytes(h, w), s, static_cast<const float*>(x),
                    static_cast<const float*>(w1),
                    static_cast<const float*>(b1),
                    static_cast<const float*>(w2),
                    static_cast<const float*>(b2), static_cast<float*>(out),
                    b, h, w);
    case kGeneral: {
      if (workspace_bytes(dtype, b, h, w, c) > 0 && workspace == nullptr)
        return cudaErrorInvalidValue;
      const int grid = persistent_grid(b);
      const auto* b1f = static_cast<const float*>(b1);
      const auto* b2f = static_cast<const float*>(b2);
      if (dtype == 1) {
        using T = __nv_bfloat16;
        return launch(general::kernel<T>, grid, kThreads,
                      general::smem_bytes(h, w, c, 2), s,
                      static_cast<const T*>(x), static_cast<const T*>(w1), b1f,
                      static_cast<const T*>(w2), b2f, static_cast<T*>(out),
                      static_cast<T*>(workspace), b, h, w, c);
      }
      return launch(general::kernel<float>, grid, kThreads,
                    general::smem_bytes(h, w, c, 4), s,
                    static_cast<const float*>(x),
                    static_cast<const float*>(w1), b1f,
                    static_cast<const float*>(w2), b2f,
                    static_cast<float*>(out), static_cast<float*>(workspace),
                    b, h, w, c);
    }
    case kStreaming:
    case kF32Plain:
      switch (c) {
        case 64:
          return launch_per_channels<64>(variant, x, w1, b1, w2, b2, out, b,
                                         h, w, s);
        case 96:
          return launch_per_channels<96>(variant, x, w1, b1, w2, b2, out, b,
                                         h, w, s);
        case 128:
          return launch_per_channels<128>(variant, x, w1, b1, w2, b2, out, b,
                                          h, w, s);
      }
  }
  return cudaErrorInvalidValue;
}
