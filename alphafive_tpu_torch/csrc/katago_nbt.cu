// KataGo nested-bottleneck kernels for Hopper (sm_90a): the convolutions of
// KataGo's b18c384nbt trunk (ops/katago_nbt.py, models/katago_nbt.py).
//
// Replaces no TPU kernel: the JAX package runs only the post-activation
// resnet. These kernels were added for the nested-bottleneck net, whose
// blocks csrc/resblock.cu does not compute (a pre-activation pair: an
// affine + ReLU on the conv's input, zero padding of the activated input,
// no ReLU after the sum; global pooling between two convs; 1x1
// bottlenecks). Activations are NHWC bf16, i.e. rows [B*H*W, C]; weights
// are packed [Cout][k*k*Cin] with k index (tap, ci), tap = ky * k + kx.
//
// Every convolution here is an implicit GEMM, M = the positions, N = the
// output channels, K = k*k taps x Cin, with
//   * a prologue on the A operand: A(v) = max(v * scale[c] + shift[s, c],
//     0), shift per channel or per sample (the pooling pair's second conv
//     takes its pooled bias there); taps off the board read zeros of the
//     activated input, never A(0);
//   * an epilogue: v * scale[n] + shift[n], ReLU from channel relu_from
//     on, + a residual in f32, rounded to bf16.
// The three entry points of ops/katago_nbt.py are launches of them:
//   preact_pair  conv1 (prologue A_1, epilogue A_2) and conv2 (+ h);
//   gpool_pair   conv1 to [r | g] (epilogue A_g on g alone), pool_kernel
//                (the board's mean, scaled mean and max of g, the dense
//                layer, folded with A_2 into a per-sample shift), conv2
//                (prologue A_2 with that shift, + h);
//   conv1x1      the bottleneck 1x1s (prologue A_p / A_q, + x for W_q).
// ops/katago_nbt.py::conv_variant picks a mainloop by shape and names it
// to alphafive_nbt_conv, which refuses one the shape does not fit
// (wg::takes): the 3x3s with 128 or 192 input channels and 192 output
// channels on boards up to wg::kMaxWidth (110) wide run
// wg::conv3x3 on wgmma; every other shape (the 1x1s, 64 output channels,
// wider boards) runs nbt::conv_kernel on mma.sync.
//
// What bounds them: at the Renju self-play leaf forward, 4,096 x 19x19, a
// 3x3 conv 192 -> 192 is 0.98 TFLOP against ~1.1 GB of activations in and
// out: the tensor cores (0.99 ms at 989 TFLOP/s). The 1x1s 384 <-> 192 are
// 0.22 TFLOP against 1.7 GB: 64 FLOP a byte, under the card's ~295, so HBM
// bounds them (0.51 ms).
//
// nbt::conv_kernel<KS, BN> (the 1x1s, cout 64): tiles of 128 positions x
// 192 (or 64) channels, K steps of 64 channels of one tap, 8 warps of 64 x
// 48 each on mma.sync m16n8k16 from ldmatrix, f32 accumulators. A and B
// move by cp.async into a 4-stage ring (3 steps in flight while one
// multiplies; A's off-board rows are 16 zero bytes); each thread applies
// the prologue to its own A rows of a step once they have landed, before
// the step's one block barrier. Rows of 144 B, so that ldmatrix's eight
// rows hit eight bank groups. Why a ring: at one CTA an SM (203-224
// registers a thread), loads started one step ahead leave their latency
// exposed (164 TFLOP/s a 3x3 pair at 4,096 x 19x19, against ~220 with the
// ring). The epilogue stages the f32 tile in shared memory, so that the
// residual is read and the output written 16 B a thread, coalesced. As
// the 3x3s' mainloop it read ~24% of the tensor cores' bound: one block
// barrier and mma.sync a K step, and the operands gathered anew for every
// tap (below).
//
// wg::conv3x3<kChunks> (the 3x3s): a tile is kBM = 192 rows of one
// sample's board grid, h x (w + 1) positions whose column w is a zero
// border (left of one row, right of the row above), x kBN = 192 output
// channels. Tap (dy, dx) of grid row o reads grid row o + dy (w + 1) + dx,
// so every tap of the tile reads one run of a slab of kBM + 2 (w + 1) + 2
// rows at a shifted start. Per chunk of 64 input channels:
//   * the slab lands once (cp.async, 16 zero bytes where a row is off the
//     board: the border column, above or below the board), in rows of
//     128 B, 128-byte swizzled as TMA would write them, and the prologue
//     runs once per element as it lands; a generic-to-async proxy fence,
//     then the slab's `full` mbarrier;
//   * the 9 taps are 9 swizzled K-major descriptors into that slab at
//     shifted rows (the swizzle follows the address, so any row may
//     start one): no copies, no bounds checks, no prologue per tap. On an
//     H100 this read 4-9% faster than no-swizzle channel-chunk planes;
//   * each tap's weights (192 x 64, 24 KB) arrive by one TMA copy,
//     128-byte swizzled, into a kStages ring of full/empty mbarriers.
// Warp-specialised: three consumer warpgroups each own 64 rows x 192
// channels (96 f32 accumulators a thread, wgmma.mma_async m64n192k16 with
// A and B from shared memory, one commit group a tap, a stage released
// once the next tap's group is issued and the previous one done); a
// producer warpgroup (setmaxnreg down to kProducerRegs, the consumers up
// to kConsumerRegs) whose warp 0 issues the weight copies and whose warps
// 1-3 land the slabs (2 buffers: chunk k + 1 lands while chunk k
// multiplies). Persistent CTAs, one an SM, tiles k, k + grid, ...; the
// epilogue goes from the accumulators to device memory (the affine from
// shared memory, a row's residual loaded before its first store, + the
// residual in f32, bf16) while the producers fill the next tile's stages.
// A pair's intermediate y goes through device memory, as with conv_kernel
// (not fused as resblock.cu's pair is).
//
// The reckoning at 4,096 x 19x19, cin = cout = 192: 2 tiles a sample
// (380 grid rows in 384), 8,192 tiles, 1.044 TFLOP executed for the 0.981
// needed (6.4% on the border column and the last tile's tail).
//   * A: a tile's slab is 234 rows x 384 B = 90 KB, so 0.74 GB of reads a
//     conv (1.30x the 0.57 GB of activations), against 9 x 0.57 = 5.1 GB
//     when every tap gathered its rows anew (conv_kernel).
//   * weights: 27 stages of 24 KB = 648 KB a tile, 5.44 GB a conv from L2
//     against 7.7 GB for conv_kernel's tiles of 128. Multicasting each
//     stage over a cluster of 2 CTAs halves that (2.72 GB) but read slower
//     on an H100 (5.33 against 3.71 ms a pair; clusters of 4 slower
//     still; there a stage is refilled only once every CTA of the cluster
//     has released it), so each CTA copies its own.
//   * 6.2 GB of L2 reads for 0.98 TFLOP: ~160 FLOP a byte (conv_kernel
//     ~77). Shared memory per 64 x 192 x 16 product: 2 KB of A and 6 KB of
//     B read by wgmma, ~85 B a cycle at the tensor cores' rate, under the
//     128 the SM serves.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {
namespace nbt {

constexpr int kThreads = 256;
constexpr int BM = 128;        // positions a tile
constexpr int BK = 64;         // input channels a K step
constexpr int kRow = BK + 8;   // bf16 a shared-memory row (144 B)
constexpr int kStages = 4;     // the cp.async ring

struct Conv {
  const __nv_bfloat16* x;      // [m][ldx], channels 0..cin-1 read
  const __nv_bfloat16* w;      // [cout][ks * ks * cin]
  const float* pro_scale;      // [cin] or null: no prologue
  const float* pro_shift;      // [cin], or [samples][shift_stride]
  const float* epi_scale;      // [cout] or null: no affine epilogue
  const float* epi_shift;      // [cout]
  const __nv_bfloat16* res;    // [m][cout] or null
  __nv_bfloat16* out;          // [m][cout]
  int ldx, shift_stride, relu_from;
  int m, hw, h, bw, cin, cout;   // bw: the board's width
};

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

// 16 B, or 16 zero bytes (nothing is read) when !full.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KS, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv_kernel(Conv p) {
  constexpr int WN = BN / 4;          // 2 warps along M x 4 along N
  constexpr int NI = WN / 8;          // n8 tiles a warp (6 or 2)
  constexpr int MI = 4;               // m16 tiles a warp (64 rows)
  constexpr int CPR = BK / 8;         // 16 B chunks a row
  constexpr int ACH = BM * CPR / kThreads;   // A chunks a thread (4)
  constexpr int BCH = BN * CPR / kThreads;   // B chunks a thread (6 or 2)
  constexpr int kStageA = BM * kRow, kStageB = BN * kRow;
  static_assert(NI % 2 == 0 && ACH * kThreads == BM * CPR &&
                    BCH * kThreads == BN * CPR && kThreads % CPR == 0,
                "tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [S][BM][kRow]
  __nv_bfloat16* bs = as + kStages * kStageA;                   // [S][BN][kRow]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int ntiles = p.cout / BN;
  const int m0 = (blockIdx.x / ntiles) * BM, n0 = (blockIdx.x % ntiles) * BN;
  const int kdim = KS * KS * p.cin;
  const int csteps = p.cin / BK;
  const int nsteps = KS * KS * csteps;

  // this thread's A rows (tid / CPR + i * kThreads / CPR), 16 B column ac
  const int ac = tid % CPR;
  int arow[ACH], ay[ACH], ax[ACH], asample[ACH];
  bool alive[ACH];
#pragma unroll
  for (int i = 0; i < ACH; ++i) {
    const int m = m0 + tid / CPR + i * (kThreads / CPR);
    alive[i] = m < p.m;
    arow[i] = alive[i] ? m : 0;
    asample[i] = arow[i] / p.hw;
    const int pos = arow[i] - asample[i] * p.hw;
    ay[i] = pos / p.bw;
    ax[i] = pos - ay[i] * p.bw;
  }
  auto valid = [&](int i, int dy, int dx) {
    const int yy = ay[i] + dy, xx = ax[i] + dx;
    return alive[i] && yy >= 0 && yy < p.h && xx >= 0 && xx < p.bw;
  };

  // step (tap, ci0) into stage `st`: A rows by cp.async, 16 zero bytes
  // where the tap is off the board; B by cp.async
  auto load_step = [&](int st, int tap, int ci0) {
    const int dy = KS == 3 ? tap / 3 - 1 : 0, dx = KS == 3 ? tap % 3 - 1 : 0;
    __nv_bfloat16* a = as + st * kStageA;
#pragma unroll
    for (int i = 0; i < ACH; ++i) {
      const bool ok = valid(i, dy, dx);
      const __nv_bfloat16* src =
          ok ? p.x + (long long)(arow[i] + dy * p.bw + dx) * p.ldx + ci0 +
                   ac * 8
             : p.x;
      cp_async16_zfill(
          smem_u32(a + (tid / CPR + i * (kThreads / CPR)) * kRow + ac * 8),
          src, ok);
    }
    __nv_bfloat16* b = bs + st * kStageB;
#pragma unroll
    for (int j = 0; j < BCH; ++j) {
      const int i = tid + kThreads * j;
      const int n = i / CPR, c = i % CPR;
      cp_async16(smem_u32(b + n * kRow + c * 8),
                 p.w + (long long)(n0 + n) * kdim + tap * p.cin + ci0 + c * 8);
    }
  };

  // the prologue on this thread's own landed A rows of stage `st` (the
  // rows off the board stay zero)
  auto prologue = [&](int st, int tap, int ci0) {
    const int dy = KS == 3 ? tap / 3 - 1 : 0, dx = KS == 3 ? tap % 3 - 1 : 0;
    const int c = ci0 + ac * 8;
    const float4* sc = reinterpret_cast<const float4*>(p.pro_scale + c);
    const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    __nv_bfloat16* a = as + st * kStageA;
#pragma unroll
    for (int i = 0; i < ACH; ++i) {
      if (!valid(i, dy, dx)) continue;
      const float4* sh = reinterpret_cast<const float4*>(
          p.pro_shift + (long long)asample[i] * p.shift_stride + c);
      const float4 t0 = __ldg(sh), t1 = __ldg(sh + 1);
      const float t[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      uint4* q = reinterpret_cast<uint4*>(
          a + (tid / CPR + i * (kThreads / CPR)) * kRow + ac * 8);
      uint4 v = *q;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(e[j]);
        f.x = fmaxf(f.x * s[2 * j] + t[2 * j], 0.f);
        f.y = fmaxf(f.y * s[2 * j + 1] + t[2 * j + 1], 0.f);
        e[j] = __floats2bfloat162_rn(f.x, f.y);
      }
      *q = v;
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto compute = [&](int st) {
    const __nv_bfloat16* ab = as + st * kStageA;
    const __nv_bfloat16* bb = bs + st * kStageB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], smem_u32(ab + (wm * 64 + mi * 16 + (lane & 15)) *
                                              kRow +
                                     kk + (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        const int n = wn * WN + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, smem_u32(bb + n * kRow + kk + ((lane >> 3) & 1) * 8));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  };

  // K steps, tap-major, BK channels of one tap each, through a ring of
  // kStages stages: steps s + 1 .. s + kStages - 1 in flight while step s
  // multiplies. One group committed a step (empty past the end), so that
  // wait_group<kStages - 2> always means "step s has landed".
  int itap = 0, icstep = 0;   // the next step to load
  auto advance = [&](int& tap, int& cs) {
    if (++cs == csteps) {
      cs = 0;
      ++tap;
    }
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) {
      load_step(s, itap, icstep * BK);
      advance(itap, icstep);
    }
    cp_async_commit();
  }
  int tap = 0, cstep = 0;     // the step multiplied
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const int st = s % kStages;
    cp_async_wait<kStages - 2>();
    if (p.pro_scale != nullptr) prologue(st, tap, cstep * BK);
    __syncthreads();   // step s visible to all; step s - 1's stage free
    if (s + kStages - 1 < nsteps) {
      load_step((s + kStages - 1) % kStages, itap, icstep * BK);
      advance(itap, icstep);
    }
    cp_async_commit();
    compute(st);
    advance(tap, cstep);
  }

  // epilogue: affine and ReLU from relu_from on the fragments into a
  // f32 tile in shared memory (the ring is free), then each thread takes
  // whole 16 B pieces of a row: + the residual, rounded to bf16, stored
  // coalesced
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kSRow = BN + 4;       // f32 a staged row (bank spread)
  static_assert(BM * kSRow * 4 <= kStages * (BM + BN) * kRow * 2, "stage");
  float* tile = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + mi * 16 + g + half * 8;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = wn * WN + ni * 8 + q * 2, n = n0 + c;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (p.epi_scale != nullptr) {
          v0 = v0 * __ldg(p.epi_scale + n) + __ldg(p.epi_shift + n);
          v1 = v1 * __ldg(p.epi_scale + n + 1) + __ldg(p.epi_shift + n + 1);
        }
        if (n >= p.relu_from) v0 = fmaxf(v0, 0.f);
        if (n + 1 >= p.relu_from) v1 = fmaxf(v1, 0.f);
        *reinterpret_cast<float2*>(tile + r * kSRow + c) = make_float2(v0, v1);
      }
    }
  __syncthreads();
  constexpr int kPieces = BM * BN / 8 / kThreads;   // 16 B outputs a thread
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = tid + kThreads * j;
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int m = m0 + r;
    if (m >= p.m) continue;
    const float4 a = *reinterpret_cast<const float4*>(tile + r * kSRow + c);
    const float4 b = *reinterpret_cast<const float4*>(tile + r * kSRow + c + 4);
    float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const long long o = (long long)m * p.cout + n0 + c;
    if (p.res != nullptr) {
      const uint4 rr = __ldg(reinterpret_cast<const uint4*>(p.res + o));
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&rr);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        v[2 * k] += f.x;
        v[2 * k + 1] += f.y;
      }
    }
    uint4 w;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p.out + o) = w;
  }
}

// One block a sample: the board's mean, scaled mean and max of g's cg
// channels (rows of ldg elements), pooled [3 cg] through the dense layer
// wl [3 cg][cr], folded with A_2: shift[b][n] = s2[n] * (pooled . wl[:, n])
// + t2[n], so that conv 2's prologue max(r * s2 + shift, 0) is A_2(r +
// Dense(pool)). Bound by reading g (0.19 GB at 4,096 x 19x19 x 64).
__global__ void __launch_bounds__(kThreads) pool_kernel(
    const __nv_bfloat16* g, int ldg, int hw, int cg, int cr, float k1,
    const float* wl, const float* s2, const float* t2, float* shift) {
  extern __shared__ float red[];   // sums [4][cg], maxes [4][cg], pooled
  const __nv_bfloat16* gb = g + (long long)blockIdx.x * hw * ldg;
  for (int i = threadIdx.x; i < 4 * cg; i += kThreads) {
    const int c = i % cg, part = i / cg;
    float s = 0.f, mx = -__int_as_float(0x7f800000);  // -inf
    for (int r = part; r < hw; r += 4) {
      const float v = __bfloat162float(gb[(long long)r * ldg + c]);
      s += v;
      mx = fmaxf(mx, v);
    }
    red[i] = s;
    red[4 * cg + i] = mx;
  }
  __syncthreads();
  float* pooled = red + 8 * cg;
  for (int c = threadIdx.x; c < cg; c += kThreads) {
    const float s = (red[c] + red[cg + c]) + (red[2 * cg + c] + red[3 * cg + c]);
    const float mx = fmaxf(fmaxf(red[4 * cg + c], red[5 * cg + c]),
                           fmaxf(red[6 * cg + c], red[7 * cg + c]));
    const float mean = s / hw;
    pooled[c] = mean;
    pooled[cg + c] = mean * k1;
    pooled[2 * cg + c] = mx;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < cr; n += kThreads) {
    float a = 0.f;
    for (int j = 0; j < 3 * cg; ++j) a += pooled[j] * __ldg(wl + j * cr + n);
    shift[(long long)blockIdx.x * cr + n] = s2[n] * a + t2[n];
  }
}

template <int KS, int BN>
cudaError_t launch_conv(const Conv& p, cudaStream_t stream) {
  constexpr int smem = kStages * (BM + BN) * kRow * 2;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<KS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const long long blocks = (long long)((p.m + BM - 1) / BM) * (p.cout / BN);
  conv_kernel<KS, BN><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace nbt

// ---------------------------------------------------------------------------
// wg: the 3x3s on wgmma (the header's wg::conv3x3)

namespace wg {

using nbt::Conv;
using nbt::cp_async16_zfill;
using nbt::cp_async_commit;
using nbt::smem_u32;

constexpr int kConsumers = 3;                      // warpgroups of products
constexpr int kThreadsW = 128 * (kConsumers + 1);  // + the producers
constexpr int kSlabThreads = 96;                   // producer warps 1-3
constexpr int kBM = 64 * kConsumers;               // grid rows a tile
constexpr int kBN = 192;                           // output channels a tile
constexpr int kBK = 64;                            // input channels a chunk
constexpr int kStages = 5;                         // the weight ring
constexpr int kStageBytes = kBN * kBK * 2;         // one tap's chunk, 24 KB
constexpr int kSlabs = 2;                          // slab buffers
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 152;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  65536,
              "registers");

// A tile's slab: its kBM grid rows and every row its taps reach, rounded
// up to whole 8-row groups (so each buffer stays 1024-byte aligned).
__host__ __device__ constexpr int slab_rows(int w) {
  return (kBM + 2 * w + 4 + 7) / 8 * 8;
}

// The weight ring (1024-byte aligned for the 128-byte swizzle: 1 KB of
// slack), the slabs (slab_rows of 128 B each), a full and an empty
// mbarrier a stage and a slab, then the epilogue's scale and shift.
__host__ __device__ constexpr int smem_bytes(int w) {
  return 1024 + kStages * kStageBytes + kSlabs * slab_rows(w) * 128 +
         2 * (kStages + kSlabs) * 8 + 2 * kBN * 4;
}

// The widest board whose slabs fit (110).
__host__ __device__ constexpr int max_width() {
  int w = 0;
  while (smem_bytes(w + 1) <= kSmemLimit) ++w;
  return w;
}
constexpr int kMaxWidth = max_width();

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of copies still to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete (a fresh barrier has
// completed parity 1), or traps after ~2^32 cycles: a lost arrival fails
// the launch instead of hanging the card.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// The box at (k, n) of the 2-D weight map into shared memory at dst,
// counted against `bar` as it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
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

// K-major operand in the 128-byte swizzle (the weights as TMA lands them,
// the slabs as the producer writes them): rows of 128 B, 8-row groups
// 1024 B apart. The swizzle follows the address (bits 7-9 into 4-6), so a
// descriptor may start at any 128-byte row of a 1024-byte aligned buffer
// and a k16 step is 32 B on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define WG_OUT8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 192] += A[64 x 16] B[16 x 192], A and B K-major from shared
// memory, f32 accumulators: acc 4j + 2h + e of lane l of warp q is row
// 16 q + 8 h + l / 4, column 8 j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma192(float (&d)[96], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT8(0), WG_OUT8(8), WG_OUT8(16), WG_OUT8(24), WG_OUT8(32), WG_OUT8(40), WG_OUT8(48), WG_OUT8(56), WG_OUT8(64), WG_OUT8(72), WG_OUT8(80), WG_OUT8(88)
      : "l"(da), "l"(db), "r"(1));
}
#undef WG_OUT8

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// One 3x3 convolution of p.cin = 64 kChunks input channels (the header's
// wg::conv3x3). Tile i is part i % parts of sample i / parts; CTA k takes
// tiles k, k + gridDim.x, ...
template <int kChunks>
__global__ void __launch_bounds__(kThreadsW, 1)
    conv3x3(const Conv p, const __grid_constant__ CUtensorMap wmap,
            int parts) {
  extern __shared__ unsigned char smem_wg[];
  const uint32_t wst = (smem_u32(smem_wg) + 1023) & ~1023u;  // the ring
  const int pitch = p.bw + 1, rows = slab_rows(p.bw);
  const uint32_t slab = wst + kStages * kStageBytes;  // kSlabs x rows x 128 B
  const uint32_t wfull = slab + kSlabs * rows * 128;
  const uint32_t wempty = wfull + 8 * kStages;
  const uint32_t sfull = wempty + 8 * kStages;
  const uint32_t sempty = sfull + 8 * kSlabs;
  float* epi = reinterpret_cast<float*>(smem_wg + (sempty + 8 * kSlabs -
                                                   smem_u32(smem_wg)));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = p.m / p.hw * parts;
  if (p.epi_scale != nullptr && tid < kBN) {  // [scale | shift]
    epi[tid] = p.epi_scale[tid];
    epi[kBN + tid] = p.epi_shift[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 4 * kConsumers);
    }
    for (int s = 0; s < kSlabs; ++s) {
      mbar_init(sfull + 8 * s, kSlabThreads);
      mbar_init(sempty + 8 * s, 4 * kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers and epi initialised

  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers) {
      if (lane != 0) return;
      // The weights: use u, counted across this CTA's tiles, is tap u % 9
      // of chunk (u / 9) % kChunks into stage u % kStages, once every
      // consumer warp has released use u - kStages (a fresh barrier passes
      // parity 1).
      int u = 0;
#pragma unroll 1
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
#pragma unroll 1
        for (int c = 0; c < kChunks; ++c)
#pragma unroll 1
          for (int tap = 0; tap < 9; ++tap, ++u) {
            const int s = u % kStages;
            const uint32_t full = wfull + 8 * s;
            wait(wempty + 8 * s, ((u / kStages) & 1) ^ 1);
            mbar_expect_tx(full, kStageBytes);
            tma_load(wst + s * kStageBytes, &wmap, tap * p.cin + c * kBK, 0,
                     full);
          }
      }
      return;
    }
    // The slabs: chunk v, counted across this CTA's tiles, into buffer v
    // % kSlabs once the consumers have released chunk v - kSlabs. Thread
    // t lands 16 B piece t % 8 (channels 8 (t % 8) ..) of rows t / 8,
    // t / 8 + 12, ... by cp.async, zeros where the row is off the board;
    // then the prologue on the pieces it landed, and the proxy fence
    // before the arrival. Piece c of row r lies at 128 r + 16 (c ^ r % 8)
    // of the buffer (1024-byte aligned): the 128-byte swizzle, which the
    // descriptors follow by address from any starting row.
    const int t = tid - 32 * (4 * kConsumers + 1);
    const int pl = t & 7, need = kBM + 2 * p.bw + 4;  // rows the taps read
    int v = 0;
#pragma unroll 1
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      const int b = i / parts;
      const int q0 = (i - b * parts) * kBM - pitch - 1;  // slab row 0's
      const long long base = (long long)b * p.hw;
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c, ++v) {
        const int sb = v % kSlabs;
        wait(sempty + 8 * sb, ((v / kSlabs) & 1) ^ 1);
        const uint32_t buf = slab + sb * rows * 128;
        auto at = [&](int r) -> uint32_t {
          return buf + 128 * r + ((pl ^ (r & 7)) << 4);
        };
        const int ch = c * kBK + pl * 8;
        uint64_t on = 0;  // bit k: row t / 8 + 12 k is on the board
#pragma unroll 1
        for (int r = t >> 3, k = 0; r < need; r += kSlabThreads / 8, ++k) {
          const int q = q0 + r;
          const int y = q < 0 ? -1 : q / pitch;
          const bool ok = q >= 0 && y < p.h && q - y * pitch < p.bw;
          const __nv_bfloat16* src =
              ok ? p.x + (base + q - y) * p.ldx + ch : p.x;
          cp_async16_zfill(at(r), src, ok);
          on |= (uint64_t)ok << k;
        }
        cp_async_commit();
        nbt::cp_async_wait<0>();
        if (p.pro_scale != nullptr && on != 0) {
          const float4* sc = reinterpret_cast<const float4*>(p.pro_scale + ch);
          const float4* sh = reinterpret_cast<const float4*>(
              p.pro_shift + b * (long long)p.shift_stride + ch);
          const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1);
          const float4 t0 = __ldg(sh), t1 = __ldg(sh + 1);
          const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float h[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll 1
          for (int r = t >> 3, k = 0; r < need; r += kSlabThreads / 8, ++k) {
            if (!((on >> k) & 1)) continue;
            uint4 x = ld_shared16(at(r));
            __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float2 f = __bfloat1622float2(e[j]);
              f.x = fmaxf(f.x * s[2 * j] + h[2 * j], 0.f);
              f.y = fmaxf(f.y * s[2 * j + 1] + h[2 * j + 1], 0.f);
              e[j] = __floats2bfloat162_rn(f.x, f.y);
            }
            st_shared16(at(r), x);
          }
        }
        fence_async_shared();
        mbar_arrive(sfull + 8 * sb);
      }
    }
    return;
  }

  // The consumers: warpgroup grp owns grid rows 64 grp .. 64 grp + 63 of the
  // tile. Per chunk, wait for its slab; per tap, wait for its weights,
  // issue 4 wgmmas (one commit group), then wait until the previous tap's
  // group is done and release its stage (and, at a chunk's first tap, the
  // previous chunk's slab). The K loop is unrolled whole, so no wgmma is
  // in flight across a runtime branch.
  regs_inc<kConsumerRegs>();
  const int grp = warp >> 2;
  int u = 0, v = 0;
  float acc[96];
#pragma unroll 1
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const int b = i / parts, part = i - b * parts;
#pragma unroll
    for (int k = 0; k < 96; ++k) {
      acc[k] = 0.f;
      fence_operand(acc[k]);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int sb = v % kSlabs;
      wait(sfull + 8 * sb, (v / kSlabs) & 1);
      const uint32_t a0 = slab + (sb * rows + grp * 64) * 128;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int s = u % kStages;
        wait(wfull + 8 * s, (u / kStages) & 1);
        uint64_t da = sw128_desc(a0 + ((tap / 3) * pitch + tap % 3) * 128);
        uint64_t db = sw128_desc(wst + s * kStageBytes);
        asm volatile("" : "+l"(da), "+l"(db));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 32 B of each row a k16
          wgmma192(acc, da + (uint64_t)(2 * kk), db + (uint64_t)(2 * kk));
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0 || tap > 0) {
          if (lane == 0) {
            mbar_arrive(wempty + 8 * ((u - 1) % kStages));
            if (tap == 0) mbar_arrive(sempty + 8 * ((v - 1) % kSlabs));
          }
          __syncwarp();
        }
        ++u;
      }
      ++v;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 96; ++k) fence_operand(acc[k]);
    if (lane == 0) {
      mbar_arrive(wempty + 8 * ((u - 1) % kStages));
      mbar_arrive(sempty + 8 * ((v - 1) % kSlabs));
    }
    __syncwarp();
    // Epilogue from the fragments: lane l of warp q holds rows 16 q + 8 h +
    // l / 4 of the warpgroup's 64 (h = 0, 1), channels 8 j + 2 (l % 4) and
    // the next; affine (from shared memory), ReLU from relu_from, + the
    // residual in f32 (a row's 24 pieces loaded before any store), bf16.
    const int c2 = 2 * (lane & 3);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int g = part * kBM + grp * 64 + (warp & 3) * 16 + hh * 8 +
                    (lane >> 2);
      const int y = g / pitch, x = g - y * pitch;
      if (y >= p.h || x >= p.bw) continue;
      const long long o = ((long long)b * p.hw + y * p.bw + x) * kBN + c2;
      uint32_t r[kBN / 8];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        r[j] = p.res == nullptr ? 0u
                                : __ldg(reinterpret_cast<const unsigned int*>(
                                      p.res + o + 8 * j));
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = 8 * j + c2;
        float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if (p.epi_scale != nullptr) {
          v0 = v0 * epi[n] + epi[kBN + n];
          v1 = v1 * epi[n + 1] + epi[kBN + n + 1];
        }
        if (n >= p.relu_from) v0 = fmaxf(v0, 0.f);
        if (n + 1 >= p.relu_from) v1 = fmaxf(v1, 0.f);
        if (p.res != nullptr) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r[j]));
          v0 += f.x;
          v1 += f.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The weights [cout][9 cin] bf16 as a 2-D tensor map, K fastest: a box of
// 64 K x kBN output channels, 128-byte swizzled. Encoded once per
// (pointer, cin, cout) (the driver's cuTensorMapEncodeTiled, reached
// through the runtime: no link against the driver library).
cudaError_t weight_map(CUtensorMap* map, const void* w, int cin, int cout) {
  static const auto encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, CUtensorMap> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(w, cin, cout);
  const auto it = known.find(key);
  if (it != known.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)9 * cin, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * cin * 2};
  const cuuint32_t boxes[2] = {(cuuint32_t)kBK, (cuuint32_t)kBN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorNotSupported;
  known[key] = *map;
  return cudaSuccess;
}

// Tiles a sample: its h x (w + 1) grid rows in tiles of kBM.
inline int parts(int h, int w) { return (h * (w + 1) + kBM - 1) / kBM; }

// The shapes conv3x3 takes (ops/katago_nbt.py::conv_variant mirrors it).
inline bool takes(int ks, int cin, int cout, int w) {
  return ks == 3 && (cin == 128 || cin == 192) && cout == kBN &&
         w <= kMaxWidth;
}

// Persistent: one CTA an SM (its shared memory admits no second), or
// one a tile where the tiles are fewer. The attribute set and the SMs
// counted once per device.
template <int kChunks>
cudaError_t launch(const Conv& p, cudaStream_t stream) {
  const auto kernel = conv3x3<kChunks>;
  static std::mutex mu;
  static std::map<int, int> sms;  // by device
  int dev = 0;
  cudaGetDevice(&dev);
  int grid = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = sms.find(dev);
    if (it != sms.end()) {
      grid = it->second;
    } else {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&grid, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return err;
      sms[dev] = grid;
    }
  }
  CUtensorMap map;
  const cudaError_t err = weight_map(&map, p.w, p.cin, p.cout);
  if (err != cudaSuccess) return err;
  const int np = parts(p.h, p.bw);
  const long long tiles = (long long)p.m / p.hw * np;
  if (tiles < grid) grid = (int)tiles;
  kernel<<<grid, kThreadsW, smem_bytes(p.bw), stream>>>(p, map, np);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// The mainloops the host names: nbt::conv_kernel (mma.sync) and
// wg::conv3x3 (wgmma).
enum Variant { kMma = 0, kWgmma = 1 };

// One convolution by the mainloop `variant` (ops/katago_nbt.py::
// conv_variant picks it by shape). Returns a cudaError_t: 1
// (cudaErrorInvalidValue) for a shape the mainloop does not take. Both:
// ks 1 or 3, cin and cout multiples of 64, ldx a multiple of 8 and >= cin,
// shift_stride a multiple of 4, whole samples (m a multiple of hw = h w).
// wg::conv3x3 besides: ks 3, cin 128 or 192, cout 192, boards at most
// wg::kMaxWidth (110) wide.
extern "C" int alphafive_nbt_conv(const void* x, int ldx, const void* w,
                                  const void* pro_scale, const void* pro_shift,
                                  int shift_stride, const void* epi_scale,
                                  const void* epi_shift, int relu_from,
                                  const void* res, void* out, int m, int hw,
                                  int h, int wd, int cin, int cout, int ks,
                                  int variant, void* stream) {
  using namespace nbt;
  if ((ks != 1 && ks != 3) || cin % BK || cout % 64 || ldx % 8 || ldx < cin ||
      shift_stride % 4 || m <= 0 || hw != h * wd || m % hw)
    return cudaErrorInvalidValue;
  if (variant != kMma && !wg::takes(ks, cin, cout, wd))
    return cudaErrorInvalidValue;
  Conv p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.pro_scale = static_cast<const float*>(pro_scale);
  p.pro_shift = static_cast<const float*>(pro_shift);
  p.epi_scale = static_cast<const float*>(epi_scale);
  p.epi_shift = static_cast<const float*>(epi_shift);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ldx = ldx;
  p.shift_stride = shift_stride;
  p.relu_from = relu_from;
  p.m = m;
  p.hw = hw;
  p.h = h;
  p.bw = wd;
  p.cin = cin;
  p.cout = cout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma)  // cin 192: three chunks; 128: two
    return cin == 192 ? wg::launch<3>(p, st) : wg::launch<2>(p, st);
  if (variant != kMma) return cudaErrorInvalidValue;
  const bool wide = cout % 192 == 0;
  if (ks == 3) return wide ? launch_conv<3, 192>(p, st) : launch_conv<3, 64>(p, st);
  return wide ? launch_conv<1, 192>(p, st) : launch_conv<1, 64>(p, st);
}

// The pooling pair's reduction and dense layer (see pool_kernel).
extern "C" int alphafive_nbt_pool(const void* g, int ldg, int samples, int hw,
                                  int cg, int cr, float k1, const void* wl,
                                  const void* s2, const void* t2, void* shift,
                                  void* stream) {
  using namespace nbt;
  if (samples <= 0 || hw <= 0 || cg <= 0 || cr <= 0) return cudaErrorInvalidValue;
  const int smem = 11 * cg * (int)sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  pool_kernel<<<samples, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), ldg, hw, cg, cr, k1,
      static_cast<const float*>(wl), static_cast<const float*>(s2),
      static_cast<const float*>(t2), static_cast<float*>(shift));
  return cudaGetLastError();
}
