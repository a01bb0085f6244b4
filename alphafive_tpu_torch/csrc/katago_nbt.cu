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
// conv_kernel<KS, BN>: one convolution as an implicit GEMM, M = the
// positions, N = the output channels, K = KS*KS taps x Cin, with
//   * a prologue on the A operand: A(v) = max(v * scale[c] + shift[s, c],
//     0), shift per channel or per sample (the pooling pair's second conv
//     takes its pooled bias there); rows whose tap is off the board are
//     zeros of the activated input, never A(0);
//   * an epilogue: v * scale[n] + shift[n], ReLU from channel relu_from
//     on, + a residual, rounded to bf16.
// The three entry points of ops/katago_nbt.py are launches of it:
//   preact_pair  conv1 (prologue A_1, epilogue A_2) and conv2 (+ h);
//   gpool_pair   conv1 to [r | g] (epilogue A_g on g alone), pool_kernel
//                (the board's mean, scaled mean and max of g, the dense
//                layer, folded with A_2 into a per-sample shift), conv2
//                (prologue A_2 with that shift, + h);
//   conv1x1      the bottleneck 1x1s (prologue A_p / A_q, + x for W_q).
//
// What bounds it: at the Renju self-play leaf forward, 4,096 x 19x19, a
// 3x3 conv 192 -> 192 is 0.98 TFLOP against ~1.1 GB of activations in
// and out: the tensor cores (1.0 ms at 989 TFLOP/s). The 1x1s 384 <-> 192
// are 0.22 TFLOP against 1.7 GB: 64 FLOP a byte, under the card's ~295,
// so HBM bounds them (0.51 ms). The design: tiles of 128 positions x 192
// (or 64) channels, K steps of 64 channels of one tap, 8 warps of 64 x 48
// each on mma.sync m16n8k16 from ldmatrix, f32 accumulators. A and B move
// by cp.async into a 4-stage ring (3 steps in flight while one
// multiplies; A's off-board rows are 16 zero bytes); each thread applies
// the prologue to its own A rows of a step once they have landed, before
// the step's one block barrier. Rows of 144 B, so that ldmatrix's eight
// rows hit eight bank groups. Why a ring: at one CTA an SM (203-224
// registers a thread), loads started one step ahead leave their latency
// exposed (164 TFLOP/s a pair at 4,096 x 19x19, against ~220 with the
// ring). The epilogue stages the f32 tile in shared memory, so that the
// residual is read and the output written 16 B a thread, coalesced. The
// pair's intermediate goes through device memory (not fused as
// resblock.cu's pair is): PERF.md records what that costs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
}  // namespace

// One convolution (see conv_kernel). Returns a cudaError_t: 1
// (cudaErrorInvalidValue) for a shape it does not take: ks other than 1
// or 3, cin not a multiple of 64, cout not of 64, ldx not of 8,
// shift_stride not of 4.
extern "C" int alphafive_nbt_conv(const void* x, int ldx, const void* w,
                                  const void* pro_scale, const void* pro_shift,
                                  int shift_stride, const void* epi_scale,
                                  const void* epi_shift, int relu_from,
                                  const void* res, void* out, int m, int hw,
                                  int h, int wd, int cin, int cout, int ks,
                                  void* stream) {
  using namespace nbt;
  if ((ks != 1 && ks != 3) || cin % BK || cout % 64 || ldx % 8 || ldx < cin ||
      shift_stride % 4 || m <= 0 || hw != h * wd)
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
