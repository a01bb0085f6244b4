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
// 15x15x64 per forward) one block is 2 x 16.6 MFLOP per sample against
// 57.6 KB of activations in and out, about 580 FLOP per byte of device
// memory traffic, so it is compute bound if the tensor cores are fed — and
// what feeds them here is shared memory: the 3x3 'same' conv is nine
// shifted [HW, C] x [C, C] products whose shifted operand rows cannot be
// staged once and reused the way a plain GEMM tile can.
//
// What the design does about it (a simple first version, not a tuned one):
//   * One block owns one sample. x is staged once in shared memory and the
//     intermediate y is written to a second shared buffer, so y never goes
//     to device memory and x is read from it once (the residual re-reads
//     the staged copy). Each row of a buffer is padded by 8 elements so the
//     fragment loads of 8 consecutive pixels hit 32 distinct banks.
//   * The taps are bf16 mma.sync m16n8k16 products with f32 accumulators.
//     A warp owns whole 16-pixel row tiles across all C output channels and
//     keeps their accumulators in registers over the nine taps. The shifted
//     operand is read per pixel with a bounds check, which replaces the TPU
//     kernel's flat roll + border mask (a TPU layout trick).
//   * Each tap's [C, C] weight slice is streamed through shared memory
//     (transposed to [Cout][Cin] so B fragments are 32-bit loads): the nine
//     taps of one conv are 72 KB at C = 64 and 288 KB at C = 128, more than
//     can sit beside x and y. At 19x19x128 the two activation buffers take
//     196 KB, one tap 35 KB, 231 KB of the 227 KiB a block may use.
//   * Tiles that do not fit one pass of the 8 warps run in rounds, each
//     round streaming the nine taps again (from L2).
// The f32 path is a plain FMA kernel (no tensor cores: TF32 would round the
// inputs) that reads x from device memory and keeps y in shared memory,
// which holds it at every bundle shape (19x19x128 f32 y is 185 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// Copy tap `t` of w[9][C][C] (Cin-major) into ws[Cout][CP] (Cin contiguous).
template <int C>
__device__ __forceinline__ void load_tap_transposed(
    const __nv_bfloat16* __restrict__ w, int t, __nv_bfloat16* ws) {
  constexpr int CP = C + 8;
  const uint4* src = reinterpret_cast<const uint4*>(w + (size_t)t * C * C);
  for (int i = threadIdx.x; i < C * C / 8; i += kThreads) {
    int k = i / (C / 8);
    int n0 = (i - k * (C / 8)) * 8;
    uint4 v = src[i];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ws[(n0 + j) * CP + k] = e[j];
  }
}

// One 3x3 'same' conv from shared src[HW][CP] into per-warp accumulators,
// then the epilogue. kSecond selects the epilogue: false writes
// relu(acc + b) rounded to bf16 into shared dst; true adds b and the
// residual from src_res, applies relu and writes bf16 to device memory.
template <int C, int kTilesPerWarp, bool kSecond>
__device__ void conv_bf16(const __nv_bfloat16* src,
                          const __nv_bfloat16* __restrict__ wg,
                          const float* __restrict__ bias,
                          __nv_bfloat16* ws, __nv_bfloat16* dst_smem,
                          const __nv_bfloat16* res_smem,
                          __nv_bfloat16* __restrict__ dst_global, int h,
                          int w) {
  constexpr int CP = C + 8;
  constexpr int NT = C / 8;  // n8 tiles across the output channels
  const int hw = h * w;
  const int m_tiles = (hw + 15) / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int per_round = kWarps * kTilesPerWarp;

  for (int round0 = 0; round0 < m_tiles; round0 += per_round) {
    float acc[kTilesPerWarp][NT][4];
#pragma unroll
    for (int r = 0; r < kTilesPerWarp; ++r)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][n][q] = 0.f;

    for (int t = 0; t < 9; ++t) {
      __syncthreads();  // every warp is done with the previous tap
      load_tap_transposed<C>(wg, t, ws);
      __syncthreads();
      const int dy = t / 3 - 1;
      const int dx = t % 3 - 1;
#pragma unroll
      for (int r = 0; r < kTilesPerWarp; ++r) {
        const int mt = round0 + r * kWarps + warp;
        if (mt >= m_tiles) continue;
        const int q0 = shifted_pixel(mt * 16 + gid, dy, dx, h, w);
        const int q1 = shifted_pixel(mt * 16 + gid + 8, dy, dx, h, w);
        const uint32_t* row0 =
            reinterpret_cast<const uint32_t*>(src + (q0 < 0 ? 0 : q0) * CP);
        const uint32_t* row1 =
            reinterpret_cast<const uint32_t*>(src + (q1 < 0 ? 0 : q1) * CP);
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          const int kw = ks * 8 + tig;  // 32-bit word of channel ks*16+tig*2
          uint32_t a[4];
          a[0] = q0 < 0 ? 0u : row0[kw];
          a[1] = q1 < 0 ? 0u : row1[kw];
          a[2] = q0 < 0 ? 0u : row0[kw + 4];
          a[3] = q1 < 0 ? 0u : row1[kw + 4];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint32_t* wrow =
                reinterpret_cast<const uint32_t*>(ws + (n * 8 + gid) * CP);
            uint32_t b[2] = {wrow[kw], wrow[kw + 4]};
            mma_bf16_16816(acc[r][n], a, b);
          }
        }
      }
    }

    // epilogue: accumulator (r, n, q) is pixel mt*16 + gid + 8*(q/2),
    // channels n*8 + tig*2 + {0, 1}
#pragma unroll
    for (int r = 0; r < kTilesPerWarp; ++r) {
      const int mt = round0 + r * kWarps + warp;
      if (mt >= m_tiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + gid + 8 * half;
        if (p >= hw) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + tig * 2;
          float v0 = acc[r][n][2 * half] + bias[col];
          float v1 = acc[r][n][2 * half + 1] + bias[col + 1];
          if (kSecond) {
            float2 xr = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res_smem + p * CP +
                                                         col));
            v0 += xr.x;
            v1 += xr.y;
          }
          __nv_bfloat162 o =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          if (kSecond) {
            *reinterpret_cast<__nv_bfloat162*>(dst_global + (size_t)p * C +
                                               col) = o;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst_smem + p * CP + col) = o;
          }
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    resblock_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ out, int h, int w) {
  constexpr int CP = C + 8;
  // 64 accumulators per thread: two row tiles at C = 64, one above
  constexpr int kTilesPerWarp = C <= 64 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = h * w;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ys = xs + hw * CP;
  __nv_bfloat16* ws = ys + hw * CP;

  const size_t base = (size_t)blockIdx.x * hw * C;
  const uint4* xg = reinterpret_cast<const uint4*>(x + base);
  for (int i = threadIdx.x; i < hw * (C / 8); i += kThreads) {
    int p = i / (C / 8);
    int c8 = i - p * (C / 8);
    *reinterpret_cast<uint4*>(xs + p * CP + c8 * 8) = xg[i];
  }
  // conv_bf16 syncs before its first weight load, which also covers xs
  conv_bf16<C, kTilesPerWarp, false>(xs, w1, b1, ws, ys, nullptr, nullptr,
                                     h, w);
  conv_bf16<C, kTilesPerWarp, true>(ys, w2, b2, ws, nullptr, xs, out + base,
                                    h, w);
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
    resblock_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        float* __restrict__ out, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);
  const size_t base = (size_t)blockIdx.x * h * w * C;
  conv_f32<C, false>(x + base, w1, b1, ys, nullptr, nullptr, h, w);
  __syncthreads();
  conv_f32<C, true>(ys, w2, b2, nullptr, x + base, out + base, h, w);
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int b,
                        int h, int w, cudaStream_t stream) {
  constexpr int CP = C + 8;
  const size_t smem = (size_t)(2 * h * w * CP + C * CP) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      resblock_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  resblock_bf16_kernel<C><<<b, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), h, w);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int b,
                       int h, int w, cudaStream_t stream) {
  const size_t smem = (size_t)h * w * C * 4;
  cudaError_t err = cudaFuncSetAttribute(
      resblock_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  resblock_f32_kernel<C><<<b, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller has checked shapes, types, contiguity and the shared-memory
// budget. Launches on `stream` and does not synchronise.
extern "C" int alphafive_resblock(int dtype, const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int b, int h,
                                  int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return cudaSuccess;
  if (dtype == 1) {
    switch (c) {
      case 64: return launch_bf16<64>(x, w1, b1, w2, b2, out, b, h, w, s);
      case 96: return launch_bf16<96>(x, w1, b1, w2, b2, out, b, h, w, s);
      case 128: return launch_bf16<128>(x, w1, b1, w2, b2, out, b, h, w, s);
    }
  } else if (dtype == 0) {
    switch (c) {
      case 64: return launch_f32<64>(x, w1, b1, w2, b2, out, b, h, w, s);
      case 96: return launch_f32<96>(x, w1, b1, w2, b2, out, b, h, w, s);
      case 128: return launch_f32<128>(x, w1, b1, w2, b2, out, b, h, w, s);
    }
  }
  return cudaErrorInvalidValue;
}
